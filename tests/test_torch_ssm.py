"""The port's SSM (Mamba-1, falcon-mamba) and hybrid (Mamba-2 with a
weight-shared attention block, zamba2) families against the JAX
package's.

The scans against JAX's and the naive recurrence at JAX's tolerances
(``tests/test_models.py``); the Mamba blocks' forward and decode step, and
the reduced models' ``forward`` and ``decode_step``, against JAX's on the
same weights (``bridge.params_from_numpy``) at f32 roundoff, and the
port's decode against its own forward at JAX's tolerance.  Sessions on the
slot layout (the teacher-forced admission) equal JAX's in every request's
tokens and ticks and in the stats on both loops, a pad id changes nothing
(JAX's ``test_pad_id_is_semantics_preserving``), and ``generate`` equals
JAX's.  The cache-row ops take the conv/ssm leaves, and every family
refusal (the paged layout, tiers, paged decode and verify, a fused
prefill) has JAX's message.  Their training is held to JAX's in
``tests/test_torch_train_families.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core.approx import ApproxConfig as JApprox
from repro.models import ssm as jS
from repro.models import transformer as jT
from repro.serve import cache as jC
from repro.serve.engine import generate as jgenerate
from repro.serve.engine import resolve_execution_mode as jresolve
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serve import (
    ServeSession,
    evict_slot,
    generate,
    greedy_generate_legacy,
    insert_slot,
    resolve_execution_mode,
    scatter_rows,
)

SSM, HYBRID = "falcon-mamba-7b", "zamba2-2.7b"
FIELDS = ("ticks", "admitted", "completed", "generated_tokens", "admit_calls", "peak_active",
          "prefill_tokens", "work_ticks", "busy_slot_steps", "idle_slot_steps", "ttft_ticks",
          "latency_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch, mode="exact"):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), q_chunk=16, approx=jresolve(mode))
    tcfg = dataclasses.replace(reduced_config(get_config(arch)),
                               approx=resolve_execution_mode(mode))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# scans and blocks
# ---------------------------------------------------------------------------


def test_selective_scan_matches_jax_and_naive():
    B, S_, di, N = 1, 16, 4, 3
    rng = np.random.default_rng(0)
    dA = rng.uniform(0.5, 0.99, (B, S_, di, N)).astype(np.float32)
    dBx = rng.normal(size=(B, S_, di, N)).astype(np.float32)
    h0 = np.zeros((B, di, N), np.float32)
    h_all, h_last = S._selective_scan_chunked(_t(dA), _t(dBx), _t(h0), chunk=4)
    jh_all, jh_last = jS._selective_scan_chunked(jnp.asarray(dA), jnp.asarray(dBx),
                                                 jnp.asarray(h0), 4)
    h = np.zeros((B, di, N), np.float32)
    for t in range(S_):
        h = dA[:, t] * h + dBx[:, t]
        np.testing.assert_allclose(h_all[:, t].numpy(), h, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), h, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_all.numpy(), np.asarray(jh_all), rtol=1e-5, atol=1e-6)


def test_ssd_matches_jax_and_naive():
    B, S_, nh, hd, N = 1, 12, 2, 4, 3
    rng = np.random.default_rng(1)
    X = rng.normal(size=(B, S_, nh, hd)).astype(np.float32)
    a = rng.uniform(-0.5, -0.01, (B, S_, nh)).astype(np.float32)
    Bm = rng.normal(size=(B, S_, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S_, N)).astype(np.float32)
    h0 = np.zeros((B, nh, hd, N), np.float32)
    Y, h_last = S.ssd_chunked(_t(X), _t(a), _t(Bm), _t(Cm), _t(h0), chunk=4)
    jY, jh = jS.ssd_chunked(*(jnp.asarray(v) for v in (X, a, Bm, Cm, h0)), 4)
    h = np.zeros((B, nh, hd, N), np.float32)
    for t in range(S_):
        h = np.exp(a[:, t])[:, :, None, None] * h + np.einsum("bhd,bn->bhdn", X[:, t], Bm[:, t])
        y = np.einsum("bhdn,bn->bhd", h, Cm[:, t])
        np.testing.assert_allclose(Y[:, t].numpy(), y, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_softplus_is_jax_softplus():
    x = np.asarray([-40.0, -3.0, 0.0, 2.5, 19.0, 21.0, 60.0], np.float32)
    np.testing.assert_array_equal(S.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)))


@pytest.mark.parametrize("block", ["mamba1", "mamba2"])
@pytest.mark.parametrize("mode", ["float", "lowrank"])
def test_mamba_blocks_match_jax(block, mode):
    d, di, N = 16, 32, 4
    key = jax.random.PRNGKey(3)
    jp = (jS.init_mamba1(key, d, di, N, 4) if block == "mamba1"
          else jS.init_mamba2(key, d, di, N, 2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jfwd, jdec = ((jS.mamba1_forward, jS.mamba1_decode_step) if block == "mamba1"
                  else (jS.mamba2_forward, jS.mamba2_decode_step))
    tfwd, tdec = ((S.mamba1_forward, S.mamba1_decode_step) if block == "mamba1"
                  else (S.mamba2_forward, S.mamba2_decode_step))
    jcfg, tcfg = JApprox(mode=mode), ApproxConfig(mode=mode)
    jfwd = jax.jit(functools.partial(jfwd, cfg=jcfg, chunk=4))
    jdec = jax.jit(functools.partial(jdec, cfg=jcfg))
    x = np.random.default_rng(4).normal(size=(2, 8, d)).astype(np.float32)
    jy, jst = jfwd(jnp.asarray(x), jp)
    ty, tst = tfwd(_t(x), tp, cfg=tcfg, chunk=4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for i in range(3):
        xs = x[:, i:i + 1] * (i + 1)
        jy, jst = jdec(jnp.asarray(xs), jp, jst)
        ty, tst = tdec(_t(xs), tp, tst, cfg=tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_forward_and_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    B, S_ = 2, 8
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, S_)).astype(np.int32)
    jl, jaux = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, taux = T.forward(tcfg, tp, _t(toks), return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert float(taux) == float(jaux) == 0.0
    jc = jT.init_cache(jcfg, B, S_, jnp.float32)
    tc = T.init_cache(tcfg, B, S_)
    jstep = jax.jit(jT.decode_step, static_argnums=0)
    outs = []
    for i in range(S_):
        jlg, jc = jstep(jcfg, jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                        jnp.full((B,), i, jnp.int32))
        with torch.no_grad():
            tlg = T.decode_step(tcfg, tp, tc, _t(toks[:, i:i + 1]), torch.full((B,), i))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=1e-4)
        outs.append(tlg[:, 0])
    # the port's decode against its own forward, at JAX's tolerance
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), tl.numpy(), rtol=2e-2, atol=2e-3)
    for name in jc:
        np.testing.assert_allclose(tc[name][..., :jc[name].shape[2], :, :].numpy()
                                   if name in ("k", "v") else tc[name].numpy(),
                                   np.asarray(jc[name]), rtol=1e-5, atol=1e-5)


def test_write_rows_freezes_the_other_rows():
    """``decode_step(write_rows=...)``: every row computes the same logits,
    and rows outside ``write_rows`` leave every cache leaf as it was."""
    _, _, tcfg, tp = _models(HYBRID)
    rng = np.random.default_rng(6)
    base = T.init_cache(tcfg, 3, 8)
    for leaf in base.values():
        leaf.copy_(torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32)))
    toks, cur = _t(rng.integers(0, 500, (3, 1))), torch.as_tensor([2, 5, 7])
    free = {k: v.clone() for k, v in base.items()}
    masked = {k: v.clone() for k, v in base.items()}
    with torch.no_grad():
        a = T.decode_step(tcfg, tp, free, toks, cur)
        b = T.decode_step(tcfg, tp, masked, toks, cur,
                          write_rows=torch.as_tensor([True, False, True]))
    assert torch.equal(a, b)
    for k in base:
        assert torch.equal(masked[k][:, [0, 2]], free[k][:, [0, 2]]), k
        assert torch.equal(masked[k][:, 1], base[k][:, 1]), k


def _trace(seed=3, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(2, 9))), int(rng.integers(1, 7)),
             int(rng.integers(0, 4))) for _ in range(n)]


def _serve(sess, trace):
    for i, (p, n, a) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a, req_id=i)
    res = sess.run(max_steps=1000)
    assert sess.drained
    return res


@pytest.mark.parametrize("arch", [SSM, HYBRID])
@pytest.mark.parametrize("loop", ["sync", "async"])
def test_sessions_match_jax(arch, loop):
    """``exact_quant`` (sync) and float (async): under per-tensor
    activation scales an f32 roundoff of the residual stream (the two
    frameworks reduce RMSNorm's mean in other orders) can move a code across
    a rounding boundary, and the approximate product carries such a flip
    into the tokens; the blocks hold ``lowrank`` to JAX above."""
    mode = "exact_quant" if loop == "sync" else "exact"
    jcfg, jp, tcfg, tp = _models(arch, mode)
    kw = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8), cache_layout="slots", loop=loop)
    trace = _trace()
    jsess = JServeSession(jcfg, jp, **kw)
    tsess = ServeSession(tcfg, tp, device="cpu", **kw)
    assert tsess.prefill_mode == jsess.prefill_mode == "decode"
    jres, tres = _serve(jsess, trace), _serve(tsess, trace)
    for i in range(len(trace)):
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.admitted_tick, t.finished_tick, t.finish_reason, t.ttft) == \
            (j.admitted_tick, j.finished_tick, j.finish_reason, j.ttft), i
    for f in FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f


def test_pad_id_is_semantics_preserving():
    """JAX's contract on the teacher-forced admission: pad id 0 and an
    in-vocab pad id 7 serve the same trace bit-identically."""
    _, _, tcfg, tp = _models(SSM)
    rng = np.random.default_rng(29)
    trace, t = [], 0
    for _ in range(6):
        p = rng.integers(0, tcfg.vocab_size, int(rng.integers(2, 9)))
        t += int(rng.poisson(1.0))
        trace.append((p, int(rng.integers(1, 7)), t))
    outs = {}
    for pad in (0, 7):
        sess = ServeSession(tcfg, tp, num_slots=2, max_len=16, prompt_buckets=(4, 8),
                            cache_layout="slots", pad_id=pad, device="cpu")
        outs[pad] = {i: r.tokens.tolist() for i, r in _serve(sess, trace).items()}
    assert outs[0] == outs[7]


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_generate_matches_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch, "exact_quant")
    prompt = np.random.default_rng(7).integers(0, 512, (2, 5)).astype(np.int32)
    want = np.asarray(jgenerate(jcfg, jp, jnp.asarray(prompt), max_new=4))
    got = generate(tcfg, tp, prompt, max_new=4, device="cpu")   # prefill_mode -> decode
    assert got.tolist() == want.tolist()
    assert greedy_generate_legacy(tcfg, tp, prompt, max_new=4, device="cpu").tolist() == \
        want.tolist()


def test_cache_row_ops_take_state_leaves():
    """``insert_slot``/``evict_slot``/``scatter_rows`` on the hybrid's
    conv/ssm leaves (no sequence axis) and its grouped K/V, against JAX's."""
    jcfg, _, tcfg, _ = _models(HYBRID)
    rng = np.random.default_rng(8)
    tfull = T.init_cache(tcfg, 4, 8)
    for leaf in tfull.values():
        leaf.copy_(torch.from_numpy(rng.normal(size=leaf.shape).astype(np.float32)))
    cut = lambda c: {k: (v[:, :, :8] if k in ("k", "v") else v) for k, v in c.items()}
    jfull = {k: jnp.asarray(v.numpy()) for k, v in cut(tfull).items()}
    assert {k: v.shape for k, v in jfull.items()} == \
        {k: v.shape for k, v in jT.init_cache(jcfg, 4, 8, jnp.float32).items()}
    one = {k: torch.from_numpy(rng.normal(size=(v.shape[0], 1) + v.shape[2:])
                               .astype(np.float32)) for k, v in tfull.items()}
    jfull = jC.insert_slot(jfull, {k: jnp.asarray(v.numpy()) for k, v in cut(one).items()},
                           jnp.int32(2))
    insert_slot(tfull, one, 2)
    jfull = jC.evict_slot(jfull, jnp.int32(0))
    evict_slot(tfull, 0)
    part = {k: rng.normal(size=(v.shape[0], 3) + v.shape[2:]).astype(np.float32)
            for k, v in tfull.items()}
    slots, valid = np.asarray([3, 1, 0], np.int32), np.asarray([True, True, False])
    for k in tfull:
        jfull[k] = jC.scatter_rows(jfull[k], jnp.asarray(cut(part)[k] if k in ("k", "v")
                                                         else part[k]),
                                   jnp.asarray(slots), jnp.asarray(valid))
        scatter_rows(tfull[k], torch.from_numpy(part[k]), torch.from_numpy(slots),
                     torch.from_numpy(valid))
    for k, v in cut(tfull).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jfull[k]), err_msg=k)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _same_error(exc, jfn, tfn):
    with pytest.raises(exc) as jerr:
        jfn()
    with pytest.raises(exc) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_family_refusals_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(4, 8))
    # the paged layout (the port's default; JAX's when asked)
    _same_error(ValueError, lambda: JServeSession(jcfg, jp, cache_layout="paged", **kw),
                lambda: ServeSession(tcfg, tp, device="cpu", **kw))
    # quality tiers
    tiers = dict(kw, cache_layout="slots", tiers=("exact", "approx_lowrank"))
    _same_error(ValueError, lambda: JServeSession(jcfg, jp, **tiers),
                lambda: ServeSession(tcfg, tp, device="cpu", **tiers))
    # the paged passes and pool
    args = ({"tokens": jnp.zeros((1, 2), jnp.int32)}, jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 1), jnp.int32))
    targs = (torch.zeros((1, 2), dtype=torch.long), torch.zeros((1,), dtype=torch.long),
             torch.zeros((1, 1), dtype=torch.int32))
    for jfn, tfn in ((jT.paged_verify_step, T.paged_verify_step),
                     (jT.paged_chunk_prefill_step, T.paged_chunk_prefill_step)):
        _same_error(NotImplementedError,
                    lambda: jfn(jcfg, jp, {}, *args, block_size=4),
                    lambda: tfn(tcfg, tp, {}, *targs, block_size=4))
    _same_error(NotImplementedError,
                lambda: jT.paged_decode_step(jcfg, jp, {}, {"tokens": args[0]["tokens"][:, :1]},
                                             args[1], args[2], block_size=4),
                lambda: T.paged_decode_step(tcfg, tp, {}, targs[0][:, :1], targs[1], targs[2],
                                            block_size=4))
    _same_error(NotImplementedError, lambda: jT.init_paged_cache(jcfg, 4, 4),
                lambda: T.init_paged_cache(tcfg, 4, 4))
    # a fused prefill
    toks = np.zeros((1, 4), np.int32)
    _same_error(NotImplementedError,
                lambda: jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, return_kv=True),
                lambda: T.forward(tcfg, tp, _t(toks), return_kv=True))


def test_launcher_serves_ssm(capsys):
    """The ssm recipe: the slot layout, the teacher-forced admission."""
    from repro_torch.launch.serve import main

    res = main(["--arch", SSM, "--reduced", "--device", "cpu", "--cache-layout", "slots",
                "--requests", "4", "--new", "4"])
    out = capsys.readouterr().out
    assert len(res) == 4 and "KV stripes:" in out
