"""The port's MoE family against the JAX package's, and every registered
config against JAX's.

Configs: every architecture the port registers equals JAX's field for
field, and so does its ``reduced_config``.  ``moe_ffn`` on the same tokens
and weights (brought across by ``bridge.params_from_numpy``) equals JAX's
in ``float`` and ``approx_lowrank``: the output at f32 roundoff and the
load-balance loss, with a router skewed until the capacity binds (the
same assignments dropped), and without a shared expert (grok-1).  The
reduced qwen2-moe-a2.7b model's ``forward``, ``decode_step`` and
``paged_decode_step`` equal JAX's (JAX's paged step through the gather and
its Pallas kernel in interpret mode, the port's through the gather and
K2's plain version), freezing calibrates stacked experts per expert as
JAX does, and sessions on one trace equal JAX's in every request's tokens
and ticks and in the session's stats, on (sync, paged), (async, paged) and
(async, slots).  Every moe refusal has JAX's message.
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
from repro.core.approx import prequantize_tree as jprequantize
from repro.models import moe as jM
from repro.models import transformer as jT
from repro.serve.engine import resolve_execution_mode as jresolve
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core.approx import ApproxConfig, QWeight, prequantize_tree
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import ServeSession, resolve_execution_mode

ATOL = 1e-5
ARCH = "qwen2-moe-a2.7b"
FIELDS = ("ticks", "admitted", "completed", "generated_tokens", "admit_calls", "peak_active",
          "peak_blocks_in_use", "prefill_tokens", "work_ticks", "busy_slot_steps",
          "idle_slot_steps", "ttft_ticks", "latency_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch=ARCH, mode="exact", freeze=False):
    """The reduced ``arch`` in both packages with JAX's weights (frozen
    under a quantized ``mode`` when ``freeze``)."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), q_chunk=16, approx=jresolve(mode))
    tcfg = dataclasses.replace(reduced_config(get_config(arch)),
                               approx=resolve_execution_mode(mode))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    if freeze:
        jp = jprequantize(jp, jcfg.approx)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


_CONFIG_FIELDS = [f.name for f in dataclasses.fields(get_config(ARCH)) if f.name != "approx"]


@pytest.mark.parametrize("arch", list_archs())
def test_registered_configs_match_jax(arch):
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jreduced(jget_config(arch)), reduced_config(get_config(arch)))):
        for f in _CONFIG_FIELDS:
            assert getattr(t, f) == getattr(j, f), (arch, f)
        assert (t.padded_vocab, t.ssm_heads) == (j.padded_vocab, j.ssm_heads)
        assert t.approx.mode == j.approx.mode == "float"


def _moe_inputs(T_, d, E, ff, *, shared, skew=0.0, seed=0):
    p = jM.init_moe(jax.random.PRNGKey(seed), d, ff, E, shared_d_ff=shared)
    x = np.random.default_rng(seed).normal(size=(T_, d)).astype(np.float32)
    if skew:
        # every token leans on expert 0: its count passes the capacity
        x += 1.0
        p = p._replace(router=p.router.at[:, 0].add(skew))
    return p, x


def _jax_keep(p, x, top_k, capacity_factor=1.25):
    """JAX's dispatch: which stably sorted assignments its capacity keeps
    (``repro/models/moe.py``'s own operations)."""
    T_ = x.shape[0]
    E = p.router.shape[-1]
    cap = M.moe_capacity(T_, top_k, E, capacity_factor)
    probs = jax.nn.softmax(jnp.asarray(x) @ p.router, axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    flat_e = top_e.reshape(-1)
    se = flat_e[jnp.argsort(flat_e, stable=True)]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    return np.asarray(jnp.arange(T_ * top_k) - starts[se] < cap)


@pytest.mark.parametrize("mode", ["float", "lowrank"])
@pytest.mark.parametrize("case", ["shared", "capacity_binds", "no_shared"])
def test_moe_ffn_matches_jax(mode, case):
    # capacity is at least 8 rows: 8 tokens never overflow an expert
    T_, d, E, ff, k = {"shared": (8, 16, 4, 24, 2), "capacity_binds": (64, 16, 4, 24, 2),
                       "no_shared": (8, 16, 8, 24, 2)}[case]
    p, x = _moe_inputs(T_, d, E, ff, shared=0 if case == "no_shared" else 8,
                       skew=4.0 if case == "capacity_binds" else 0.0)
    jcfg, tcfg = JApprox(mode=mode), ApproxConfig(mode=mode)
    jout, jaux = jM.moe_ffn(jnp.asarray(x), p, top_k=k, cfg=jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    tout, taux = M.moe_ffn(torch.from_numpy(x), tp, top_k=k, cfg=tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-6, atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    cap = M.moe_capacity(T_, k, E, 1.25)
    r = M.route(torch.from_numpy(x), tp["router"], k, cap)
    keep = r.keep.numpy()
    assert keep.tolist() == _jax_keep(p, x, k).tolist()
    assert (not keep.all()) == (case == "capacity_binds")
    if case == "no_shared":
        assert tp["shared_gate"] is None and tp["shared_router"] is None


def test_moe_combine_is_deterministic():
    """The combine sums each token's contributions in one fixed order (by
    expert ascending), so a binding-capacity run repeats bit for bit."""
    p, x = _moe_inputs(64, 16, 4, 24, shared=8, skew=4.0)
    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    cfg = ApproxConfig(mode="lowrank")
    a, _ = M.moe_ffn(torch.from_numpy(x), tp, top_k=2, cfg=cfg)
    b, _ = M.moe_ffn(torch.from_numpy(x), tp, top_k=2, cfg=cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_forward_and_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jaux = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, taux = T.forward(tcfg, tp, torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    # return_kv gives the same logits and the fused-prefill seed
    with torch.no_grad():
        tl2, (k, v) = T.forward(tcfg, tp, torch.from_numpy(toks), return_kv=True)
    assert torch.equal(tl, tl2) and k.shape == (tcfg.num_layers, 2, 8, tcfg.num_kv_heads,
                                                tcfg.head_dim)
    jc = jT.init_cache(jcfg, 2, 8, jnp.float32)
    tc = T.init_cache(tcfg, 2, 8)
    jstep = jax.jit(jT.decode_step, static_argnums=0)
    for i in range(8):
        jlg, jc = jstep(jcfg, jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                        jnp.full((2,), i, jnp.int32))
        with torch.no_grad():
            tlg = T.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                torch.full((2,), i))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=1e-4)


@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_paged_decode_step_matches_jax(attn):
    jcfg, jp, tcfg, tp = _models(ARCH, "approx_lowrank", freeze=True)
    bs, W, B = 4, 4, 2
    rng = np.random.default_rng(2)
    jc = jT.init_paged_cache(jcfg, B * W, bs, jnp.float32)
    tc = T.init_paged_cache(tcfg, B * W, bs)
    tables = np.arange(B * W, dtype=np.int32).reshape(B, W)
    jstep = jax.jit(jT.paged_decode_step, static_argnums=0,
                    static_argnames=("block_size", "attn_impl"))
    for step in range(6):
        toks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        cur = np.full((B,), step, np.int32)
        jlg, jc = jstep(jcfg, jp, jc, {"tokens": jnp.asarray(toks)}, jnp.asarray(cur),
                        jnp.asarray(tables), block_size=bs,
                        attn_impl="pallas" if attn == "kernel" else "gather")
        with torch.no_grad():
            tlg = T.paged_decode_step(tcfg, tp, tc, torch.from_numpy(toks),
                                      torch.from_numpy(cur), torch.from_numpy(tables),
                                      block_size=bs, attn_impl=attn)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc["k"][:, :-1].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)


def test_freeze_calibrates_each_expert_as_jax():
    jcfg, jp, tcfg, tp = _models(ARCH, "approx_lowrank")
    jq = params_from_numpy(jax.tree.map(np.asarray, jprequantize(jp, jcfg.approx)))
    tq = prequantize_tree(tp, tcfg.approx)
    moe = tq["layers"]["moe"]
    for name in ("w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down"):
        w, want = moe[name], jq["layers"]["moe"][name]
        assert isinstance(w, QWeight)
        for a, b in zip(w, want):
            assert torch.equal(a, b), name
    assert moe["w_gate"].scale.shape == (tcfg.num_layers, tcfg.moe_experts, 1, tcfg.d_ff)
    assert not isinstance(moe["router"], QWeight) and not isinstance(moe["shared_router"],
                                                                     QWeight)
    per = T.init_params(tcfg, 0, device="cpu", freeze=True)
    whole = prequantize_tree(T.init_params(tcfg, 0, device="cpu"), tcfg.approx)
    for a, b in zip(per["layers"]["moe"]["w_up"], whole["layers"]["moe"]["w_up"]):
        assert torch.equal(a, b)


def _trace(seed=3, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(2, 9))), int(rng.integers(1, 7)),
             int(rng.integers(0, 4))) for _ in range(n)]


def _serve(sess, trace):
    for i, (p, n, a) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a, req_id=i)
    return sess.run(max_steps=1000)


@pytest.mark.parametrize("loop,layout,attn", [("sync", "paged", "kernel"),
                                              ("async", "paged", "gather"),
                                              ("async", "slots", "gather")])
def test_sessions_match_jax(loop, layout, attn):
    mode = "approx_lowrank" if layout == "paged" and loop == "sync" else "exact"
    jcfg, jp, tcfg, tp = _models(ARCH, mode, freeze=mode != "exact")
    kw = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8), cache_layout=layout, loop=loop)
    if layout == "paged":
        kw["block_size"] = 4
    trace = _trace()
    jsess = JServeSession(jcfg, jp, attn_impl="pallas" if attn == "kernel" else "gather", **kw)
    tsess = ServeSession(tcfg, tp, attn_impl=attn, device="cpu", **kw)
    jres, tres = _serve(jsess, trace), _serve(tsess, trace)
    assert sorted(jres) == sorted(tres) == list(range(len(trace)))
    for i in range(len(trace)):
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.admitted_tick, t.finished_tick, t.finish_reason, t.ttft) == \
            (j.admitted_tick, j.finished_tick, j.finish_reason, j.ttft), i
    for f in FIELDS:
        if layout == "slots" and f == "peak_blocks_in_use":
            continue
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f


_REFUSALS = {
    "spec_decode": dict(cache_layout="paged", block_size=4, spec_decode=True),
    "chunked_prefill": dict(cache_layout="paged", block_size=4, chunked_prefill=True),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_moe_refusals_match_jax(case):
    jcfg, jp, tcfg, tp = _models()
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(4, 8), **_REFUSALS[case])
    with pytest.raises(ValueError) as jerr:
        JServeSession(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        ServeSession(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_moe_paged_verify_refused_as_jax():
    jcfg, jp, tcfg, tp = _models()
    with pytest.raises(NotImplementedError) as jerr:
        jT.paged_verify_step(jcfg, jp, {}, {"tokens": jnp.zeros((1, 2), jnp.int32)},
                             jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1), jnp.int32),
                             block_size=4)
    for fn in (T.paged_verify_step, T.paged_chunk_prefill_step):
        with pytest.raises(NotImplementedError) as terr:
            fn(tcfg, tp, {}, torch.zeros((1, 2), dtype=torch.long), torch.zeros((1,)),
               torch.zeros((1, 1), dtype=torch.int32), block_size=4)
        assert str(terr.value) == str(jerr.value)


def test_launcher_serves_moe(capsys):
    """The moe recipe: the paged pool through K1 and K2 (their plain
    versions on the CPU)."""
    from repro_torch.launch.serve import main

    res = main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "4",
                "--new", "4"])
    out = capsys.readouterr().out
    assert len(res) == 4 and "KV pool:" in out and "attention impl kernel" in out
