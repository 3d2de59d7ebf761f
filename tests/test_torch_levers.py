"""Query chunking (``ModelConfig.q_chunk``), the fused projections
(``fuse_qkv``, ``fuse_gate_up``) and bfloat16 parameters (``param_dtype``)
against the JAX package, at ``reduced_config(granite-3-2b)`` width, on the
CPU.  Tolerances, each with its reason:

* ``attention_core`` in chunks is the unchunked call bit for bit (each
  chunk's rows are the same rows of the same products), and within 2e-6
  of JAX's chunked call (JAX repeats K/V to full heads before its
  einsums, the port groups them: float32 summation order);
* ``forward`` at ``q_chunk`` 64 over 128 tokens: in float
  ``tests/test_torch_model.py``'s atol 1e-4; through the approximate
  multiplier on frozen weights the code-flip rule (JAX's attention parts
  from the port's by float32 roundoff, which now and then flips a
  per-tensor activation code, and a flipped code moves its row's logits):
  99% of the logits within 1e-4, every one within 2**-4 of the largest;
* a fused product is the separate products bit for bit wherever weight
  scales are per output channel (float, ``lowrank``, ``exact_quant`` on
  float weights; every frozen path); a fused forward agrees with JAX's
  fused forward at atol 1e-4 in float; in the quantized modes on float
  weights JAX's fused forward is its unfused one to 1e-4 and the port's
  parts from it as from the unfused one (the straight-through value
  ``y_lin + (y_int - y_lin)`` keeps ``y_lin``'s float32 summation order,
  ROADMAP.md section 3); with per-tensor weight scales the fused product
  calibrates over the concatenation, as JAX's does;
* a training step: ``tests/test_torch_train.py``'s tolerances, and with
  bfloat16 parameters one more allowance: a new parameter rounds to
  bfloat16 once, so a weight whose update agrees to float32 roundoff may
  land one bf16 ulp of the weight away;
* the data-parallel step (2 ranks over gloo, fused, bf16 parameters)
  against JAX's no-mesh step on the global batch: ``tests/test_torch_dp.py``'s
  quantized tolerances, with the bf16 allowance above.

One world of 2 ranks (``launch.mesh.run_ranks``, a ``FileStore`` under a
temporary directory) runs a tensor-parallel session with both fusions
against the same session at tp=1, and the data-parallel step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import approx as japprox
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serve.engine import freeze_params as jfreeze
from repro.serve.engine import resolve_execution_mode as jresolve
from repro.train import loop as jloop
from repro.train import optim as JO
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import approx
from repro_torch.launch.dryrun import (collectives_per_pass, collectives_per_train_step,
                                       k1_per_pass, k1_per_train_step)
from repro_torch.launch.mesh import TPMesh, run_ranks
from repro_torch.models import transformer as T
from repro_torch.models.attention import attention_core
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import COUNTS
from repro_torch.serve import ServeSession, freeze_params, resolve_execution_mode
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves

ARCH = "granite-3-2b"
ATOL = 1e-4
FUSED = dict(fuse_qkv=True, fuse_gate_up=True)
ADAMW = dict(lr=1e-3, warmup_steps=0, total_steps=10)
_WORLD_TIMEOUT = 150


def _jcfg(**over):
    return dataclasses.replace(jreduced(jget_config(ARCH)), **over)


def _tcfg(**over):
    return dataclasses.replace(reduced_config(get_config(ARCH)), **over)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# attention_core in query chunks
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Hkv, q_chunk, q_offset, causal, kv_len)
CHUNK_CASES = {
    "chunks-32-g2": (2, 128, 128, 4, 2, 32, 0, True, None),
    "chunks-16-g2": (2, 128, 128, 4, 2, 16, 0, True, None),
    "chunks-8-g1": (2, 64, 64, 4, 4, 8, 0, True, None),
    "not-a-multiple": (2, 40, 40, 4, 2, 16, 0, True, None),
    "within-one-chunk": (2, 16, 16, 4, 2, 16, 0, True, None),
    "q-offset": (1, 32, 96, 4, 2, 8, 64, True, None),
    "kv-len": (2, 64, 64, 4, 2, 16, 0, False, (40, 64)),
}


@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_attention_core_chunks_are_the_whole_call_and_jax(name):
    B, Sq, Sk, H, Hkv, qc, off, causal, kv_len = CHUNK_CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(B, Sq, H, 32)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, 32)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, 32)).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkl = None if kl is None else torch.from_numpy(kl)
    kw = dict(causal=causal, q_offset=off)
    chunked = attention_core(tq, tk, tv, kv_len=tkl, q_chunk=qc, **kw)
    whole = attention_core(tq, tk, tv, kv_len=tkl, q_chunk=1 << 20, **kw)
    assert torch.equal(chunked, whole)
    want = jA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_len=None if kl is None else jnp.asarray(kl), q_chunk=qc, **kw)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def _pair(mode, per_row=False, **over):
    """(jcfg, jax frozen params, tcfg, port params) at ``reduced_config``
    with ``over`` on both configs."""
    jcfg = _jcfg(approx=jresolve(mode, act_per_row=per_row), **over)
    tcfg = _tcfg(approx=resolve_execution_mode(mode, act_per_row=per_row), **over)
    jp = jfreeze(jcfg, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _code_flip_close(got, want, vocab, *, exact):
    """Logits within ATOL; in a quantized mode the code-flip rule: a
    float32 roundoff apart flips an activation code now and then, and a
    flipped code moves its row's logits, so 99% within ATOL and every one
    within 2**-4 of the largest."""
    got, want = got[..., :vocab], want[..., :vocab]
    if exact:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    d = np.abs(got - want)
    assert (d <= ATOL).mean() >= 0.99 and d.max() <= 2.0 ** -4 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["exact", "approx_lowrank"])
def test_forward_at_q_chunk_64_over_128_tokens_matches_jax(mode):
    # one layer through the multiplier: JAX's lowrank reference is slow here
    jcfg, jp, tcfg, tp = _pair(mode, **({} if mode == "exact" else {"num_layers": 1}))
    assert tcfg.q_chunk == jcfg.q_chunk == 64
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 128)).astype(np.int32)
    jl, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl = T.forward(tcfg, tp, torch.from_numpy(toks))
    _code_flip_close(tl.numpy(), np.asarray(jl), tcfg.vocab_size, exact=mode == "exact")
    # the same logits as one unchunked call
    assert torch.equal(tl, T.forward(dataclasses.replace(tcfg, q_chunk=1 << 20), tp,
                                     torch.from_numpy(toks)))


# ---------------------------------------------------------------------------
# the fused projections
# ---------------------------------------------------------------------------


def _float_pair(mode, per_channel=True, **over):
    """Float (unfrozen) weights of the JAX init, run in ``mode``."""
    ja = japprox.ApproxConfig(multiplier="mul8x8_2", mode=mode, w_per_channel=per_channel)
    ta = approx.ApproxConfig(multiplier="mul8x8_2", mode=mode, w_per_channel=per_channel)
    jcfg, tcfg = _jcfg(approx=ja, **over), _tcfg(approx=ta, **over)
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("mode", ["float", "lowrank", "exact_quant"])
def test_fused_forward_is_unfused_and_matches_jax_fused(mode):
    jcfg, jp, tcfg, tp = _float_pair(mode, **FUSED)
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    fused = T.forward(tcfg, tp, torch.from_numpy(toks))
    plain = T.forward(dataclasses.replace(tcfg, fuse_qkv=False, fuse_gate_up=False), tp,
                      torch.from_numpy(toks))
    assert torch.equal(fused, plain)
    jl, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(jl)[..., :tcfg.vocab_size]
    fused = fused.numpy()[..., :tcfg.vocab_size]
    if mode == "float":
        np.testing.assert_allclose(fused, jl, rtol=0, atol=ATOL)
        return
    # on float weights the straight-through value keeps y_lin's float32
    # summation order, and JAX's lowrank sums past 2**24 inexactly (ROADMAP.md
    # section 3): the fused step parts from JAX's as the unfused one does
    jplain, _ = jT.forward(dataclasses.replace(jcfg, fuse_qkv=False, fuse_gate_up=False), jp,
                           {"tokens": jnp.asarray(toks)})
    jplain = np.asarray(jplain)[..., :tcfg.vocab_size]
    np.testing.assert_allclose(jl, jplain, rtol=0, atol=ATOL)


def test_fused_per_tensor_weights_calibrate_over_the_concatenation_as_jax():
    jcfg, jp, tcfg, tp = _float_pair("exact_quant", per_channel=False, **FUSED)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl = T.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_freeze_params_builds_the_fused_leaves_once():
    cfg = _tcfg(approx=resolve_execution_mode("approx"), **FUSED)
    frozen = T.init_params(cfg, 0, device="cpu", freeze=True)
    assert sorted(frozen["layers"]["attn"]) == ["wo", "wqkv"]
    assert sorted(frozen["layers"]["ffn"]) == ["w_down", "w_gate_up"]
    again = freeze_params(cfg, T.init_params(cfg, 0, device="cpu"))
    for a, b in zip(leaves(frozen), leaves(again)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
            else torch.equal(a, b)
    assert T.fuse_params(cfg, frozen) == frozen           # fused already: passes through
    with pytest.raises(approx.ConcatError):
        approx.concat_weights([frozen["layers"]["attn"]["wo"], torch.zeros(2, 2)])


def _frozen_pairs(mode="approx", per_row=False):
    cfg = _tcfg(approx=resolve_execution_mode(mode, act_per_row=per_row))
    fcfg = dataclasses.replace(cfg, **FUSED)
    return (cfg, T.init_params(cfg, 0, device="cpu", freeze=True),
            fcfg, T.init_params(fcfg, 0, device="cpu", freeze=True))


def test_fused_frozen_decode_paged_decode_and_verify_are_unfused_bit_for_bit():
    cfg, p, fcfg, fp = _frozen_pairs()
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    outs = []
    for c, params in ((cfg, p), (fcfg, fp)):
        logits, kvs = T.forward(c, params, toks, return_kv=True)
        slot = T.init_cache(c, 2, 32)
        T.seed_cache(c, slot, kvs)
        cur = torch.tensor([12, 12])
        nxt = torch.tensor([[5], [7]])
        dec = T.decode_step(c, params, slot, nxt, cur)
        pool = T.init_paged_cache(c, 8, 8)
        tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
        from repro_torch.serve.cache import scatter_prompt_blocks

        scatter_prompt_blocks(pool, kvs, tables[:, :2], 8)
        paged = T.paged_decode_step(c, params, pool, nxt, cur, tables, block_size=8,
                                    attn_impl="kernel")
        ver = T.paged_verify_step(c, params, pool, torch.tensor([[1, 2, 3], [4, 5, 6]]),
                                  cur + 1, tables, block_size=8)
        outs.append([logits, kvs[0], kvs[1], dec, slot["k"], paged, ver, pool["k"],
                     pool["v"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_fused_sessions_serve_the_unfused_tokens_and_k1_counts():
    """A paged session on frozen weights with both fusions: the unfused
    session's tokens, and K1's calls ``k1_per_pass`` (fused) per pass,
    where the separate leaves' session makes ``7n + 1``."""
    cfg, p, fcfg, fp = _frozen_pairs("approx", per_row=True)
    cfg = dataclasses.replace(cfg, approx=dataclasses.replace(cfg.approx, mode="kernel"))
    fcfg = dataclasses.replace(fcfg, approx=cfg.approx)
    rng = np.random.default_rng(5)
    trace = [(rng.integers(0, 512, int(rng.integers(2, 9))), int(rng.integers(1, 7)))
             for _ in range(5)]
    got = {}
    for name, c, params in (("plain", cfg, p), ("fused", fcfg, fp),
                            ("fused-in-session", fcfg, p)):
        calls = _K1Calls()
        try:
            sess = ServeSession(c, params, num_slots=3, max_len=32, prompt_buckets=(4, 8),
                                block_size=4, device="cpu")
            for i, (pr, n) in enumerate(trace):
                sess.submit(pr, max_new=n, req_id=i)
            res = sess.run()
        finally:
            calls.close()
        passes = sess.stats.ticks + sess.stats.admit_calls
        assert calls.n == k1_per_pass(c) * passes, name
        got[name] = {i: r.tokens.tolist() for i, r in res.items()}
    assert k1_per_pass(fcfg) == 4 * fcfg.num_layers + 1 < k1_per_pass(cfg) == 7 * cfg.num_layers + 1
    assert got["fused"] == got["plain"] == got["fused-in-session"]


class _K1Calls:
    """K1's calls through ``quantized_matmul`` while installed."""

    def __init__(self):
        self.n, self._k1 = 0, approx.approx_matmul

        def k1(*a, **kw):
            self.n += 1
            return self._k1(*a, **kw)

        approx.approx_matmul = k1

    def close(self):
        approx.approx_matmul = self._k1


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b", "zamba2-2.7b"])
def test_k1_per_pass_and_per_train_step_count_the_fusion(arch):
    kernel = approx.ApproxConfig(multiplier="mul8x8_2", mode="kernel")
    cfg = dataclasses.replace(reduced_config(get_config(arch)), approx=kernel, remat=True,
                              **FUSED)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 64, (2, 8)).astype(np.int32))
    calls = _K1Calls()
    try:
        with torch.no_grad():
            T.forward(cfg, T.init_params(cfg, 0, device="cpu", freeze=True), toks)
        n_pass = calls.n
        state = loop.init_state(cfg, O.OptConfig(), 0, device="cpu")
        calls.n = 0
        loop.make_train_step(cfg, O.OptConfig())(state, {"tokens": toks, "labels": toks})
        n_step = calls.n
    finally:
        calls.close()
    assert n_pass == k1_per_pass(cfg)
    assert n_step == k1_per_train_step(cfg)


# ---------------------------------------------------------------------------
# training: fused and bfloat16 parameters
# ---------------------------------------------------------------------------


def _check_state(got, want, lr, tol):
    """Moments to ``tol`` of each leaf's largest; parameters within 2.1 lr,
    a weight whose moment is certain within 1e-3 lr plus one bf16 ulp of
    the weight when the parameters are bf16."""
    for key in ("m", "v"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    for a, b, m, bf16 in zip(got["params"], want["params"], want["m"], got["bf16"]):
        d = np.abs(a - b) - (2.0 ** -8 * np.abs(b) if bf16 else 0.0)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()
        assert sure.any() and d[sure].max() <= 1e-3 * lr


def _jax_step(jcfg, init, toks, labels):
    jst, jm = jax.jit(jloop.make_train_step(jcfg, JO.OptConfig(**ADAMW)))(
        jax.tree.map(jnp.asarray, init), {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    return {"params": [np.asarray(x, np.float32) for x in jax.tree.leaves(jst["params"])],
            **{k: [np.asarray(x) for x in jax.tree.leaves(jst["opt"][k])] for k in ("m", "v")},
            "metrics": {k: float(v) for k, v in jm.items()}}


def _state_np(state):
    return {"params": [_np(t) for t in leaves(state["params"])],
            "bf16": [t.dtype == torch.bfloat16 for t in leaves(state["params"])],
            **{k: [_np(t) for t in leaves(state["opt"][k])] for k in ("m", "v")}}


STEP_CASES = {"fused-lowrank": ("lowrank", FUSED, "float32"),
              "bf16-fused-lowrank": ("lowrank", FUSED, "bfloat16")}


def _train_cfgs(mode, over, pd):
    ja = japprox.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=1e-4)
    ta = approx.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=1e-4)
    return (_jcfg(approx=ja, param_dtype=pd, **over),
            _tcfg(approx=ta, param_dtype=pd, **over))


def _jax_case(name):
    """(tcfg, the JAX initial state, the batch, JAX's step) of a step case."""
    mode, over, pd = STEP_CASES[name]
    jcfg, tcfg = _train_cfgs(mode, over, pd)
    init = jax.tree.map(np.asarray, jloop.init_state(jcfg, JO.OptConfig(**ADAMW),
                                                     jax.random.PRNGKey(0)))
    batch = _batch(tcfg)
    return tcfg, init, batch, _jax_step(jcfg, init, *batch)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_jax(name, world):
    mode, _, pd = STEP_CASES[name]
    tcfg, init, (toks, labels), want = world[3] if name == DP_CASE else _jax_case(name)
    state = state_from_numpy(init)
    assert {t.dtype for t in leaves(state["params"])} == {getattr(torch, pd)}
    state, m = loop.make_train_step(tcfg, O.OptConfig(**ADAMW))(
        state, loop.as_batch((toks, labels), "cpu"))
    assert {t.dtype for t in leaves(state["opt"]["m"])} == {torch.float32}
    assert m["loss"].item() == pytest.approx(want["metrics"]["loss"], rel=1e-5)
    for k in ("ce", "band_reg", "grad_norm", "lr"):
        assert m[k].item() == pytest.approx(want["metrics"][k], rel=1e-4, abs=1e-9), k
    tol = 2 ** -7 if mode != "float" or pd != "float32" else 1e-3
    _check_state(_state_np(state), want, want["metrics"]["lr"], tol)


def _batch(cfg):
    from repro_torch.data.synthetic import token_batches

    return next(token_batches(cfg.vocab_size, 4, 16, seed=0))


def test_bf16_leaves_cross_the_bridge_and_the_checkpoint_bit_exact(tmp_path):
    jcfg, tcfg = _train_cfgs("lowrank", {}, "bfloat16")
    init = jax.tree.map(np.asarray, jloop.init_state(jcfg, JO.OptConfig(),
                                                     jax.random.PRNGKey(0)))
    state = state_from_numpy(init)
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(init["params"])):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(a.detach().view(torch.int16).numpy(), b.view(np.int16))
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), 3, state)
    assert path is not None
    target = loop.init_state(tcfg, O.OptConfig(), 1, device="cpu")
    back, step = ckpt.restore_checkpoint(str(tmp_path / "ck"), target)
    assert step == 3
    for a, b in zip(leaves(back), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a.detach().view(-1).view(torch.uint8),
                                                  b.detach().reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# meshes: tp=2 fused serving and a dp=2 fused bf16 step, one world
# ---------------------------------------------------------------------------


class _DataView:
    """The world's group read as a data mesh."""

    axis_names = ("data",)
    device = torch.device("cpu")

    def __init__(self, mesh):
        self.group, self.rank, self.size = mesh.group, mesh.rank, mesh.size
        self.shape = {"data": mesh.size}


def _serve(cfg, params, mesh, trace):
    """(tokens, ticks, collectives, passes) of a session on ``trace``."""
    sess = ServeSession(cfg, params, num_slots=3, max_len=32, prompt_buckets=(4, 8),
                        block_size=4, device="cpu", mesh=mesh)
    for i, (p, n) in enumerate(trace):
        sess.submit(p, max_new=n, req_id=i)
    calls = COUNTS["calls"]
    res = sess.run()
    st = sess.stats
    return ({i: r.tokens.tolist() for i, r in res.items()}, st.ticks, COUNTS["calls"] - calls,
            st.ticks + st.admit_calls)


def _rank_job(rank, world, store_path, payload):
    torch.set_num_threads(1)
    mesh = TPMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                  backend="gloo", device="cpu")
    try:
        cfg = _tcfg(approx=resolve_execution_mode("approx"), **FUSED)
        unfused = T.init_params(dataclasses.replace(cfg, fuse_qkv=False, fuse_gate_up=False),
                                0, device="cpu", freeze=True)
        fused = T.init_params(cfg, 0, device="cpu", freeze=True)
        trace = payload["trace"]
        rep = {"tp1": _serve(cfg, fused, None, trace),
               "tp2_cut_fused": _serve(cfg, fused, mesh, trace),
               "tp2_fused_after_cut": _serve(cfg, unfused, mesh, trace)}
        # the data-parallel step on the world's group
        dcfg = payload["dcfg"]
        data = _DataView(mesh)
        state = fsdp.shard_state(state_from_numpy(payload["init"]), dcfg, data)
        calls = COUNTS["calls"]
        state, m = loop.make_train_step(dcfg, O.OptConfig(**ADAMW), mesh=data)(
            state, loop.as_batch(payload["batch"], "cpu"))
        rep["dp_collectives"] = COUNTS["calls"] - calls
        rep["dp_metrics"] = {k: v.item() for k, v in m.items()}
        whole = fsdp.whole_state(state, dcfg, data, device="cpu")
        rep["dp_state"] = _state_np({"params": whole["params"], "opt": whole["opt"]})
        return rep
    finally:
        mesh.close()


DP_CASE = "bf16-fused-lowrank"            # the data-parallel step's case


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's report, JAX's step of DP_CASE, its config, the case):
    the world runs in a thread while this process steps JAX."""
    import threading

    rng = np.random.default_rng(7)
    trace = [(rng.integers(0, 512, int(rng.integers(2, 9))), int(rng.integers(1, 7)))
             for _ in range(5)]
    mode, over, pd = STEP_CASES[DP_CASE]
    jcfg, tcfg = _train_cfgs(mode, over, pd)
    init = jax.tree.map(np.asarray, jloop.init_state(jcfg, JO.OptConfig(**ADAMW),
                                                     jax.random.PRNGKey(0)))
    batch = _batch(tcfg)
    payload = {"trace": trace, "dcfg": tcfg, "init": init, "batch": batch}
    store = tmp_path_factory.mktemp("levers") / "store"
    ranks, errors = [], []

    def spawn():
        try:
            ranks.extend(run_ranks(_rank_job, 2, (str(store), payload), timeout=_WORLD_TIMEOUT))
        except BaseException as e:      # re-raised in the test process below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        want = _jax_step(jcfg, init, *batch)
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return ranks, want, tcfg, (tcfg, init, batch, want)


def test_tp2_fused_sessions_serve_the_tp1_tokens(world):
    """Both fused trees at tp=2 (fused whole then cut piece by piece, and
    cut then fused per rank) serve tp=1's tokens and ticks, with
    ``collectives_per_pass`` per pass: fusion adds no collective."""
    cfg = _tcfg(approx=resolve_execution_mode("approx"), **FUSED)
    for rep in world[0]:
        tp1 = rep["tp1"]
        for name in ("tp2_cut_fused", "tp2_fused_after_cut"):
            toks, ticks, calls, passes = rep[name]
            assert (toks, ticks) == tp1[:2], name
            assert calls == collectives_per_pass(cfg, 2) * passes, name


def test_dp2_fused_bf16_step_matches_jax_global_step(world):
    ranks, want, tcfg, _ = world
    for rep in ranks:
        got = rep["dp_metrics"]
        assert got["loss"] == pytest.approx(want["metrics"]["loss"], rel=1e-5)
        for k in ("ce", "band_reg", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want["metrics"][k], rel=1e-4, abs=1e-9), k
        assert rep["dp_collectives"] == collectives_per_train_step(tcfg, 2)
    _check_state(ranks[0]["dp_state"], want, want["metrics"]["lr"], 2.0 ** -6)
