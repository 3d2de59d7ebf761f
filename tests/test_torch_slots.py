"""The port's slot layout against the JAX package's: the cache-row ops, and
``ServeSession(cache_layout="slots")`` against the JAX session on the same
layout and loop.

Greedy tokens, admission and finish ticks and TTFT must be identical on
seeded traces (``_assert_same_results``), in every policy, with eos, with
``zero_on_evict`` and under both activation-scale settings: with per-tensor
scales a freed slot's stale carry flows into every row's quantization, so
the port must carry exactly what the JAX session carries.  Within the
port, slots must equal paged, and each request must equal ``generate`` of
its prompt alone.  The cache-row ops are exact copies: equal bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as jC
from repro.serve.engine import SamplingConfig as JSampling
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.serve import (
    SamplingConfig,
    ServeSession,
    evict_slot,
    generate,
    insert_prefill_kv,
    insert_slot,
    scatter_rows,
    slot_view,
)
from test_torch_serve import KW, _assert_same_results, _models, _run, _trace

SKW = {k: v for k, v in KW.items() if k != "block_size"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's thread pool spinning on cores that other workers hold slows
    the CPU-bound steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mode, per_row=False, eos=-1, **kw):
    jcfg, jp, tcfg, tp = _models(mode, per_row)
    kw = {**SKW, **kw}
    jsess = JServeSession(jcfg, jp, cache_layout="slots", loop="sync",
                          sampling=JSampling(eos_id=eos), **kw)
    tsess = ServeSession(tcfg, tp, cache_layout="slots", loop="sync",
                         sampling=SamplingConfig(eos_id=eos), device="cpu", **kw)
    return jsess, tsess


STAT_FIELDS = ("ticks", "admitted", "completed", "generated_tokens", "admit_calls",
               "peak_active", "prefill_tokens", "busy_slot_steps", "idle_slot_steps",
               "work_ticks")


def _same_stats(jsess, tsess):
    for f in STAT_FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.prefills == jsess.stats.prefills


def test_slot_session_matches_jax_approx():
    """K1's plain version (``approx``) against the JAX session's Pallas
    kernel in interpret mode, per-tensor activation scales."""
    jsess, tsess = _pair("approx", policy="fifo")
    trace = _trace(3)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    _same_stats(jsess, tsess)
    assert tsess.stats.attn_impl == "gather"


@pytest.mark.parametrize("per_row", [False, True], ids=["per_tensor", "per_row"])
@pytest.mark.parametrize("policy", ["priority", "fifo", "sjf"])
def test_slot_session_matches_jax_every_policy(policy, per_row):
    jsess, tsess = _pair("approx_lowrank", per_row, policy=policy)
    trace = _trace(11, n=7)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    _same_stats(jsess, tsess)


def test_slot_session_eos_matches_jax():
    _, tfree = _pair("exact", policy="fifo")
    trace = _trace(5, n=7)
    free_run = _run(tfree, trace)
    eos = int(next(r.tokens[1] for r in free_run.values() if len(r.tokens) > 2))
    jsess, tsess = _pair("exact", policy="fifo", eos=eos)
    tres = _run(tsess, trace)
    _assert_same_results(_run(jsess, trace), tres, trace)
    assert any(r.finish_reason == "eos" for r in tres.values())
    _same_stats(jsess, tsess)


@pytest.mark.parametrize("per_row", [False, True], ids=["per_tensor", "per_row"])
def test_zero_on_evict_matches_jax(per_row):
    """Zeroed stripes change what a freed slot decodes afterwards, which
    per-tensor scales carry into every row: tokens still equal the JAX
    session's, and every free stripe ends at zero."""
    jsess, tsess = _pair("approx_lowrank", per_row, policy="fifo", zero_on_evict=True)
    trace = _trace(7, n=7)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    _same_stats(jsess, tsess)
    max_len = SKW["max_len"]
    for name in ("k", "v"):
        np.testing.assert_allclose(tsess.cache[name][:, :, :max_len].numpy(),
                                   np.asarray(jsess.cache[name]), rtol=1e-5, atol=1e-5)
    for slot in range(tsess.num_slots):
        # a freed row still writes at its stale cur_len each tick after the
        # eviction; every other position of its stripe is zero
        stripe = tsess.cache["k"][:, slot].clone()
        stripe[:, int(tsess._cur_len[slot])] = 0
        assert not stripe.any(), slot


def test_slot_freed_at_max_len_minus_one_keeps_ticking():
    """A request filling its stripe exactly (prompt + max_new == max_len)
    leaves its slot at cur_len == max_len - 1; the freed row keeps decoding
    there while the other rows run on, under per-tensor scales, and every
    token, tick and the freed row's final cache row equal the JAX
    session's."""
    max_len = 16
    trace = [(np.arange(1, 9), 8, 0, 0),          # 8 + 8 == max_len
             (np.arange(20, 23), 13, 0, 0),
             (np.arange(40, 44), 3, 10, 0)]       # reuses slot 0 later
    jsess, tsess = _pair("approx_lowrank", policy="fifo", max_len=max_len, num_slots=2)
    for sess in (jsess, tsess):
        for i, (p, n, arrival, prio) in enumerate(trace):
            sess.submit(p, max_new=n, arrival=arrival, priority=prio, req_id=i)
    carry = []
    while not tsess.drained:
        tsess.step()
        jsess.step()
        carry.append((int(tsess._cur_len[0]), int(tsess._last_token[0])))
        assert carry[-1] == (int(jsess._cur_len[0]), int(jsess._last_token[0]))
        if tsess.clock == 9:
            np.testing.assert_allclose(tsess.cache["k"][:, :, :max_len].numpy(),
                                       np.asarray(jsess.cache["k"]), rtol=1e-5, atol=1e-5)
    assert jsess.drained
    _assert_same_results(jsess.results, tsess.results, trace)
    # slot 0 sat freed at cur_len == max_len - 1 for ticks 8..10
    assert sum(c == max_len - 1 for c, _ in carry) >= 2


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_slots_equal_paged_within_the_port(mode):
    """Float, or quantized with per-row activation scales: a freed row
    computes something else on each layout (its stale stripe against an
    all-sentinel table), which per-tensor scales would carry into the live
    rows' codes, as in the JAX package."""
    _, _, tcfg, tp = _models(mode, per_row=True)
    trace = _trace(13, n=7)
    slots = _run(ServeSession(tcfg, tp, cache_layout="slots", policy="sjf", device="cpu",
                              **SKW), trace)
    paged = _run(ServeSession(tcfg, tp, cache_layout="paged", policy="sjf", device="cpu",
                              **KW), trace)
    _assert_same_results(paged, slots, trace)


@pytest.mark.parametrize("mode", ["exact", "approx_lowrank"])
def test_each_request_equals_generate_alone(mode):
    """The JAX package's order-independence oracle: per-row activation
    scales (quantized modes) make a request's tokens independent of its
    batch mates, slot and arrival."""
    _, _, tcfg, tp = _models(mode, per_row=True)
    trace = _trace(17, n=7)
    res = _run(ServeSession(tcfg, tp, cache_layout="slots", device="cpu", **SKW), trace)
    for i, (p, n, _, _) in enumerate(trace):
        alone = generate(tcfg, tp, p[None, :].astype(np.int32), max_new=n, device="cpu")
        assert alone[0, len(p):].tolist() == res[i].tokens.tolist(), i


def test_slot_session_arguments():
    _, _, tcfg, tp = _models("exact")
    assert ServeSession(tcfg, tp, device="cpu", **KW).attn_impl == "kernel"
    sess = ServeSession(tcfg, tp, cache_layout="slots", device="cpu", **SKW)
    assert sess.attn_impl == "gather"
    # max_len + the trash position
    assert sess.cache["k"].shape == (tcfg.num_layers, 3, 33, tcfg.num_kv_heads, tcfg.head_dim)
    with pytest.raises(ValueError, match="requires cache_layout='paged'"):
        ServeSession(tcfg, tp, cache_layout="slots", attn_impl="kernel", device="cpu", **SKW)
    with pytest.raises(ValueError, match="slot layout only"):
        ServeSession(tcfg, tp, zero_on_evict=True, device="cpu", **KW)
    with pytest.raises(ValueError, match="cache_layout"):
        ServeSession(tcfg, tp, cache_layout="ring", device="cpu", **KW)
    # no block_size constraint on stripes
    ServeSession(tcfg, tp, cache_layout="slots", device="cpu", **dict(SKW, max_len=30))
    with pytest.raises(ValueError, match="exceeds cache max_len"):
        sess.submit(np.arange(6), max_new=30)


# ---------------------------------------------------------------------------
# cache-row ops against the JAX package's, on the same numpy inputs
# ---------------------------------------------------------------------------


def _tree(rng, B=4, S=6):
    return {n: rng.normal(size=(2, B, S, 2, 3)).astype(np.float32) for n in ("k", "v")}


def _j(tree):
    return {n: jnp.asarray(a) for n, a in tree.items()}


def _t(tree):
    return {n: torch.from_numpy(a.copy()) for n, a in tree.items()}


def _equal(tc, jc):
    for n in jc:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


@pytest.mark.parametrize("slot", [0, 2, 3])
def test_insert_view_evict_match_jax(slot):
    rng = np.random.default_rng(slot)
    full, one = _tree(rng), _tree(rng, B=1)
    jc = jC.insert_slot(_j(full), _j(one), jnp.int32(slot))
    tc = _t(full)
    insert_slot(tc, _t(one), slot)
    _equal(tc, jc)
    _equal(slot_view(tc, slot), jC.slot_view(jc, jnp.int32(slot)))
    jc = jC.evict_slot(jc, jnp.int32(slot))
    evict_slot(tc, slot)
    _equal(tc, jc)
    assert not tc["k"][:, slot].any()


@pytest.mark.parametrize("s_cap", [None, 4])
def test_scatter_rows_matches_jax(s_cap):
    """Rows with ``valid == False`` rewrite what they gathered: the
    padding rows of an admission change nothing."""
    rng = np.random.default_rng(1)
    full = rng.normal(size=(2, 4, 6, 2, 3)).astype(np.float32)
    part = rng.normal(size=(2, 3, s_cap or 6, 2, 3)).astype(np.float32)
    slots = np.asarray([2, 0, 3], np.int32)
    valid = np.asarray([True, False, True])
    want = jC.scatter_rows(jnp.asarray(full), jnp.asarray(part), jnp.asarray(slots),
                           jnp.asarray(valid), s_cap=s_cap)
    got = torch.from_numpy(full.copy())
    scatter_rows(got, torch.from_numpy(part), torch.from_numpy(slots),
                 torch.from_numpy(valid), s_cap=s_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, 0].numpy(), full[:, 0])     # the no-op row


def test_insert_prefill_kv_matches_jax():
    rng = np.random.default_rng(2)
    full = _tree(rng)
    k, v = (rng.normal(size=(2, 1, 4, 2, 3)).astype(np.float32) for _ in range(2))
    jc = jC.insert_prefill_kv(_j(full), (jnp.asarray(k), jnp.asarray(v)), jnp.int32(1))
    tc = _t(full)
    insert_prefill_kv(tc, (torch.from_numpy(k), torch.from_numpy(v)), 1)
    _equal(tc, jc)
    jax.block_until_ready(jc["k"])
