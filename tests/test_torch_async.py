"""The port's async serve loop, ``steps_per_tick`` and prefill/decode
interleaving against the JAX package's, and the loop's own contracts.

On seeded traces the port's ``ServeSession(loop="async")`` must equal the
JAX session with ``loop="async"``: every request's tokens, finish reason,
admission and finish ticks and TTFT, and the scheduler's ticks, busy and
idle slot-steps, decode-gap gauge and prefill stalls — on both layouts,
with ``steps_per_tick`` 1 and 3, in float and quantized modes (per-tensor
scales carry the stale rows of the device carry into every row's codes,
so the carry must be the JAX session's), and under a prefill-decode ratio
and a flat prefill-token budget.  Within the port the async loop must give
the sync loop's tokens and ticks, finish immediate completions (max_new
1, eos as the first token) exactly once, flush on ``close()`` and then
refuse work.  ``merge_admit_carry`` is held against the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as jC
from repro.serve.engine import SamplingConfig as JSampling
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.serve import (
    SERVE_LOOPS,
    SamplingConfig,
    SchedulerStats,
    ServeSession,
    merge_admit_carry,
)
from test_torch_serve import KW, _assert_same_results, _models, _run, _trace

SKW = {k: v for k, v in KW.items() if k != "block_size"}
BURST_KW = dict(num_slots=4, max_len=64, prompt_buckets=(4, 8, 16))

STAT_FIELDS = ("ticks", "busy_slot_steps", "idle_slot_steps", "max_decode_gap_ticks",
               "prefill_stall_ticks", "admitted", "completed", "generated_tokens",
               "admit_calls", "peak_active", "prefill_tokens", "work_ticks", "ttft_ticks",
               "latency_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burst_trace(seed, vocab=512):
    """Two resident decode-heavy requests, then a clump of long prompts:
    the pattern the interleaving policy exists for (the JAX package's
    ``test_async_serve`` burst)."""
    rng = np.random.default_rng(seed)
    tr = [(rng.integers(0, vocab, 3), 24, 0, 0), (rng.integers(0, vocab, 4), 24, 0, 0)]
    return tr + [(rng.integers(0, vocab, 15), 2, 2, 0) for _ in range(6)]


def _same_stats(jsess, tsess):
    for f in STAT_FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.prefills == jsess.stats.prefills
    if tsess.layout == "paged":
        assert tsess.stats.peak_blocks_in_use == jsess.stats.peak_blocks_in_use
    st = tsess.stats
    assert st.busy_slot_steps + st.idle_slot_steps == st.ticks * tsess.num_slots


def _sessions(mode, per_row, layout, *, jax_attn="gather", eos=-1, **kw):
    """The JAX and the port's async session on one config.  A paged
    session under per-tensor scales needs JAX's Pallas attention: a freed
    row's all-sentinel table attends to zeros there and in the port, where
    the JAX gather attends its clamped stand-in block, and per-tensor
    scales carry that row into every row's codes."""
    jcfg, jp, tcfg, tp = _models(mode, per_row)
    kw = {**(KW if layout == "paged" else SKW), **kw}
    jsess = JServeSession(jcfg, jp, cache_layout=layout, loop="async", attn_impl=jax_attn,
                          sampling=JSampling(eos_id=eos), **kw)
    tsess = ServeSession(tcfg, tp, cache_layout=layout, sampling=SamplingConfig(eos_id=eos),
                         device="cpu", **kw)
    assert tsess.loop == "async"                   # the default, as in the JAX package
    return jsess, tsess


CASES = [
    # layout, steps_per_tick, mode, per_row, JAX attention
    ("paged", 1, "approx", False, "pallas"),      # K1 and K2 routes vs the Pallas kernels
    ("slots", 1, "approx_lowrank", False, "gather"),
    ("paged", 3, "approx_lowrank", True, "gather"),
    ("slots", 3, "exact", False, "gather"),
]


@pytest.mark.parametrize("layout,steps,mode,per_row,jattn", CASES,
                         ids=[f"{c[0]}-x{c[1]}-{c[2]}-{'per_row' if c[3] else 'per_tensor'}"
                              for c in CASES])
def test_async_session_matches_jax(layout, steps, mode, per_row, jattn):
    jsess, tsess = _sessions(mode, per_row, layout, jax_attn=jattn, steps_per_tick=steps,
                             policy="fifo" if steps == 1 else "priority")
    trace = _trace(3 + steps, n=7)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    _same_stats(jsess, tsess)
    assert tsess.drained and tsess._inflight is None


@pytest.mark.parametrize("layout,policy", [("paged", dict(prefill_decode_ratio=1.0)),
                                           ("slots", dict(prefill_token_budget=8))],
                         ids=["paged-ratio_1.0-per_row", "slots-budget_8-per_tensor"])
def test_interleaving_matches_jax(layout, policy):
    """A long-prompt burst against resident decodes, steps_per_tick 2: the
    budget defers the queue head in the same steps as the JAX session, and
    the decode-gap gauge stays within its bound."""
    steps = 2
    jsess, tsess = _sessions("approx_lowrank", layout == "paged", layout, steps_per_tick=steps,
                             **BURST_KW, **policy)
    trace = _burst_trace(5)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    _same_stats(jsess, tsess)
    st = tsess.stats
    assert st.prefill_stall_ticks > 0
    if "prefill_decode_ratio" in policy:
        assert st.max_decode_gap_ticks <= steps + math.ceil(1.0 * steps)
    else:
        assert st.max_decode_gap_ticks <= steps + -(-8 // BURST_KW["num_slots"])


def test_immediate_finishes_match_jax():
    """max_new = 1 and eos as the first token: the async loop learns of both
    one chunk late; no token is lost or duplicated, and the ticks are the
    JAX session's."""
    _, _, tcfg, tp = _models("exact")
    trace = [(np.asarray([i + 1, i + 2]), 1, 0, 0) for i in range(4)]
    trace += [(np.asarray([9, 8, 7]), 6, 0, 0), (np.asarray([5, 4, 3, 2]), 5, 1, 0)]
    free = _run(ServeSession(tcfg, tp, device="cpu", **KW), trace)
    eos = int(free[5].tokens[0])                   # request 5 stops at its first token
    jsess, tsess = _sessions("exact", False, "paged", eos=eos, steps_per_tick=3)
    tres = _run(tsess, trace)
    _assert_same_results(_run(jsess, trace), tres, trace)
    _same_stats(jsess, tsess)
    for i in range(4):
        assert len(tres[i].tokens) == 1 and tres[i].finish_reason == "length"
    assert tres[5].finish_reason == "eos" and tres[5].tokens.tolist() == [eos]
    st = tsess.stats
    assert st.generated_tokens == sum(len(r.tokens) for r in tres.values())
    assert sum(len(r.tokens) - 1 for r in tres.values()) == st.busy_slot_steps


@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_async_equals_sync_within_the_port(layout):
    """Per-row scales: a freed row's garbage chunk touches no other row, so
    the loops give identical tokens, ticks and admissions; a request
    finishes at the harvest, up to one chunk after the sync loop."""
    _, _, tcfg, tp = _models("approx", per_row=True)
    trace = [t for t in _trace(21, n=8) if t[1] > 1]
    kw = dict(KW if layout == "paged" else SKW, cache_layout=layout, steps_per_tick=2,
              device="cpu")
    runs = {loop: ServeSession(tcfg, tp, loop=loop, **kw) for loop in SERVE_LOOPS}
    res = {loop: _run(s, trace) for loop, s in runs.items()}
    assert runs["async"].stats.ticks == runs["sync"].stats.ticks
    for i in res["sync"]:
        a, s = res["async"][i], res["sync"][i]
        assert a.tokens.tolist() == s.tokens.tolist(), i
        assert (a.admitted_tick, a.ttft, a.finish_reason) == \
            (s.admitted_tick, s.ttft, s.finish_reason), i
        assert a.finished_tick - s.finished_tick in (0, 2), i
    assert 0.0 <= runs["async"].stats.overlap_fraction <= 1.0


def test_close_flushes_inflight_and_seals():
    _, _, tcfg, tp = _models("exact")
    sess = ServeSession(tcfg, tp, steps_per_tick=2, device="cpu", **KW)
    rid = sess.submit(np.asarray([1, 2, 3]), max_new=8)
    done = sess.submit(np.asarray([4, 5]), max_new=2)
    sess.step()                                    # admit + dispatch, no harvest yet
    assert sess._inflight is not None and sess._pending_tok0
    res = sess.close()
    assert sess._inflight is None and not sess._pending_tok0
    st = sess.stats
    assert st.busy_slot_steps + st.idle_slot_steps == st.ticks * sess.num_slots
    # the flushed chunk finished request `done` (tok0 + 2 steps >= 2 tokens)
    assert set(res) == {done} and res[done].tokens.shape == (2,)
    assert rid not in sess.results
    with pytest.raises(RuntimeError, match=r"request 2:.*close\(\)"):
        sess.submit(np.asarray([3, 4]), max_new=2)
    with pytest.raises(RuntimeError, match=r"request 7:.*close\(\)"):
        sess.submit(np.asarray([3, 4]), max_new=2, req_id=7)
    with pytest.raises(RuntimeError, match="closed"):
        sess.step()
    with pytest.raises(RuntimeError, match="closed"):
        sess.run()
    assert set(sess.close()) == {done}             # idempotent


@pytest.mark.parametrize("bad", [dict(loop="double-buffered"),
                                 dict(prefill_decode_ratio=1.0, prefill_token_budget=8),
                                 dict(prefill_decode_ratio=0.0),
                                 dict(prefill_token_budget=0),
                                 dict(steps_per_tick=0)],
                         ids=["loop", "both_policies", "ratio_0", "budget_0", "steps_0"])
def test_validation_raises_the_jax_errors(bad):
    jcfg, jp, tcfg, tp = _models("exact")
    with pytest.raises(ValueError) as jerr:
        JServeSession(jcfg, jp, **SKW, **bad)
    with pytest.raises(ValueError) as terr:
        ServeSession(tcfg, tp, cache_layout="slots", device="cpu", **SKW, **bad)
    assert str(terr.value) == str(jerr.value)


def test_merge_admit_carry_matches_jax():
    """The port carries request ids where the JAX package carries PRNG
    keys: JAX's merge on keys (req_id, 0) and the port's on ids scatter
    alike, and padding rows (valid False) rewrite what they gathered."""
    rng = np.random.default_rng(0)
    N, A = 6, 4
    lt = rng.integers(0, 500, N).astype(np.int32)
    ids = rng.integers(0, 1000, N).astype(np.uint32)
    slots = np.asarray([4, 1, 0, 5], np.int32)
    tok0s = rng.integers(0, 500, A).astype(np.int32)
    req = rng.integers(0, 1000, A).astype(np.uint32)
    valid = np.asarray([True, True, True, False])
    jlt, jsk = jC.merge_admit_carry(
        jnp.asarray(lt), jnp.stack([jnp.asarray(ids), jnp.zeros(N, jnp.uint32)], 1),
        jnp.asarray(slots), jnp.asarray(tok0s),
        jnp.stack([jnp.asarray(req), jnp.zeros(A, jnp.uint32)], 1), jnp.asarray(valid))
    tlt = torch.from_numpy(lt.astype(np.int64))
    tids = torch.from_numpy(ids.astype(np.int64))
    merge_admit_carry(tlt, tids, torch.from_numpy(slots), torch.from_numpy(tok0s),
                      torch.from_numpy(req.astype(np.int64)), torch.from_numpy(valid))
    assert tlt.tolist() == np.asarray(jlt).tolist()
    assert tids.tolist() == np.asarray(jsk)[:, 0].tolist()
    assert tlt[5] == lt[5] and tids[5] == ids[5]   # the padding row is untouched


def test_stats_docs_complete():
    fields = {f.name for f in dataclasses.fields(SchedulerStats)}
    props = {n for n, v in vars(SchedulerStats).items()
             if isinstance(v, property) and not n.startswith("_")}
    assert fields | props == set(SchedulerStats.DOCS)
    assert {"prefill_stall_ticks", "overlap_fraction"} <= set(SchedulerStats.DOCS)


def test_launcher_async_steps_per_tick(capsys):
    from repro_torch.launch.serve import main

    res = main(["--reduced", "--device", "cpu", "--loop", "async", "--steps-per-tick", "2",
                "--requests", "4", "--new", "4", "--exec", "approx_lowrank",
                "--prefill-decode-ratio", "1.0"])
    out = capsys.readouterr().out
    assert len(res) == 4 and "/async on cpu]" in out
    assert "overlap" in out and "prefill stalls" in out


def test_llm_approx_serve_example_tiny(capsys):
    """The example at a tiny size: K1's route equals the plain approximate
    product, and every continuous arm (both loops, both layouts, K2's
    route) gives each request its tokens from ``generate`` alone."""
    from repro_torch.examples.llm_approx_serve import CONTINUOUS_ARMS, main

    res = main(["--device", "cpu", "--batch", "2", "--new", "3", "--kernel", "--continuous"])
    assert torch.equal(res["approx_kernel"], res["mul8x8_2"])
    assert len(res["continuous"]) == len(CONTINUOUS_ARMS)
    assert set(res["continuous"].values()) == {10}
    assert "paged/async/kernel" in capsys.readouterr().out


def test_example_without_device_raises_without_cuda(monkeypatch):
    from repro_torch.device import NoCudaDeviceError
    from repro_torch.examples.llm_approx_serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        main(["--new", "2"])
