"""The port's quality tiers and load shedder against the JAX package's.

Sessions on the JAX tests' ladder (``tests/test_tiers.py``: ``exact``,
``approx_lowrank``, ``approx_msr`` over mul8x8_2, the reduced float
weights): the port's ``ServeSession(tiers=...)`` must equal the JAX
session in every request's tokens, effective ``tier``, admission and
finish ticks and TTFT, and in the ticks, admissions and tier gauges, on
both loops and layouts.  JAX's MSR rung runs its Pallas kernel in
interpret mode, the port's K1's plain version.

Within the port, a mixed-tier session equals single-mode sessions of each
rung serving only that rung's requests (JAX's own contract) on every
(loop, layout, attention) combination the JAX test runs, with ``"kernel"``
(K2's plain version here) in place of ``"pallas"``.  The shedder's
per-step ``shed_level`` sequence, demotions and restorations equal JAX's
on a burst; a preemption victim replays at the rung it was first admitted
at; and every constructor and ``submit`` refusal has JAX's message.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.serve import ServeSession, resolve_execution_mode
from test_torch_serve import _models as _build_models

TIERS = ("exact", "approx_lowrank", "approx_msr")
TIER_MULTIPLIER = "mul8x8_2"
BASE = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8))
FIELDS = ("ticks", "admitted", "completed", "generated_tokens", "admit_calls", "peak_active",
          "prefill_tokens", "work_ticks", "busy_slot_steps", "idle_slot_steps", "ttft_ticks",
          "latency_ticks", "tier_demotions", "tier_restorations", "shed_level",
          "active_per_tier", "preemptions")


@functools.lru_cache(maxsize=None)
def _models():
    """The reduced model's float weights in both packages (tier sessions
    quantize per rung, per call)."""
    return _build_models("exact")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout_kw(layout, attn):
    """Session keywords of one (layout, attention) case; ``attn`` is the
    port's name ("kernel": K2's plain version, JAX's "pallas")."""
    if layout == "slots":
        return dict(cache_layout="slots"), dict(cache_layout="slots")
    kw = dict(cache_layout="paged", block_size=8)
    return ({**kw, "attn_impl": "pallas" if attn == "kernel" else "gather"},
            {**kw, "attn_impl": attn})


def _tier_trace(rng, n):
    """(req_id, prompt, max_new, tier): rungs round-robin, the last request
    at tier None (the best rung), as the JAX test's trace."""
    out = []
    for i in range(n):
        p = rng.integers(0, 512, int(rng.integers(2, 9)))
        out.append((i, p, int(rng.integers(2, 6)), None if i == n - 1 else TIERS[i % 3]))
    return out


def _serve(sess, trace, arrival=lambda i: 0):
    for rid, p, n, tier in trace:
        sess.submit(p, max_new=n, req_id=rid, tier=tier, arrival=arrival(rid))
    res = sess.run(max_steps=5_000)
    assert sess.drained and sorted(res) == sorted(r for r, *_ in trace)
    return res


def _assert_same(jsess, tsess, trace, **kw):
    jres, tres = _serve(jsess, trace, **kw), _serve(tsess, trace, **kw)
    for i in jres:
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.tier, t.finish_reason, t.admitted_tick, t.finished_tick, t.ttft) == \
            (j.tier, j.finish_reason, j.admitted_tick, j.finished_tick, j.ttft), i
    for f in FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    return tres


def _sessions(jkw, tkw=None, **kw):
    jcfg, jp, tcfg, tp = _models()
    tkw = jkw if tkw is None else tkw
    common = dict(BASE, tiers=TIERS, tier_multiplier=TIER_MULTIPLIER, **kw)
    return (JServeSession(jcfg, jp, **common, **jkw),
            ServeSession(tcfg, tp, device="cpu", **common, **tkw))


@pytest.mark.parametrize("loop,layout", [("sync", "paged"), ("async", "slots")])
def test_tier_sessions_match_jax(loop, layout):
    jkw, tkw = _layout_kw(layout, "gather")
    jsess, tsess = _sessions(jkw, tkw, loop=loop)
    tres = _assert_same(jsess, tsess, _tier_trace(np.random.default_rng(3), 7))
    assert {r.tier for r in tres.values()} == set(TIERS)
    # the gauge decays to zero once every request is released
    assert tsess.stats.active_per_tier == dict.fromkeys(TIERS, 0)


@pytest.mark.parametrize("loop,layout,attn", [("sync", "slots", None),
                                              ("sync", "paged", "gather"),
                                              ("async", "slots", None),
                                              ("async", "paged", "gather"),
                                              ("async", "paged", "kernel")])
def test_mixed_tiers_equal_single_mode_oracles(loop, layout, attn):
    """Each request's tokens equal a single-mode session of its rung that
    serves that rung's requests alone, with no tier routing at all."""
    _, _, tcfg, tp = _models()
    trace = _tier_trace(np.random.default_rng(3), 7)
    _, kw = _layout_kw(layout, attn)
    kw.update(BASE, loop=loop, device="cpu")
    mixed = _serve(ServeSession(tcfg, tp, tiers=TIERS, tier_multiplier=TIER_MULTIPLIER, **kw),
                   trace)
    for t in TIERS:
        mine = [(rid, p, n, None) for rid, p, n, tier in trace if (tier or TIERS[0]) == t]
        ocfg = dataclasses.replace(tcfg, approx=resolve_execution_mode(
            t, TIER_MULTIPLIER, act_per_row=True))
        oracle = _serve(ServeSession(ocfg, tp, **kw), mine)
        for rid, *_ in mine:
            assert mixed[rid].tier == t
            assert mixed[rid].tokens.tolist() == oracle[rid].tokens.tolist(), (t, rid)


def _shed_levels(sess, trace):
    """Serve ``trace`` step by step: the shed level after every step."""
    for rid, p, n, tier in trace:
        sess.submit(p, max_new=n, req_id=rid, tier=tier)
    levels = []
    while not sess.drained:
        sess.step()
        levels.append(sess.stats.shed_level)
    return levels


def test_shedder_levels_match_jax_on_a_burst():
    """A burst of 10 requests against 2 slots: the queue breaches depth 2,
    the shedder demotes new admissions one rung per breach step, and after
    the queue drains 4 healthy steps restore each rung, step for step as
    in the JAX session."""
    rng = np.random.default_rng(11)
    trace = [(i, rng.integers(0, 512, int(rng.integers(2, 9))), 3, None) for i in range(10)]
    kw = dict(num_slots=2, cache_layout="paged", block_size=8, shed_queue_depth=2,
              shed_hold_steps=4)
    jsess, tsess = _sessions(dict(attn_impl="gather"), dict(attn_impl="gather"), **kw)
    jl, tl = _shed_levels(jsess, trace), _shed_levels(tsess, trace)
    assert tl == jl and max(tl) == len(TIERS) - 1
    for _ in range(2 * 4 * len(TIERS)):         # restores need healthy steps
        jsess.step()
        tsess.step()
        jl.append(jsess.stats.shed_level)
        tl.append(tsess.stats.shed_level)
    assert tl == jl and tl[-1] == 0
    for f in ("tier_demotions", "tier_restorations", "ticks", "generated_tokens"):
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.tier_demotions == 2 and tsess.stats.tier_restorations == 2
    # the burst breached before its first admission: nothing served at the best rung
    assert {r.tier for r in tsess.results.values()} == set(TIERS[1:])
    # once restored, an admission serves at its requested rung again
    for sess in (jsess, tsess):
        sess.submit(np.arange(1, 5), max_new=2, req_id=99)
        sess.run()
    jres, tres = jsess.results, tsess.results
    assert tres[99].tier == TIERS[0]
    assert {i: (r.tier, r.tokens.tolist()) for i, r in tres.items()} == \
        {i: (r.tier, r.tokens.tolist()) for i, r in jres.items()}


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_preemption_victim_replays_at_its_first_rung(loop):
    """A starved pool under a shedding ladder: a victim is replayed at the
    rung it was first admitted at, whatever the shed level by then, and
    every request equals the JAX session and the single-mode session of
    its rung."""
    rng = np.random.default_rng(7)
    trace = [(i, rng.integers(1, 99, 6), 12, None) for i in range(4)]
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(8, 32), num_blocks=5, preemption=True,
              shed_queue_depth=1, shed_hold_steps=2, loop=loop, cache_layout="paged",
              block_size=4)
    jsess, tsess = _sessions(dict(attn_impl="gather"), dict(attn_impl="gather"), **kw)
    admits, inner = [], tsess._admit_many

    def admit(reqs, tier_idx=0):
        admits.extend((r.req_id, tier_idx, tsess._shed_level, r.req_id in tsess._preempt_resume)
                      for r in reqs)
        inner(reqs, tier_idx=tier_idx)

    tsess._admit_many = admit
    tres = _assert_same(jsess, tsess, trace, arrival=lambda i: i // 2)
    assert tsess.stats.preemptions >= 1 and tsess.stats.tier_demotions >= 1
    first = {}
    for rid, t, level, replay in admits:
        if not replay:
            first[rid] = t
        else:
            assert t == first[rid], (rid, admits)
    # the shed level had moved off the victim's rung at some replay
    assert any(replay and level != t for _, t, level, replay in admits), admits
    _, _, tcfg, tp = _models()
    for t in {r.tier for r in tres.values()}:
        mine = [(rid, p, n, None) for rid, p, n, _ in trace if tres[rid].tier == t]
        ocfg = dataclasses.replace(tcfg, approx=resolve_execution_mode(
            t, TIER_MULTIPLIER, act_per_row=True))
        oracle = _serve(ServeSession(ocfg, tp, device="cpu", **{
            **BASE, **kw, "num_blocks": 16, "shed_queue_depth": None, "preemption": False}),
            mine)
        for rid, *_ in mine:
            assert tres[rid].tokens.tolist() == oracle[rid].tokens.tolist(), (t, rid)


CTOR_REFUSALS = {
    "empty": dict(tiers=()),
    "duplicate": dict(tiers=("exact", "exact")),
    "unknown_mode": dict(tiers=("exact", "nope")),
    "spec_decode": dict(cache_layout="paged", block_size=8, spec_decode=True, tiers=TIERS),
    "shed_without_ladder": dict(shed_queue_depth=4),
    "shed_one_rung": dict(tiers=("exact",), shed_queue_depth=4),
    "shed_depth": dict(tiers=TIERS, shed_queue_depth=0),
    "shed_gap": dict(tiers=TIERS, shed_gap_ticks=0),
    "shed_hold": dict(tiers=TIERS, shed_gap_ticks=3, shed_hold_steps=0),
    "shed_fraction": dict(tiers=TIERS, shed_queue_depth=2, shed_restore_fraction=1.5),
}


@pytest.mark.parametrize("case", sorted(CTOR_REFUSALS))
def test_tier_constructor_refusals_match_jax(case):
    jcfg, jp, tcfg, tp = _models()
    kw = {**BASE, "cache_layout": "slots", **CTOR_REFUSALS[case]}
    with pytest.raises(ValueError) as jerr:
        JServeSession(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        ServeSession(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("tiers,tier", [(None, "exact"), (TIERS, "nope")],
                         ids=["no_ladder", "not_a_rung"])
def test_tier_submit_refusals_match_jax(tiers, tier):
    jcfg, jp, tcfg, tp = _models()
    errs = []
    for sess in (JServeSession(jcfg, jp, **BASE, tiers=tiers),
                 ServeSession(tcfg, tp, device="cpu", cache_layout="slots", **BASE,
                              tiers=tiers)):
        with pytest.raises(ValueError, match="request 5") as e:
            sess.submit(np.arange(1, 4), max_new=2, req_id=5, tier=tier)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_eff_tier_is_the_shed_level_or_the_replay_rung():
    """The rung a request is admitted at: its own, demoted to the shed
    level, and a preemption victim's first rung whatever the level."""
    _, _, tcfg, tp = _models()
    sess = ServeSession(tcfg, tp, device="cpu", **BASE, cache_layout="slots", tiers=TIERS)
    for rid, tier in enumerate((None, "approx_lowrank", "approx_msr")):
        sess.submit(np.arange(1, 4), max_new=2, req_id=rid, tier=tier)
    reqs = sorted((r for _, _, r in sess._ready), key=lambda r: r.req_id)
    assert [sess._eff_tier(r) for r in reqs] == [0, 1, 2]
    sess._shed_level = 1
    assert [sess._eff_tier(r) for r in reqs] == [1, 1, 2]
    sess._preempt_resume[0] = ([7], 0, 0, 0)
    assert sess._eff_tier(reqs[0]) == 0


def test_launcher_tiers_and_shedder(capsys):
    """The launcher's tiered synthetic trace (a random rung per request)
    with the shedder armed, on float weights (``--freeze-weights`` off)."""
    from repro_torch.launch.serve import main

    res = main(["--reduced", "--device", "cpu", "--tiers", ",".join(TIERS),
                "--shed-queue-depth", "2", "--requests", "4", "--new", "4"])
    out = capsys.readouterr().out
    assert len(res) == 4 and all(r.tier in TIERS for r in res.values())
    assert f"tiers {','.join(TIERS)}: served" in out and "demotions 1" in out
