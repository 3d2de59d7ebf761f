"""The port's self-speculative decoding against the JAX package's, and its
exactness contract within the port.

Sessions, on the JAX tests' traces (``tests/test_specdec.py``): a float
verifier with an ``approx_lowrank`` draft (the JAX tests' pair), the
port's ``ServeSession(spec_decode=True)`` must equal the JAX session in
every request's tokens, finish reason, ticks and TTFT and in
``draft_tokens``, ``accepted_tokens``, ``verify_calls`` and
``peak_blocks_in_use`` — on both host loops (the async loop against the
JAX Pallas kernel: the draft's per-tensor scales carry a freed row's
attention into every row's codes, and JAX's gather attends a freed row's
clamped stand-in block), through the gather and through K2's plain
version; with the exact draft (every token accepted), ``draft_k = 1``,
eos inside the drafted span, preemption under sharing and
``dynamic_draft_k``.  Within the port the spec output under
``exact_quant`` with per-row scales — the card's contract — is bit-equal
to a non-speculative gather session, as is a temperature run under the
positional sampling keys.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as jC
from repro.serve.engine import SamplingConfig as JSampling
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.serve import (
    SamplingConfig,
    SchedulerStats,
    ServeSession,
    draft_config,
    merge_spec_len,
    resolve_execution_mode,
)
from test_torch_prefix import _models


SPEC = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8), cache_layout="paged",
            block_size=4, spec_decode=True, draft_k=3, draft_mode="approx_lowrank")
FIELDS = ("ticks", "draft_tokens", "accepted_tokens", "verify_calls", "peak_blocks_in_use",
          "busy_slot_steps", "idle_slot_steps", "generated_tokens", "admitted",
          "preemptions", "prefix_hit_blocks", "cow_forks", "draft_k_shrinks",
          "draft_k_grows", "draft_k_current", "work_ticks", "ttft_ticks", "latency_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_prompts(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 99, int(rng.integers(2, 9))).astype(np.int32) for _ in range(n)]


def _serve(sess, prompts, max_new):
    for i, p in enumerate(prompts):
        sess.submit(p, max_new=max_new, req_id=i)
    res = sess.run(max_steps=10_000)
    assert sess.drained and sorted(res) == list(range(len(prompts)))
    return res


def _tokens(res):
    return {i: r.tokens.tolist() for i, r in res.items()}


def _check_against_jax(prompts, max_new, *, attn="gather", eos=-1, **kw):
    """The JAX and the port's spec session on the float reduced model:
    equal results and counters; returns the port's session and results."""
    jcfg, jp, tcfg, tp = _models("exact")
    kw = {**SPEC, **kw}
    jsess = JServeSession(jcfg, jp, attn_impl="pallas" if attn == "kernel" else "gather",
                          sampling=JSampling(eos_id=eos), **kw)
    tsess = ServeSession(tcfg, tp, attn_impl=attn, sampling=SamplingConfig(eos_id=eos),
                         device="cpu", **kw)
    jres, tres = _serve(jsess, prompts, max_new), _serve(tsess, prompts, max_new)
    for i in jres:
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.finish_reason, t.admitted_tick, t.finished_tick, t.ttft) == \
            (j.finish_reason, j.admitted_tick, j.finished_tick, j.ttft), i
    for f in FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.accept_rate == jsess.stats.accept_rate
    return tsess, tres


def _oracle(prompts, max_new, mode="exact", per_row=False, **kw):
    """The port's non-speculative sync gather session on the same trace."""
    _, _, tcfg, tp = _models(mode, per_row)
    kw = {**SPEC, "spec_decode": False, "loop": "sync", **kw}
    for k in ("draft_k", "draft_mode"):
        kw.pop(k)
    return _tokens(_serve(ServeSession(tcfg, tp, attn_impl="gather", device="cpu", **kw),
                          prompts, max_new))


# ---------------------------------------------------------------------------
# Construction-time contract
# ---------------------------------------------------------------------------


_BAD = {"slots": dict(cache_layout="slots", spec_decode=True),
        "steps_per_tick": dict(SPEC, steps_per_tick=2),
        "draft_k": dict(SPEC, draft_k=0),
        "dynamic_without_spec": dict(SPEC, spec_decode=False, dynamic_draft_k=True),
        "cost_ratio": dict(SPEC, dynamic_draft_k=True, draft_cost_ratio=1.0),
        "window": dict(SPEC, dynamic_draft_k=True, draft_window=0)}


@pytest.mark.parametrize("case", list(_BAD))
def test_validation_raises_the_jax_errors(case):
    jcfg, jp, tcfg, tp = _models("exact")
    kw = {**dict(num_slots=3, max_len=32, prompt_buckets=(4, 8)), **_BAD[case]}
    with pytest.raises(ValueError) as jerr:
        JServeSession(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        ServeSession(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_moe_is_refused_with_the_jax_reason():
    """Spec decode refuses the moe family (its routing is capacity-coupled
    across the token batch) with JAX's message, on the real reduced
    qwen2-moe-a2.7b config of both packages."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced_config as jreduced
    from repro_torch.configs import get_config, reduced_config

    jmoe = jreduced(jget_config("qwen2-moe-a2.7b"))
    tmoe = reduced_config(get_config("qwen2-moe-a2.7b"))
    kw = dict(cache_layout="paged", block_size=4, max_len=32, prompt_buckets=(4, 8),
              spec_decode=True)
    with pytest.raises(ValueError, match="moe") as jerr:
        JServeSession(jmoe, {}, **kw)
    with pytest.raises(ValueError, match="moe") as terr:
        ServeSession(tmoe, {}, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_accept_rate_is_defined_before_any_draft():
    st = SchedulerStats()
    assert st.accept_rate == 0.0
    st.draft_tokens, st.accepted_tokens = 8, 6
    assert st.accept_rate == 0.75


def test_draft_config_swaps_only_the_multiplier_path():
    _, _, tcfg, _ = _models("exact_quant", per_row=True)
    d = draft_config(tcfg, "approx", "mul8x8_3")
    assert d.approx == resolve_execution_mode("approx", "mul8x8_3", act_per_row=True)
    assert dataclasses.replace(d, approx=tcfg.approx) == tcfg


def test_merge_spec_len_matches_jax():
    rng = np.random.default_rng(1)
    cur = rng.integers(0, 30, 5).astype(np.int32)
    slots = np.asarray([3, 0, 4], np.int32)
    lens = np.asarray([7, 9, 2], np.int32)
    valid = np.asarray([True, False, True])
    want = jC.merge_spec_len(jnp.asarray(cur), jnp.asarray(slots), jnp.asarray(lens),
                             jnp.asarray(valid))
    got = torch.from_numpy(cur.astype(np.int64))
    merge_spec_len(got, torch.from_numpy(slots), torch.from_numpy(lens),
                   torch.from_numpy(valid))
    assert got.tolist() == np.asarray(want).tolist() and got[0] == cur[0]


# ---------------------------------------------------------------------------
# Sessions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loop,attn", [("sync", "gather"), ("sync", "kernel"),
                                       ("async", "kernel")])
def test_spec_matches_jax_and_the_nonspec_session(loop, attn):
    """Greedy spec outputs equal the JAX spec session's and the port's
    non-speculative session's; a tick's capacity is num_slots * (draft_k +
    1) token-slots and busy counts emitted tokens."""
    prompts = _mixed_prompts()
    tsess, tres = _check_against_jax(prompts, 8, attn=attn, loop=loop)
    assert _tokens(tres) == _oracle(prompts, 8)
    st = tsess.stats
    assert sum(len(r.tokens) - 1 for r in tres.values()) == st.busy_slot_steps
    assert st.busy_slot_steps + st.idle_slot_steps == st.ticks * 3 * (3 + 1)
    assert st.verify_calls > 0 and st.draft_tokens == st.verify_calls * 3
    assert 0 <= st.accepted_tokens <= st.draft_tokens


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_exact_draft_accepts_every_token(loop):
    """draft_mode = the verifier's mode: every drafted token is accepted
    (max_new 8 is a multiple of draft_k + 1, so no tick is clipped)."""
    prompts = _mixed_prompts(seed=5)
    tsess, tres = _check_against_jax(prompts, 8, loop=loop, draft_mode="exact")
    assert tsess.stats.accept_rate == 1.0
    assert tsess.stats.accepted_tokens == tsess.stats.draft_tokens > 0
    assert _tokens(tres) == _oracle(prompts, 8)


def test_accept_extremes_with_draft_k_1():
    """draft_k = 1: each verify accepts 0 or all drafted tokens, and both
    happen on this trace."""
    prompts = _mixed_prompts(n=6, seed=7)
    tsess, tres = _check_against_jax(prompts, 7, draft_k=1, loop="sync")
    assert 0 < tsess.stats.accepted_tokens < tsess.stats.draft_tokens
    assert _tokens(tres) == _oracle(prompts, 7)


@pytest.mark.parametrize("draft_mode", ["exact", "approx_lowrank"])
def test_eos_inside_the_drafted_span(draft_mode):
    """An eos at drafted position j ends the request at j, where a
    sequential decode stops; the co-resident row runs on."""
    prompts = [np.asarray([3, 1, 4, 1], np.int32), np.asarray([9, 9], np.int32)]
    base = _oracle(prompts[:1], 8)[0]
    eos = base[2]
    _, tres = _check_against_jax(prompts, 8, draft_k=4, draft_mode=draft_mode, eos=eos)
    hit = base.index(eos)
    assert tres[0].finish_reason == "eos" and tres[0].tokens.tolist() == base[:hit + 1]
    assert len(tres[1].tokens) == 8


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_spec_with_preemption_under_sharing(loop):
    """Preemption mid-flight discards drafted-but-unharvested tokens; the
    starved pool's outputs equal the JAX session's and the non-speculative
    roomy run's, with prefix sharing live underneath."""
    rng = np.random.default_rng(13)
    prefix = rng.integers(1, 50, 12)
    prompts = [np.concatenate([prefix, rng.integers(50, 99, 2)]).astype(np.int32)
               for _ in range(5)]
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(8, 32))
    tsess, tres = _check_against_jax(prompts, 12, attn="kernel" if loop == "async" else "gather",
                                     loop=loop, num_blocks=9, prefix_sharing=True,
                                     preemption=True, **kw)
    assert tsess.stats.preemptions >= 1 and tsess.stats.prefix_hit_blocks > 0
    assert tsess._reserved_total == 0 and not tsess._preempt_resume
    assert _tokens(tres) == _oracle(prompts, 12, **kw)


def test_dynamic_draft_k_rule():
    """The window shrinks exactly when the rolling accept rate is strictly
    below 1 / draft_cost_ratio, grows back at or above it, and the window
    clears on every move."""
    _, _, tcfg, tp = _models("exact")
    sess = ServeSession(tcfg, tp, device="cpu", **dict(SPEC, draft_k=4), dynamic_draft_k=True,
                        draft_cost_ratio=4.0, draft_window=4)
    assert sess._draft_ks == (4, 2, 1) and sess._draft_k_eff == 4

    def feed(pairs):
        sess._accept_hist.clear()
        sess._accept_hist.extend(pairs)
        sess._update_draft_k()

    feed([(4, 0)] * 3)                                   # a short window: no move
    assert sess._draft_k_eff == 4 and sess.stats.draft_k_shrinks == 0
    feed([(4, 1)] * 4)                                   # at break-even: hold
    assert sess._draft_k_eff == 4
    feed([(4, 1)] * 3 + [(4, 0)])                        # below: shrink, window cleared
    assert sess._draft_k_eff == 2 and sess.stats.draft_k_shrinks == 1
    assert len(sess._accept_hist) == 0 and sess.stats.draft_k_current == 2
    feed([(2, 0)] * 4)
    feed([(1, 0)] * 4)                                   # the floor rung holds
    assert sess._draft_k_eff == 1 and sess.stats.draft_k_shrinks == 2
    feed([(1, 1)] * 4)
    feed([(2, 2)] * 4)                                   # one rung per full window
    assert sess._draft_k_eff == 4 and sess.stats.draft_k_grows == 2


def test_dynamic_draft_k_matches_jax():
    """A lossy draft under a tight window shrinks the live draft_k as in
    the JAX session; the tokens stay the non-speculative session's."""
    prompts = _mixed_prompts(n=4, seed=5)
    dyn = dict(draft_k=4, dynamic_draft_k=True, draft_cost_ratio=1.05, draft_window=2)
    tsess, tres = _check_against_jax(prompts, 12, loop="sync", **dyn)
    assert tsess.stats.draft_k_shrinks >= 1 and tsess.stats.draft_k_current < 4
    oracle = _oracle(prompts, 12)
    assert _tokens(tres) == oracle
    _, _, tcfg, tp = _models("exact")
    sess = ServeSession(tcfg, tp, attn_impl="gather", device="cpu", **{**SPEC, **dyn})
    assert _tokens(_serve(sess, prompts, 12)) == oracle          # the async loop
    assert sess.stats.draft_k_shrinks >= 1


# ---------------------------------------------------------------------------
# Within the port: the card's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loop,attn", [("sync", "gather"), ("async", "kernel")])
def test_exact_quant_per_row_spec_equals_the_gather_session(loop, attn):
    """An ``exact_quant`` verifier with per-row scales is integer-exact per
    row, so the verify pass is bit-equal to sequential gather decode: the
    spec tokens equal a non-speculative gather session's, whatever the
    draft (here mul8x8_2 through K1's route, attending as ``attn``)."""
    _, _, tcfg, tp = _models("exact_quant", per_row=True)
    prompts = _mixed_prompts(n=5, seed=11)
    sess = ServeSession(tcfg, tp, attn_impl=attn, loop=loop, device="cpu",
                        **dict(SPEC, draft_mode="approx", draft_k=4))
    res = _serve(sess, prompts, 10)
    assert _tokens(res) == _oracle(prompts, 10, mode="exact_quant", per_row=True)
    assert sess.stats.verify_calls > 0


def test_self_test_draft_accepts_every_token_per_row():
    """The verifier's own mode as the draft keeps its per-row scales
    (``draft_config``), so with the gather every drafted token is
    accepted: max_new 10 is a multiple of draft_k + 1 = 5."""
    _, _, tcfg, tp = _models("exact_quant", per_row=True)
    sess = ServeSession(tcfg, tp, attn_impl="gather", device="cpu",
                        **dict(SPEC, draft_mode="exact_quant", draft_k=4))
    _serve(sess, _mixed_prompts(n=3, seed=2), 10)
    assert sess.stats.accept_rate == 1.0 and sess.stats.draft_tokens > 0


def test_temperature_spec_equals_the_nonspec_session():
    """The verify pass samples with the positional keys a sequential
    decode uses, so temperature outputs are the non-speculative
    session's too."""
    _, _, tcfg, tp = _models("exact")
    samp = SamplingConfig(temperature=0.8, top_k=8)
    prompts = _mixed_prompts(n=4, seed=9)
    spec = ServeSession(tcfg, tp, attn_impl="gather", sampling=samp, seed=42, device="cpu",
                        **SPEC)
    assert _tokens(_serve(spec, prompts, 6)) == _oracle(prompts, 6, sampling=samp, seed=42)


def test_launcher_spec_decode(capsys):
    from repro_torch.launch.serve import main

    res = main(["--reduced", "--device", "cpu", "--spec-decode", "--exec", "exact_quant",
                "--draft-mode", "approx", "--draft-k", "3", "--dynamic-draft-k",
                "--draft-window", "2", "--requests", "4", "--new", "6", "--loop", "sync"])
    out = capsys.readouterr().out
    assert len(res) == 4 and "spec decode: draft approx/mul8x8_2 k=3" in out
    assert "dynamic draft: k now" in out
