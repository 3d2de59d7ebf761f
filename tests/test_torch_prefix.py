"""The port's copy-on-write prefix sharing and preemption against the JAX
package's.

Units: ``BlockPool``'s refcounts (``share``, ``release`` freeing on the
last reference, the atomic ``release_many``), ``PrefixCache``'s interned
rolling keys, publication and LRU order, and ``copy_block``, each held
against the JAX package's on the same operations.

Sessions, on the JAX tests' traces (``tests/test_prefix_sharing.py``),
float execution: the port's ``ServeSession(prefix_sharing=...,
preemption=...)`` must equal the JAX session in every request's tokens,
finish reason, admission and finish ticks and TTFT, and in the ticks,
``prefix_hit_blocks``, ``cow_forks``, ``preemptions`` and
``peak_blocks_in_use`` — on both host loops, through K2's plain version
(against JAX's Pallas kernel) and the gather; and a drained pool is clean
(only cache-pinned blocks, each at refcount 1).  A replay is charged at
its own bucket and SJF ranks a victim on its replay length, as in the JAX
package.
"""
from __future__ import annotations

import functools
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cache as jC
from repro.serve.engine import SamplingConfig as JSampling
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.serve import (
    BlockPool,
    PrefixCache,
    SamplingConfig,
    ServeSession,
    copy_block,
)
from test_torch_serve import _models as _build_models


@functools.lru_cache(maxsize=None)
def _models(mode, per_row=False):
    """``test_torch_serve._models``, built once per mode (sessions never
    write their parameters)."""
    return _build_models(mode, per_row)

PAGED = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8), cache_layout="paged",
             block_size=4)
FIELDS = ("ticks", "prefix_hit_blocks", "cow_forks", "preemptions", "peak_blocks_in_use",
          "peak_active", "admitted", "completed", "generated_tokens", "admit_calls",
          "prefill_tokens", "work_ticks", "busy_slot_steps", "idle_slot_steps",
          "ttft_ticks", "latency_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sessions(*, attn="gather", eos=-1, **kw):
    """The JAX and the port's session on the float reduced model; ``attn``
    is the port's decode attention ("kernel": K2's plain version, held
    against JAX's Pallas kernel)."""
    jcfg, jp, tcfg, tp = _models("exact")
    kw = {**PAGED, **kw}
    jsess = JServeSession(jcfg, jp, attn_impl="pallas" if attn == "kernel" else "gather",
                          sampling=JSampling(eos_id=eos), **kw)
    tsess = ServeSession(tcfg, tp, attn_impl=attn, sampling=SamplingConfig(eos_id=eos),
                         device="cpu", **kw)
    return jsess, tsess


def _serve(sess, trace):
    """``trace``: (prompt, max_new[, arrival]) per request id."""
    for i, (p, n, *a) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a[0] if a else 0, req_id=i)
    res = sess.run(max_steps=20_000)
    assert sess.drained and sorted(res) == list(range(len(trace)))
    return res


def _assert_same(jsess, tsess, trace):
    """Run both sessions on ``trace``: equal results and counters."""
    jres, tres = _serve(jsess, trace), _serve(tsess, trace)
    for i in jres:
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.finish_reason, t.admitted_tick, t.finished_tick, t.ttft) == \
            (j.finish_reason, j.admitted_tick, j.finished_tick, j.ttft), i
    for f in FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.prefills == jsess.stats.prefills
    return tres


def _assert_pool_clean(sess):
    """A drained session: the prefix cache may pin blocks (each at refcount
    1, the cache's own reference), every other block is free, tables are
    the sentinel, reservations zero, no replay pending."""
    cached = set(sess._prefix.lru_blocks()) if sess._prefix is not None else set()
    for b in cached:
        assert sess.blocks.refcount(b) == 1, b
    assert sess.blocks.free_count == sess.num_blocks - len(cached)
    assert sess._reserved_total == 0 and (sess._future == 0).all()
    assert (sess._tables == sess.num_blocks).all() and all(not h for h in sess._held)
    assert not sess._preempt_resume
    for b in range(sess.num_blocks):
        assert sess.blocks.refcount(b) == (b in cached), b


def _shared_prefix_trace(n=6, shared=12, unique=2, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 50, shared)
    return [(np.concatenate([prefix, rng.integers(50, 99, unique)]).astype(np.int32), 6)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Units against the JAX package's
# ---------------------------------------------------------------------------


def _pool_state(p):
    return p.free_count, p.busy_count, [p.refcount(b) for b in range(p.num_blocks)]


def test_block_pool_refcount_lifecycle_matches_jax():
    pools = [BlockPool(3), jC.BlockPool(3)]
    for p in pools:
        a = p.acquire()
        assert p.refcount(a) == 1 and p.share(a) == 2 and p.share(a) == 3
        p.release(a)
        p.release(a)
        assert p.refcount(a) == 1 and p.free_count == 2     # still held: not freed
        p.release(a)
        assert p.refcount(a) == 0 and p.free_count == 3
        assert p.acquire() == a                            # back on the heap
    assert _pool_state(pools[0]) == _pool_state(pools[1])


@pytest.mark.parametrize("case", ["share_free", "double_release", "out_of_range"])
def test_block_pool_validation_raises_the_jax_errors(case):
    errs = []
    for p in (BlockPool(2), jC.BlockPool(2)):
        a = p.acquire()
        p.release(a)
        with pytest.raises(ValueError) as e:
            {"share_free": lambda: p.share(0), "double_release": lambda: p.release(a),
             "out_of_range": lambda: p.release(7)}[case]()
        errs.append(str(e.value))
        assert p.free_count == 2                            # the failure left the pool intact
    assert errs[0] == errs[1]


def test_release_many_is_atomic_against_refcounts():
    """The whole batch is checked against the held refcounts before any
    reference is dropped, with the JAX package's message."""
    errs, states = [], []
    for p in (BlockPool(4), jC.BlockPool(4)):
        a, b = p.acquire(), p.acquire()
        p.share(a)                                         # a: 2 refs, b: 1
        with pytest.raises(ValueError, match="2 refs") as e:
            p.release_many([a, a, b, b])
        errs.append(str(e.value))
        assert p.refcount(a) == 2 and p.refcount(b) == 1 and p.free_count == 2
        p.release_many([a, a, b])
        assert p.free_count == 4 and p.busy_count == 0
        with pytest.raises(ValueError):
            p.release_many([a])                            # free now: an atomic no-op
        states.append(_pool_state(p))
    assert errs[0] == errs[1] and states[0] == states[1]


def test_prefix_cache_keys_publish_lookup_lru_match_jax():
    caches = [PrefixCache(), jC.PrefixCache()]
    seen = []
    for c in caches:
        root = c.ROOT
        k0 = c.key(root, [1, 2, 3, 4])
        assert c.key(root, np.asarray([1, 2, 3, 4])) == k0          # interned
        assert c.key(root, [1, 2, 3, 5]) != k0                      # other content
        k1 = c.key(k0, [5, 6, 7, 8])
        assert c.key(c.key(root, [9]), [5, 6, 7, 8]) != k1          # other parent
        assert c.lookup(k0) is None
        c.insert(k0, 5)
        c.insert(k1, 9)
        assert c.lookup(k0) == 5 and c.lookup(k1) == 9
        assert c.holds_block(9) and not c.holds_block(7)
        with pytest.raises(ValueError, match="already published"):
            c.insert(k0, 7)                                         # a second publish
        with pytest.raises(ValueError, match="already published"):
            c.insert(c.key(root, [0]), 9)
        c.lookup(k0)                                 # recency: k1 is now the LRU head
        assert c.lru_blocks() == [9, 5]
        assert c.drop_block(9) and not c.drop_block(9)
        assert c.lookup(k1) is None and len(c) == 1
        seen.append((k0, k1, c.lru_blocks()))
    assert seen[0] == seen[1]


def test_copy_block_matches_jax():
    rng = np.random.default_rng(0)
    leaves = {n: rng.normal(size=(2, 5, 4, 2, 3)).astype(np.float32) for n in ("k", "v")}
    want = jC.copy_block({n: jnp.asarray(a) for n, a in leaves.items()},
                         jnp.int32(3), jnp.int32(1))
    got = {n: torch.from_numpy(a.copy()) for n, a in leaves.items()}
    copy_block(got, 3, 1)
    for n in leaves:
        assert np.array_equal(got[n].numpy(), np.asarray(want[n]))
        assert np.array_equal(got[n][:, 1].numpy(), leaves[n][:, 3])


# ---------------------------------------------------------------------------
# Sessions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loop,attn", [("sync", "gather"), ("async", "gather"),
                                       ("async", "kernel")])
def test_sharing_matches_jax_and_the_unshared_session(loop, attn):
    """Shared system prompts: requests 2.. hit the three full shared
    blocks, the outputs equal the JAX session's and the unshared port
    session's, and the drained pool holds only cache-pinned blocks."""
    trace = _shared_prefix_trace()
    kw = dict(loop=loop, prompt_buckets=(4, 8, 16, 32))
    jsess, tsess = _sessions(attn=attn, prefix_sharing=True, **kw)
    tres = _assert_same(jsess, tsess, trace)
    assert tsess.stats.prefix_hit_blocks >= 3 * (len(trace) - 1)
    _assert_pool_clean(tsess)
    _, _, tcfg, tp = _models("exact")
    plain = _serve(ServeSession(tcfg, tp, attn_impl=attn, device="cpu", **{**PAGED, **kw}),
                   trace)
    assert {i: r.tokens.tolist() for i, r in plain.items()} == \
        {i: r.tokens.tolist() for i, r in tres.items()}


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_cow_fork_on_a_shared_partial_tail(loop):
    """Three identical 14-token prompts (3.5 blocks): the later two share
    the partial tail block, and the first decode write into it forks a
    private copy instead of writing the sharer's block."""
    p = np.arange(1, 15, dtype=np.int32)
    jsess, tsess = _sessions(loop=loop, prompt_buckets=(16,), prefix_sharing=True)
    tres = _assert_same(jsess, tsess, [(p, 5)] * 3)
    assert tsess.stats.cow_forks >= 1 and tsess.stats.prefix_hit_blocks >= 1
    _assert_pool_clean(tsess)
    assert len({tuple(r.tokens.tolist()) for r in tres.values()}) == 1


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_forced_preemption_matches_jax_and_the_roomy_pool(loop):
    """A pool too small for two worst cases: the lower-priority resident is
    evicted and replayed (charged at its replay prompt's bucket); its
    tokens equal the roomy pool's run."""
    rng = np.random.default_rng(11)
    trace = [(rng.integers(1, 99, 6).astype(np.int32), 12) for _ in range(2)]
    kw = dict(num_slots=2, prompt_buckets=(8, 32), loop=loop, prefix_sharing=True,
              preemption=True)
    jsess, tsess = _sessions(num_blocks=5, **kw)
    tres = _assert_same(jsess, tsess, trace)
    st = tsess.stats
    assert st.preemptions >= 1
    # every admission, a replay's included, is charged its own bucket: the
    # replay prompt (6 + accepted tokens > 8) lands in bucket 32
    assert sum(st.prefills.values()) == st.admitted + st.preemptions
    assert st.prefill_tokens == sum(b * n for b, n in st.prefills.items())
    assert st.prefills.get(32, 0) >= 1
    _assert_pool_clean(tsess)
    _, _, tcfg, tp = _models("exact")
    roomy = _serve(ServeSession(tcfg, tp, attn_impl="gather", device="cpu",
                                **{**PAGED, **kw, "num_blocks": 24}), trace)
    assert {i: r.tokens.tolist() for i, r in roomy.items()} == \
        {i: r.tokens.tolist() for i, r in tres.items()}


def test_preemption_admits_beyond_the_worst_case_reservation():
    """Three requests whose worst cases (3 blocks each) overfill a 5-block
    pool: the reservation serializes them, preemption runs them together —
    the same tokens, a higher peak concurrency, each as the JAX session."""
    rng = np.random.default_rng(13)
    trace = [(rng.integers(1, 99, 4).astype(np.int32), 9) for _ in range(3)]
    peak, outs = {}, {}
    for preempt in (False, True):
        jsess, tsess = _sessions(max_len=16, prompt_buckets=(4, 16), num_blocks=5,
                                 preemption=preempt)
        tres = _assert_same(jsess, tsess, trace)
        peak[preempt] = tsess.stats.peak_active
        outs[preempt] = {i: r.tokens.tolist() for i, r in tres.items()}
        _assert_pool_clean(tsess)
    assert outs[False] == outs[True] and peak[True] > peak[False]


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_fork_preempt_eos_interleaving_leaves_a_clean_pool(loop):
    """A randomized shared-prefix trace against a starved pool, with an eos
    id and steps_per_tick 2: prefix hits, forks, preemptions and eos and
    length exits interleave as in the JAX session, and the drained pool
    holds every block at refcount 0 or 1 (cache-pinned)."""
    rng = np.random.default_rng(17)
    prefix = rng.integers(1, 50, 8)
    trace = []
    for i in range(10):
        tail = rng.integers(50, 99, int(rng.integers(1, 5)))
        p = np.concatenate([prefix[:int(rng.integers(4, 9))], tail]).astype(np.int32)
        trace.append((p, int(rng.integers(2, 8)), i // 2))
    kw = dict(prompt_buckets=(4, 8, 16, 32), num_blocks=8, prefix_sharing=True,
              preemption=True, steps_per_tick=2, loop=loop)
    _, _, tcfg, tp = _models("exact")
    free = _serve(ServeSession(tcfg, tp, attn_impl="gather", device="cpu", **{**PAGED, **kw}),
                  trace)
    eos = int(next(r.tokens[1] for r in free.values() if len(r.tokens) > 3))
    jsess, tsess = _sessions(eos=eos, **kw)
    tres = _assert_same(jsess, tsess, trace)
    st = tsess.stats
    assert st.prefix_hit_blocks > 0 and st.preemptions > 0 and st.peak_blocks_in_use <= 8
    assert any(r.finish_reason == "eos" for r in tres.values())
    _assert_pool_clean(tsess)


def test_sjf_ranks_a_victim_on_its_replay_length():
    """SJF charges a preempted request its replay prompt (prompt + accepted
    tokens), not its original one, as the JAX session does."""
    jcfg, jp, tcfg, tp = _models("exact")
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(4, 8, 16), cache_layout="paged",
              block_size=4, policy="sjf", preemption=True)
    keys = []
    for sess in (JServeSession(jcfg, jp, **kw), ServeSession(tcfg, tp, device="cpu", **kw)):
        rid = sess.submit(np.arange(1, 5, dtype=np.int32), max_new=2)     # bucket 4
        req = sess._ready[0][2]
        k0 = sess._ready_key(req)
        sess._preempt_resume[rid] = ([11, 12, 13, 14, 15], None)          # replay: 9 tokens
        fresh = sess.submit(np.arange(1, 6, dtype=np.int32), max_new=4)
        fresh_req = next(r for _, _, r in sess._ready if r.req_id == fresh)
        keys.append((k0, sess._ready_key(req), sess._ready_key(req, eff_len=9),
                     sess._ready_key(fresh_req)))
    assert keys[0] == keys[1] == (2 + 4, 2 + 16, 2 + 16, 12)


def test_submit_validation_raises_the_jax_errors():
    jcfg, jp, tcfg, tp = _models("exact")
    for kw, (prompt, n, rid) in ((dict(num_blocks=3, prefix_sharing=True),
                                  (np.arange(1, 7, dtype=np.int32), 5, 2)),
                                 (dict(preemption=True), (np.arange(1, 7, dtype=np.int32), 4, 4))):
        errs = []
        for sess in (JServeSession(jcfg, jp, **PAGED, **kw),
                     ServeSession(tcfg, tp, device="cpu", **PAGED, **kw)):
            with pytest.raises(ValueError, match=f"request {rid}") as e:
                sess.submit(prompt, max_new=n, req_id=rid)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("bad", [dict(prefix_sharing=True), dict(preemption=True)],
                         ids=["sharing", "preemption"])
def test_sharing_and_preemption_require_the_paged_layout(bad):
    jcfg, jp, tcfg, tp = _models("exact")
    kw = dict(PAGED, cache_layout="slots")
    kw.pop("block_size")
    with pytest.raises(ValueError, match="BlockPool") as jerr:
        JServeSession(jcfg, jp, **kw, **bad)
    with pytest.raises(ValueError, match="BlockPool") as terr:
        ServeSession(tcfg, tp, device="cpu", **kw, **bad)
    assert str(terr.value) == str(jerr.value)


def test_launcher_prefix_sharing_and_preemption(capsys):
    from repro_torch.launch.serve import main

    res = main(["--reduced", "--device", "cpu", "--prefix-sharing", "--preemption",
                "--num-blocks", "6", "--requests", "6", "--new", "6", "--prompt-len", "12",
                "--exec", "exact"])
    out = capsys.readouterr().out
    assert len(res) == 6 and "prefix-hit blocks" in out and "preemptions" in out
