"""The port's ServeSession against the JAX package's, and the port's own
sampling contract.

Greedy tokens are the cross-framework contract: on one seeded trace the
port's session (paged, sync, ``approx``, ``attn_impl="kernel"``, so the
plain versions on the CPU) must give every request the same tokens, at the
same ticks, as the JAX session (paged, sync, ``approx``,
``attn_impl="pallas"``, the kernels in interpret mode).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import transformer as jT
from repro.serve.engine import SamplingConfig as JSampling
from repro.serve.engine import freeze_params as jfreeze
from repro.serve.engine import resolve_execution_mode as jresolve
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.serve import (
    BlockPool,
    PromptBuckets,
    SamplingConfig,
    ServeSession,
    resolve_execution_mode,
    scatter_prompt_blocks,
    select_token,
)
from repro_torch.serve.engine import philox_uniform


def _models(mode, per_row=False):
    jcfg = dataclasses.replace(jreduced(jget_config("granite-3-2b")), q_chunk=16,
                               approx=jresolve(mode, act_per_row=per_row))
    tcfg = dataclasses.replace(reduced_config(get_config("granite-3-2b")),
                               approx=resolve_execution_mode(mode, act_per_row=per_row))
    jp = jfreeze(jcfg, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _trace(seed, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, int(rng.integers(2, 9))), int(rng.integers(1, 7)),
             int(rng.integers(0, 4)), int(rng.integers(0, 3))) for _ in range(n)]


KW = dict(num_slots=3, max_len=32, prompt_buckets=(4, 8), block_size=4)


def _run(sess, trace):
    for i, (p, n, arrival, prio) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=arrival, priority=prio, req_id=i)
    return sess.run(max_steps=1000)


def _assert_same_results(jres, tres, trace):
    assert sorted(jres) == sorted(tres) == list(range(len(trace)))
    for i in range(len(trace)):
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.admitted_tick, t.finished_tick, t.finish_reason, t.ttft) == \
            (j.admitted_tick, j.finished_tick, j.finish_reason, j.ttft), i


def test_greedy_tokens_match_jax_session_approx_kernels():
    jcfg, jp, tcfg, tp = _models("approx")
    trace = _trace(3)
    jsess = JServeSession(jcfg, jp, cache_layout="paged", loop="sync", attn_impl="pallas",
                          policy="fifo", **KW)
    tsess = ServeSession(tcfg, tp, attn_impl="kernel", policy="fifo", loop="sync",
                         device="cpu", **KW)
    _assert_same_results(_run(jsess, trace), _run(tsess, trace), trace)
    for f in ("ticks", "admitted", "completed", "generated_tokens", "admit_calls",
              "peak_active", "peak_blocks_in_use", "prefill_tokens", "busy_slot_steps"):
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    assert tsess.stats.peak_blocks_in_use > 0


def test_bf16_cache_dtype_session_runs_clean():
    """A bf16 paged pool (``cache_dtype``, as the JAX session's): decode
    attends the pool-rounded fused token through K2's CPU route.  Token
    parity with a float32 pool is not a contract (the pool rounds K/V), so
    this pins shapes, token ranges and a clean pool, as the JAX package's
    own bf16-pool test does."""
    _, _, tcfg, tp = _models("approx")
    assert ServeSession(tcfg, tp, device="cpu", **KW).cache["k"].dtype == torch.float32
    sess = ServeSession(tcfg, tp, attn_impl="kernel", cache_dtype=torch.bfloat16,
                        device="cpu", **dict(KW, num_slots=2))
    assert sess.cache["k"].dtype == sess.cache["v"].dtype == torch.bfloat16
    ids = [sess.submit(np.arange(1, 4 + i, dtype=np.int32), max_new=3) for i in range(3)]
    res = sess.run(max_steps=10_000)
    for rid in ids:
        toks = res[rid].tokens
        assert toks.shape == (3,)
        assert 0 <= int(toks.min()) and int(toks.max()) < tcfg.vocab_size
    assert sess.blocks.free_count == sess.num_blocks and sess.blocks.busy_count == 0
    assert sess._reserved_total == 0 and (sess._future == 0).all()
    assert (sess._tables == sess.num_blocks).all() and all(not h for h in sess._held)
    assert sess.cache["k"].abs().sum() > 0            # the pool was written


@pytest.mark.parametrize("policy", ["priority", "sjf"])
def test_admission_policies_and_eos_match_jax(policy):
    """Float execution with the gather oracle, an eos id and an undersized
    block pool, so admission waits on the worst-case reservation."""
    jcfg, jp, tcfg, tp = _models("exact")
    trace = _trace(5, n=7)
    kw = dict(KW, num_blocks=8)
    free_run = _run(ServeSession(tcfg, tp, attn_impl="gather", policy=policy, device="cpu",
                                 **kw), trace)
    eos = int(next(r.tokens[1] for r in free_run.values() if len(r.tokens) > 2))
    jsess = JServeSession(jcfg, jp, cache_layout="paged", loop="sync", attn_impl="gather",
                          policy=policy, sampling=JSampling(eos_id=eos), **kw)
    tsess = ServeSession(tcfg, tp, attn_impl="gather", policy=policy, loop="sync",
                         sampling=SamplingConfig(eos_id=eos), device="cpu", **kw)
    tres = _run(tsess, trace)
    _assert_same_results(_run(jsess, trace), tres, trace)
    assert any(r.finish_reason == "eos" for r in tres.values())
    assert tsess.stats.peak_blocks_in_use <= 8


def test_temperature_tokens_do_not_depend_on_the_slot():
    """The port's positional Philox schedule: a request's sampled tokens
    depend on (seed, request id, position, its logits) only.  Per-row
    activation scales make its logits independent of its batch mates."""
    _, _, tcfg, tp = _models("approx", per_row=True)
    samp = SamplingConfig(temperature=0.9, top_k=50)
    prompt = np.arange(5, 11)
    alone = ServeSession(tcfg, tp, sampling=samp, seed=7, device="cpu", **KW)
    alone.submit(prompt, max_new=6, req_id=42)
    want = alone.run()[42].tokens.tolist()
    busy = ServeSession(tcfg, tp, sampling=samp, seed=7, device="cpu", **KW)
    busy.submit(np.arange(100, 108), max_new=3, req_id=1)     # takes slot 0
    busy.submit(np.arange(200, 203), max_new=2, req_id=2)     # takes slot 1
    busy.submit(prompt, max_new=6, req_id=42, arrival=1)      # lands in another slot
    res = busy.run()
    assert res[42].tokens.tolist() == want
    other = ServeSession(tcfg, tp, sampling=samp, seed=8, device="cpu", **KW)
    other.submit(prompt, max_new=6, req_id=42)
    assert other.run()[42].tokens.tolist() != want            # the seed matters


def test_philox_known_answer_and_range():
    zero = torch.zeros((1,), dtype=torch.int64)
    u = philox_uniform(zero, zero, zero, zero)
    # Philox4x32-10 of key (0, 0), counter (0, 0, 0, 0): first word 0x6627e8d5
    assert u.item() == (0x6627E8D5 + 0.5) / 2**32
    u = philox_uniform(torch.tensor([3]), torch.tensor([9]), torch.arange(4)[:, None],
                       torch.arange(1000)[None, :])
    assert u.shape == (4, 1000) and (u > 0).all() and (u < 1).all()
    assert u.unique().numel() == u.numel()


def test_greedy_select_takes_first_index_on_ties():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [3, 9]] = 2.0
    logits[1, [0, 15]] = -1.0
    logits[2, :] = 5.0
    got = select_token(torch.from_numpy(logits), SamplingConfig()).tolist()
    assert got == np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1)).tolist() == [3, 1, 0]


def test_scatter_prompt_blocks_pads_bucket_and_drops_sentinels():
    from repro.serve.cache import scatter_prompt_blocks as jscatter

    rng = np.random.default_rng(0)
    L, A, S, hkv, hd, bs, nb = 2, 3, 6, 2, 4, 4, 7           # bucket 6 -> 2 blocks of 4
    k = rng.normal(size=(L, A, S, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(L, A, S, hkv, hd)).astype(np.float32)
    ids = np.asarray([[4, 1], [0, nb], [nb, nb]], np.int32)   # partial row, padding row
    pool = rng.normal(size=(L, nb, bs, hkv, hd)).astype(np.float32)
    jc = jscatter({"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
                  (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(ids), bs)
    tc = {"k": torch.from_numpy(np.concatenate([pool, pool[:, :1]], 1)),
          "v": torch.from_numpy(np.concatenate([pool, pool[:, :1]], 1))}
    scatter_prompt_blocks(tc, (torch.from_numpy(k), torch.from_numpy(v)),
                          torch.from_numpy(ids), bs)
    np.testing.assert_array_equal(tc["k"][:, :nb].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(tc["v"][:, :nb].numpy(), np.asarray(jc["v"]))
    np.testing.assert_array_equal(tc["k"][:, 1, 2:].numpy(), 0.0)   # the pad of the bucket


def test_pools_hand_out_lowest_first_and_release_atomically():
    pool = BlockPool(4)
    assert [pool.acquire() for _ in range(3)] == [0, 1, 2]
    pool.release(1)
    assert pool.acquire() == 1 and pool.busy_count == 3
    with pytest.raises(ValueError, match="block 3: batch releases 1 refs but only 0 held"):
        pool.release_many([0, 3])               # 3 is free: nothing is released
    assert pool.free_count == 1
    pool.release_many([2, 0])
    assert pool.free_count == 3 and pool.acquire() == 0
    with pytest.raises(ValueError, match="out of range"):
        pool.release(4)
    buckets = PromptBuckets((16, 4, 8))
    assert buckets.sizes == (4, 8, 16) and buckets.bucket(5) == 8
    assert buckets.pad(np.arange(3) + 1, pad_id=9).tolist() == [[1, 2, 3, 9]]
    with pytest.raises(ValueError, match="exceeds"):
        buckets.bucket(17)
