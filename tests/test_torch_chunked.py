"""The port's chunked prefill against the JAX package's.

On the JAX tests' configuration (``tests/test_chunked_prefill.py``: the
reduced float model, a paged pool of 4-row blocks, buckets 4/8/16,
chunks of 4): every constructor and ``submit`` refusal has JAX's message;
a sentinel-tailed block table reads as the truncated context; the
per-chunk accounting (``prefills``, ``prefill_tokens``,
``prefill_chunks``) and each request's TTFT equal the JAX session's;
chunked sessions equal JAX's on both loops in every request's tokens,
ticks and TTFT and in the stats, and so does a chunked replay after forced
preemption.  Within the port, chunked sessions give the unchunked
session's tokens on both loops and both attention impls, and a prompt past
the largest bucket (only chunking admits it) gives ``generate``'s.

The chunk pass is held chunk by chunk against one
``paged_chunk_prefill_step`` over the whole prompt, not bitwise against
the fused ``forward`` (JAX's own test of that fails on this tree): the
per-position pass and ``forward`` agree to roundoff only.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import paged_decode_attention as jpaged_decode_attention
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.bridge import params_from_numpy
from repro_torch.models.attention import paged_decode_attention
from repro_torch.models.transformer import init_paged_cache, paged_chunk_prefill_step
from repro_torch.serve import ServeSession, generate
from test_torch_serve import _models as _build_models

CHUNKED = dict(num_slots=3, max_len=48, prompt_buckets=(4, 8, 16), cache_layout="paged",
               block_size=4)
FIELDS = ("ticks", "admitted", "completed", "generated_tokens", "admit_calls", "peak_active",
          "prefill_tokens", "prefill_chunks", "prefills", "work_ticks", "busy_slot_steps",
          "idle_slot_steps", "ttft_ticks", "latency_ticks", "max_decode_gap_ticks",
          "prefill_stall_ticks", "peak_blocks_in_use", "preemptions")


@functools.lru_cache(maxsize=None)
def _models():
    return _build_models("exact")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sessions(*, chunked=True, attn="gather", **over):
    """The JAX and the port's session; ``attn`` is the port's name
    ("kernel": K2's plain version, JAX's "pallas")."""
    jcfg, jp, tcfg, tp = _models()
    kw = dict(CHUNKED)
    if chunked:
        kw.update(chunked_prefill=True, prefill_chunk=4)
    kw.update(over)
    return (JServeSession(jcfg, jp, attn_impl="pallas" if attn == "kernel" else attn, **kw),
            ServeSession(tcfg, tp, attn_impl=attn, device="cpu", **kw))


def _trace(rng, n, vocab, *, plen=(2, 15), new=(1, 7), rate=1.0):
    """The JAX test's trace: (prompt, max_new, arrival), Poisson arrivals."""
    out, t = [], 0
    for _ in range(n):
        t += int(rng.poisson(rate))
        out.append((rng.integers(0, vocab, int(rng.integers(*plen))), int(rng.integers(*new)), t))
    return out


def _serve(sess, trace):
    for i, (p, n, t) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=t, req_id=i)
    res = sess.run(max_steps=5_000)
    assert sess.drained and sorted(res) == list(range(len(trace)))
    return res


def _assert_same(jsess, tsess, trace):
    jres, tres = _serve(jsess, trace), _serve(tsess, trace)
    for i in jres:
        j, t = jres[i], tres[i]
        assert t.tokens.tolist() == j.tokens.tolist(), i
        assert (t.finish_reason, t.admitted_tick, t.finished_tick, t.ttft) == \
            (j.finish_reason, j.admitted_tick, j.finished_tick, j.ttft), i
    for f in FIELDS:
        assert getattr(tsess.stats, f) == getattr(jsess.stats, f), f
    return tres


CTOR_REFUSALS = {
    "chunk_without_chunking": dict(prefill_chunk=4),
    "slots": dict(cache_layout="slots", chunked_prefill=True),
    "not_a_bucket": dict(chunked_prefill=True, prefill_chunk=5),
    "spec_decode": dict(chunked_prefill=True, spec_decode=True),
    "tiers": dict(chunked_prefill=True, tiers=("exact", "approx_lowrank")),
    "prefix_sharing": dict(chunked_prefill=True, prefix_sharing=True),
}


@pytest.mark.parametrize("case", sorted(CTOR_REFUSALS))
def test_chunked_constructor_refusals_match_jax(case):
    jcfg, jp, tcfg, tp = _models()
    kw = {**CHUNKED, **CTOR_REFUSALS[case]}
    if kw["cache_layout"] == "slots":
        kw.pop("block_size")
    with pytest.raises(ValueError) as jerr:
        JServeSession(jcfg, jp, **kw)
    with pytest.raises(ValueError) as terr:
        ServeSession(tcfg, tp, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_chunked_submit_matches_jax():
    """The default chunk is the largest bucket; unchunked, a prompt past
    it is refused as JAX refuses it; chunked, it is admitted and only the
    raw context binds."""
    jsess, tsess = _sessions(prefill_chunk=None)
    assert tsess.prefill_chunk == jsess.prefill_chunk == 16
    for chunked, n, rid in ((False, 2, 0), (True, 40, 1)):
        errs = []
        for sess in _sessions(chunked=chunked):
            with pytest.raises(ValueError, match=f"request {rid}") as e:
                sess.submit(np.arange(1, 20), max_new=n, req_id=rid)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for sess in _sessions():
        assert sess.submit(np.arange(1, 20), max_new=2, req_id=0) == 0


def test_sentinel_tail_table_reads_as_truncated_context():
    """Entries past the cursor's block are invisible: a sentinel-tailed
    table and the same table with its tail aimed at garbage-filled real
    blocks attend bit-identically (output and pool), for cursors mid-block
    and on a block boundary (chunk == block_size), through K2's plain
    version and the gather; and the port's tail output equals the JAX
    package's within f32 roundoff."""
    _, _, tcfg, _ = _models()
    rng = np.random.default_rng(3)
    d, hq, hkv, hd, bs, w, nb, b = 32, 2, 1, 16, 4, 6, 16, 2
    from repro.models.attention import init_attn

    jp = init_attn(jax.random.PRNGKey(1), d, hq, hkv, hd)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    kb = rng.standard_normal((nb + 1, bs, hkv, hd)).astype(np.float32)
    vb = rng.standard_normal((nb + 1, bs, hkv, hd)).astype(np.float32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    for cur in (2, bs, bs + 1, 2 * bs, 3 * bs - 1):
        need = cur // bs + 1                       # decode writes at position cur
        tail = np.full((b, w), nb, np.int32)
        real = np.full((b, w), nb, np.int32)
        for row in range(b):
            blocks = rng.choice(nb, size=w, replace=False)
            tail[row, :need] = blocks[:need]
            real[row] = blocks                     # the tail aims at garbage blocks
        outs = {}
        for impl in ("kernel", "gather"):
            for name, table in (("tail", tail), ("real", real)):
                k, v = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
                o = paged_decode_attention(
                    torch.from_numpy(x), tp, k, v, torch.from_numpy(table),
                    torch.full((b,), cur), block_size=bs, n_heads=hq, n_kv=hkv,
                    cfg=tcfg.approx, attn_impl=impl)
                outs[impl, name] = (o.numpy(), k[:nb].numpy(), v[:nb].numpy())
            for got, want in zip(outs[impl, "tail"], outs[impl, "real"]):
                assert np.array_equal(got, want), (impl, cur)
        jo, _ = jpaged_decode_attention(
            jnp.asarray(x), jp, jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(tail),
            jnp.full((b,), cur, jnp.int32), block_size=bs, n_heads=hq, n_kv=hkv,
            cfg=tcfg.approx, attn_impl="gather")
        for impl in ("kernel", "gather"):
            np.testing.assert_allclose(outs[impl, "tail"][0], np.asarray(jo), atol=1e-5)


def test_chunks_equal_one_pass_over_the_prompt():
    """Chunk by chunk, ``paged_chunk_prefill_step`` gives the logits and
    pool of one pass over the whole prompt, bit for bit, for block-edge and
    mid-block splits (the contract the chunked session rests on)."""
    _, _, tcfg, tp = _models()
    rng = np.random.default_rng(5)
    b, plen, bs, w, nb = 2, 13, 4, 8, 32
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (b, plen)))
    tables = torch.full((b, w), nb, dtype=torch.int32)
    need = -(-plen // bs)
    for row in range(b):
        tables[row, :need] = torch.arange(need) + row * need
    one = init_paged_cache(tcfg, nb, bs, device="cpu")
    with torch.no_grad():
        whole = paged_chunk_prefill_step(tcfg, tp, one, toks, torch.zeros(b, dtype=torch.long),
                                         tables, block_size=bs)
        for cuts in ((4,), (7,), (4, 8), (5, 6, 11)):
            cache = init_paged_cache(tcfg, nb, bs, device="cpu")
            parts, pos = [], 0
            for hi in (*cuts, plen):
                parts.append(paged_chunk_prefill_step(
                    tcfg, tp, cache, toks[:, pos:hi], torch.full((b,), pos), tables,
                    block_size=bs))
                pos = hi
            assert torch.equal(torch.cat(parts, dim=1), whole), cuts
            for n in ("k", "v"):
                assert torch.equal(cache[n][:, :nb], one[n][:, :nb]), cuts


def test_per_chunk_accounting_and_ttft_match_jax():
    """A 10-token prompt in chunks 4 + 4 + 2 (each at bucket 4) beside a
    one-shot 3-token prompt: ``prefill_chunks`` 3, ``prefills`` {4: 4},
    ``prefill_tokens`` 16, and one TTFT sample per request, as in JAX."""
    jcfg, _, _, _ = _models()
    rng = np.random.default_rng(0)
    trace = [(rng.integers(1, jcfg.vocab_size, 10), 3, 0),
             (rng.integers(1, jcfg.vocab_size, 3), 3, 0)]
    jsess, tsess = _sessions(loop="sync", num_slots=2)
    res = _assert_same(jsess, tsess, trace)
    st = tsess.stats
    assert st.prefill_chunks == 3 and st.prefills == {4: 4} and st.prefill_tokens == 16
    assert sorted(st.ttft_ticks) == sorted(r.ttft for r in res.values())
    assert all(r.ttft >= 0 for r in res.values()) and len(st.ttft_ticks) == 2


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_chunked_sessions_match_jax(loop):
    jcfg, _, _, _ = _models()
    trace = _trace(np.random.default_rng(9), 8, jcfg.vocab_size)
    jsess, tsess = _sessions(loop=loop, prefill_decode_ratio=2.0)
    _assert_same(jsess, tsess, trace)
    assert tsess.stats.prefill_chunks > 0


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("attn", ["gather", "kernel"])
def test_chunked_matches_unchunked(loop, attn):
    """Chunking is a scheduling change only: the unchunked session's
    tokens, on both loops and both attention impls."""
    _, _, tcfg, tp = _models()
    trace = _trace(np.random.default_rng(9), 8, tcfg.vocab_size)
    outs = {}
    for chunked in (False, True):
        kw = dict(CHUNKED, chunked_prefill=True, prefill_chunk=4) if chunked else CHUNKED
        sess = ServeSession(tcfg, tp, loop=loop, attn_impl=attn, prefill_decode_ratio=2.0,
                            device="cpu", **kw)
        outs[chunked] = {i: r.tokens.tolist() for i, r in _serve(sess, trace).items()}
        assert (sess.stats.prefill_chunks > 0) == chunked
    assert outs[False] == outs[True]


def test_beyond_bucket_prompts_match_generate():
    """Prompts past the largest bucket, which only chunking admits, give
    ``generate``'s tokens for each prompt alone, on both loops."""
    _, _, tcfg, tp = _models()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in (18, 23, 33)]
    alone = [generate(tcfg, tp, p[None], max_new=6, device="cpu")[0, len(p):].tolist()
             for p in prompts]
    for loop in ("sync", "async"):
        sess = ServeSession(tcfg, tp, loop=loop, num_blocks=40, chunked_prefill=True,
                            prefill_chunk=4, device="cpu", **CHUNKED)
        res = _serve(sess, [(p, 6, i) for i, p in enumerate(prompts)])
        assert [res[i].tokens.tolist() for i in range(len(prompts))] == alone, loop


@pytest.mark.parametrize("loop", ["sync", "async"])
def test_chunked_replay_after_forced_preemption_matches_jax(loop):
    """A starved pool evicts rows mid-flight; victims replay prompt +
    accepted tokens through the chunked path, as in the JAX session, and
    every request's tokens equal a roomy pool's run, with one TTFT sample
    each."""
    _, _, tcfg, _ = _models()
    rng = np.random.default_rng(12)
    trace = [(rng.integers(1, tcfg.vocab_size, n).astype(np.int32), 8, i)
             for i, n in enumerate((14, 13, 11, 6))]
    jsess, tsess = _sessions(loop=loop, num_slots=2, num_blocks=9, preemption=True)
    tres = _assert_same(jsess, tsess, trace)
    assert tsess.stats.preemptions >= 1 and len(tsess.stats.ttft_ticks) == len(trace)
    _, roomy = _sessions(loop=loop, num_slots=2, num_blocks=40, preemption=True)
    assert {i: r.tokens.tolist() for i, r in _serve(roomy, trace).items()} == \
        {i: r.tokens.tolist() for i, r in tres.items()}


def test_launcher_chunked_prefill(capsys):
    from repro_torch.launch.serve import main

    res = main(["--reduced", "--device", "cpu", "--chunked-prefill", "--prefill-chunk", "8",
                "--prompt-len", "20", "--requests", "4", "--new", "4"])
    out = capsys.readouterr().out
    assert len(res) == 4 and "chunked prefill: chunk 8" in out
    assert any(r.prompt.size > 8 for r in res.values()) and " 0 chunk rows" not in out
