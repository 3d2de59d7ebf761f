"""The port's multi-token paged pass against the JAX package's, and against
the port's own sequential decode.

``paged_verify_step`` scores S consecutive tokens per row in one pass;
``paged_chunk_prefill_step`` is the same pass over one chunk of a prompt.
Against the JAX package (its weights through the bridge, the same pools,
tables and tokens) the logits agree to atol 1e-4 and the pool to 1e-5, the
tolerances of ``test_torch_model.py``.  Within the port, under per-row
activation scales, the pass is bit-identical to S sequential
``paged_decode_step(attn_impl="gather")`` calls, and N chunks to one pass
over the whole prompt (the JAX package's chunks are held chunk by chunk:
its own chunked-vs-fused pin is red, see ROADMAP section 3).
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro_torch.models import transformer as T
from test_torch_model import ATOL, _pair

CACHE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the other serving tests: parallel workers
    each spinning PyTorch's full thread pool slow the CPU steps down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pools(rng, cfg, nb, bs):
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
    return rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32)


def _verify_inputs(rng, cfg, S, B=3, W=4, bs=4):
    """Random pools; row 0 with a sentinel tail past its positions, row 1
    on a block boundary, row 2 running off the end of its table mid-pass.
    (No hole below a row's positions: the JAX gather attends a sentinel
    block's clamped stand-in where K2 and its plain version skip it, and a
    session's tables never have one.)"""
    nb = B * W + 2
    k, v = _pools(rng, cfg, nb, bs)
    perm = rng.permutation(nb)
    tbl = np.full((B, W), nb, np.int32)
    tbl[0, :3] = perm[:3]
    tbl[1, :] = perm[3:3 + W]
    tbl[2, :] = perm[3 + W:3 + 2 * W]
    cur = np.asarray([bs + 1, 2 * bs, W * bs - 2], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return k, v, tbl, cur, toks, bs


def _torch_cache(tcfg, k, v, bs):
    cache = T.init_paged_cache(tcfg, k.shape[1], bs, device="cpu")
    cache["k"][:, :-1] = torch.from_numpy(k)
    cache["v"][:, :-1] = torch.from_numpy(v)
    return cache


def _jax_step(jfn, jcfg, jp, k, v, toks, cur, tbl, bs):
    jfn = jax.jit(jfn, static_argnames=("cfg", "block_size"))
    jl, jc = jfn(jcfg, jp, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                 {"tokens": jnp.asarray(toks)}, jnp.asarray(cur), jnp.asarray(tbl),
                 block_size=bs)
    return np.asarray(jl), np.asarray(jc["k"]), np.asarray(jc["v"])


@pytest.mark.parametrize("mode,per_row", [("exact", False), ("approx", False), ("approx", True)],
                         ids=["exact", "approx-per_tensor", "approx-per_row"])
def test_paged_verify_step_matches_jax(mode, per_row):
    jcfg, jp, tcfg, tp = _pair(mode, per_row=per_row)
    k, v, tbl, cur, toks, bs = _verify_inputs(np.random.default_rng(3), tcfg, S=5)
    jl, jk, jv = _jax_step(jT.paged_verify_step, jcfg, jp, k, v, toks, cur, tbl, bs)
    cache = _torch_cache(tcfg, k, v, bs)
    tl = T.paged_verify_step(tcfg, tp, cache, torch.from_numpy(toks), torch.from_numpy(cur),
                             torch.from_numpy(tbl), block_size=bs)
    assert tl.shape == (3, 5, tcfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)
    # JAX drops the writes through the hole and past row 2's table; the
    # port sends them to the trash block, which nothing reads
    np.testing.assert_allclose(cache["k"][:, :-1].numpy(), jk, rtol=0, atol=CACHE_ATOL)
    np.testing.assert_allclose(cache["v"][:, :-1].numpy(), jv, rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("mode", ["approx", "exact_quant"])
def test_verify_equals_sequential_gather_decode_bitwise(mode):
    """Per-row scales: S decode steps, each teacher-forced with the next
    token, give the verify pass's logits and pool bit for bit."""
    _, _, tcfg, tp = _pair(mode, per_row=True)
    S = 4
    k, v, tbl, cur, toks, bs = _verify_inputs(np.random.default_rng(5), tcfg, S=S)
    one = _torch_cache(tcfg, k, v, bs)
    seq = _torch_cache(tcfg, k, v, bs)
    tbl_t, cur_t, toks_t = (torch.from_numpy(a) for a in (tbl, cur, toks))
    lv = T.paged_verify_step(tcfg, tp, one, toks_t, cur_t, tbl_t, block_size=bs)
    ls = torch.cat([T.paged_decode_step(tcfg, tp, seq, toks_t[:, j:j + 1], cur_t + j, tbl_t,
                                        block_size=bs, attn_impl="gather")
                    for j in range(S)], dim=1)
    assert torch.equal(lv, ls)
    assert torch.equal(one["k"][:, :-1], seq["k"][:, :-1])
    assert torch.equal(one["v"][:, :-1], seq["v"][:, :-1])


@pytest.mark.parametrize("cuts", [(4,), (5,), (4, 8), (3, 6, 11)],
                         ids=["edge", "mid", "two-edges", "three-mid"])
def test_chunk_prefill_matches_jax_chunk_by_chunk(cuts):
    """A 13-token prompt per row in chunks through a sentinel-tailed table
    (blocks acquired only as far as the chunks reach): each chunk's logits
    and the pool after it against JAX ``paged_chunk_prefill_step`` on the
    same pool; the chunks together bit-equal one verify pass."""
    jcfg, jp, tcfg, tp = _pair("approx", per_row=True)
    rng = np.random.default_rng(7)
    B, plen, bs, W, nb = 2, 13, 4, 8, 32
    toks = rng.integers(0, tcfg.vocab_size, (B, plen)).astype(np.int32)
    k, v = _pools(rng, tcfg, nb, bs)
    full = np.full((B, W), nb, np.int32)
    need = -(-plen // bs)
    for row in range(B):
        full[row, :need] = np.arange(need) + row * need
    jk, jv = k, v
    cache = _torch_cache(tcfg, k, v, bs)
    parts, pos = [], 0
    for hi in (*cuts, plen):
        tbl = np.where(np.arange(W)[None, :] < -(-hi // bs), full, nb).astype(np.int32)
        chunk = toks[:, pos:hi]
        at = np.full((B,), pos, np.int32)
        jl, jk, jv = _jax_step(jT.paged_chunk_prefill_step, jcfg, jp, jk, jv, chunk, at, tbl, bs)
        tl = T.paged_chunk_prefill_step(tcfg, tp, cache, torch.from_numpy(chunk),
                                        torch.from_numpy(at), torch.from_numpy(tbl),
                                        block_size=bs)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)
        np.testing.assert_allclose(cache["k"][:, :-1].numpy(), jk, rtol=0, atol=CACHE_ATOL)
        np.testing.assert_allclose(cache["v"][:, :-1].numpy(), jv, rtol=0, atol=CACHE_ATOL)
        jk, jv = cache["k"][:, :-1].numpy(), cache["v"][:, :-1].numpy()
        parts.append(tl)
        pos = hi
    one = _torch_cache(tcfg, k, v, bs)
    lv = T.paged_verify_step(tcfg, tp, one, torch.from_numpy(toks),
                             torch.zeros((B,), dtype=torch.int32), torch.from_numpy(full),
                             block_size=bs)
    assert torch.equal(torch.cat(parts, dim=1), lv)
    assert torch.equal(cache["k"][:, :-1], one["k"][:, :-1])
    assert torch.equal(cache["v"][:, :-1], one["v"][:, :-1])


def test_verify_family_gates():
    _, _, tcfg, tp = _pair("exact")
    args = (tp, {}, torch.zeros((1, 2), dtype=torch.int64), torch.zeros((1,)),
            torch.zeros((1, 1), dtype=torch.int32))
    moe = types.SimpleNamespace(**{**vars(tcfg), "family": "moe"})
    for fn in (T.paged_verify_step, T.paged_chunk_prefill_step):
        with pytest.raises(NotImplementedError, match="capacity-coupled"):
            fn(moe, *args, block_size=4)
    # ssm and hybrid: the real reduced configs, with the JAX package's message
    from repro.configs import get_config as jget_config
    from repro.configs import reduced_config as jreduced
    from repro_torch.configs import get_config, reduced_config

    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        with pytest.raises(NotImplementedError) as jerr:
            jT.paged_verify_step(jreduced(jget_config(arch)), {}, {},
                                 {"tokens": jnp.zeros((1, 2), jnp.int32)},
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1), jnp.int32),
                                 block_size=4)
        with pytest.raises(NotImplementedError) as terr:
            T.paged_verify_step(reduced_config(get_config(arch)), *args, block_size=4)
        assert str(terr.value) == str(jerr.value)
