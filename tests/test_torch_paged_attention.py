"""K2, paged decode attention, in the port against the JAX package.

The same numpy inputs go through the port's wrapper (its plain version on
the CPU), the JAX oracle ``paged_attention_ref`` and the JAX Pallas kernel
in interpret mode, with float32 and bfloat16 pools.  The plain version sums
in another order than the kernels' online softmax, so they agree to float32
roundoff: rtol/atol 1e-5.  A float emulation of the CUDA kernel's split
table walk and merge holds its algorithm to the plain version at the same
tolerance, on the plans the wrapper picks and on forced ones.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas, paged_attention_ref
from repro.kernels.paged_attention.kernel import paged_attention_kernel_call
from repro_torch.kernels.paged_attention import (
    PagedAttentionShapeError,
    paged_attention,
    paged_attention_plain,
)
from repro_torch.kernels.paged_attention import ops as k2_ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, B, W, bs, n_kv, g, hd, *, holes=False):
    """Random inputs as numpy: each row holds a random number of distinct
    blocks (possibly none: an all-sentinel row), its cur_len anywhere in its
    last block (offset 0 included); ``holes`` knocks an allocated middle
    block back to the sentinel."""
    H = n_kv * g
    nb = B * W + 1
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kn, vn, kp, vp = f(B, H, hd), f(B, n_kv, hd), f(B, n_kv, hd), f(nb, bs, n_kv, hd), f(nb, bs, n_kv, hd)
    tbl = np.full((B, W), nb, np.int32)
    cur = np.zeros((B,), np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        n_alloc = int(rng.integers(0, W + 1))
        tbl[b, :n_alloc] = [free.pop() for _ in range(n_alloc)]
        if n_alloc:
            cur[b] = int(rng.integers((n_alloc - 1) * bs, n_alloc * bs))
            if holes and n_alloc > 1:
                tbl[b, int(rng.integers(0, n_alloc - 1))] = nb
        else:
            cur[b] = int(rng.integers(0, W * bs))
    return [q, kn, vn, kp, vp, tbl, cur]


def _check(args, bs):
    port = paged_attention(*map(torch.from_numpy, args), block_size=bs).numpy()
    jargs = list(map(jnp.asarray, args))
    ref = np.asarray(paged_attention_ref(*jargs, block_size=bs))
    kern = np.asarray(paged_attention_pallas(*jargs, block_size=bs, interpret=True))
    assert port.shape == ref.shape == kern.shape
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(port, kern, **TOL)
    return port


# (B, W, block_size, Hkv, group, head_dim): the reduced model's shape, then
# block_size 1 and 8 with odd groups and small heads
_SHAPES = [(3, 4, 4, 2, 2, 32), (2, 3, 1, 1, 3, 16), (4, 2, 8, 2, 1, 4)]


@pytest.mark.parametrize("holes", [False, True], ids=["dense", "holes"])
@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_ref_and_kernel(shape, holes, seed):
    rng = np.random.default_rng(seed)
    B, W, bs, n_kv, g, hd = shape
    _check(_case(rng, B, W, bs, n_kv, g, hd, holes=holes), bs)


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_all_sentinel_rows_are_exact_zero(shape):
    rng = np.random.default_rng(5)
    B, W, bs, n_kv, g, hd = shape
    args = _case(rng, B, W, bs, n_kv, g, hd)
    args[5][1:] = args[3].shape[0]                    # rows 1.. hold no block
    out = _check(args, bs)
    assert np.array_equal(out[1:], np.zeros_like(out[1:]))


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cur_len_on_block_boundary_and_past_table(shape):
    rng = np.random.default_rng(6)
    B, W, bs, n_kv, g, hd = shape
    args = _case(rng, B, W, bs, n_kv, g, hd)
    args[5] = rng.permutation(args[3].shape[0])[:B * W].reshape(B, W).astype(np.int32)
    args[6] = (bs * rng.integers(0, W, B)).astype(np.int32)         # offset 0 of a block
    _check(args, bs)
    args[6] = (W * bs + rng.integers(0, bs + 1, B)).astype(np.int32)  # beyond the table
    assert np.isfinite(_check(args, bs)).all()


def _shared_case(rng, B, W, bs, n_kv, g, hd):
    """Rows whose tables name the same W - 1 leading physical blocks (a
    shared prompt prefix) and a tail block each, with cur_len at a random
    offset of each row's tail."""
    args = _case(rng, B, W, bs, n_kv, g, hd)
    perm = rng.permutation(args[3].shape[0])
    tbl = np.empty((B, W), np.int32)
    tbl[:, :W - 1] = perm[:W - 1]
    tbl[:, W - 1] = perm[W - 1:W - 1 + B]
    args[5] = tbl
    args[6] = ((W - 1) * bs + rng.integers(0, bs, B)).astype(np.int32)
    return args


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rows_sharing_leading_blocks(shape):
    """Prefix sharing: rows attend the same physical leading blocks through
    their own tables, and a decode step through K2's route (its plain
    version here) writes only each row's cur_len slot — the shared blocks'
    bytes are unchanged, as the gather's step leaves them."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.models.attention import paged_decode_attention

    rng = np.random.default_rng(7)
    B, W, bs, n_kv, g, hd = shape
    args = _shared_case(rng, B, W, bs, n_kv, g, hd)
    _check(args, bs)
    H, d, nb = n_kv * g, 16, args[3].shape[0]
    w = lambda *s: torch.from_numpy((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
    p = {"wq": w(d, H * hd), "wk": w(d, n_kv * hd), "wv": w(d, n_kv * hd), "wo": w(H * hd, d)}
    x = torch.from_numpy(rng.normal(size=(B, 1, d)).astype(np.float32))
    trash = np.zeros((1,) + args[3].shape[1:], np.float32)
    pools = {impl: [torch.from_numpy(np.concatenate([a, trash])) for a in args[3:5]]
             for impl in ("kernel", "gather")}
    tbl, cur = torch.from_numpy(args[5]), torch.from_numpy(args[6])
    outs = {impl: paged_decode_attention(x, p, *pools[impl], tbl, cur, block_size=bs,
                                         n_heads=H, n_kv=n_kv, cfg=ApproxConfig(mode="float"),
                                         attn_impl=impl)
            for impl in pools}
    np.testing.assert_allclose(outs["kernel"].numpy(), outs["gather"].numpy(), **TOL)
    written = np.zeros((nb + 1, bs), bool)
    written[args[5][:, W - 1], args[6] % bs] = True
    for before, k_after, g_after in zip(args[3:5], *pools.values()):
        assert torch.equal(k_after, g_after)
        changed = (k_after[:nb].numpy() != before).any(axis=(2, 3))
        assert np.array_equal(changed, written[:nb])     # each row's slot, nothing else
        assert not changed[args[5][0, :W - 1]].any()     # the shared blocks


def test_wrapper_validates_like_jax():
    rng = np.random.default_rng(0)
    q, kn, vn, kp, vp, tbl, cur = map(torch.from_numpy, _case(rng, 2, 2, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(q, kn, vn, kp, vp, tbl, cur, block_size=8)
    with pytest.raises(ValueError, match="new-token"):
        paged_attention(q, kn[:1], vn, kp, vp, tbl, cur, block_size=4)
    with pytest.raises(ValueError, match="batch"):
        paged_attention(q, kn, vn, kp, vp, tbl[:1], cur, block_size=4)
    with pytest.raises(ValueError, match="incompatible"):
        paged_attention(q[:, :3], kn, vn, kp, vp, tbl, cur, block_size=4)
    # all on meta: shape inference (an empty output, no launch); a meta
    # operand beside CPU ones is not quietly computed by the plain version
    meta = [t.to("meta") for t in (q, kn, vn, kp, vp, tbl, cur)]
    n0 = paged_attention.launches
    out = paged_attention(*meta, block_size=4)
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype, "meta")
    assert paged_attention.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(meta[0], kn, vn, kp, vp, tbl, cur, block_size=4)


def test_kernel_shape_limits_raise_named_error():
    """What the CUDA kernel does not take is refused by name before any
    launch (the wrapper's check, called with shapes only: no card needed)."""
    def check(H=4, n_kv=2, hd=32, bs=4, dtype=torch.float32, q_dtype=torch.float32):
        k2_ops._check(q_dtype, dtype, H, hd, n_kv, bs)

    check()
    check(dtype=torch.bfloat16, q_dtype=torch.bfloat16)   # bf16 pools and queries are taken
    for bad in (dict(hd=256), dict(hd=30), dict(H=66, n_kv=1), dict(dtype=torch.float16),
                dict(q_dtype=torch.float16), dict(bs=256, hd=64)):
        with pytest.raises(PagedAttentionShapeError):
            check(**bad)


def test_plain_version_is_the_wrappers_cpu_path():
    rng = np.random.default_rng(9)
    args = list(map(torch.from_numpy, _case(rng, 3, 4, 4, 2, 2, 32, holes=True)))
    before = paged_attention.launches
    assert torch.equal(paged_attention(*args, block_size=4),
                       paged_attention_plain(*args, block_size=4))
    assert paged_attention.launches == before


# ---------------------------------------------------------------------------
# bf16 pools: the port and the JAX package read the same rounded values
# ---------------------------------------------------------------------------


def _bf16_pool(args):
    """Round the pools and the new token's K/V to bf16 (the pool dtype);
    q stays float32.  Returns the torch operands and the numpy float32
    copies of the same (exactly representable) values."""
    t = [torch.from_numpy(a) for a in args]
    for i in (1, 2, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    return t, [x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy() for x in t]


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_pool_matches_jax_kernel_and_ref(shape, seed):
    rng = np.random.default_rng(10 + seed)
    B, W, bs, n_kv, g, hd = shape
    targs, nargs = _bf16_pool(_case(rng, B, W, bs, n_kv, g, hd, holes=bool(seed)))
    port = paged_attention(*targs, block_size=bs)
    assert port.dtype == torch.float32 and targs[3].dtype == torch.bfloat16
    jargs = [jnp.asarray(x) for x in nargs]
    for i in (1, 2, 3, 4):
        jargs[i] = jargs[i].astype(jnp.bfloat16)       # exact: the values are bf16
    ref = np.asarray(paged_attention_ref(*jargs, block_size=bs))
    kern = np.asarray(paged_attention_kernel_call(*jargs, block_size=bs, interpret=True))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), kern, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the CUDA kernel's split walk and merge, emulated in float32
# ---------------------------------------------------------------------------

_NEG = -1e30


def _emulate_split_walk(q, kn, vn, kp, vp, tbl, cur, bs, splits, chunk, R):
    """What paged_attention.cu computes, step for step: each (row, KV head,
    split) compacts its chunk's held blocks, walks them R at a time with an
    online softmax over the valid prefix of positions, and writes (m, l,
    acc); the merge weighs the splits with l > 0 by e^{m_s - M}."""
    B, H, hd = q.shape
    nb, _, n_kv, _ = kp.shape
    g, W = H // n_kv, tbl.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    out = torch.zeros((B, H, hd))
    for b in range(B):
        c = int(cur[b])
        for h in range(n_kv):
            qs = q[b, h * g:(h + 1) * g].float() * scale
            parts = []
            for s in range(splits):
                held = [(w, int(tbl[b, w])) for w in range(s * chunk, min(W, (s + 1) * chunk))
                        if 0 <= int(tbl[b, w]) < nb and w * bs <= c]
                if not held:
                    parts.append((torch.full((g,), _NEG), torch.zeros(g), None))
                    continue
                m, l, acc = torch.full((g,), _NEG), torch.zeros(g), torch.zeros(g, hd)
                for r0 in range(0, len(held), R):
                    ks, vs = [], []
                    for w, e in held[r0:r0 + R]:
                        rows = min(bs, c - w * bs + 1)
                        K, V = kp[e, :rows, h].float().clone(), vp[e, :rows, h].float().clone()
                        if w == c // bs:
                            K[c % bs], V[c % bs] = kn[b, h].float(), vn[b, h].float()
                        ks.append(K)
                        vs.append(V)
                    K, V = torch.cat(ks), torch.cat(vs)
                    sc = qs @ K.T
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    acc = acc * alpha[:, None] + p @ V
                    l = l * alpha + p.sum(dim=1)
                    m = m_new
                parts.append((m, l, acc))
            ms = torch.stack([pm for pm, _, _ in parts])
            ls = torch.stack([pl for _, pl, _ in parts])
            M = torch.where(ls > 0, ms, torch.full_like(ms, _NEG)).max(dim=0).values
            wts = torch.where(ls > 0, torch.exp(ms - M), torch.zeros_like(ms))
            num = sum(wts[k][:, None] * a for k, (_, _, a) in enumerate(parts) if a is not None)
            den = (wts * ls).sum(dim=0)
            if isinstance(num, torch.Tensor):
                out[b, h * g:(h + 1) * g] = torch.where(den[:, None] > 0, num / den[:, None], 0.0)
    return out


def _plans(B, n_kv, W, bs, hd):
    """The wrapper's plan and forced ones: several blocks per split walked
    in rounds of one and of two."""
    splits, chunk = k2_ops.split_plan(B, n_kv, W)
    R, _ = k2_ops._ring(chunk, bs, hd, 4)
    plans = [(splits, chunk, R)]
    for ch, r in ((2, 1), (3, 2), (W, 1)):
        plans.append((math.ceil(W / ch), ch, r))
    return plans


def _check_emulation(args, bs, zero_rows=()):
    t = [torch.from_numpy(a) for a in args]
    B, W = t[5].shape
    ref = paged_attention_plain(*t, block_size=bs)
    for splits, chunk, R in _plans(B, t[3].shape[2], W, bs, t[0].shape[2]):
        got = _emulate_split_walk(*t, bs, splits, chunk, R)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"splits {splits} chunk {chunk} R {R}")
        for b in zero_rows:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_walk_emulation_with_empty_chunks_and_holes(shape):
    """Rows hold fewer blocks than the table is wide, so later chunks hold
    no valid position; holes knock middle blocks out."""
    rng = np.random.default_rng(21)
    B, W, bs, n_kv, g, hd = shape
    _check_emulation(_case(rng, B, W, bs, n_kv, g, hd, holes=True), bs)
    _check_emulation(_case(rng, B, W, bs, n_kv, g, hd), bs)


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_walk_emulation_all_sentinel_rows(shape):
    rng = np.random.default_rng(22)
    B, W, bs, n_kv, g, hd = shape
    args = _case(rng, B, W, bs, n_kv, g, hd)
    args[5][1:] = args[3].shape[0]
    _check_emulation(args, bs, zero_rows=range(1, B))


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_walk_emulation_cur_len_on_chunk_boundary_and_past_table(shape):
    """cur_len at the first position of a chunk (so that chunk holds only
    the new token), then past the table (every allocated block is full)."""
    rng = np.random.default_rng(23)
    B, W, bs, n_kv, g, hd = shape
    args = _case(rng, B, W, bs, n_kv, g, hd)
    args[5] = rng.permutation(args[3].shape[0])[:B * W].reshape(B, W).astype(np.int32)
    for chunk in (1, 2, 3):
        args[6] = (chunk * bs * rng.integers(0, math.ceil(W / chunk), B)).astype(np.int32)
        _check_emulation(args, bs)
    args[6] = (W * bs + rng.integers(0, bs + 1, B)).astype(np.int32)
    _check_emulation(args, bs)


def test_split_plan_fills_the_card_from_the_grid_shape_alone():
    # the served decode step: 4 rows x 8 KV heads, 10 table entries
    splits, chunk = k2_ops.split_plan(4, 8, 10)
    assert splits * chunk >= 10 and (splits - 1) * chunk < 10
    assert 4 * 8 * splits >= 2 * 132
    # 4,096 positions in blocks of 16: W = 256
    splits, chunk = k2_ops.split_plan(4, 8, 256)
    assert 4 * 8 * splits >= 2 * 132 and splits * chunk >= 256
    R, nslot = k2_ops._ring(chunk, 16, 64, 4)
    assert 1 <= R <= chunk and nslot <= 2 * R
    smem = k2_ops._smem_bytes(4, 64, 16, 4, R, nslot, splits, chunk)
    assert smem <= k2_ops._RING_BUDGET + 16 * 1024
    # a wide batch needs no split; a table wider than the split cap is chunked
    assert k2_ops.split_plan(64, 8, 10) == (2, 5)
    assert k2_ops.split_plan(1, 1, 10_000)[0] <= k2_ops._MAX_SPLITS
