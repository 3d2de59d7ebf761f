"""K2, paged decode attention, in the port against the JAX package.

The same numpy inputs go through the port's wrapper (its plain version on
the CPU), the JAX oracle ``paged_attention_ref`` and the JAX Pallas kernel
in interpret mode.  The plain version sums in another order than the
kernels' online softmax, so they agree to float32 roundoff: rtol/atol 1e-5.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_pallas, paged_attention_ref
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
    meta = [t.to("meta") for t in (q, kn, vn, kp, vp, tbl, cur)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*meta, block_size=4)


def test_kernel_shape_limits_raise_named_error():
    """What the CUDA kernel does not take is refused by name before any
    launch (checked here on meta tensors: no card needed)."""
    def args(B=2, H=4, n_kv=2, hd=32, bs=4, nb=5, dtype=torch.float32):
        q = torch.empty((B, H, hd), device="meta")
        pool = torch.empty((nb, bs, n_kv, hd), dtype=dtype, device="meta")
        return q, pool, bs

    k2_ops._check_kernel_shapes(*args())
    for bad in (dict(hd=256), dict(H=66, n_kv=1), dict(dtype=torch.bfloat16),
                dict(bs=256, hd=64)):
        with pytest.raises(PagedAttentionShapeError):
            k2_ops._check_kernel_shapes(*args(**bad))


def test_plain_version_is_the_wrappers_cpu_path():
    rng = np.random.default_rng(9)
    args = list(map(torch.from_numpy, _case(rng, 3, 4, 4, 2, 2, 32, holes=True)))
    before = paged_attention.launches
    assert torch.equal(paged_attention(*args, block_size=4),
                       paged_attention_plain(*args, block_size=4))
    assert paged_attention.launches == before
