"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a); without one they skip.  On
the card, run ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.multipliers import MULTIPLIERS, mul8x8_table
from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
from repro_torch.kernels.approx_mul_eltwise import approx_mul_eltwise, approx_mul_eltwise_plain
from repro_torch.kernels.paged_attention import (
    PagedAttentionShapeError,
    paged_attention,
    paged_attention_plain,
)
from repro_torch.kernels.paged_attention import ops as k2_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc for sm_90a)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("M,K,N", [(1, 33, 5), (4, 2048, 512), (13, 300, 77), (70, 1000, 130)])
@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_approx_matmul_kernel_equals_plain(dev, multiplier, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    a = torch.randint(0, 256, (M, K), generator=g, device=dev, dtype=torch.uint8)
    b = torch.randint(0, 256, (K, N), generator=g, device=dev, dtype=torch.uint8)
    before = approx_matmul.launches
    out = approx_matmul(a, b, multiplier=multiplier)
    torch.cuda.synchronize()
    assert approx_matmul.launches == before + 1
    assert torch.equal(out, approx_matmul_plain(a, b, multiplier=multiplier))


def _k1_case(dev, M, K, N, multiplier="mul8x8_2", rhs_max=255):
    g = torch.Generator(device=dev).manual_seed(M * 7919 + K * 31 + N)
    a = torch.randint(0, 256, (M, K), generator=g, device=dev, dtype=torch.uint8)
    b = torch.randint(0, rhs_max + 1, (K, N), generator=g, device=dev, dtype=torch.uint8)
    before = approx_matmul.launches
    out = approx_matmul(a, b, multiplier=multiplier, rhs_max=rhs_max)
    torch.cuda.synchronize()
    assert approx_matmul.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (M, N)
    assert torch.equal(out, approx_matmul_plain(a, b, multiplier=multiplier, rhs_max=rhs_max))


# the CNNs' im2col shapes: ragged K (LeNet's 5x5 convs on 1 and 3 channels,
# 3x3 on 3, 5x5 on 6), narrow N (6, 10, 16), and ResNet-19's stage-1 conv at
# batch 64 (M = 65,536) and its widest one (K = 4,608)
@pytest.mark.parametrize("M,K,N", [(50176, 25, 6), (65536, 75, 6), (6400, 150, 16),
                                   (65536, 27, 128), (64, 400, 120), (64, 84, 10),
                                   (256, 256, 10), (65536, 1152, 128), (1024, 4608, 512)])
@pytest.mark.parametrize("multiplier", ["mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm"])
def test_approx_matmul_kernel_cnn_im2col_shapes(dev, multiplier, M, K, N):
    _k1_case(dev, M, K, N, multiplier=multiplier)


def test_resnet19_kernel_forward_equals_lowrank(dev):
    """ResNet-19 at full width through K1 and through its plain version:
    bit-identical logits, 21 launches per forward."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.models.cnn import cnn_forward, init_cnn

    model = init_cnn("resnet19", 0, device=dev)
    x = torch.rand(16, 32, 32, 3, generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    with torch.no_grad():
        before = approx_matmul.launches
        k = cnn_forward(model, x, ApproxConfig(multiplier="mul8x8_2", mode="kernel"))
        assert approx_matmul.launches == before + 21
        ref = cnn_forward(model, x, ApproxConfig(multiplier="mul8x8_2", mode="lowrank"))
        assert approx_matmul.launches == before + 21
    assert k.shape == (16, 10) and torch.isfinite(k).all()
    assert torch.equal(k, ref)


@pytest.mark.parametrize("M", [1, 4, 16, 63, 64, 65, 512])
def test_approx_matmul_kernel_both_paths_ragged_k(dev, M):
    """M < 64 swaps the operands, M >= 64 does not; K = 1000 is a multiple
    of no tile (the wrapper pads it to 1008) and N = 300 of no block."""
    _k1_case(dev, M, 1000, 300)


@pytest.mark.parametrize("M", [4, 512])
def test_approx_matmul_kernel_lm_head_width(dev, M):
    _k1_case(dev, M, 2048, 49664)


@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_approx_matmul_kernel_rhs_max_31(dev, multiplier):
    """The co-optimized band: codes <= 31 under the pruned factorization."""
    _k1_case(dev, 70, 520, 200, multiplier, rhs_max=31)
    _k1_case(dev, 4, 520, 200, multiplier, rhs_max=31)


@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_approx_matmul_kernel_all_pairs_table_is_the_lut(dev, multiplier):
    codes = torch.arange(256, device=dev, dtype=torch.uint8)
    out = approx_matmul(codes[:, None], codes[None, :], multiplier=multiplier)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), torch.from_numpy(mul8x8_table(multiplier)).to(torch.int32))


def _k2_case(dev, B, W, bs, n_kv, g, hd, pool_dtype, seed):
    rng = np.random.default_rng(seed)
    nb = B * W + 1
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
    q = f(B, n_kv * g, hd)
    kn, vn, kp, vp = (x.to(pool_dtype) for x in (f(B, n_kv, hd), f(B, n_kv, hd),
                                                 f(nb, bs, n_kv, hd), f(nb, bs, n_kv, hd)))
    tbl = torch.as_tensor(rng.permutation(nb)[:B * W].reshape(B, W), dtype=torch.int32, device=dev)
    return q, kn, vn, kp, vp, tbl, nb


def _k2_check(args, bs, q_dtype, zero_rows=()):
    """One launch per call; within 1e-4 of the plain version (and, for a
    bf16 query, the output is that result rounded to bf16: within 1e-4 plus
    bf16's rounding); all-sentinel rows exactly 0; a second call (the
    counters reset) gives the same bits."""
    q = args[0].to(q_dtype)
    args = (q, *args[1:])
    before = paged_attention.launches
    out = paged_attention(*args, block_size=bs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.dtype == q_dtype and out.shape == q.shape
    ref = paged_attention_plain(*args, block_size=bs)
    err = (out.float() - ref).abs()
    slack = 1e-4 + (ref.abs() * 2.0 ** -8 if q_dtype == torch.bfloat16 else 0.0)
    assert (err <= slack).all(), err.max().item()
    if q_dtype == torch.bfloat16:        # the same values read as f32: 1e-4 outright
        out32 = paged_attention(q.float(), *args[1:], block_size=bs)
        assert (out32 - ref).abs().max().item() <= 1e-4
        assert torch.equal(out, out32.to(torch.bfloat16))
    for b in zero_rows:
        assert torch.equal(out[b], torch.zeros_like(out[b]))
    assert torch.equal(paged_attention(*args, block_size=bs), out)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,W,bs,n_kv,g,hd", [(4, 10, 16, 8, 4, 64), (3, 5, 4, 2, 2, 32),
                                              (2, 6, 1, 1, 3, 16), (4, 3, 8, 1, 2, 4)])
def test_paged_attention_kernel_within_1e4_of_plain(dev, B, W, bs, n_kv, g, hd, pool_dtype,
                                                    q_dtype):
    q, kn, vn, kp, vp, tbl, nb = _k2_case(dev, B, W, bs, n_kv, g, hd, pool_dtype, B * W)
    tbl[0, 1:] = nb                                   # row 0 holds one block
    tbl[-1, :] = nb                                   # last row holds none
    cur = torch.as_tensor(np.random.default_rng(B).integers(0, W * bs, B), dtype=torch.int32,
                          device=dev)
    cur[0] = bs - 1
    _k2_check((q, kn, vn, kp, vp, tbl, cur), bs, q_dtype, zero_rows=[B - 1])


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_attention_kernel_long_table_with_empty_later_chunks(dev, pool_dtype):
    """W = 256 (4,096 positions in blocks of 16): rows end early, so the
    later splits of their walk hold no valid position; one row runs past
    its table and one holds no block."""
    B, W, bs, n_kv, g, hd = 4, 256, 16, 8, 4, 64
    q, kn, vn, kp, vp, tbl, nb = _k2_case(dev, B, W, bs, n_kv, g, hd, pool_dtype, 7)
    cur = torch.as_tensor([37, 1500, W * bs + 3, 0], dtype=torch.int32, device=dev)
    tbl[3, :] = nb
    tbl[1, 40] = nb                                    # a hole
    splits, _ = k2_ops.split_plan(B, n_kv, W)
    assert splits > 1
    _k2_check((q, kn, vn, kp, vp, tbl, cur), bs, torch.bfloat16, zero_rows=[3])
    _k2_check((q, kn, vn, kp, vp, tbl, cur), bs, torch.float32, zero_rows=[3])


def test_paged_attention_kernel_refuses_what_it_does_not_take(dev):
    q, kn, vn, kp, vp, tbl, _ = _k2_case(dev, 2, 3, 4, 2, 2, 32, torch.float32, 0)
    cur = torch.zeros(2, dtype=torch.int32, device=dev)
    before = paged_attention.launches
    with pytest.raises(PagedAttentionShapeError, match="pool dtype"):
        paged_attention(q, kn.bfloat16(), vn, kp, vp, tbl, cur, block_size=4)
    with pytest.raises(PagedAttentionShapeError, match="pool dtype"):
        paged_attention(q, kn.half(), vn.half(), kp.half(), vp.half(), tbl, cur, block_size=4)
    assert paged_attention.launches == before


@pytest.mark.parametrize("multiplier", ["mul8x8_1", "mul8x8_2", "mul8x8_3"])
def test_approx_mul_eltwise_kernel_equals_plain_and_table_on_all_pairs(dev, multiplier):
    a = torch.arange(256, device=dev, dtype=torch.uint8).repeat_interleave(256)
    b = torch.arange(256, device=dev, dtype=torch.uint8).repeat(256)
    before = approx_mul_eltwise.launches
    out = approx_mul_eltwise(a, b, multiplier=multiplier)
    torch.cuda.synchronize()
    assert approx_mul_eltwise.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (65536,)
    assert torch.equal(out, approx_mul_eltwise_plain(a, b, multiplier))
    table = torch.from_numpy(mul8x8_table(multiplier).reshape(-1).copy()).to(dev)
    assert torch.equal(out, table)


@pytest.mark.parametrize("shape", [(1,), (3,), (1_000_003,), (2, 3, 5, 7), (64, 1, 129)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_approx_mul_eltwise_kernel_ragged_and_nd(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    a = torch.randint(0, 256, shape, generator=g, device=dev, dtype=dtype)
    b = torch.randint(0, 256, shape, generator=g, device=dev, dtype=dtype)
    out = approx_mul_eltwise(a, b, multiplier="mul8x8_3")
    torch.cuda.synchronize()
    assert out.shape == shape
    assert torch.equal(out, approx_mul_eltwise_plain(a, b, "mul8x8_3"))


def test_approx_mul_eltwise_kernel_takes_unaligned_views(dev):
    a = torch.randint(0, 256, (4099,), device=dev, dtype=torch.uint8)
    b = torch.randint(0, 256, (4099,), device=dev, dtype=torch.uint8)
    av, bv = a[1:4097], b[3:4099]               # 1 and 3 bytes past an aligned start
    out = approx_mul_eltwise(av, bv, multiplier="mul8x8_1")
    torch.cuda.synchronize()
    assert torch.equal(out, approx_mul_eltwise_plain(av, bv, "mul8x8_1"))
