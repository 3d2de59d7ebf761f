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
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

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


@pytest.mark.parametrize("B,W,bs,n_kv,g,hd", [(4, 10, 16, 8, 4, 64), (3, 5, 4, 2, 2, 32),
                                              (2, 6, 1, 1, 3, 16)])
def test_paged_attention_kernel_within_1e4_of_plain(dev, B, W, bs, n_kv, g, hd):
    rng = np.random.default_rng(B * W)
    nb = B * W + 1
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
    q, kn, vn, kp, vp = f(B, n_kv * g, hd), f(B, n_kv, hd), f(B, n_kv, hd), \
        f(nb, bs, n_kv, hd), f(nb, bs, n_kv, hd)
    tbl = torch.as_tensor(rng.permutation(nb)[:B * W].reshape(B, W), dtype=torch.int32, device=dev)
    tbl[0, 1:] = nb                                   # row 0 holds one block
    tbl[-1, :] = nb                                   # last row holds none
    cur = torch.as_tensor(rng.integers(0, W * bs, B), dtype=torch.int32, device=dev)
    cur[0] = bs - 1
    args = (q, kn, vn, kp, vp, tbl, cur)
    before = paged_attention.launches
    out = paged_attention(*args, block_size=bs)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_plain(*args, block_size=bs)
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))


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
