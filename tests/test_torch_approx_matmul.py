"""K1, the approximate-multiplier matmul, in the port against the JAX package.

The plain version (the float64 exact decomposition the CUDA kernel is held
to on the card) must equal the JAX LUT oracle ``approx_matmul_ref`` bit for
bit, for every registered multiplier; the dense layers built on it must
match the JAX ones to float32 roundoff.  The kernel's 8-bit feature tables
must reconstruct every multiplier's error, and an integer emulation of the
kernel's arithmetic on them must equal the JAX TPU kernel (interpret mode)
and the plain version.  The wrapper takes the plain version for CPU tensors
only and never falls back for another device.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro.core.multipliers import MULTIPLIERS, mul8x8_table
from repro.kernels.approx_matmul.kernel import approx_matmul_kernel_call
from repro.kernels.approx_matmul.ref import approx_matmul_ref
from repro_torch.core import approx as tapprox
from repro_torch.core import multipliers as tmul
from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain, feature_tables
from repro_torch.kernels.approx_matmul import ops as k1_ops


def test_multiplier_tables_are_the_reference_tables():
    assert tmul.MULTIPLIERS == MULTIPLIERS
    for name in MULTIPLIERS:
        t = tmul.mul8x8_table(name)
        np.testing.assert_array_equal(t, mul8x8_table(name))
        assert t.min() >= 0 and t.max() <= 65025   # K * 65025 < 2**31 keeps int32 sums exact


@pytest.mark.parametrize("M", [1, 5, 24])
@pytest.mark.parametrize("rhs_max", [255, 31])
@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_plain_matches_lut_oracle(multiplier, rhs_max, M):
    rng = np.random.default_rng(M * 1000 + rhs_max)
    K, N = 37, 19                                   # ragged: no block multiple
    a = rng.integers(0, 256, (M, K)).astype(np.uint8)
    b = rng.integers(0, rhs_max + 1, (K, N)).astype(np.uint8)
    want = np.asarray(approx_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(mul8x8_table(multiplier))))
    got = approx_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                              multiplier=multiplier, rhs_max=rhs_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rhs_max", [255, 31])
@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_feature_tables_reconstruct_the_error_in_8_bits(multiplier, rhs_max):
    """LUT[a, b] == a*b - c * sum_f vt_f(a) u'_f(b) on [0,255] x [0, rhs_max],
    against the JAX package's table; every vt_f fits int8 (or uint8 where
    flagged) and every u'_f uint8; the packed table the kernel loads holds
    the same bytes."""
    t = feature_tables(multiplier, 255, rhs_max)
    F = t.num_features
    v, u = t.v_values(), t.u.to(torch.int64)
    assert v.shape == u.shape == (F, 256) and t.u.dtype == t.v.dtype == torch.uint8
    for f in range(F):
        lo, hi = (-128, 127) if t.v_signed[f] else (0, 255)
        assert lo <= int(v[f].min()) and int(v[f].max()) <= hi
    a, b = np.arange(256), np.arange(rhs_max + 1)
    err = a[:, None] * b[None, :] - mul8x8_table(multiplier).astype(np.int64)[:, :rhs_max + 1]
    got = t.c * torch.einsum("fa,fb->ab", v, u[:, :rhs_max + 1]).numpy()
    np.testing.assert_array_equal(got, err)
    assert torch.equal(t.packed[0, :, :F].T, t.v) and not t.packed[0, :, F:].any()
    assert torch.equal(t.packed[1, :, 0], torch.arange(256, dtype=torch.uint8))
    assert torch.equal(t.packed[1, :, 1:F + 1].T, t.u) and not t.packed[1, :, F + 1:].any()


def test_feature_tables_refuse_a_factorization_that_does_not_reconstruct(monkeypatch):
    good = k1_ops.correction("mul8x8_2", 255, 255)
    broken = type(good)(multiplier=good.multiplier, side=good.side, lhs_max=255, rhs_max=255,
                        features=good.features[:-1])
    monkeypatch.setattr(k1_ops, "correction", lambda *args: broken)
    with pytest.raises(ValueError, match="do not reconstruct"):
        k1_ops._build_tables("mul8x8_2", 255, 255)


def _kernel_emulation(a: np.ndarray, b: np.ndarray, multiplier: str, rhs_max: int = 255):
    """The kernel's arithmetic in integers: K padded with code 0 to a
    multiple of 16, then A@B - c * sum_f vt_f(A) @ u'_f(B) in int64, cast
    to int32 (the kernel's s32 sums wrap; the true result fits)."""
    t = feature_tables(multiplier, 255, rhs_max)
    pad = -a.shape[1] % 16
    A = torch.from_numpy(np.pad(a, ((0, 0), (0, pad))).astype(np.int64))
    B = torch.from_numpy(np.pad(b, ((0, pad), (0, 0))).astype(np.int64))
    v, u = t.v_values(), t.u.to(torch.int64)
    corr = sum((v[f][A] @ u[f][B] for f in range(t.num_features)), torch.zeros((), dtype=torch.int64))
    out = A @ B - t.c * corr
    return ((out + 2**31) % 2**32 - 2**31).to(torch.int32).numpy()


@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_kernel_arithmetic_equals_the_tpu_kernel(multiplier):
    """Block-multiple shapes, the JAX kernel in interpret mode (as the JAX
    package's own tests run it on the CPU)."""
    rng = np.random.default_rng(sum(map(ord, multiplier)))
    a = rng.integers(0, 256, (16, 256)).astype(np.uint8)
    b = rng.integers(0, 256, (256, 128)).astype(np.uint8)
    want = np.asarray(approx_matmul_kernel_call(jnp.asarray(a), jnp.asarray(b), multiplier=multiplier,
                                                bm=16, bn=128, bk=256, interpret=True))
    np.testing.assert_array_equal(_kernel_emulation(a, b, multiplier), want)


@pytest.mark.parametrize("M,K,N", [(1, 33, 5), (5, 300, 77), (13, 1000, 130)])
@pytest.mark.parametrize("rhs_max", [255, 31])
@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_kernel_arithmetic_equals_plain_on_ragged_shapes(multiplier, rhs_max, M, K, N):
    rng = np.random.default_rng(M * K + N + rhs_max)
    a = rng.integers(0, 256, (M, K)).astype(np.uint8)
    b = rng.integers(0, rhs_max + 1, (K, N)).astype(np.uint8)
    want = approx_matmul_plain(torch.from_numpy(a), torch.from_numpy(b), multiplier=multiplier,
                               rhs_max=rhs_max).numpy()
    np.testing.assert_array_equal(_kernel_emulation(a, b, multiplier, rhs_max), want)


@pytest.mark.parametrize("multiplier", MULTIPLIERS)
def test_all_pairs_table_of_k1_is_the_lut(multiplier):
    """One K = 1 call on all code pairs gives the multiplier's table: the
    table that K3's cross-check holds its bit logic against."""
    codes = torch.arange(256, dtype=torch.uint8)
    got = approx_matmul(codes[:, None], codes[None, :], multiplier=multiplier)
    np.testing.assert_array_equal(got.numpy(), mul8x8_table(multiplier))


@pytest.mark.parametrize("multiplier", ["mul8x8_1", "mul8x8_2", "mul8x8_3"])
def test_k3_cross_check_finds_k1_right(multiplier):
    from repro_torch.kernels.approx_mul_eltwise import lut_mismatches

    assert lut_mismatches(multiplier, device="cpu") == 0


def test_wrapper_on_cpu_takes_plain_and_counts_no_launch():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 256, (2, 3, 40)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (40, 9)).astype(np.uint8))
    before = approx_matmul.launches
    out = approx_matmul(a, b, multiplier="mul8x8_3")
    assert out.shape == (2, 3, 9)
    assert torch.equal(out, approx_matmul_plain(a, b, multiplier="mul8x8_3"))
    assert approx_matmul.launches == before


def test_wrapper_raises_off_cpu_and_off_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device must not be
    quietly computed by the plain version."""
    a = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    b = torch.zeros((8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        approx_matmul(a, b)
    with pytest.raises(ValueError, match="contraction"):
        approx_matmul(torch.zeros((2, 8), dtype=torch.uint8),
                      torch.zeros((7, 3), dtype=torch.uint8))


class _Attn(NamedTuple):
    """A one-field stand-in for the JAX package's AttnParams (its freezing
    matches weights by attribute path)."""

    wq: object


_MODES = [("exact_quant", "exact_quant", "exact"), ("lowrank", "lowrank", "mul8x8_2"),
          ("kernel", "pallas", "mul8x8_2"), ("kernel", "pallas", "etm"),
          ("kernel", "pallas", "mul8x8_msr4")]


def _cfgs(tmode, jmode, mult, per_row):
    kw = dict(multiplier=mult, act_per_row=per_row)
    return tapprox.ApproxConfig(mode=tmode, **kw), japprox.ApproxConfig(mode=jmode, **kw)


@pytest.mark.parametrize("tmode,jmode,mult,per_row",
                         [(*m, False) for m in _MODES] + [("kernel", "pallas", "mul8x8_2", True)])
def test_approx_dense_matches_jax(tmode, jmode, mult, per_row):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 24)) / 7).astype(np.float32)
    tc, jc = _cfgs(tmode, jmode, mult, per_row)
    want = np.asarray(japprox.approx_dense(jnp.asarray(x), jnp.asarray(w), jc))
    got = tapprox.approx_dense(torch.from_numpy(x), torch.from_numpy(w), tc)
    assert got.shape == want.shape
    # the JAX value is y_lin + (y_int - y_lin) of its QAT estimator: f32 roundoff
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "tmode,jmode,mult,per_row,dtype",
    [(*m, False, "float32") for m in _MODES]
    + [("kernel", "pallas", "mul8x8_2", True, "float32"),
       ("kernel", "pallas", "mul8x8_2", False, "bfloat16")])
def test_frozen_dense_matches_jax(tmode, jmode, mult, per_row, dtype):
    from repro_torch.bridge import params_from_numpy

    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 40)) / 8).astype(np.float32)
    tc, jc = _cfgs(tmode, jmode, mult, per_row)
    jw = japprox.prequantize_tree(_Attn(jnp.asarray(w)), jc)._asdict()
    tw = tapprox.prequantize_tree({"wq": torch.from_numpy(w)}, tc)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jw))
    assert isinstance(bridged["wq"], tapprox.QWeight)
    for a, b in zip(tw["wq"], bridged["wq"]):
        assert torch.equal(a, b)                     # freezing is bit-identical
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(japprox._approx_dense_frozen(jx, jw["wq"], jc).astype(jnp.float32))
    got = tapprox._approx_dense_frozen(tx, tw["wq"], tc)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=1e-5)


def test_concat_weights_keeps_codes_frozen():
    rng = np.random.default_rng(2)
    cfg = tapprox.ApproxConfig(mode="kernel")
    ws = [tapprox.prequantize_tree({"wq": torch.from_numpy(
        rng.normal(size=(16, n)).astype(np.float32))}, cfg)["wq"] for n in (8, 4)]
    cat = tapprox.concat_weights(ws)
    assert cat.codes.shape == (16, 12) and cat.scale.shape == (1, 12)
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    want = torch.cat([tapprox.approx_dense(x, w, cfg) for w in ws], dim=-1)
    assert torch.equal(tapprox.approx_dense(x, cat, cfg), want)
