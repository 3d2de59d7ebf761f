"""K1, the approximate-multiplier matmul, in the port against the JAX package.

The plain version (the float64 exact decomposition the CUDA kernel is held
to on the card) must equal the JAX LUT oracle ``approx_matmul_ref`` bit for
bit, for every registered multiplier; the dense layers built on it must
match the JAX ones to float32 roundoff.  The wrapper takes the plain
version for CPU tensors only and never falls back for another device.
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
from repro.kernels.approx_matmul.ref import approx_matmul_ref
from repro_torch.core import approx as tapprox
from repro_torch.core import multipliers as tmul
from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain


def test_multiplier_tables_are_the_reference_tables():
    assert tmul.MULTIPLIERS == MULTIPLIERS
    for name in MULTIPLIERS:
        t = tmul.mul8x8_table(name)
        np.testing.assert_array_equal(t, mul8x8_table(name))
        assert t.min() >= 0 and t.max() <= 65025          # fits the kernel's uint16 LUT


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
