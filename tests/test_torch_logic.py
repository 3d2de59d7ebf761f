"""The port's bit logic and the elementwise approximate multiplier (K3)
against the JAX package, bit for bit.

The port's ``approx_mul3x3``/``approx_mul8x8_bitwise`` over the whole
8-bit domain against ``repro.core.logic`` and both packages' LUTs; K3's
plain version and the CPU route of its wrapper against the JAX package's
Pallas kernel run in interpret mode (as ``tests/test_logic.py`` runs it),
on seeded ragged and multi-dimensional shapes.  Integer results: no
tolerance.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import logic as jlogic
from repro.core import multipliers as JM
from repro.kernels.approx_mul_eltwise.ops import approx_mul_eltwise_pallas
from repro.kernels.approx_mul_eltwise.ref import approx_mul_eltwise_ref
from repro_torch.core import logic
from repro_torch.core import multipliers as M
from repro_torch.kernels.approx_mul_eltwise import (
    DESIGNS,
    UnsupportedMultiplierError,
    approx_mul_eltwise,
    approx_mul_eltwise_plain,
    lut_mismatches,
)

CASES = [(1, False, "mul8x8_1"), (2, False, "mul8x8_2"), (2, True, "mul8x8_3")]


def _grid(n):
    a, b = np.meshgrid(np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32),
                       indexing="ij")
    return a, b


@pytest.mark.parametrize("design", [1, 2])
def test_bitwise_3x3_equals_jax(design):
    a, b = _grid(8)
    got = logic.approx_mul3x3(torch.from_numpy(a), torch.from_numpy(b), design).numpy()
    want = np.asarray(jlogic.approx_mul3x3(jnp.asarray(a), jnp.asarray(b), design))
    np.testing.assert_array_equal(got, want)
    table = M.mul3x3_1_table() if design == 1 else M.mul3x3_2_table()
    np.testing.assert_array_equal(got, table)


@pytest.mark.parametrize("design,removed,name", CASES)
def test_bitwise_8x8_equals_jax_over_the_whole_domain(design, removed, name):
    a, b = _grid(256)
    got = logic.approx_mul8x8_bitwise(torch.from_numpy(a).to(torch.uint8),
                                      torch.from_numpy(b).to(torch.uint8), design, removed)
    assert got.dtype == torch.int32
    want = np.asarray(jlogic.approx_mul8x8_bitwise(jnp.asarray(a), jnp.asarray(b),
                                                   design, removed))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), M.mul8x8_table(name))
    np.testing.assert_array_equal(got.numpy(), JM.mul8x8_table(name))
    assert DESIGNS[name] == (design, removed)


def _k3_corr(x, y, design):
    """The CUDA kernel's correction of one 3x3 block (approx_mul_eltwise.cu,
    ``corr``): a step function of P = (x & 3) * (y & 3), gated on bit 2 of
    both fields."""
    P = ((x & y) >> 2 & 1) * ((x & 3) * (y & 3))
    ge3, ge4, ge9 = (P >= 3).astype(np.int32), (P >= 4).astype(np.int32), (P >= 9).astype(np.int32)
    return 4 * (2 * ge3 + ge4 + 2 * ge9) if design == 1 else 4 * (2 * ge3 - 3 * ge4 + 2 * ge9)


@pytest.mark.parametrize("design,removed,name", CASES)
def test_cuda_kernels_four_corrections_equal_jax_bit_logic(design, removed, name):
    """K3 on the card computes a*b minus the four corrections that can be
    non-zero ((alo,blo), (alo,bmid), (amid,blo), (amid,bmid)) and, for
    mul8x8_3, minus (alo*bhi) << 6.  Its arithmetic, emulated here over the
    whole 8-bit domain, equals the JAX package's bit logic and the LUT."""
    a, b = _grid(256)
    alo, amid, blo, bmid = a & 7, (a >> 3) & 7, b & 7, (b >> 3) & 7
    got = (a * b - _k3_corr(alo, blo, design)
           - ((_k3_corr(alo, bmid, design) + _k3_corr(amid, blo, design)) << 3)
           - (_k3_corr(amid, bmid, design) << 6))
    if removed:
        got = got - ((alo * (b >> 6)) << 6)
    want = np.asarray(jlogic.approx_mul8x8_bitwise(jnp.asarray(a), jnp.asarray(b),
                                                   design, removed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, M.mul8x8_table(name))
    # every block with an operand <= 4, or with a field of ahi / bhi, is exact
    x, y = _grid(8)
    zero = (x < 5) | (y < 5)
    assert (_k3_corr(x, y, design)[zero] == 0).all()


@pytest.mark.parametrize("name", [c[2] for c in CASES])
def test_plain_and_wrapper_equal_jax_kernel_over_the_whole_domain(name):
    a, b = _grid(256)
    ta, tb = torch.from_numpy(a).to(torch.uint8), torch.from_numpy(b).to(torch.uint8)
    want = np.asarray(approx_mul_eltwise_pallas(jnp.asarray(a, jnp.uint8),
                                                jnp.asarray(b, jnp.uint8), multiplier=name))
    before = approx_mul_eltwise.launches
    np.testing.assert_array_equal(approx_mul_eltwise_plain(ta, tb, name).numpy(), want)
    np.testing.assert_array_equal(approx_mul_eltwise(ta, tb, multiplier=name).numpy(), want)
    assert approx_mul_eltwise.launches == before        # the CPU route launches nothing


@pytest.mark.parametrize("shape", [(1,), (7,), (4099,), (37, 21), (3, 5, 7), (2, 3, 5, 11)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("name", [c[2] for c in CASES])
def test_ragged_and_nd_shapes_equal_jax(shape, dtype, name):
    rng = np.random.default_rng([*shape, int(name[-1])])
    a = rng.integers(0, 256, shape).astype(dtype)
    b = rng.integers(0, 256, shape).astype(dtype)
    want = np.asarray(approx_mul_eltwise_pallas(jnp.asarray(a), jnp.asarray(b),
                                                multiplier=name, block=256))
    np.testing.assert_array_equal(
        want, np.asarray(approx_mul_eltwise_ref(jnp.asarray(a), jnp.asarray(b), name)))
    got = approx_mul_eltwise(torch.from_numpy(a), torch.from_numpy(b), multiplier=name)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["exact", "pkm", "etm", "mul8x8_msr4", "nope"])
def test_unknown_multiplier_raises_as_in_jax(name):
    a = torch.zeros((4,), dtype=torch.uint8)
    with pytest.raises(UnsupportedMultiplierError, match="no bitwise form"):
        approx_mul_eltwise(a, a, multiplier=name)
    with pytest.raises(KeyError):
        approx_mul_eltwise_pallas(jnp.zeros((4,), jnp.uint8), jnp.zeros((4,), jnp.uint8),
                                  multiplier=name)


def test_wrapper_validates_operands():
    a = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shapes differ"):
        approx_mul_eltwise(a, a.reshape(4, 3))
    with pytest.raises(TypeError, match="uint8 or int32"):
        approx_mul_eltwise(a.float(), a.float())
    with pytest.raises(ValueError, match="both must be on the CPU"):
        approx_mul_eltwise(a, torch.zeros((3, 4), dtype=torch.uint8, device="meta"))
    assert approx_mul_eltwise(a[:0], a[:0]).shape == (0, 4)


@pytest.mark.parametrize("name", [c[2] for c in CASES])
def test_lut_cross_check_finds_k1_table_right(name, monkeypatch):
    from repro_torch.device import NoCudaDeviceError

    assert lut_mismatches(name, device="cpu") == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        lut_mismatches(name)
