"""The port's affine quantization against the JAX package's: the same float
inputs, made with numpy, give bit-identical scales, zero points and codes,
per tensor, per channel and per row, including values that sit exactly on
a .5 rounding boundary (both frameworks round half to even)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import affine as jq
from repro_torch.quant import affine as tq


def _both(x, axis, qmax):
    jp = jq.calibrate(jnp.asarray(x), axis=axis, qmax=qmax)
    tp = tq.calibrate(torch.from_numpy(x), axis=axis, qmax=qmax)
    return jp, tp


def _assert_same(jp, tp, x):
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.zero_point), tp.zero_point.numpy())
    jc = np.asarray(jq.quantize(jnp.asarray(x), jp))
    tc = tq.quantize(torch.from_numpy(x), tp).numpy()
    assert tc.dtype == np.uint8
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(np.asarray(jq.dequantize(jnp.asarray(jc), jp)),
                                  tq.dequantize(torch.from_numpy(tc), tp).numpy())


@pytest.mark.parametrize("qmax", [255, 31])
@pytest.mark.parametrize("axis", [None, (0,), (1,)], ids=["tensor", "channel", "row"])
@pytest.mark.parametrize("shift", [0.0, 0.7, -0.7], ids=["centred", "positive", "negative"])
def test_calibrate_quantize_bit_equal(axis, qmax, shift):
    x = (np.random.default_rng(7).normal(size=(24, 40)) + shift).astype(np.float32)
    _assert_same(*_both(x, axis, qmax), x)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_half_boundaries_round_to_even(dtype):
    """Inputs at exact multiples of scale/2: x/scale lands on k + .5 and
    both packages round to the even neighbour."""
    codes = np.arange(-8, 9, dtype=np.float32) + 0.5          # -7.5 .. 8.5
    x = np.concatenate([codes * 0.25, [-2.0, 30.0]]).astype(np.float32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    qp = tq.QuantParams(scale=torch.tensor(0.25), zero_point=torch.tensor(8, dtype=torch.int32))
    jqp = jq.QuantParams(scale=jnp.float32(0.25), zero_point=jnp.int32(8))
    tc = tq.quantize(tx, qp).numpy()
    np.testing.assert_array_equal(np.asarray(jq.quantize(jx, jqp)), tc)
    # k + .5 -> nearest even integer, then + zero point 8
    np.testing.assert_array_equal(tc[:17], np.round(codes).astype(np.int64) + 8)
    assert tc[:4].tolist() == [0, 2, 2, 4]            # -7.5 -6.5 -5.5 -4.5
    _assert_same(*_both(np.asarray(tx.float()), (0,), 255), np.asarray(tx.float()))


def test_bfloat16_input_calibration_matches():
    x = np.random.default_rng(3).normal(size=(16, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for axis in (None, (1,)):
        jp = jq.calibrate(jx, axis=axis)
        tp = tq.calibrate(tx, axis=axis)
        np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
        np.testing.assert_array_equal(np.asarray(jp.zero_point), tp.zero_point.numpy())
        np.testing.assert_array_equal(np.asarray(jq.quantize(jx, jp)), tq.quantize(tx, tp).numpy())
