"""The dry run of every cell at full width (``launch/dryrun.run_cell``):
10 archs x 4 shapes, less the 8 long_500k cells of the attention-only
archs, each step counted on ``meta`` from 1 and 2 layer units.  Each
cell's K1 calls equal ``k1_per_pass`` (prefill, decode) or
``k1_per_train_step`` times its microbatches (train), the predictors the
card is held to; its temporaries are positive and finite and its bound
positive; no kernel is launched and no card memory is taken.
"""
import math

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.kernels.approx_mul_eltwise import approx_mul_eltwise
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.launch import dryrun as D

KERNELS = (approx_matmul, paged_attention, approx_mul_eltwise)


def _card_bytes():
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def test_cells_counted_and_skipped():
    supported = [D.cell_supported(get_config(a), s) is None for a in list_archs()
                 for s in SHAPES.values()]
    assert (sum(supported), len(supported) - sum(supported)) == (32, 8)


@pytest.mark.parametrize("arch", list_archs())
def test_every_cell_at_full_width(arch):
    cfg = get_config(arch)
    before = [k.launches for k in KERNELS], _card_bytes()
    for name, shape in SHAPES.items():
        res = D.run_cell(arch, name)
        if D.cell_supported(cfg, shape):
            assert set(res) == {"arch", "shape", "skipped"}, name
            continue
        want = (D.k1_per_train_step(cfg) * res["microbatches"] if shape.kind == "train"
                else D.k1_per_pass(cfg))
        assert res["kernels"]["approx_matmul"]["calls"] == want, name
        assert 0 < res["temp_size_in_bytes"] < math.inf, name
        assert res["t_bound_s"] > 0 and res["bound"] in ("compute", "memory"), name
        assert res["argument_size_in_bytes"] > 0, name
    assert ([k.launches for k in KERNELS], _card_bytes()) == before
