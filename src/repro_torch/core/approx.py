"""ApproxConfig — the switch for the paper's technique, and the quantized
dense layer every projection routes through.

Modes (every quantized one bit-exact to the multiplier's LUT semantics):
  float       no quantization at all (fp baseline)
  exact_quant uint8 affine quantization with an exact integer matmul
  lut         the paper-faithful simulation: one gather of the multiplier's
              LUT per MAC (kernels/approx_matmul/ref.py), on either device;
              as in the JAX package it is a plain gather, not a kernel, and
              a caller picks it, it is no fallback
  lowrank     the plain exact form A@B - U(A)@V(B) (core/lowrank.py) in
              float64 — K1's plain version, on any device
  kernel      the CUDA approximate-matmul kernel (kernels/approx_matmul) for
              CUDA tensors, its plain version for CPU tensors

On a float weight ``approx_dense`` is the QAT layer of the paper's
retraining: its value is the integer simulation and its gradient flows
through a straight-through estimator (STE), written as ``.detach()``
algebra as the JAX package writes it with ``stop_gradient``.  The integer
matmul takes codes and records no graph, so no ``autograd.Function`` is
needed.

Under tensor parallelism (``serve.ServeSession(mesh=...)``) a weight
arrives as a ``Shard``: this rank's part of it.  A column split needs no
collective; a row split sums the ranks' int32 code dots and code row sums
before any cast to float, so in the integer modes its result equals the
unsharded call's bit for bit, and calibrates the activation (and a float
weight) over the ranks' parts (``parallel/collectives.py``).

Under data-parallel training (``make_train_step(..., mesh=DataMesh)``) a
weight arrives as a ``DataPart``: the rank's part of it, gathered whole
where it is used (``parallel/fsdp.py``), or the whole weight where no rule
splits it.  Each rank holds other rows of the batch, so a per-tensor
activation range spans every rank's rows (one MAX all-reduce); per-row
ranges need none.  A MoE layer's experts gather their stacks once per
layer (``models/moe.py``) and reach ``approx_dense`` as ``Gathered``
pieces of them, whose inputs are the same on every rank.

Under a training mesh with a model axis (``launch.mesh.TrainMesh``) a
``DataPart`` may also carry a Megatron split: its data gather yields the
model rank's ``Shard``, which computes as in serving, through the
autograd-aware "f" on a column split's input and "g" on a row split's
float32 partial products (``parallel/collectives.py``).  A per-tensor
activation range spans the batch group (the rows), and for a row split
the model group too (the columns).  A weight's cotangent is summed over
every rank that holds a share of it (the data group by the reduce-scatter,
the pods by an all-reduce) and an input's over the model group ("f"), in
float32, before the one rounding to bf16.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import multipliers as mul
from repro_torch.kernels.approx_matmul.ops import approx_matmul
from repro_torch.kernels.approx_matmul.ref import approx_matmul_lut, approx_matmul_plain
from repro_torch.parallel.collectives import (
    all_reduce_sum,
    gather_value,
    max_range,
    model_input,
    model_sum,
    owned_whole,
)
from repro_torch.quant.affine import calibrate, dequantize, quantize

__all__ = [
    "ApproxConfig",
    "ConcatError",
    "DataPart",
    "Gathered",
    "Modes",
    "QWeight",
    "Shard",
    "approx_dense",
    "concat_weights",
    "prequantize_tree",
    "quantized_matmul",
    "shard_info",
    "w_dim",
]

Modes = ("float", "exact_quant", "lut", "lowrank", "kernel")


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    """Static (hashable) configuration of the approximate-multiplier feature."""

    multiplier: str = "mul8x8_2"       # exact | mul8x8_1/2/3 | pkm | etm | mul8x8_msr*
    mode: str = "lowrank"              # one of Modes
    act_qmax: int = 255                # activation code band
    w_qmax: int = 255                  # weight code band (co-optimized: 31)
    w_per_channel: bool = True         # per-output-channel weight scales
    band_reg: float = 0.0              # weight band-regularizer strength (retraining)
    act_per_row: bool = False          # per-row (per-token) activation scales:
    #   each flattened (M, K) row calibrates independently, so a row's codes
    #   (and its outputs) do not depend on which other rows share the batch

    def __post_init__(self):
        if self.mode not in Modes:
            raise ValueError(f"mode {self.mode!r} not in {Modes}")
        if self.mode in ("lut", "lowrank", "kernel"):
            mul.mul8x8_table(self.multiplier)  # validate name

    @property
    def is_quantized(self) -> bool:
        return self.mode != "float"



def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of codes: float64 products and sums of uint8
    codes stay below 2**53, so the cast back to int32 is exact (CUDA has
    no int32 matmul)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lut(multiplier: str, device: torch.device) -> torch.Tensor:
    """The multiplier's 256 x 256 LUT as int32 on ``device``, cached."""
    return torch.from_numpy(mul.mul8x8_table(multiplier).astype(np.int32)).to(device)


def quantized_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor, cfg: ApproxConfig) -> torch.Tensor:
    """Integer matmul of uint8 codes under the configured multiplier.

    a_codes: (..., M, K) in [0, act_qmax]; b_codes: (K, N) in [0, w_qmax].
    Returns (..., M, N) int32 equal (bit-exactly) to ``sum_k LUT[a, b]``."""
    if cfg.mode == "exact_quant" or cfg.multiplier == "exact":
        return _int_dot(a_codes, b_codes)
    if cfg.mode == "lut":
        return approx_matmul_lut(a_codes, b_codes, _lut(cfg.multiplier, a_codes.device))
    if cfg.mode == "lowrank":
        return approx_matmul_plain(a_codes, b_codes, multiplier=cfg.multiplier,
                                   lhs_max=cfg.act_qmax, rhs_max=cfg.w_qmax)
    if cfg.mode == "kernel":
        return approx_matmul(a_codes, b_codes, multiplier=cfg.multiplier,
                             lhs_max=cfg.act_qmax, rhs_max=cfg.w_qmax)
    raise ValueError(cfg.mode)


# ---------------------------------------------------------------------------
# Frozen pre-quantized weights (serving path)
# ---------------------------------------------------------------------------


class QWeight(NamedTuple):
    """A weight matrix frozen to uint8 codes at load time: serving reads 1
    byte per element and skips per-step weight calibration.  Stacked layer
    weights carry a leading layer axis on every field."""

    codes: torch.Tensor        # (..., K, N) uint8
    scale: torch.Tensor        # per-channel (..., 1, N) or scalar, f32
    zero_point: torch.Tensor   # int32, same shape as scale
    col_sum: torch.Tensor      # (..., 1, N) f32: sum_k codes (zero-point term)


# the JAX package's ``_PREQUANT_LEAVES``: attention, the dense and routed
# expert FFNs, the MoE shared expert, Mamba's projections and the LM head;
# routers, convs, ``a_log``/``dt_bias``/``d_skip``/``norm_g`` stay float
_PREQUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "shared_gate", "shared_up", "shared_down",
                  "in_proj", "x_proj", "dt_proj", "out_proj", "lm_head")


class Shard(NamedTuple):
    """A weight's part on one rank of a tensor-parallel mesh
    (``parallel/tp.shard_params``).  ``split`` is ``"column"`` (the rank's
    output columns; a frozen weight's per-channel fields sliced with its
    codes), ``"row"`` (its input rows: the products are summed over the
    ranks, and a frozen weight's fields stay whole, since they describe
    whole columns), ``"vocab"`` (an embedding table's rows) or
    ``"expert"`` (a MoE's (..., E, K, N) expert stack cut to the rank's
    ``E/size`` whole experts, every field that carries the expert axis with
    them: ``models/moe.moe_ffn`` runs them and gathers their rows)."""

    w: Any                     # a tensor or a QWeight
    split: str
    mesh: Any                  # launch.mesh.TPMesh


_MODEL_DIM = {"column": -1, "row": -2, "vocab": -2, "expert": -3}


class DataPart(NamedTuple):
    """A float weight on one rank of a training mesh (``parallel/fsdp.wrap``):
    ``w`` is the rank's ``1/size`` along ``dim`` (a negative dim) of the
    data axis ``mesh``, or the whole weight where ``dim`` is None.
    ``whole()`` is the weight every rank computes with; ``mesh`` also
    carries the activation ranges across the ranks' rows.

    On a ``TrainMesh`` (``axes``, its ``TrainAxes``) ``split`` names a
    Megatron split over the model axis (``"column"``, ``"row"`` or
    ``"vocab"``): ``w`` is then a block of the weight, cut along the model
    dim too, and the data gather yields the model rank's part, which
    ``sharded`` makes a ``Shard``.  Without ``axes`` (a one-axis data
    mesh) ``mesh`` is the batch group and the world too."""

    w: torch.Tensor
    dim: Any                   # Optional[int]
    mesh: Any                  # the data axis (launch.mesh.DataMesh or an Axis), or None
    split: Any = None          # Optional[str]: a split over the model axis
    axes: Any = None           # launch.mesh.TrainAxes, or None on a one-axis data mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        """The data-gathered weight's shape: the whole weight's, or the
        model rank's part of it under a split."""
        return tuple(n * (self.mesh.size if i - self.w.dim() == self.dim else 1)
                     for i, n in enumerate(self.w.shape))

    @property
    def device(self) -> torch.device:
        return self.w.device

    @property
    def model(self):
        """The model axis of a split, else None."""
        return self.axes.model if self.split is not None else None

    @property
    def batch(self):
        """The ranks that hold other rows of the batch (pod x data)."""
        return self.mesh if self.axes is None else self.axes.batch

    @property
    def world(self):
        """Every rank of the mesh: the batch group's rows and the model
        group's columns."""
        return self.mesh if self.axes is None else self.axes.world

    def cuts(self):
        """((dim, axis), ...) whose gathers, in order, make the whole weight
        of the rank's ``w``: the data axis's, then the model axis's."""
        out = [] if self.dim is None else [(self.dim, self.mesh)]
        return out + ([] if self.split is None else [(_MODEL_DIM[self.split], self.model)])

    def owned(self, whole: torch.Tensor, round_to=None) -> torch.Tensor:
        """``whole``, computed without a graph from ``value()``, as autograd
        sees it (``collectives.owned_whole``): its cotangent, summed over the
        data ranks at the part's slice and over the pods (for a weight the
        data axis does not split, over the batch group), then rounded
        through ``round_to``, reaches ``w``."""
        if self.dim is None:
            return owned_whole(self.w, whole, None, self.batch, round_to)
        pod = None if self.axes is None else self.axes.pod
        return owned_whole(self.w, whole, self.dim, self.mesh, round_to, pod)

    def whole(self) -> torch.Tensor:
        """The data-gathered weight: an all-gather along ``dim`` whose
        backward sums the ranks' gradients of this part; for a weight every
        data rank holds whole (``dim`` None), the weight itself, whose
        backward sums the ranks' gradients of this use in float32 (an
        all-reduce)."""
        return self.owned(self.value())

    def value(self) -> torch.Tensor:
        """The data-gathered weight's value, recorded by no autograd graph."""
        w = self.w.detach()
        return w if self.dim is None else gather_value(w, self.dim, self.mesh)

    def sharded(self, t: torch.Tensor):
        """``t`` (the data-gathered weight) as the ``Shard`` of its split,
        or as it is."""
        return t if self.split is None else Shard(t, self.split, self.model)


class Gathered(NamedTuple):
    """One expert's float weight from a stack gathered whole from a data
    mesh once per layer (``models/moe.py``): it computes as a float
    weight on an input that is the same on every rank (the dispatch
    buffer summed over the ranks), so its activation range is the rank's
    own, and its straight-through product passes the float32 weight
    cotangent back unrounded: the stack's gather sums the ranks'
    cotangents of every expert at once and rounds the sum to bf16, as one
    device rounds each expert's."""

    w: torch.Tensor


def shard_info(w):
    """(split, model mesh) of a ``Shard`` or of a ``DataPart`` with a
    split; None for a weight no model axis splits."""
    if isinstance(w, Shard):
        return w.split, w.mesh
    if isinstance(w, DataPart) and w.split is not None:
        return w.split, w.model
    return None


def w_dim(w, i: int) -> int:
    """Shape accessor that works for float weights, frozen QWeights and
    their shards (a ``Shard``'s own size; a ``DataPart``'s whole size)."""
    if isinstance(w, DataPart):
        return w.shape[i]
    if isinstance(w, Shard):
        w = w.w
    return (w.codes if isinstance(w, QWeight) else w).shape[i]


class ConcatError(ValueError):
    """``concat_weights`` was given weights it cannot join."""


def concat_weights(ws, dim: int = -1):
    """Concatenate weights along the output-channel axis (the JAX
    package's ``concat_weights``): float tensors; QWeights, which stay
    frozen (per-channel scales concatenate losslessly; a per-tensor scale
    is repeated per column); column ``Shard``s of one mesh, as the rank's
    ``[q_r | k_r | v_r]`` (each rank concatenates its own columns, never
    a split of the whole concatenation); ``DataPart``s of one data mesh
    that share their split dim and model split, each rank concatenating
    its own parts (the ``"fsdp"`` rules split the fused weights along
    their input dim; a column split gives the rank's ``[q_r | k_r | v_r]``),
    so the result's gather takes the rank's slice of the whole
    concatenation and its backward reaches each part.  Anything else
    raises ``ConcatError``."""
    if any(isinstance(w, (Shard, DataPart)) for w in ws):
        kind = type(ws[0])
        if not all(type(w) is kind and w.mesh is ws[0].mesh for w in ws):
            raise ConcatError("concat_weights: every weight must be a Shard, or a DataPart, "
                              "of one mesh")
        if kind is Shard:
            if any(w.split != "column" for w in ws):
                raise ConcatError("concat_weights: only column Shards concatenate along the "
                                  "output dim")
            return Shard(concat_weights([w.w for w in ws], dim), "column", ws[0].mesh)
        d0, sp = ws[0].dim, ws[0].split
        if any(w.dim != d0 or w.split != sp for w in ws):
            raise ConcatError("concat_weights: DataParts split along different dims")
        if d0 is not None and d0 % ws[0].w.dim() == dim % ws[0].w.dim():
            raise ConcatError("concat_weights: DataParts split along the concatenated dim")
        if sp not in (None, "column"):
            raise ConcatError("concat_weights: only column-split DataParts concatenate along "
                              "the output dim")
        return ws[0]._replace(w=torch.cat([w.w for w in ws], dim=dim))
    if any(isinstance(w, QWeight) for w in ws):
        if not all(isinstance(w, QWeight) for w in ws):
            raise ConcatError("cannot concatenate frozen and float weights")
        def bcast(t, w):
            return t.expand(*w.col_sum.shape)
        return QWeight(
            codes=torch.cat([w.codes for w in ws], dim=dim),
            scale=torch.cat([bcast(w.scale, w) for w in ws], dim=-1),
            zero_point=torch.cat([bcast(w.zero_point, w) for w in ws], dim=-1),
            col_sum=torch.cat([w.col_sum for w in ws], dim=-1),
        )
    if not all(isinstance(w, torch.Tensor) for w in ws):
        raise ConcatError(f"concat_weights: cannot join {[type(w).__name__ for w in ws]}")
    return torch.cat(ws, dim=dim)


def _freeze(leaf: torch.Tensor, cfg: ApproxConfig) -> QWeight:
    qp = calibrate(leaf, axis=(leaf.dim() - 2,) if cfg.w_per_channel else None,
                   qmax=cfg.w_qmax)
    codes = quantize(leaf, qp)
    return QWeight(
        codes=codes,
        scale=qp.scale,
        zero_point=qp.zero_point,
        col_sum=codes.to(torch.float32).sum(dim=-2, keepdim=True),
    )


def prequantize_tree(params: Dict[str, Any], cfg: ApproxConfig) -> Dict[str, Any]:
    """Freeze every projection weight (``_PREQUANT_KEYS``) to a QWeight;
    embeddings, norms, routers and the Mamba blocks' conv and state
    parameters stay float.  A stacked weight calibrates over its
    second-to-last axis: one scale per output channel, per layer (and per
    expert of a stacked (L, E, d, ff) expert weight)."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.dim() >= 2 and key in _PREQUANT_KEYS:
            return _freeze(node, cfg)
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# Real-valued dense layer with approximate-multiplier semantics
# ---------------------------------------------------------------------------


def _sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """A row split's float partial products summed over ``mesh``'s ranks
    in float32 ("g"); ``t`` itself without one."""
    return t if mesh is None else model_sum(t, mesh)


def _input(t: torch.Tensor, mesh) -> torch.Tensor:
    """A column split's replicated input, whose cotangent is summed over
    ``mesh``'s ranks ("f"); ``t`` itself without one."""
    return t if mesh is None else model_input(t, mesh)


def _ranged(mesh):
    """The ``calibrate`` hook that widens a part's range to the ranks'."""
    return None if mesh is None else (lambda lo, hi: max_range(lo, hi, mesh))


def _code_sum(q: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """float32 sums of uint8 codes along ``dim`` (kept), over ``mesh``'s
    ranks too: summed as int32 first, so the sum of the parts is exact."""
    t = q.to(torch.int32).sum(dim=dim, keepdim=True)
    return (t if mesh is None else all_reduce_sum(t, mesh)).to(torch.float32)


def _code_dot(qx: torch.Tensor, codes: torch.Tensor, cfg: ApproxConfig, mesh):
    """(raw, row_x), float32: the integer code dot and the activation
    codes' row sums, over ``mesh``'s ranks in one int32 all-reduce (the row
    sums ride as one more column), so both are exact before the cast."""
    raw = quantized_matmul(qx, codes, cfg)
    row_x = qx.to(torch.int32).sum(dim=-1, keepdim=True)
    if mesh is None:
        return raw.to(torch.float32), row_x.to(torch.float32)
    both = all_reduce_sum(torch.cat([raw, row_x], dim=-1), mesh).to(torch.float32)
    return both[..., :-1], both[..., -1:]


def _act_codes(x2: torch.Tensor, cfg: ApproxConfig, mesh=None, data=None):
    """The activation's codes; its range spans ``mesh``'s K-parts (a row
    split), or, where it is one range per tensor, every rank of ``data``
    (the ranks that hold the tensor's rows, and under a row split its
    K-parts too)."""
    if data is not None and not cfg.act_per_row:
        mesh = data
    qp_x = calibrate(x2, axis=(1,) if cfg.act_per_row else None, qmax=cfg.act_qmax,
                     reduce=_ranged(mesh))
    return qp_x, quantize(x2, qp_x)


def _zero_point_correct(raw, row_x, zx, zw, col_w, K):
    """sum_k (qx - zx)(qw - zw) from the raw code dot and the codes' row
    sums ``row_x``, in the JAX package's f32 operation order."""
    return raw - zx * col_w - row_x * zw + (K * zx) * zw


def approx_dense(x: torch.Tensor, w, cfg: ApproxConfig) -> torch.Tensor:
    """y = x @ w computed through the approximate-multiplier pipeline.

    x: (..., K) float; w: (K, N) float or a frozen ``QWeight``, a
    ``Shard`` of either, or a float ``DataPart``.  Quantizes
    both operands to unsigned codes (dynamic activation scale, per-channel
    weight scales), runs the configured integer multiplier, applies the
    zero-point corrections and dequantizes.

    On a float ``w`` the result is the JAX package's straight-through sum

        y = y_lin + (y_int - y_lin).detach(),   y_lin = fq(x) @ fq(w)

    in float32: its value is the integer simulation ``y_int`` (to f32
    roundoff) and its gradient is that of ``y_lin``, the product of the
    bf16-rounded fake-quantized operands.  The cotangents pass back through
    the bf16 casts, so the weight gradient is bf16-rounded as in JAX.  A
    QWeight (serving) returns ``x.dtype`` and records no graph.  A
    ``Gathered`` weight is a float weight whose weight cotangent is not
    rounded here (its gather rounds the ranks' sum).

    On a row ``Shard`` ``x`` holds the rank's columns of the activation
    (its K-part): the ranges, the code dots and the code sums span the
    ranks, and float partial products (float mode, ``y_lin``) are summed
    in float32, which agrees with the unsharded call to roundoff.

    A ``DataPart`` computes with the whole weight on the rank's rows of
    ``x``; a per-tensor activation range spans every rank's rows, so the
    codes are those of the whole batch.  Its straight-through product
    takes its gradient through ``DataPart.owned``, split or replicated: the
    ranks' partial weight gradients of this use are summed in float32 and
    then rounded to bf16, once, as on one device (rounding each rank's
    part first would not add up to one device's gradient).  A ``DataPart``
    with a model split computes as its ``Shard`` under autograd: a column
    split's float32 input passes through "f", so its cotangent is summed
    over the model ranks before the cast rounds it, and a row split's
    partial products through "g"."""
    split = mesh = data = part = None
    rounded = not isinstance(w, Gathered)
    if not rounded:
        w = w.w
    if isinstance(w, DataPart):
        data = w
        if cfg.mode != "float":
            part = w
            w = w.sharded(w.value())
        else:
            w = w.sharded(w.whole())
    if isinstance(w, Shard):
        w, split, mesh = w
        if split == "expert":
            raise ValueError("approx_dense: an expert Shard is a stack of experts, not "
                             "one projection (moe_ffn runs each of the rank's experts)")
    rows = mesh if split == "row" else None
    cols = mesh if split == "column" else None
    if isinstance(w, QWeight):
        return _approx_dense_frozen(x, w, cfg, rows)
    if cfg.mode == "float":
        y = _input(x.to(torch.float32), cols) @ w.to(x.dtype).to(torch.float32)
        return _sum(y, rows).to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    xd, wd = x2.detach(), w.detach()
    ranks = None if data is None else data.world if rows is not None else data.batch
    qp_x, qx = _act_codes(xd, cfg, rows, ranks)
    # a column split's per-channel ranges are the rank's own; every other
    # weight range spans the ranks' parts
    w_ranks = None if split is None or (split == "column" and cfg.w_per_channel) else mesh
    qp_w = calibrate(wd, axis=(0,) if cfg.w_per_channel else None, qmax=cfg.w_qmax,
                     reduce=_ranged(w_ranks))
    qw = quantize(wd, qp_w)

    # differentiable STE path: an f32 product of bf16-exact operands equals
    # the bf16 x bf16 -> f32 product up to summation order
    x_fq = x2 + (dequantize(qx, qp_x).to(x2.dtype) - x2).detach()
    w_fq = w + (dequantize(qw, qp_w).to(w.dtype) - w).detach()
    bf = torch.bfloat16
    w_lin = w_fq.to(bf).to(torch.float32)
    if part is not None:
        w_lin = part.owned(w_lin, round_to=bf)
    elif not rounded:            # the value of the cast, the cotangent unrounded
        w_lin = w_fq + (w_lin - w_fq).detach()
    y_lin = _sum(_input(x_fq.to(bf).to(torch.float32), cols) @ w_lin, rows)

    # integer simulation (value path, gradient-free)
    raw, row_x = _code_dot(qx, qw, cfg, rows)
    K = x2.shape[-1] * (rows.size if rows is not None else 1)
    acc = _zero_point_correct(raw, row_x, qp_x.zero_point.to(torch.float32),
                              qp_w.zero_point.to(torch.float32), _code_sum(qw, 0, rows), K)
    y_int = acc * (qp_x.scale * qp_w.scale)

    y = y_lin + (y_int - y_lin).detach()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _approx_dense_frozen(x: torch.Tensor, w: QWeight, cfg: ApproxConfig,
                         rows=None) -> torch.Tensor:
    """Inference dense against frozen uint8 weight codes (no calibration of
    w) — the serving path.  ``rows``: the mesh whose ranks each hold a
    K-part of ``x`` and ``w.codes`` (a row split)."""
    x2 = x.reshape(-1, x.shape[-1])
    qp_x, qx = _act_codes(x2, cfg, rows)
    raw, row_x = _code_dot(qx, w.codes, cfg, rows)
    K = x2.shape[-1] * (rows.size if rows is not None else 1)
    acc = _zero_point_correct(raw, row_x, qp_x.zero_point.to(torch.float32),
                              w.zero_point.to(torch.float32), w.col_sum, K)
    y = acc * (qp_x.scale * w.scale)
    return y.reshape(*x.shape[:-1], w.codes.shape[-1]).to(x.dtype)
