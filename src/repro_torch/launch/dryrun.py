"""Dry run on the host: every (arch x shape) cell's step built on the
``meta`` device and counted (``launch/roofline.py`` ``count_costs``),
with its roofline on one card.  Nothing is allocated on a card and no
kernel is launched.

The steps, as the JAX package lowers them, through the approximate
multiplier ``mul8x8_2``: a train cell runs ``make_train_step`` (float32
state, ``mode="kernel"``: K1 on every projection, its STE products in
float32, or ``cfg.param_dtype``), a prefill cell ``prefill_step`` and a
decode cell the slot-layout ``serve_step`` (one new token against a
``seq_len`` cache), both on frozen weights through K1 (with the fused
leaves of ``fuse_qkv``/``fuse_gate_up``).  The vlm and audio backbones
take embeddings.  Attention runs its queries in chunks of
``cfg.q_chunk``, as the step does (the JAX dry run passes ``q_chunk =
seq_len`` only to suit XLA's cost extraction), so a prefill cell counts
one chunk's scores, not the whole (S, S) tensor.

The count is extrapolated in depth from two points, as the JAX package's
``extract_costs``: the step at 1 and at 2 layer units (a hybrid's unit is
``attn_every`` layers: one group), then ``fixed + n_units * per_unit``
(the port's layer loop is linear in depth), times the microbatches of a
train cell (each microbatch counted as one step of ``global_batch /
microbatches`` rows, the optimizer's update included, as in JAX).  The
peak of live storages (``temp_size_in_bytes``) goes with depth as
``in_depth`` says: a prefill or decode step's is that of two units (each
layer frees its temporaries), a train cell's the larger of its line
through 1 and 2 units and the end of its backward (``backward_peak``).
A training step's per-rank counts on a mesh (``collectives_per_train_step``,
``gathered_bytes_per_train_step``, ``state_bytes_per_rank``,
``k1_shapes_per_rank``) follow the rules and the code of
``parallel/fsdp.py``; the whole dry run of the production cells on a mesh
is still to come (ROADMAP.md item 11).

Usage (host only; writes one JSON per cell under ``results/dryrun_torch``,
counted anew each time):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.approx import ApproxConfig
from repro_torch.launch import roofline as R
from repro_torch.launch.specs import cache_specs, input_specs, params_specs, state_specs
from repro_torch.models.moe import moe_capacity
from repro_torch.models.transformer import decode_step, forward
from repro_torch.launch.mesh import MeshShape
from repro_torch.parallel.fsdp import leaf_specs
from repro_torch.parallel.sharding import opt_state_pspecs, tree_bytes
from repro_torch.train import optim as O
from repro_torch.train.loop import make_train_step
from repro_torch.train.tree import LEAF_CHUNK

__all__ = ["auto_microbatch", "backward_peak", "band_term_costs", "build_step",
           "cell_supported", "collectives_per_pass", "collectives_per_train_step",
           "extract_costs", "gathered_bytes_per_train_step", "in_depth", "k1_per_pass",
           "k1_per_train_step", "k1_shapes_per_rank", "model_flops", "moe_dispatch_costs",
           "run_cell", "state_bytes_per_rank"]

DEFAULT_OUT = os.path.join("results", "dryrun_torch")
APPROX = ApproxConfig(multiplier="mul8x8_2", mode="kernel")   # every cell's multiplier and mode


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; otherwise the reason it is skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "quadratic attention at 524k ctx: skipped for pure full-attention archs"
    return None


def auto_microbatch(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1,
                    budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation split keeping each device's stack of saved
    layer inputs (L x rows x S x d in bf16) under about 4 GB."""
    per_seq = cfg.num_layers * shape.seq_len * cfg.d_model * 2
    budget_seqs = max(1, int(budget_bytes // max(per_seq, 1)))
    b_per_dev = max(1, shape.global_batch // dp)
    mb = 1
    while b_per_dev // mb > budget_seqs and mb < b_per_dev:
        mb *= 2
    return mb


def _attn_products(cfg: ModelConfig) -> int:
    """K1 calls of one attention block: q/k/v (one with ``fuse_qkv``) and
    ``wo``."""
    return (1 if cfg.fuse_qkv else 3) + 1


def _ffn_products(cfg: ModelConfig) -> int:
    """K1 calls of one SwiGLU FFN: gate/up (one with ``fuse_gate_up``) and
    ``w_down``."""
    return (1 if cfg.fuse_gate_up else 2) + 1


def k1_per_pass(cfg: ModelConfig, tp: int = 1) -> int:
    """K1 calls of one forward or decode pass of ``cfg``'s stack (frozen
    weights) on one rank of a ``tp``-rank mesh: every projection of every
    layer, each routed expert's three included (empty experts too; under
    expert parallelism, where ``tp`` divides the experts, the rank's
    ``E/tp``), and the LM head.  A fused leaf is one call, in decode too
    (``transformer.fuse_params``: granite's ``7n + 1`` becomes ``4n + 1``
    with both levers); the hybrid's shared block fuses gate/up only, as
    the JAX package's."""
    n = cfg.num_layers
    if cfg.family == "moe":
        experts = cfg.moe_experts // tp if cfg.moe_experts % tp == 0 else cfg.moe_experts
        return n * (_attn_products(cfg) + 3 * experts + (3 if cfg.moe_shared_ff else 0)) + 1
    if cfg.family == "ssm":
        return 4 * n + 1
    if cfg.family == "hybrid":
        return 2 * n + (4 + _ffn_products(cfg)) * (n // cfg.attn_every) + 1
    return (_attn_products(cfg) + _ffn_products(cfg)) * n + 1


def collectives_per_pass(cfg: ModelConfig, tp: int) -> int:
    """Collectives of one serving pass on each rank of a ``tp``-rank
    mesh (``parallel/tp.py``; float weights in float mode, else frozen or
    quantized): per layer, each row split reduces once in float mode and
    twice otherwise (the activation range's MAX, then the code dot's
    SUM): ``wo``, and ``w_down`` (dense) or ``shared_down`` and the routed
    experts (one all-gather of their rows under expert parallelism, else
    each expert's ``w_down``); then the vocab-split embedding's SUM and the
    head's all-gather, where ``tp`` divides their vocab."""
    row = 1 if cfg.approx.mode == "float" else 2
    per_layer = 2 * row
    if cfg.family == "moe":
        per_layer = row * (1 + bool(cfg.moe_shared_ff))
        per_layer += 1 if cfg.moe_experts % tp == 0 else row * cfg.moe_experts
    return (cfg.num_layers * per_layer + (cfg.vocab_size % tp == 0)
            + (cfg.padded_vocab % tp == 0))


def k1_per_train_step(cfg: ModelConfig) -> int:
    """K1 calls of one training step of ``cfg`` (float weights, remat on):
    every projection in the forward, then each layer's recompute in the
    backward, which stops once the tensors the backward saved are back
    (torch's non-reentrant checkpoint), so it skips a block's last
    projection when nothing after it is saved (the FFN's ``w_down``,
    Mamba's ``out_proj``); the MoE block recomputes all of its own (the
    shared expert and the load-balance terms come after the experts).  The
    LM head runs once.  A fused product (``fuse_qkv``, ``fuse_gate_up``) is
    one call."""
    n = cfg.num_layers
    if cfg.family == "moe":
        per = _attn_products(cfg) + 3 * cfg.moe_experts + (3 if cfg.moe_shared_ff else 0)
        return 2 * n * per + 1
    if cfg.family == "ssm":
        return (4 + 3) * n + 1
    if cfg.family == "hybrid":
        shared = 4 + _ffn_products(cfg)
        return (2 + 1) * n + (2 * shared - 1) * (n // cfg.attn_every) + 1
    per = _attn_products(cfg) + _ffn_products(cfg)
    return (2 * per - 1) * n + 1


# the leaves ``dense`` reads (the projections), by their last key: each
# use takes an activation range; routers and the Mamba blocks' convolution
# and scan parameters are read raw, and a MoE layer's expert stacks run on
# the same buffer on every rank (``models/moe.py``)
_PROJECTIONS = re.compile(r"(\.(wq|wk|wv|wo|wqkv|w_gate|w_up|w_down|w_gate_up|shared_gate|"
                          r"shared_up|shared_down|in_proj|x_proj|dt_proj|out_proj)"
                          r"|\['lm_head'\])$")


def _uses(cfg: ModelConfig, path: str) -> Tuple[int, bool]:
    """(uses of a parameter leaf in one forward, whether each layer's
    recompute under ``remat`` reruns them): a stacked layer leaf once per
    layer, the hybrid's shared block once per group, the rest once."""
    if path.startswith("['layers']"):
        return cfg.num_layers, True
    if path.startswith("['shared_attn']"):
        return cfg.num_layers // cfg.attn_every, True
    return 1, False


def _joined(cfg: ModelConfig, path: str) -> bool:
    """Whether a fused product (``fuse_qkv``: a layer's q/k/v,
    ``fuse_gate_up``: a dense FFN's gate/up) reads this leaf as one weight
    with its first leaf: one range and one gather, counted there."""
    if cfg.fuse_qkv and path.startswith("['layers']['attn']") and path.endswith((".wk", ".wv")):
        return True
    return cfg.fuse_gate_up and "['ffn']" in path and path.endswith(".w_up")


def _mesh_key(dp: int, tp: int, pod: int):
    """``leaf_specs``' key: the data axis alone (``DataMesh``, counted as
    it runs even at one rank), or a ``TrainMesh``'s shape."""
    if tp == 1 and pod == 1:
        return dp
    return MeshShape((("pod", pod), ("data", dp), ("model", tp)))


class _Lines(NamedTuple):
    data: bool
    model: bool
    pod: bool
    batch: bool
    world: bool


def _lines(dp: int, tp: int, pod: int) -> _Lines:
    """Which lines of the mesh hold more than one rank (a one-axis data
    mesh's always run its collectives)."""
    one_axis = tp == 1 and pod == 1
    return _Lines(data=dp > 1 or one_axis, model=tp > 1, pod=pod > 1,
                  batch=pod * dp > 1 or one_axis, world=pod * dp * tp > 1 or one_axis)


def _use_collectives(cfg: ModelConfig, path: str, spec, ln: _Lines) -> Tuple[int, int, int]:
    """(forward, of which after the product, backward) collectives of one
    use of a covered leaf on a rank."""
    a = cfg.approx
    d, m = (spec.index(x) - len(spec) if x in spec else None for x in ("data", "model"))
    fwd = bwd = after = 0
    if d is not None:                       # the gather; its reduce-scatter, the pods' sum
        fwd, bwd = 1, 1 + ln.pod
    elif ln.batch:                          # the batch group's sum of a replicated use
        bwd = 1
    if path == "['embed']":
        return fwd + (m is not None), 0, bwd                      # a vocab split's "g"
    if not _PROJECTIONS.search(path) or re.search(r"\['moe'\]\.w_", path):
        return fwd, 0, bwd
    row, col = m == -2, m == -1
    if a.is_quantized:
        if a.act_per_row:
            fwd += row                                   # the K-parts' per-row ranges
        else:
            fwd += (ln.world if row else ln.batch)
        fwd += row or (col and not a.w_per_channel)      # the weight's range
        after = 3 * row                                  # "g", the code dot, the code sums
    else:
        after = int(row)                                 # "g"
    bwd += col                                           # "f"
    fwd += col and path == "['lm_head']"                 # the head's gather
    return fwd + after, after, bwd


def collectives_per_train_step(cfg: ModelConfig, dp: int, *, tp: int = 1, pod: int = 1,
                               microbatch: int = 1, grad_compression: bool = False) -> int:
    """Collectives of one training step of ``cfg`` (any family; a model
    axis the dense family) on each rank of a mesh of ``pod x dp x tp``
    ranks (``make_train_step(..., mesh=)``, ``parallel/fsdp.py``; with
    ``tp`` and ``pod`` 1 a one-axis ``DataMesh``, else a ``TrainMesh``,
    whose lines of one rank run none), from the rules and the code, per
    microbatch:

    * each use of a leaf split over data gathers it (every layer's
      projections, a MoE layer's router and each expert stack, once per
      layer, the hybrid's shared block at each of its groups, the
      embedding, the head), and the backward reduce-scatters each
      gather's cotangent once, then sums it across the pods (one more
      all-reduce over a pod axis);
    * a leaf a rule covers but the data axis keeps whole (no rule splits
      it over data, as the Mamba blocks' ``dt_proj``, convolution and
      scan parameters, or its dim ``dp`` does not divide) is gathered
      never; each use's backward sums its gradient over the batch group
      (one float32 all-reduce per use);
    * in a quantized mode with per-tensor activation ranges, each use of
      a projection (``_PROJECTIONS``: not a router, not a Mamba block's
      raw parameters, not a MoE expert stack, whose input is the same on
      every rank) takes one MAX of its range (over the batch group, or
      the whole mesh for a row split);
    * over a model axis, each use of a column split sums its input's
      cotangent over the model group ("f", in the backward); a row split
      takes its weight's per-channel range (a MAX) and, with per-row
      activation ranges, its rows' (a MAX), then sums its partial
      products ("g") and, in a quantized mode, its int32 code dot and code
      sums (two SUMs); the vocab-split embedding sums its lookups ("g")
      and the head gathers its columns;
    * a MoE layer's routing all-gathers the ranks' per-expert counts and
      sums their dispatch buffers: two per layer;
    * with ``remat`` each layer's recompute in the backward (the hybrid's
      shared block's too) runs again up to the last tensor the backward
      saved, the straight-through product of its last projection, which
      comes after every gather, range and routing collective of the layer
      and before its last row split's "g" and code sums (a MoE block ends
      in its shared expert and load-balance terms; a Mamba block in its
      ``out_proj``).  Without remat every gathered weight stays saved for
      the backward instead, and the split saves nothing of it;
    * a fused product (``fuse_qkv``, ``fuse_gate_up``) gathers the
      concatenation of its leaves' parts once, and takes one range;
    * the band term (``band_reg`` > 0) gathers each split weight whole once
      per chunk of matrices, in the forward, where each rank takes the
      chunk's gradient at once (``train.loop._BandChunk``): one gather a
      chunk and split axis (a replicated weight: none);

    then once per step: the batch group's all-reduce of the gradients of
    the leaves no rule covers (norm scales), the metrics' all-reduce (the
    batch group's), the global norm's (the mesh's) and, with
    ``grad_compression``, the scales' MAX (the mesh's)."""
    a = cfg.approx
    ln = _lines(dp, tp, pod)
    per_mb = rerun = band = 0
    uncovered = False
    last = "ffn" if cfg.family == "dense" else None   # the block whose w_down ends a layer
    for path, shape, spec in leaf_specs(cfg, _mesh_key(dp, tp, pod)):
        uses, reruns = _uses(cfg, path)
        if _joined(cfg, path):
            uses = 0
        if spec == ():
            uncovered = True
            continue
        fwd, after, bwd = _use_collectives(cfg, path, spec, ln)
        per_mb += uses * (fwd + bwd)
        if cfg.remat and reruns:
            ends = last is not None and path.endswith(f"['{last}'].w_down")
            rerun += uses * (fwd - (after if ends else 0))
        if len(shape) >= 2 and shape[-1] > 1:
            per = max(1, LEAF_CHUNK // (shape[-2] * shape[-1]))
            chunks = -(-math.prod(shape[:-2]) // per)
            band += chunks * (("data" in spec) + ("model" in spec))
    if cfg.family == "moe" and ln.batch:
        per_mb += 2 * cfg.num_layers * (1 + cfg.remat)
    if a.band_reg > 0:
        per_mb += band
    once = (uncovered and ln.batch) + ln.batch + ln.world + (grad_compression and ln.world)
    return max(microbatch, 1) * (per_mb + rerun) + once


def gathered_bytes_per_train_step(cfg: ModelConfig, dp: int, *, tp: int = 1, pod: int = 1,
                                  microbatch: int = 1) -> int:
    """Bytes the all-gathers of weights return on each rank in one training
    step on a mesh of ``pod x dp x tp`` ranks
    (``collectives_per_train_step``'s gathers): each use of a leaf split
    over data gathers the model rank's part of it in ``cfg.param_dtype``
    (a layer's use its layer, the hybrid's shared block once per group),
    again in each recompute with ``remat``; the band term gathers each
    split weight of more than one column once, over data and then over
    the model axis (the whole weight).  The reduce-scatters move the
    first of these back.  The routing's counts (8 bytes an expert and
    rank) and the head's gathered logits are not in it."""
    size = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    per_mb = 0
    for path, shape, spec in leaf_specs(cfg, _mesh_key(dp, tp, pod)):
        if spec == ():
            continue
        uses, reruns = _uses(cfg, path)
        whole = math.prod(shape) * size
        part = whole // (tp if "model" in spec else 1)            # the data gather's result
        if "data" in spec:
            n = part // (cfg.num_layers if path.startswith("['layers']") else 1)
            per_mb += n * uses * (1 + (cfg.remat and reruns))
        if cfg.approx.band_reg > 0 and len(shape) >= 2 and shape[-1] > 1:
            per_mb += part * ("data" in spec) + whole * ("model" in spec)
    return max(microbatch, 1) * per_mb


def state_bytes_per_rank(cfg: ModelConfig, dp: int, *, tp: int = 1, pod: int = 1,
                         opt_kind: str = "adamw", grad_compression: bool = False) -> int:
    """Bytes of a rank's training state on a mesh of ``pod x dp x tp``
    ranks (``fsdp.init_state``): each parameter leaf (``cfg.param_dtype``)
    and its float32 moments (two for AdamW, one for SGD) and error-feedback
    buffer cut to ``1/dp`` along its data dim and ``1/tp`` along its model
    dim where the rules split them (the pods replicate), and the int32
    step."""
    size = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    specs = leaf_specs(cfg, _mesh_key(dp, tp, pod))
    opt = opt_state_pspecs(O.OptConfig(kind=opt_kind), {p: s for p, _, s in specs})
    moments = len(opt) - 1 + grad_compression
    total = 4
    for _, shape, spec in specs:
        n = math.prod(shape) // (dp if "data" in spec else 1) // (tp if "model" in spec else 1)
        total += n * (size + 4 * moments)
    return total


def k1_shapes_per_rank(cfg: ModelConfig, tokens: int, dp: int, *, tp: int = 1,
                       pod: int = 1) -> list:
    """The sorted (M, K, N) of every K1 call of ``cfg``'s training step on
    a rank of a ``pod x dp x tp`` mesh, for a global batch of ``tokens``:
    M the rank's rows (the batch over pod x dp), (K, N) each projection's
    part (a column split's ``N/tp``, a row split's ``K/tp``; a fused
    product's concatenated parts), and for a MoE's experts the rows of
    its dispatch buffer, the global capacity (the same on every rank)."""
    M = tokens // (pod * dp)
    out = set()
    fused: Dict[str, Tuple[int, int]] = {}
    for path, shape, spec in leaf_specs(cfg, _mesh_key(dp, tp, pod)):
        if not _PROJECTIONS.search(path):
            continue
        K, N = shape[-2:]
        if "model" in spec:
            K, N = (K // tp, N) if spec[-2] == "model" else (K, N // tp)
        if re.search(r"\['moe'\]\.w_", path):
            cap = moe_capacity(tokens, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
            out.add((cap, K, N))
            continue
        group = ("qkv" if cfg.fuse_qkv and path.startswith("['layers']['attn']")
                 and path.endswith((".wq", ".wk", ".wv"))
                 else "gate_up" if cfg.fuse_gate_up and "['ffn']" in path
                 and path.endswith((".w_gate", ".w_up")) else None)
        if group is not None:
            key = path.rsplit(".", 1)[0] + group
            k0, n0 = fused.get(key, (K, 0))
            fused[key] = (k0, n0 + N)
            continue
        out.add((M, K, N))
    out |= {(M, K, N) for K, N in fused.values()}
    return sorted(out)


def band_term_costs(cfg: ModelConfig, dp: int) -> Dict[str, int]:
    """What the band term (``band_reg`` > 0) of one training step costs on
    each rank of a ``dp``-rank data mesh (``train.loop._BandChunk``), per
    microbatch: its ``chunks`` (one all-gather each; a recompute in the
    backward would run two gathers and a reduce-scatter a chunk), the
    bytes those gathers return (``gathered_bytes``: each split weight of
    more than one column whole, in ``cfg.param_dtype``), and the bytes of
    band gradient the rank keeps from the forward to the backward
    (``kept_bytes``: its part of each such weight), which is what the one
    gather a chunk costs in memory."""
    size = torch.empty((), dtype=getattr(torch, cfg.param_dtype)).element_size()
    out = {"chunks": 0, "gathered_bytes": 0, "kept_bytes": 0}
    if cfg.approx.band_reg <= 0:
        return out
    for _, shape, spec in leaf_specs(cfg, dp):
        if "data" not in spec or len(shape) < 2 or shape[-1] <= 1:
            continue
        per = max(1, LEAF_CHUNK // (shape[-2] * shape[-1]))
        out["chunks"] += -(-math.prod(shape[:-2]) // per)
        out["gathered_bytes"] += math.prod(shape) * size
        out["kept_bytes"] += math.prod(shape) * size // dp
    return out


def moe_dispatch_costs(cfg: ModelConfig, dp: int, tokens_per_rank: int) -> Dict[str, int]:
    """One MoE layer's routing in a forward on each rank of a ``dp``-rank
    data mesh whose ranks route ``tokens_per_rank`` tokens each, as
    ``models/moe.moe_ffn`` routes over the global batch: the ``capacity``
    of the global T, the ``buffer_bytes`` of the float32 dispatch buffer
    (experts x capacity x d) that every rank builds whole and all-reduces,
    and the ``expert_flops`` of the gate, up and down products that every
    rank runs on all of it; beside them the rows the rank's own
    assignments fill at most (``own_rows``: top_k x its tokens) and the
    FLOPs of those rows alone (``own_flops``), all a rank-local expert
    pass would need."""
    capacity = moe_capacity(tokens_per_rank * dp, cfg.moe_top_k, cfg.moe_experts,
                            cfg.capacity_factor)
    rows = cfg.moe_experts * capacity
    own = min(rows, cfg.moe_top_k * tokens_per_rank)
    per_row = 2 * 3 * cfg.d_model * cfg.d_ff
    return {"capacity": capacity, "buffer_bytes": 4 * rows * cfg.d_model,
            "expert_flops": rows * per_row, "own_rows": own, "own_flops": own * per_row}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int, float]:
    """(N, tokens, model FLOPs): 6*N*tokens for training, 2*N*tokens
    otherwise, N the active parameters of a MoE."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return n, tokens, float((6 if shape.kind == "train" else 2) * n * tokens)


def _prefill(cfg: ModelConfig):
    def step(params, batch):
        return forward(cfg, params, batch.get("tokens"), embeddings=batch.get("embeddings"),
                       positions_thw=batch.get("positions_thw"))
    return step


def _decode(cfg: ModelConfig):
    def step(params, cache, batch, cur_len):
        return decode_step(cfg, params, cache, batch.get("tokens"), cur_len,
                           embeddings=batch.get("embeddings"))
    return step


def build_step(cfg: ModelConfig, shape: ShapeConfig, opt_cfg: O.OptConfig, *,
               microbatch: int = 1):
    """(step, its arguments on ``meta``, whether it records gradients)."""
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        return (make_train_step(cfg, opt_cfg, microbatch=microbatch),
                (state_specs(cfg, opt_cfg), batch), True)
    params = params_specs(cfg, frozen=True)
    if shape.kind == "prefill":
        return _prefill(cfg), (params, batch), False
    cur_len = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
    return _decode(cfg), (params, cache_specs(cfg, shape), batch, cur_len), False


def _count(cfg, shape, opt_cfg) -> R.Costs:
    fn, args, grad = build_step(cfg, shape, opt_cfg)
    with torch.set_grad_enabled(grad):
        return R.count_costs(fn, *args)


def backward_peak(c1: R.Costs, c2: R.Costs, n: float) -> float:
    """The most bytes alive at the end of a training step of ``n`` layer
    units, from its counts at 1 (``c1``) and 2 units (``c2``): the
    operations their traces share at their end (the first unit's backward,
    the stacking of the layers' gradients, the update) stand at the same
    distance from the end at any depth, and the bytes alive after each grow
    by a fixed amount per unit (one more layer's gradients), so each is
    extrapolated on its own line."""
    (o1, a1), (o2, a2) = c1.trace, c2.trace
    n1, n2 = len(o1), len(o2)
    q = 0
    while q < n1 and o1[n1 - 1 - q] == o2[n2 - 1 - q]:
        q += 1
    if q == 0:
        return 0.0
    t1, t2 = (torch.tensor(a[len(a) - q:], dtype=torch.float64) for a in (a1, a2))
    return float((t1 + (n - 1) * (t2 - t1)).max())


PEAKS = ("flat", "grows", "backward")


def in_depth(cfg: ModelConfig, count: Callable[[ModelConfig], R.Costs], *,
             peak: str) -> Dict[str, Any]:
    """A step's costs at ``cfg``'s depth from ``count`` (the costs of the
    step at a given config) at 1 and 2 layer units (a hybrid's unit is
    ``attn_every`` layers): ``fixed + n_units * per_unit``, exact where the
    step is linear in depth, as the port's layer loop is.  ``peak`` says
    how the peak of live storages goes with depth: ``"flat"``, a forward
    that frees each layer's temporaries (that of two units); ``"grows"``, a
    forward that keeps each layer's outputs (on the line through 1 and 2
    units); ``"backward"``, a training step, the larger of that line (the
    saved layer inputs) and ``backward_peak`` (the layers' gradients, which
    set the peak from about ten layers on)."""
    if peak not in PEAKS:
        raise ValueError(f"peak must be one of {PEAKS}, not {peak!r}")
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    t0 = time.perf_counter()
    c1, c2 = (count(dataclasses.replace(cfg, num_layers=k * unit)) for k in (1, 2))
    n = cfg.num_layers // unit
    total = R.combine((2.0 - n, c1), (n - 1.0, c2))
    line = c1.peak_bytes + (n - 1) * (c2.peak_bytes - c1.peak_bytes)
    if peak == "flat":
        total.peak_bytes = c2.peak_bytes
    elif peak == "grows":
        total.peak_bytes = line
    else:
        total.peak_bytes = max(line, round(backward_peak(c1, c2, n)))
    return {"n_units": n, "total": total, "per_unit": R.combine((1.0, c2), (-1.0, c1)),
            "fixed": R.combine((2.0, c1), (-1.0, c2)), "count_s": time.perf_counter() - t0}


def extract_costs(cfg: ModelConfig, shape: ShapeConfig, opt_cfg: O.OptConfig) -> Dict[str, Any]:
    """The two-point count extrapolated in depth (``in_depth``), times
    the microbatches (see the module text)."""
    mb = auto_microbatch(cfg, shape) if shape.kind == "train" else 1
    shape_mb = dataclasses.replace(shape, global_batch=max(1, shape.global_batch // mb))
    out = in_depth(cfg, lambda c: _count(c, shape_mb, opt_cfg),
                   peak="backward" if shape.kind == "train" else "flat")
    peak = out["total"].peak_bytes
    out["total"] = R.combine((float(mb), out["total"]))
    out["total"].peak_bytes = peak
    return {"microbatches": mb, **out}


def run_cell(arch: str, shape_name: str) -> Dict[str, Any]:
    """One cell's dry run at one device of the target card (see the
    module text); the JAX package's keys where their meaning holds
    (``count_s`` in place of ``lower_s``/``compile_s``) and each kernel's
    calls and work."""
    card = R.TARGET_CARD
    cfg = dataclasses.replace(get_config(arch), approx=APPROX)
    shape = SHAPES[shape_name]
    skip = cell_supported(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "skipped": skip}
    opt_cfg = O.OptConfig()
    costs = extract_costs(cfg, shape, opt_cfg)
    total = costs["total"]
    n_params, tokens, mf = model_flops(cfg, shape)
    terms = R.roofline_terms(flops_per_device=total.compute_by_class(),
                             bytes_per_device=total.total_bytes(), wire_bytes_per_device=0.0,
                             n_devices=1, model_flops_global=mf, card=card)
    return {
        "arch": arch, "shape": shape_name, "n_devices": 1, "card": card,
        "approx_mode": APPROX.mode, "multiplier": APPROX.multiplier, "kind": shape.kind,
        "count_s": costs["count_s"],
        "params": n_params, "tokens": tokens, "microbatches": costs["microbatches"],
        "cost_breakdown": {
            "n_units": costs["n_units"], "bytes_raw": total.bytes_raw,
            "n_ops": total.n_ops,
            **{f"{k}_{part}": getattr(costs[part], k) if k != "flops"
               else costs[part].flops_total for part in ("per_unit", "fixed")
               for k in ("flops", "bytes", "bytes_raw")}},
        "kernels": {k: {"calls": v["calls"], "bytes": v["bytes"], "ops": v["ops"],
                        "design_ops": v["design_ops"], "op_class": v["op_class"]}
                    for k, v in total.kernels.items()},
        "argument_size_in_bytes": tree_bytes(*build_step(cfg, shape, opt_cfg)[1]),
        "temp_size_in_bytes": total.peak_bytes,
        **terms,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of the port's cells on meta")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every arch and shape")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.all and args.arch is None and args.shape is None:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    elif not args.all and args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        tag = f"{arch}__{shape}"
        try:
            res = run_cell(arch, shape)
        except Exception as e:  # noqa: BLE001 - report every failing cell, then exit 1
            traceback.print_exc()
            failures.append((tag, repr(e)))
            continue
        if "skipped" not in res:
            print(f"{arch} {shape} on {res['card']}: {res['bound']}-bound "
                  f"{res['t_bound_s']:.4g} s (compute {res['t_compute_s']:.4g}, memory "
                  f"{res['t_memory_s']:.4g}); model-FLOP fraction {res['roofline_fraction']:.4f};"
                  f" arguments {res['argument_size_in_bytes']:.4g} B, temporaries "
                  f"{res['temp_size_in_bytes']:.4g} B")
        path = os.path.join(args.out, tag + ".json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print("wrote:", path)
    if failures:
        print("\nFAILED CELLS:")
        for t, e in failures:
            print(" ", t, e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
