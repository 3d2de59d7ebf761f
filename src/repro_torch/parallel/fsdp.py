"""Data-parallel training with FSDP sharding over a ``launch.mesh.DataMesh``:
the JAX package's ``"fsdp"`` rules (``parallel/sharding.py``) resolved to
the data axis, as its launcher shards a training state.

Every parameter leaf whose rule splits a dim over ``"data"`` lives on each
rank only as its ``1/size`` along that dim, and so do its AdamW moments and
its error-feedback buffer (``opt_state_pspecs`` mirrors the parameters'
specs); a leaf that no rule splits, or whose dim the axis does not divide,
stays whole on every rank.  The state's leaves stay plain tensors, so
autograd, the optimizer and the checkpoint see tensors: ``shard_state``
cuts a whole state, ``init_state`` builds the seeded one a part at a time
and ``whole_state`` gathers it back.

In the step (``train.loop.make_train_step(..., mesh=)``) the forward sees
``wrap``'s view: each projection weight, embedding and head as a
``core.approx.DataPart``, which ``layers.unstack`` cuts per layer and
``layers.dense``/``embed`` gather whole where they use it (an all-gather
along the split dim whose backward reduce-scatters the cotangent, so each
rank gets the sum of the ranks' gradients for its part); a replicated
projection weight is a ``DataPart`` too, which carries the activation
ranges across the ranks' rows and sums each use's gradient over the ranks
in its backward (a float32 all-reduce).  Each rank differentiates its
share of the global loss, so those sums are the global gradients;
``reduce_grads`` then all-reduces the gradients of the leaves no rule
covers (norm scales).  The two agree leaf by leaf, by the spec alone: a
leaf whose spec is ``()`` is a plain tensor whose gradient
``reduce_grads`` sums once, and every other leaf, split or not (a spec of
``None``s: the Mamba blocks' ``dt_proj``, convolution and scan
parameters under a data axis, which the rules split only over
``model``), is a ``DataPart`` whose every use sums its gradient (model
code reads it through ``dense``, ``embed``, ``layers.whole`` or, a MoE
layer's expert stacks, ``owned_whole`` once per layer), so no gradient is
summed twice or never.
``rank_rows`` keeps the rank's rows of the global batch: of the tokens or
embeddings, the labels and the multimodal positions grid.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import DataPart
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.transformer import init_params
from repro_torch.parallel.collectives import all_reduce_sum, gather_dim
from repro_torch.parallel.sharding import Spec, batch_pspecs, opt_state_pspecs, param_pspec
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["data_dims", "init_state", "leaf_specs", "rank_rows", "reduce_grads", "shard_state",
           "whole_state", "wrap"]


@functools.lru_cache(maxsize=None)
def leaf_specs(cfg: ModelConfig, dp: int) -> Tuple[Tuple[str, Tuple[int, ...], Spec], ...]:
    """(path, whole shape, spec) of every parameter leaf of ``cfg`` on a
    data axis of ``dp`` ranks, in flatten order, from the tree on
    ``meta``."""
    mesh = MeshShape((("data", dp),))
    return tuple((path, tuple(t.shape), param_pspec(path, tuple(t.shape), cfg, mesh))
                 for path, t in leaves_with_path(init_params(cfg, device="meta")))


def _dim(spec: Spec) -> Optional[int]:
    return spec.index("data") - len(spec) if "data" in spec else None


def data_dims(cfg: ModelConfig, dp: int) -> List[Optional[int]]:
    """Per parameter leaf, in flatten order: the dim (from the end) that a
    data axis of ``dp`` ranks splits, or None for a leaf kept whole."""
    return [_dim(spec) for _, _, spec in leaf_specs(cfg, dp)]


def _part(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """The rank's ``1/size`` of ``t`` along ``dim`` as a contiguous copy
    outside any graph (``t`` itself for None)."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.size
    return t.detach().narrow(dim, mesh.rank * n, n).clone(memory_format=torch.contiguous_format)


def _cut(tree: Any, dims: List[Optional[int]], mesh) -> Any:
    return unflatten(tree, (_part(t, d, mesh) for t, d in zip(leaves(tree), dims)))


def _state_dims(state: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The dims of every leaf group of a training state: the parameters',
    the optimizer state's as ``opt_state_pspecs`` mirrors them, the
    error-feedback buffer's as the parameters'."""
    specs = {path: spec for path, _, spec in leaf_specs(cfg, mesh.size)}
    opt = opt_state_pspecs(O.OptConfig(kind="adamw" if "v" in state["opt"] else "sgd"), specs)
    dims = data_dims(cfg, mesh.size)
    return {"params": dims, "grad_err": dims,
            **{f"opt.{k}": [_dim(s) for s in opt[k].values()] for k in opt if k != "step"}}


def shard_state(state: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The rank's part of a whole training state (each split leaf a copy,
    so the whole can be freed); its parameters ready for autograd."""
    dims = _state_dims(state, cfg, mesh)
    out = {"params": _cut(state["params"], dims["params"], mesh),
           "opt": {k: v if k == "step" else _cut(v, dims[f"opt.{k}"], mesh)
                   for k, v in state["opt"].items()}}
    if "grad_err" in state:
        out["grad_err"] = _cut(state["grad_err"], dims["grad_err"], mesh)
    for p in leaves(out["params"]):
        p.requires_grad_(True)
    return out


def init_state(cfg: ModelConfig, opt_cfg: O.OptConfig, seed: int, mesh, *,
               grad_compression: bool = False, device=None) -> Dict[str, Any]:
    """The rank's part of ``train.loop.init_state``'s state: the seeded
    parameters drawn whole (the same draw as one device's) and cut, the
    moments and error buffers zero on the parts alone."""
    params = _cut(init_params(cfg, seed, device=device), data_dims(cfg, mesh.size), mesh)
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": O.init_opt_state(opt_cfg, params)}
    if grad_compression:
        state["grad_err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


@torch.no_grad()
def whole_state(state: Dict[str, Any], cfg: ModelConfig, mesh, *, device=None) -> Dict[str, Any]:
    """Every leaf of the rank's state whole (the split ones gathered, on
    every rank), moved to ``device`` (default: where it is)."""
    dims = _state_dims(state, cfg, mesh)

    def join(tree, ds):
        return unflatten(tree, ((t.detach() if d is None else gather_dim(t.detach(), d, mesh))
                                .to(device or t.device) for t, d in zip(leaves(tree), ds)))

    out = {"params": join(state["params"], dims["params"]),
           "opt": {k: v.to(device or v.device) if k == "step" else join(v, dims[f"opt.{k}"])
                   for k, v in state["opt"].items()}}
    if "grad_err" in state:
        out["grad_err"] = join(state["grad_err"], dims["grad_err"])
    return out


def wrap(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The view of the rank's parameters that the forward takes: every
    leaf a rule covers as a ``DataPart`` (its part and split dim, or the
    whole leaf with dim None), the others (norm scales) as they are."""
    specs = leaf_specs(cfg, mesh.size)
    return unflatten(params, (t if spec == () else DataPart(t, _dim(spec), mesh)
                              for t, (_, _, spec) in zip(leaves(params), specs)))


def reduce_grads(grads: List[torch.Tensor], cfg: ModelConfig, mesh) -> List[torch.Tensor]:
    """The global gradients of the rank's parts from its ``autograd.grad``
    results (each rank differentiates its share of the global loss,
    ``train.loop.make_train_step``): a ``DataPart`` leaf's, split or
    replicated, as they are (each use's backward summed the ranks'
    cotangents); the leaves no rule covers (norm scales) summed over the
    ranks in one all-reduce of their concatenation."""
    rest = [i for i, (_, _, spec) in enumerate(leaf_specs(cfg, mesh.size)) if spec == ()]
    out = list(grads)
    if rest:
        flat = all_reduce_sum(torch.cat([out[i].reshape(-1).to(torch.float32) for i in rest]),
                              mesh)
        for i, piece in zip(rest, flat.split([out[i].numel() for i in rest])):
            out[i] = piece.view(out[i].shape).to(out[i].dtype)
    return out


def rank_rows(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh,
              microbatch: int = 1) -> Dict[str, torch.Tensor]:
    """The rank's rows of a global batch, for each key ``batch_pspecs``
    splits over the data axis: of each of the ``microbatch`` contiguous
    chunks the step accumulates over (the JAX package's ``split``), the
    rank's ``1/size``, in chunk order.  So the rank's microbatch j, taken
    contiguously from these rows, is its slice of the global chunk j."""
    specs = batch_pspecs(cfg, mesh, "train")
    mb = max(microbatch, 1)
    out = {}
    for k, v in batch.items():
        if k not in specs or specs[k][0] is None:
            out[k] = v
            continue
        B = v.shape[0]
        if B % (mb * mesh.size):
            raise ValueError(f"batch {B} does not split into {mb} microbatches of "
                             f"{mesh.size} ranks' rows")
        out[k] = v.reshape(mb, mesh.size, B // (mb * mesh.size), *v.shape[1:])[:, mesh.rank] \
            .reshape(B // mesh.size, *v.shape[1:])
    return out
