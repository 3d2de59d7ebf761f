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

On a ``launch.mesh.TrainMesh`` (pod x data x model) the rules' ``"tp"``
dims split over the model axis too (the JAX package's ``"fsdp"`` and
``"tp"`` rules at once): a leaf's rank part is then a block, its
``"fsdp"`` dim cut over the data axis and its ``"tp"`` dim over the model
axis, and ``wrap`` gives it as a ``DataPart`` with its Megatron split
(``core.approx``).  The batch runs over pod x data (``rank_rows`` over the
batch group); the parameters are replicated across pods, and each use's
backward sums a split part's gradient across them.  A leaf no rule covers
is the same on every model rank, so ``reduce_grads`` sums its gradient
over the batch group only.  A mesh axis of size 1 splits nothing.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import DataPart
from repro_torch.launch.mesh import MeshShape, TrainMesh, train_axes
from repro_torch.models.transformer import init_params
from repro_torch.parallel.collectives import all_reduce_sum, gather_value
from repro_torch.parallel.sharding import Spec, batch_pspecs, opt_state_pspecs, param_pspec
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["data_dims", "init_state", "join_leaf", "leaf_specs", "mesh_shape", "rank_rows",
           "reduce_grads", "shard_state", "split_axes", "split_dims", "whole_state", "wrap"]

Dims = Tuple[Optional[int], Optional[int]]       # (data dim, model dim), from the end


def mesh_shape(mesh) -> Union[int, MeshShape]:
    """What ``leaf_specs`` keys a running mesh by: a ``TrainMesh``'s
    ``MeshShape``, or a one-axis data mesh's size."""
    return mesh.mesh_shape if isinstance(mesh, TrainMesh) else mesh.size


@functools.lru_cache(maxsize=None)
def leaf_specs(cfg: ModelConfig, mesh: Union[int, MeshShape]
               ) -> Tuple[Tuple[str, Tuple[int, ...], Spec], ...]:
    """(path, whole shape, spec) of every parameter leaf of ``cfg``, in
    flatten order, from the tree on ``meta``: on a data axis of ``mesh``
    ranks (an int), or on a ``MeshShape``'s axes of more than one rank."""
    if isinstance(mesh, int):
        shape = MeshShape((("data", mesh),))
    else:
        shape = MeshShape(tuple((n, k) for n, k in mesh.axes if k > 1))
    return tuple((path, tuple(t.shape), param_pspec(path, tuple(t.shape), cfg, shape))
                 for path, t in leaves_with_path(init_params(cfg, device="meta")))


def _at(spec: Spec, axis: str) -> Optional[int]:
    return spec.index(axis) - len(spec) if axis in spec else None


def _dims(spec: Spec) -> Dims:
    return _at(spec, "data"), _at(spec, "model")


def split_dims(cfg: ModelConfig, mesh) -> List[Dims]:
    """Per parameter leaf, in flatten order: the dims (from the end) that
    the data axis and the model axis split, each None where it keeps the
    leaf whole; ``mesh`` as ``leaf_specs`` takes it."""
    return [_dims(spec) for _, _, spec in leaf_specs(cfg, mesh)]


def data_dims(cfg: ModelConfig, dp) -> List[Optional[int]]:
    """Per parameter leaf, in flatten order: the dim (from the end) that
    the data axis splits (of ``dp`` ranks, or of a ``MeshShape``), or None
    for a leaf it keeps whole."""
    return [d for d, _ in split_dims(cfg, dp)]


def split_axes(cfg: ModelConfig, mesh) -> List[Tuple[str, ...]]:
    """Per parameter leaf, in flatten order: the axes whose ranks hold
    other parts of it (``optim.global_norm`` sums its squares over them)."""
    return [tuple(a for a, d in zip(("data", "model"), ds) if d is not None)
            for ds in split_dims(cfg, mesh_shape(mesh))]


def _split_kind(path: str, model_dim: Optional[int]) -> Optional[str]:
    if model_dim is None:
        return None
    if path == "['embed']":
        return "vocab"
    return {-1: "column", -2: "row", -3: "expert"}[model_dim]


def _part(t: torch.Tensor, dims: Dims, ax) -> torch.Tensor:
    """The rank's block of ``t`` (its model part, then its data part of
    that) as a contiguous copy outside any graph (``t`` itself where
    neither axis splits it)."""
    d, m = dims
    if d is None and m is None:
        return t
    out = t.detach()
    for dim, axis in ((m, ax.model), (d, ax.data)):
        if dim is not None:
            n = out.shape[dim] // axis.size
            out = out.narrow(dim, axis.rank * n, n)
    return out.clone(memory_format=torch.contiguous_format)


def join_leaf(t: torch.Tensor, dims: Dims, mesh) -> torch.Tensor:
    """The whole leaf from the ranks' blocks (``dims`` its ``split_dims``):
    gathered over the data axis, then over the model axis (every rank
    takes part and gets it; no graph)."""
    d, m = dims
    ax = train_axes(mesh)
    out = t.detach()
    for dim, axis in ((d, ax.data), (m, ax.model)):
        if dim is not None:
            out = gather_value(out, dim, axis)
    return out


def _state_dims(state: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, List[Dims]]:
    """The dims of every leaf group of a training state: the parameters',
    the optimizer state's as ``opt_state_pspecs`` mirrors them, the
    error-feedback buffer's as the parameters'."""
    key = mesh_shape(mesh)
    specs = {path: spec for path, _, spec in leaf_specs(cfg, key)}
    opt = opt_state_pspecs(O.OptConfig(kind="adamw" if "v" in state["opt"] else "sgd"), specs)
    dims = split_dims(cfg, key)
    return {"params": dims, "grad_err": dims,
            **{f"opt.{k}": [_dims(s) for s in opt[k].values()] for k in opt if k != "step"}}


def _cut(tree: Any, dims: List[Dims], ax) -> Any:
    return unflatten(tree, (_part(t, d, ax) for t, d in zip(leaves(tree), dims)))


def shard_state(state: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The rank's part of a whole training state (each split leaf a copy,
    so the whole can be freed); its parameters ready for autograd."""
    dims, ax = _state_dims(state, cfg, mesh), train_axes(mesh)
    out = {"params": _cut(state["params"], dims["params"], ax),
           "opt": {k: v if k == "step" else _cut(v, dims[f"opt.{k}"], ax)
                   for k, v in state["opt"].items()}}
    if "grad_err" in state:
        out["grad_err"] = _cut(state["grad_err"], dims["grad_err"], ax)
    for p in leaves(out["params"]):
        p.requires_grad_(True)
    return out


def init_state(cfg: ModelConfig, opt_cfg: O.OptConfig, seed: int, mesh, *,
               grad_compression: bool = False, device=None) -> Dict[str, Any]:
    """The rank's part of ``train.loop.init_state``'s state: the seeded
    parameters drawn whole (the same draw as one device's) and cut, the
    moments and error buffers zero on the parts alone."""
    params = _cut(init_params(cfg, seed, device=device), split_dims(cfg, mesh_shape(mesh)),
                  train_axes(mesh))
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
        return unflatten(tree, (join_leaf(t, d, mesh).to(device or t.device)
                                for t, d in zip(leaves(tree), ds)))

    out = {"params": join(state["params"], dims["params"]),
           "opt": {k: v.to(device or v.device) if k == "step" else join(v, dims[f"opt.{k}"])
                   for k, v in state["opt"].items()}}
    if "grad_err" in state:
        out["grad_err"] = join(state["grad_err"], dims["grad_err"])
    return out


def wrap(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The view of the rank's parameters that the forward takes: every
    leaf a rule covers as a ``DataPart`` (its block, its data dim or None,
    and its model split), the others (norm scales) as they are."""
    ax = train_axes(mesh)
    specs = leaf_specs(cfg, mesh_shape(mesh))
    out = []
    for t, (path, _, spec) in zip(leaves(params), specs):
        if spec == ():
            out.append(t)
            continue
        d, m = _dims(spec)
        out.append(DataPart(t, d, ax.data, _split_kind(path, m), ax))
    return unflatten(params, out)


def reduce_grads(grads: List[torch.Tensor], cfg: ModelConfig, mesh) -> List[torch.Tensor]:
    """The global gradients of the rank's parts from its ``autograd.grad``
    results (each rank differentiates its share of the global loss,
    ``train.loop.make_train_step``): a ``DataPart`` leaf's, split or
    replicated, as they are (each use's backward summed the ranks'
    cotangents); the leaves no rule covers (norm scales) summed over the
    batch group in one all-reduce of their concatenation (every model
    rank holds the same gradient of them)."""
    batch = train_axes(mesh).batch
    rest = [i for i, (_, _, spec) in enumerate(leaf_specs(cfg, mesh_shape(mesh)))
            if spec == ()]
    out = list(grads)
    if rest and batch is not None:
        flat = all_reduce_sum(torch.cat([out[i].reshape(-1).to(torch.float32) for i in rest]),
                              batch)
        for i, piece in zip(rest, flat.split([out[i].numel() for i in rest])):
            out[i] = piece.view(out[i].shape).to(out[i].dtype)
    return out


def rank_rows(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh,
              microbatch: int = 1) -> Dict[str, torch.Tensor]:
    """The rank's rows of a global batch, for each key ``batch_pspecs``
    splits over the batch axes (pod x data): of each of the
    ``microbatch`` contiguous chunks the step accumulates over (the JAX
    package's ``split``), the batch group rank's ``1/size``, in chunk
    order.  So the rank's microbatch j, taken contiguously from these
    rows, is its slice of the global chunk j."""
    specs = batch_pspecs(cfg, mesh, "train")
    group = train_axes(mesh).batch
    if group is None:
        return dict(batch)
    mb = max(microbatch, 1)
    out = {}
    for k, v in batch.items():
        if k not in specs or specs[k][0] is None:
            out[k] = v
            continue
        B = v.shape[0]
        if B % (mb * group.size):
            raise ValueError(f"batch {B} does not split into {mb} microbatches of "
                             f"{group.size} ranks' rows")
        out[k] = v.reshape(mb, group.size, B // (mb * group.size), *v.shape[1:])[:, group.rank] \
            .reshape(B // group.size, *v.shape[1:])
    return out
