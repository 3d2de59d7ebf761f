"""Sharding rules: which mesh axes split each dimension of a parameter,
batch input or cache leaf (data parallelism over pod x data, tensor or
expert parallelism over model, FSDP parameter sharding over data,
sequence parallelism as the slot cache's fallback).

Pure functions of a leaf's path, its shape and the mesh's axis sizes
(anything with ``axis_names`` and a ``shape`` mapping, as
``launch/mesh.MeshShape``): a spec is a tuple with one entry per
dimension, an axis name, a tuple of names or None, or ``()`` for a leaf
that replicates whole, as the JAX package's ``PartitionSpec``s.  A
dimension is split only where its size divides the axes' product, so
shards stay exact.  Paths are the JAX package's key strings
(``['layers']['attn'].wq``, a frozen weight's ``.codes``).  Nothing here
builds a process group or moves a tensor.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import QWeight, Shard
from repro_torch.launch.mesh import batch_axes
from repro_torch.train.tree import leaves_with_path

__all__ = ["Spec", "batch_pspecs", "cache_pspecs", "named_leaves", "opt_state_pspecs",
           "param_pspec", "param_pspecs", "prune_pspec", "tree_bytes"]

Spec = Tuple[Any, ...]

# (regex on path, {dim from the END of the shape: "fsdp" (data) | "tp" (model)})
_RULES: Tuple[Tuple[str, Dict[int, str]], ...] = (
    # attention / dense projections: (..., d_in, d_out)
    (r"\.wq$|\.wk$|\.wv$|w_gate$|w_up$|shared_gate$|shared_up$", {-2: "fsdp", -1: "tp"}),
    # the fused serving leaves: column-parallel piece by piece (parallel/tp.py)
    (r"\.wqkv$|\.w_gate_up$", {-2: "fsdp", -1: "tp"}),
    (r"\.wo$|w_down$|shared_down$", {-2: "tp", -1: "fsdp"}),
    (r"router$|shared_router$", {-2: "fsdp"}),
    # embeddings / head
    (r"^\['embed'\]$", {-2: "tp", -1: "fsdp"}),
    (r"^\['lm_head'\]$", {-2: "fsdp", -1: "tp"}),
    # mamba
    (r"\.in_proj$|\.x_proj$", {-2: "fsdp", -1: "tp"}),
    (r"\.out_proj$", {-2: "tp", -1: "fsdp"}),
    (r"\.dt_proj$", {-1: "tp"}),
    (r"\.conv_w$|\.conv_b$|\.a_log$|\.d_skip$|\.dt_bias$|\.norm_g$", {-1: "tp"}),
    # everything else (norm scales, biases): replicated
)

_MOE_EP_RULES: Tuple[Tuple[str, Dict[int, str]], ...] = (
    # expert parallelism: the experts' dim over model
    (r"\['moe'\]\.w_gate$|\['moe'\]\.w_up$", {-3: "tp", -2: "fsdp"}),
    (r"\['moe'\]\.w_down$", {-3: "tp", -1: "fsdp"}),
)


def _entry(names: Tuple[str, ...]) -> Any:
    """One dim's entry as a ``PartitionSpec`` holds it: None for no axis,
    the name for one, the tuple for more."""
    return None if not names else names[0] if len(names) == 1 else names


def _axis_size(mesh, name: Optional[str]) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def param_pspec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh) -> Spec:
    """The spec of one parameter leaf.  A frozen weight's codes shard as
    the float weight; its per-channel scale, zero point and column sums
    replicate."""
    if path.endswith((".scale", ".zero_point", ".col_sum")):
        return ()
    if path.endswith(".codes"):
        path = path[: -len(".codes")]
    fsdp_ax = "data" if "data" in mesh.axis_names else None
    tp_ax = "model" if "model" in mesh.axis_names else None
    alias = {"fsdp": fsdp_ax, "tp": tp_ax}
    rules = _RULES
    if cfg.family == "moe" and cfg.moe_experts % _axis_size(mesh, tp_ax) == 0:
        rules = _MOE_EP_RULES + _RULES   # EP when the experts divide the TP axis
    for pat, dims in rules:
        if re.search(pat, path):
            spec: List[Any] = [None] * len(shape)
            for rel, ax_alias in dims.items():
                ax, idx = alias[ax_alias], len(shape) + rel
                if ax is None or idx < 0:
                    continue
                if shape[idx] % mesh.shape[ax] == 0:
                    spec[idx] = ax
            return tuple(spec)      # never the stacked-layer leading axis
    return ()


def named_leaves(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) in the JAX package's flatten order and key strings,
    a frozen ``QWeight`` expanded into its ``.codes``, ``.scale``,
    ``.zero_point`` and ``.col_sum``, a ``Shard`` read as its part."""
    out = []
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, Shard):
            leaf = leaf.w
        if isinstance(leaf, QWeight):
            out += [(f"{path}.{f}", t) for f, t in zip(QWeight._fields, leaf)]
        else:
            out.append((path, leaf))
    return out


def param_pspecs(cfg: ModelConfig, params: Any, mesh) -> Dict[str, Spec]:
    """Path -> spec for every leaf of a parameter tree."""
    return {p: param_pspec(p, tuple(t.shape), cfg, mesh) for p, t in named_leaves(params)}


def opt_state_pspecs(opt_cfg, param_specs: Dict[str, Spec]) -> Dict[str, Any]:
    """The optimizer state's specs, as the JAX package's
    ``opt_state_shardings`` gives them: the step replicated, each moment
    leaf (``m``, and ``v`` for AdamW) sharded as its parameter."""
    out: Dict[str, Any] = {"step": (), "m": dict(param_specs)}
    if opt_cfg.kind == "adamw":
        out["v"] = dict(param_specs)
    return out


def batch_pspecs(cfg: ModelConfig, mesh, kind: str) -> Dict[str, Spec]:
    """Specs of the batch inputs of a shape kind: the batch dim over the
    data-parallel axes."""
    b = (_entry(batch_axes(mesh)),)
    specs: Dict[str, Spec] = {"tokens" if cfg.embed_input else "embeddings": b}
    if kind == "train":
        specs["labels"] = b
    if cfg.pos_embedding == "m_rope":
        specs["positions_thw"] = b
    if kind == "decode":
        specs["cur_len"] = b
    return specs


def prune_pspec(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop each dim's axes whose sizes do not divide it (a batch of 1
    over 16 data shards) or that the mesh lacks."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(a for a in names if a in mesh.axis_names)
        size = 1
        for a in names:
            size *= int(mesh.shape[a])
        out.append(_entry(names) if dim % size == 0 else None)
    return tuple(out)


def cache_pspecs(cfg: ModelConfig, mesh, cache: Dict[str, torch.Tensor], *,
                 layout: str = "slots") -> Dict[str, Spec]:
    """Decode-cache specs, key -> spec (the JAX package's rules).

    ``"slots"`` (leaves (L, B, S, Hkv, hd) and the conv/ssm state): the
    batch over the data-parallel axes; KV heads over model where they
    divide it, else the sequence (SP); the Mamba state's channels or heads
    and the conv taps' channels over model.  ``"paged"`` (leaves (L,
    blocks, block_size, Hkv, hd)): only the KV-head dim, over model, where
    it divides; the block dim never splits (the tables are host state)."""
    if layout not in ("slots", "paged"):
        raise ValueError(f"cache_pspecs: unknown layout {layout!r}")
    dp = batch_axes(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    tp_size = _axis_size(mesh, tp)
    out = {}
    for key, leaf in cache.items():
        shape = tuple(leaf.shape)
        spec: List[Any] = [None] * len(shape)
        if layout == "paged":
            if key in ("k", "v") and tp and shape[3] % tp_size == 0:
                spec[3] = tp
        else:
            spec[1] = _entry(dp)
            if key in ("k", "v"):
                if tp and shape[3] % tp_size == 0:
                    spec[3] = tp
                elif tp and shape[2] % tp_size == 0:
                    spec[2] = tp          # SP over the cache length
            elif key == "ssm" or key == "conv":
                dim = 2 if key == "ssm" else 3
                if tp and shape[dim] % tp_size == 0:
                    spec[dim] = tp
        out[key] = prune_pspec(mesh, tuple(spec), shape)
    return out


def tree_bytes(*trees: Any) -> int:
    """Bytes of every tensor in ``trees`` (a frozen weight's fields too; a
    ``Shard``'s part)."""
    return sum(t.numel() * t.element_size() for tree in trees for _, t in named_leaves(tree))
