"""Tensor-parallel serving at run time: each rank's part of the
parameters and of the paged pool, cut by the sharding rules
(``parallel/sharding.py``) on a ``launch.mesh.TPMesh``, and the
collectives that join the parts (``parallel/collectives.py``).

``shard_params`` cuts every leaf whose rule names the ``"model"`` axis
(a rule whose dim the axis does not divide leaves the leaf whole, as
granite's 49,155-row embedding) into a ``core.approx.Shard``: the
projections Megatron-style (``wq``/``wk``/``wv``/``w_gate``/``w_up`` and
the LM head by output column, ``wo``/``w_down`` by input row), the
embedding by vocab row, and a MoE's routed-expert stacks by expert where
the experts divide the axis (each rank holds ``E/tp`` whole experts).  A
frozen ``QWeight`` must be frozen whole before it is cut (a K-part's
per-channel scale would be another scale): a column split slices its
per-channel scale, zero point and column sums with its codes' columns,
an expert split slices every field that carries the expert axis, a row
split keeps them whole.  A fused serving leaf (``wqkv``, ``w_gate_up``)
is cut piece by piece and joined again per rank, so rank r holds
``[q_r | k_r | v_r]``.  ``shard_cache`` keeps the rank's KV heads of
the paged pool.  Every part is a copy, so the whole tensor can be freed.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import QWeight, Shard, concat_weights
from repro_torch.parallel.collectives import (
    COUNTS,
    all_gather_last,
    all_reduce_max,
    all_reduce_sum,
    max_range,
)
from repro_torch.parallel.sharding import cache_pspecs, param_pspec
from repro_torch.train.tree import leaves_with_path, unflatten

__all__ = ["COUNTS", "all_gather_last", "all_reduce_max", "all_reduce_sum", "max_range",
           "shard_cache", "shard_params"]


def _part(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The rank's ``1/size`` of ``t`` along ``dim``, as a contiguous copy."""
    n = t.shape[dim] // mesh.size
    return t.narrow(dim, mesh.rank * n, n).clone(memory_format=torch.contiguous_format)


# a fused serving leaf (``transformer.fuse_params``) and the leaves it joins
_FUSED = {".wqkv": (".wq", ".wk", ".wv"), ".w_gate_up": (".w_gate", ".w_up")}


def _columns(leaf, widths):
    """``leaf`` (a tensor or a QWeight whose per-channel fields follow its
    columns) cut into consecutive column pieces of ``widths``."""
    if not isinstance(leaf, QWeight):
        return list(leaf.split(list(widths), dim=-1))
    n = leaf.codes.shape[-1]
    fields = [t.split(list(widths), dim=-1) if t.dim() > 0 and t.shape[-1] == n
              else (t,) * len(widths) for t in leaf]
    return [QWeight(*f) for f in zip(*fields)]


def _shard_fused(path: str, suffix: str, leaf, cfg: ModelConfig, mesh):
    """A fused leaf cut piece by piece: the rank's ``[q_r | k_r | v_r]``
    (or ``[gate_r | up_r]``), each piece as its own leaf's rule cuts it."""
    hd = cfg.head_dim
    widths = ((cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd)
              if suffix == ".wqkv" else (cfg.d_ff, cfg.d_ff))
    base = path[: -len(suffix)]
    parts = [_shard_leaf(base + name, piece, cfg, mesh)
             for name, piece in zip(_FUSED[suffix], _columns(leaf, widths))]
    if not any(isinstance(p, Shard) for p in parts):
        return leaf
    return concat_weights(parts)


def _shard_leaf(path: str, leaf, cfg: ModelConfig, mesh):
    if isinstance(leaf, Shard):                    # cut already
        return leaf
    for suffix in _FUSED:
        if path.endswith(suffix):
            return _shard_fused(path, suffix, leaf, cfg, mesh)
    codes = leaf.codes if isinstance(leaf, QWeight) else leaf
    spec = param_pspec(path + (".codes" if isinstance(leaf, QWeight) else ""),
                       tuple(codes.shape), cfg, mesh)
    if "model" not in spec:
        return leaf
    dim = spec.index("model") - len(spec)          # from the end: -1, -2 or -3
    if path == "['embed']":
        split = "vocab"
    else:
        split = {-1: "column", -2: "row", -3: "expert"}[dim]
    if not isinstance(leaf, QWeight):
        return Shard(_part(leaf, dim, mesh), split, mesh)

    def field(t):
        # per-channel fields follow a column split; fields that carry the
        # expert axis follow an expert split; the rest stay whole
        if split == "column" and t.dim() > 0 and t.shape[-1] == codes.shape[-1] > 1:
            return _part(t, -1, mesh)
        if split == "expert" and t.dim() == codes.dim() and t.shape[-3] == codes.shape[-3]:
            return _part(t, -3, mesh)
        return t

    return Shard(QWeight(_part(codes, dim, mesh), *(field(t) for t in leaf[1:])), split, mesh)


def shard_params(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The rank's parameter tree: every leaf that the rules split over
    ``mesh``'s ``"model"`` axis as a ``Shard`` of its part, the rest as
    they are; a tree cut already passes through (a rank that cut its
    weights as it built them, so it never holds two whole copies).  The
    dense and moe families: the ssm and hybrid families keep no paged
    pool, which serving under a mesh needs (in the JAX package too)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"tensor-parallel serving of the {cfg.family} family: its decode state "
            "has no paged layout, and a mesh serves the paged pool only")
    pairs = leaves_with_path(params)
    return unflatten(params, (_shard_leaf(p, leaf, cfg, mesh) for p, leaf in pairs))


def shard_cache(cfg: ModelConfig, mesh, cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The rank's part of a paged pool (leaves (L, blocks + 1, block_size,
    Hkv, hd)): its KV heads where the axis divides them
    (``cache_pspecs(layout="paged")``), else the leaf whole."""
    specs = cache_pspecs(cfg, mesh, cache, layout="paged")
    return {k: _part(t, specs[k].index("model"), mesh) if "model" in specs[k] else t
            for k, t in cache.items()}
