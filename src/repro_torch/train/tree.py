"""Parameter trees as nested dicts, walked in the JAX package's order.

``jax.tree`` flattens a dict in sorted-key order and a named tuple in field
order.  The port keeps the JAX package's ``AttnParams``/``FFNParams`` named
tuples as dicts in field order (``bridge.params_from_numpy`` and
``models.transformer.init_params`` build them so), so a dict whose keys are
exactly such a field tuple is walked in that order and named ``.field`` as
``jax.tree_util.keystr`` names a named-tuple field.  Sums over leaves
(global norms, the band regularizer) therefore add in the JAX package's
order, and checkpoint keys match its keys.  A list (the CNNs' per-layer
parameter dicts) is walked in index order and named ``[i]``, as
``keystr`` names a list entry.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

__all__ = ["leaves", "leaves_with_path", "tree_map", "unflatten"]

# field orders of the JAX package's parameter named tuples
_FIELD_ORDERS = {("wq", "wk", "wv", "wo"), ("w_gate", "w_up", "w_down")}


def _is_fields(node: dict) -> bool:
    return tuple(node) in _FIELD_ORDERS


def _keys(node: dict) -> List[str]:
    return list(node) if _is_fields(node) else sorted(node)


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(keystr, leaf) pairs in the JAX package's flatten order; a keystr is
    ``['a']['b'].wq`` as ``jax.tree_util.keystr`` writes it."""
    if isinstance(tree, dict):
        attr = _is_fields(tree)
        out = []
        for k in _keys(tree):
            out += leaves_with_path(tree[k], prefix + (f".{k}" if attr else f"[{k!r}]"))
        return out
    if isinstance(tree, list):
        return [x for i, node in enumerate(tree) for x in leaves_with_path(node, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves: Iterator[Any]) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in flatten order."""
    it = iter(new_leaves)
    if isinstance(tree, dict):
        out = {}
        for k in _keys(tree):
            out[k] = unflatten(tree[k], it)
        return {k: out[k] for k in tree}
    if isinstance(tree, list):
        return [unflatten(node, it) for node in tree]
    return next(it)
