"""Bring the JAX package's parameter trees across, through numpy.

``params_from_numpy(tree)`` takes the JAX ``init_params`` pytree after
``jax.tree.map(np.asarray, ...)`` — dicts, the ``AttnParams``/``FFNParams``
named tuples and, for frozen trees, JAX ``QWeight`` named tuples, all with
numpy leaves — and returns the port's parameter dict of the same shape:
named tuples of weights become dicts keyed by field name, and a frozen
weight becomes the port's ``QWeight``.  ``state_from_numpy`` does the same
for a whole training state (``{"params", "opt": {"step", "m", "v"}}`` and
``grad_err``), so a test can start the port's step from the JAX step's
exact parameters and optimizer state.  ``cnn_from_numpy`` takes the JAX
``init_cnn`` model (``{"name", "layers": [per-layer dicts], "defs"}``) and
returns the port's ``models/cnn.py`` model, conv weights in HWIO as they
are.  Nothing here imports JAX; the tests do the ``np.asarray``
conversion.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.approx import QWeight
from repro_torch.train.tree import leaves

__all__ = ["cnn_from_numpy", "params_from_numpy", "state_from_numpy"]

_QWEIGHT_FIELDS = ("codes", "scale", "zero_point", "col_sum")


def params_from_numpy(tree: Any, device="cpu") -> Any:
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields is not None:
            if tuple(fields) == _QWEIGHT_FIELDS:
                return QWeight(*(conv(x) for x in node))
            return {f: conv(x) for f, x in zip(fields, node)}
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return conv(tree)


def state_from_numpy(state: Any, device="cpu") -> Any:
    """A JAX training state (numpy leaves) as the port's: parameters,
    moments, the int32 ``step`` and any error-feedback buffers, with the
    parameters ready for autograd."""
    out = params_from_numpy(state, device)
    for leaf in leaves(out["params"]):
        leaf.requires_grad_(True)
    return out


def cnn_from_numpy(model: Any, device="cpu") -> Any:
    """A JAX ``init_cnn`` model with numpy leaves as the port's CNN model:
    the same name and layer defs, every per-layer dict's arrays as float32
    tensors on ``device``."""
    return {"name": model["name"], "defs": [tuple(d) for d in model["defs"]],
            "layers": [params_from_numpy(dict(layer), device) for layer in model["layers"]]}
