"""Checkpoints in the JAX package's on-disk layout, so that a checkpoint
the JAX launcher wrote restores into the port and back:

  <dir>/step_000123.tmp-<nonce>/   (staging)
  <dir>/step_000123/
      manifest.json                {step, time, leaves: {key: shape, dtype}}
      arrays.npz                   one entry per leaf (a bfloat16 leaf as its
                                   uint16 words; the manifest says bfloat16)
  <dir>/LATEST                     text file: "step_000123"

A leaf's key is its ``jax.tree_util.keystr`` path with every run of
characters outside ``[A-Za-z0-9_.]`` replaced by ``/`` (``train/tree.py``
walks the port's dicts as the JAX package's trees).  Publishing is atomic:
the snapshot is written to a staging directory and renamed, then
``LATEST`` is replaced.

Under a training mesh (``cfg=``, ``mesh=``: a training state of FSDP
parts, blocks under a model axis, ``parallel/fsdp.py``) every rank calls
both functions: the leaves are gathered whole over both axes and rank 0
of the mesh writes them in the same format, and a restore reads the whole
leaves and keeps the rank's part of each.  So a checkpoint written at one
mesh shape restores at any other, on one device, and into the JAX
package (its docstring's "reshard across cluster sizes").
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import barrier
from repro_torch.train.tree import leaves_with_path, tree_map, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_SAFE = re.compile(r"[^A-Za-z0-9_.]+")


def _flatten(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    return [(_SAFE.sub("/", path).strip("/"), leaf) for path, leaf in leaves_with_path(tree)]


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3, cfg=None,
                    mesh=None) -> Optional[str]:
    """Write ``tree`` as step ``step`` and keep the newest ``keep``; the
    snapshot's path.  Under a training ``mesh`` (``tree`` the rank's
    training state, cut by ``cfg``'s rules) rank 0 writes the whole state
    and returns its path, the others None, once it is published."""
    if mesh is None:
        return _write(directory, step, tree, keep)
    whole = fsdp.whole_state(tree, cfg, mesh, device="cpu")
    path = _write(directory, step, whole, keep) if mesh.rank == 0 else None
    del whole
    barrier(mesh)
    return path


def _write(directory: str, step: int, tree: Any, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    stage = tempfile.mkdtemp(prefix=name + ".tmp-", dir=directory)
    try:
        flat = [(k, v.detach().cpu()) for k, v in _flatten(tree)]
        arrays = {k: _to_numpy(v) for k, v in flat}
        np.savez(os.path.join(stage, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)} for k, v in flat},
        }
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(stage, final)                      # atomic publish
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return os.path.join(directory, name)


def _dtype_name(t: torch.Tensor) -> str:
    """The manifest's dtype: numpy's name, or ``bfloat16``."""
    return "bfloat16" if t.dtype == torch.bfloat16 else str(_to_numpy(t).dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """numpy has no bfloat16: a bfloat16 leaf is stored as its 16-bit
    words (uint16), the manifest naming its dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _gc(directory: str, keep: int) -> None:
    for s in list_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for n in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """Prefer the LATEST pointer; fall back to a directory scan."""
    p = os.path.join(directory, "LATEST")
    if os.path.exists(p):
        with open(p) as f:
            m = re.fullmatch(r"step_(\d+)", f.read().strip())
        if m and os.path.isdir(os.path.join(directory, f"step_{int(m.group(1)):09d}")):
            return int(m.group(1))
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, target_tree: Any, *, step: Optional[int] = None,
                       cfg=None, mesh=None) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``: each leaf comes back
    with its stored dtype, on the device of the target's leaf.  Under a
    data ``mesh`` (``target_tree`` the rank's training state, cut by
    ``cfg``'s rules) each leaf is read whole and the rank's part kept."""
    if mesh is not None:
        whole, step = restore_checkpoint(directory, tree_map(lambda t: torch.empty(0),
                                                             target_tree), step=step)
        part = fsdp.shard_state(whole, cfg, mesh)
        return tree_map(lambda p, t: p.detach().to(t.device), part, target_tree), step
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = []
        for k, leaf in _flatten(target_tree):
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            restored.append(_from_numpy(data[k], dtypes.get(k, "")).to(leaf.device))
    return unflatten(target_tree, restored), step
