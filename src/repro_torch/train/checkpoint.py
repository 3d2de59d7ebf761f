"""Checkpoints in the JAX package's on-disk layout, so that a checkpoint
the JAX launcher wrote restores into the port and back:

  <dir>/step_000123.tmp-<nonce>/   (staging)
  <dir>/step_000123/
      manifest.json                {step, time, leaves: {key: shape, dtype}}
      arrays.npz                   one entry per leaf
  <dir>/LATEST                     text file: "step_000123"

A leaf's key is its ``jax.tree_util.keystr`` path with every run of
characters outside ``[A-Za-z0-9_.]`` replaced by ``/`` (``train/tree.py``
walks the port's dicts as the JAX package's trees).  Publishing is atomic:
the snapshot is written to a staging directory and renamed, then
``LATEST`` is replaced.
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

from repro_torch.train.tree import leaves_with_path, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_SAFE = re.compile(r"[^A-Za-z0-9_.]+")


def _flatten(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    return [(_SAFE.sub("/", path).strip("/"), leaf) for path, leaf in leaves_with_path(tree)]


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    stage = tempfile.mkdtemp(prefix=name + ".tmp-", dir=directory)
    try:
        arrays = {k: v.detach().cpu().numpy() for k, v in _flatten(tree)}
        np.savez(os.path.join(stage, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in arrays.items()},
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


def restore_checkpoint(directory: str, target_tree: Any, *,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``: each leaf comes back
    with its stored dtype, on the device of the target's leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        restored = []
        for k, leaf in _flatten(target_tree):
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            restored.append(torch.from_numpy(np.array(data[k])).to(leaf.device))
    return unflatten(target_tree, restored), step
