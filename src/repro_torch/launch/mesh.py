"""Mesh shapes: which axes a deployment's cards form and how many cards
each holds, as pure data.  Nothing here builds a process group or touches
a device: the sharding rules (``parallel/sharding.py``) read only the axis
sizes.

The production shapes are the JAX package's: one pod of (16, 16) cards
over ("data", "model"), two pods (2, 16, 16) over ("pod", "data",
"model").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["MeshShape", "batch_axes", "mesh_tag", "production_mesh_shape"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named axes and their sizes, in order."""

    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((("pod", 2), ("data", 16), ("model", 16)))
    return MeshShape((("data", 16), ("model", 16)))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the global batch (data parallelism)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
