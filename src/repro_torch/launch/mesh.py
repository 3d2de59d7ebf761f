"""Meshes: which axes a deployment's cards form and how many cards each
holds (``MeshShape``, pure data that the sharding rules in
``parallel/sharding.py`` read), and the one mesh that runs: ``TPMesh``, a
one-axis ("model") tensor-parallel mesh over a ``torch.distributed``
process group, with ``run_ranks`` to start its ranks.

The production shapes are the JAX package's: one pod of (16, 16) cards
over ("data", "model"), two pods (2, 16, 16) over ("pod", "data",
"model").

``TPMesh`` takes its backend, store and device from the caller (NCCL with
``cuda:r`` on rank r, or gloo on the CPU or on one shared card): nothing
here picks them from what the machine has.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import NoCudaDeviceError

__all__ = ["MeshShape", "TPMesh", "batch_axes", "mesh_tag", "production_mesh_shape",
           "run_ranks"]


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


class TPMesh:
    """One ``("model",)`` axis of ``world`` ranks over a process group that
    this constructor initialises (``dist.init_process_group`` with the
    caller's ``store`` and ``backend``): the rank's index, the axis size
    and the device the rank computes on.  ``axis_names`` and ``shape``
    read as ``MeshShape``'s, so ``param_pspec`` and ``cache_pspecs`` take
    it unchanged.  A CUDA ``device`` without a card raises; ``close()``
    destroys the group."""

    axis_names: Tuple[str, ...] = ("model",)

    def __init__(self, *, rank: int, world: int, store: "dist.Store", backend: str,
                 device):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise NoCudaDeviceError(f"rank {rank}: no CUDA device for {dev}")
            torch.cuda.set_device(dev)
        dist.init_process_group(backend=backend, store=store, rank=rank, world_size=world)
        self.group = dist.group.WORLD
        self.rank, self.size, self.device = rank, world, dev

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": self.size}

    def close(self) -> None:
        dist.destroy_process_group()


def _rank_entry(target, rank, world, args, results):
    try:
        results.put((rank, None, target(rank, world, *args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))


def run_ranks(target: Callable[..., Any], world: int, args: Sequence[Any] = (), *,
              timeout: float) -> List[Any]:
    """``target(rank, world, *args)`` in ``world`` spawned processes (the
    target builds its ``TPMesh``); each rank's return value, in rank
    order.  A rank that raises, dies or outlives ``timeout`` seconds
    fails the run: every rank still alive is then terminated."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, tuple(args), results),
                         name=f"rank-{r}") for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out: Dict[int, Any] = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: no result after {timeout:.0f}s "
                                   f"(ranks done: {sorted(out)})")
            try:
                rank, err, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if not dead:
                    continue
                try:                        # a result may still be on its way
                    rank, err, value = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result")
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return [out[r] for r in range(world)]
