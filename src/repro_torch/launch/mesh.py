"""Meshes: which axes a deployment's cards form and how many cards each
holds (``MeshShape``, pure data that the sharding rules in
``parallel/sharding.py`` read, and ``parse_mesh`` for the launchers'
``--mesh`` strings), and the meshes that run, each one axis over a
``torch.distributed`` process group: ``TPMesh`` ("model", tensor-parallel
serving) and ``DataMesh`` ("data", data-parallel and FSDP training), with
``run_ranks`` to start their ranks.

The production shapes are the JAX package's: one pod of (16, 16) cards
over ("data", "model"), two pods (2, 16, 16) over ("pod", "data",
"model").

A running mesh takes its backend, store and device from the caller (NCCL
with ``cuda:r`` on rank r, or gloo on the CPU or on one shared card):
nothing here picks them from what the machine has.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import NoCudaDeviceError

__all__ = ["DataMesh", "MeshShape", "TPMesh", "batch_axes", "data_ranks", "mesh_tag",
           "parse_mesh", "production_mesh_shape", "run_ranks"]


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


def parse_mesh(spec: str, devices: int) -> MeshShape:
    """A launcher's ``--mesh`` string as the JAX launcher's
    ``make_mesh_from_args`` reads it: ``"auto"`` is (``devices``, 1) over
    ("data", "model"), ``"DxM"`` (D, M) over ("data", "model") and
    ``"PxDxM"`` adds the pod axis.  One number ``"D"`` is a data axis of D
    (the JAX launcher makes it a model axis; the port trains data-parallel
    only, see ``data_ranks``)."""
    if spec == "auto":
        return MeshShape((("data", devices), ("model", 1)))
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: want auto, D, DxM or PxDxM") from None
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: want auto, D, DxM or PxDxM of sizes >= 1")
    names = ("data",) if len(dims) == 1 else ("pod", "data", "model")[-len(dims):]
    return MeshShape(tuple(zip(names, dims)))


def data_ranks(shape: MeshShape) -> int:
    """The data-parallel ranks a training mesh of ``shape`` runs.  A model
    axis above 1 or a pod axis raises ``NotImplementedError``: training
    under them is not ported (ROADMAP.md section 1: tensor-parallel
    training, then the pod axis)."""
    sizes = shape.shape
    if "pod" in sizes:
        raise NotImplementedError(
            f"mesh {mesh_tag(shape)}: training over a pod axis is not ported "
            "(ROADMAP.md section 1, item 10: the pod axis)")
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh {mesh_tag(shape)}: tensor-parallel training (a model axis above 1) "
            "is not ported (ROADMAP.md section 1, item 9: TP training)")
    return sizes["data"]


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the global batch (data parallelism)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_tag(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


class _GroupMesh:
    """One axis of ``world`` ranks over a process group that this
    constructor initialises (``dist.init_process_group`` with the caller's
    ``store`` and ``backend``): the rank's index, the axis size and the
    device the rank computes on.  ``axis_names`` and ``shape`` read as
    ``MeshShape``'s, so the sharding rules take it unchanged.  A CUDA
    ``device`` without a card raises; ``close()`` destroys the group."""

    axis_names: Tuple[str, ...] = ()

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
        return {self.axis_names[0]: self.size}

    def close(self) -> None:
        dist.destroy_process_group()


class TPMesh(_GroupMesh):
    """The ``("model",)`` axis of tensor-parallel serving
    (``ServeSession(mesh=...)``, ``parallel/tp.py``)."""

    axis_names = ("model",)


class DataMesh(_GroupMesh):
    """The ``("data",)`` axis of data-parallel training with FSDP
    parameter and optimizer-state sharding (``make_train_step(...,
    mesh=...)``, ``parallel/fsdp.py``)."""

    axis_names = ("data",)


def _rank_entry(target, rank, world, args, results):
    try:
        results.put((rank, None, target(rank, world, *args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))


def run_ranks(target: Callable[..., Any], world: int, args: Sequence[Any] = (), *,
              timeout: float, rank0_here: bool = False) -> List[Any]:
    """``target(rank, world, *args)`` in ``world`` spawned processes (the
    target builds its mesh); each rank's return value, in rank
    order.  A rank that raises, dies or outlives ``timeout`` seconds
    fails the run: every rank still alive is then terminated.

    ``rank0_here``: rank 0 runs in the calling process, after the other
    ranks are spawned (so they start up while it works, and it keeps the
    caller's CUDA context and libraries); a thread collects the others'
    results and terminates them all when one fails, so that rank 0, if it
    waits on one in a collective, fails there rather than waits."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    first = 1 if rank0_here else 0
    procs = {r: ctx.Process(target=_rank_entry, args=(target, r, world, tuple(args), results),
                            name=f"rank-{r}") for r in range(first, world)}
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + timeout
    out: Dict[int, Any] = {}                  # the spawned ranks' results

    def collect():
        while len(out) < len(procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: no result after {timeout:.0f}s "
                                   f"(ranks done: {sorted(out)})")
            try:
                rank, err, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in procs.items() if r not in out and p.exitcode is not None]
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

    def stop():
        for p in procs.values():
            if p.is_alive():
                p.terminate()

    failed: List[BaseException] = []

    def watch():
        try:
            collect()
        except BaseException as e:     # rank 0 reraises it
            failed.append(e)
            stop()

    try:
        if rank0_here:
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            try:
                here = target(0, world, *args)
            except BaseException:
                if failed:                  # the other rank's failure is the cause
                    raise failed[0]
                raise
            watcher.join(max(0.0, deadline - time.monotonic()))
            if failed:
                raise failed[0]
            if watcher.is_alive():
                raise TimeoutError(f"{world} ranks: no result after {timeout:.0f}s "
                                   f"(ranks done: {sorted(out)})")
            out[0] = here
        else:
            collect()
        for p in procs.values():
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        stop()
        for p in procs.values():
            p.join()
    return [out[r] for r in range(world)]
