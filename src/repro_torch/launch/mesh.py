"""Meshes: which axes a deployment's cards form and how many cards each
holds (``MeshShape``, pure data that the sharding rules in
``parallel/sharding.py`` read, and ``parse_mesh`` for the launchers'
``--mesh`` strings), and the meshes that run, each one axis over a
``torch.distributed`` process group: ``TPMesh`` ("model", tensor-parallel
serving) and ``DataMesh`` ("data", data-parallel and FSDP training), and
``TrainMesh``, the training mesh of up to three axes ("pod", "data",
"model") with a process group per axis line, with ``run_ranks`` to start
their ranks.

The production shapes are the JAX package's: one pod of (16, 16) cards
over ("data", "model"), two pods (2, 16, 16) over ("pod", "data",
"model").

A running mesh takes its backend, store and device from the caller (NCCL
with ``cuda:r`` on rank r, or gloo on the CPU or on one shared card):
nothing here picks them from what the machine has.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing as mp
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import NoCudaDeviceError

__all__ = ["Axis", "DataMesh", "MeshShape", "TPMesh", "TrainAxes", "TrainMesh", "batch_axes",
           "carve_mesh", "mesh_ranks", "mesh_tag", "parse_mesh", "production_mesh_shape",
           "run_ranks", "train_axes"]


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
    (the JAX launcher makes it a model axis: ROADMAP.md section 3)."""
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


def mesh_ranks(shape: MeshShape) -> int:
    """The ranks a training mesh of ``shape`` runs: the product of its axes
    (``pod x data x model``).  What a family or a head count cannot take
    on it, ``train.loop.check_data_mesh`` refuses."""
    return math.prod(shape.shape.values())


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


class Axis(NamedTuple):
    """One line of a training mesh: the process group of the ranks that
    differ only along it (for the batch group, along pod and data), this
    rank's index in it and its size.  The collectives take it as they take
    a one-axis mesh."""

    group: Any
    rank: int
    size: int


class TrainAxes(NamedTuple):
    """The lines of a training mesh through one rank, each an ``Axis`` or
    None where it holds one rank: ``data`` (FSDP), ``model`` (the Megatron
    splits), ``pod``, ``batch`` (pod x data: the ranks that hold other rows
    of the global batch) and ``world`` (every rank of the mesh)."""

    data: Optional[Axis]
    model: Optional[Axis]
    pod: Optional[Axis]
    batch: Optional[Axis]
    world: Optional[Axis]


def _sizes(shape: MeshShape) -> Tuple[int, int, int]:
    s = shape.shape
    return s.get("pod", 1), s.get("data", 1), s.get("model", 1)


class TrainMesh:
    """A training mesh of ``shape``'s axes (``parse_mesh``: data, data x
    model, or pod x data x model).  Rank r sits at (pod, data, model) =
    ``np.unravel_index(r, (P, D, M))``, the model axis fastest, as in
    ``jax.make_mesh``.  ``axis_names`` and ``shape`` read as
    ``MeshShape``'s, so the sharding rules take it unchanged; ``axes``
    holds the rank's lines (``TrainAxes``), each with its own group, and
    ``rank``, ``size`` and ``group`` are the world's (rank 0 writes
    checkpoints, the preemption flag spans every rank).

    Built by ``TrainMesh(shape, rank=, world=, store=, backend=, device=)``,
    which initialises the process group (``close()`` destroys it), or by
    ``carve_mesh`` inside a world that is running already."""

    def __init__(self, shape: MeshShape, *, device, rank: int = 0, world: Optional[int] = None,
                 store: "Optional[dist.Store]" = None, backend: Optional[str] = None,
                 _axes: Optional[TrainAxes] = None):
        self.mesh_shape = shape
        self.axis_names = shape.axis_names
        self.shape = shape.shape
        self.device = torch.device(device)
        self._owns_group = _axes is None
        if _axes is None:
            if world != mesh_ranks(shape):
                raise ValueError(f"mesh {mesh_tag(shape)} holds {mesh_ranks(shape)} ranks, "
                                 f"not {world}")
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise NoCudaDeviceError(f"rank {rank}: no CUDA device for {self.device}")
                torch.cuda.set_device(self.device)
            dist.init_process_group(backend=backend, store=store, rank=rank, world_size=world)
            _axes = _carve(shape, list(range(world)))
        self.axes = _axes
        w = _axes.world
        self.rank, self.size = (w.rank, w.size) if w is not None else (0, 1)
        self.group = w.group if w is not None else None

    data = property(lambda self: self.axes.data)
    model = property(lambda self: self.axes.model)
    pod = property(lambda self: self.axes.pod)
    batch = property(lambda self: self.axes.batch)
    world = property(lambda self: self.axes.world)

    def close(self) -> None:
        if self._owns_group:
            dist.destroy_process_group()


def _carve(shape: MeshShape, ranks: List[int]) -> Optional[TrainAxes]:
    """Every line of a mesh of ``shape`` over the global ``ranks`` (in
    mesh order), one group each: every rank of the running world calls
    ``dist.new_group`` for every line, in the same order, members or not
    (a line equal to one made already reuses its group; a one-rank line
    has none).  The lines through this rank, or None outside the mesh."""
    P, D, M = _sizes(shape)
    if len(ranks) != P * D * M:
        raise ValueError(f"mesh {mesh_tag(shape)} wants {P * D * M} ranks, got {len(ranks)}")
    grid = [[[ranks[(p * D + d) * M + m] for m in range(M)] for d in range(D)] for p in range(P)]
    everyone = list(range(dist.get_world_size()))
    made: Dict[Tuple[int, ...], Any] = {}

    def group(members):
        members = tuple(members)
        if len(members) > 1 and members not in made:
            made[members] = (dist.group.WORLD if list(members) == everyone
                             else dist.new_group(list(members)))
        return members

    lines = {
        "model": [group(grid[p][d]) for p in range(P) for d in range(D)],
        "data": [group([grid[p][d][m] for d in range(D)]) for p in range(P) for m in range(M)],
        "pod": [group([grid[p][d][m] for p in range(P)]) for d in range(D) for m in range(M)],
        "batch": [group([grid[p][d][m] for p in range(P) for d in range(D)]) for m in range(M)],
        "world": [group(ranks)],
    }
    me = dist.get_rank()
    if me not in ranks:
        return None

    def axis(name):
        members = next(line for line in lines[name] if me in line)
        return Axis(made[members], members.index(me), len(members)) if len(members) > 1 else None

    return TrainAxes(*(axis(n) for n in TrainAxes._fields))


def carve_mesh(shape: MeshShape, ranks: Sequence[int], device) -> Optional[TrainMesh]:
    """A ``TrainMesh`` of ``shape`` over the global ``ranks`` (in mesh
    order) of the process group running already: every rank of that world
    calls it with the same arguments, in the same order as its other
    group calls; the ranks outside ``ranks`` get None.  Its ``close()``
    leaves the world's group alone."""
    axes = _carve(shape, list(ranks))
    return None if axes is None else TrainMesh(shape, device=device, _axes=axes)


def train_axes(mesh) -> TrainAxes:
    """The lines of a training mesh: a ``TrainMesh``'s own, or for a
    one-axis data mesh (``DataMesh``, or any object with ``group``,
    ``rank`` and ``size`` whose ``axis_names`` are ``("data",)``) that
    mesh as the data axis, the batch group and the world."""
    if isinstance(mesh, TrainMesh):
        return mesh.axes
    if tuple(mesh.axis_names) != ("data",):
        raise TypeError(f"a training mesh over {tuple(mesh.axis_names)} must be a TrainMesh")
    return TrainAxes(data=mesh, model=None, pod=None, batch=mesh, world=mesh)


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
