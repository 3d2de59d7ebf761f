"""Training launcher: QAT retraining with the approximate multiplier,
checkpoint/restart and fault monitoring, on one device or data-parallel
over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --reduced --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --mesh 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --reduced --device cpu --steps 2     # also falcon-mamba-7b, zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --reduced --device cpu --mesh 2 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --mesh 2x1x2

The JAX package's launcher plus ``--device``.  ``--mode kernel`` (the
default) runs every projection's integer simulation through the CUDA
approximate-matmul kernel; ``lowrank`` is that kernel's plain version, and
on ``--device cpu`` both take the plain version.  Without ``--device`` the
run needs a CUDA device and raises without one.  A run resumes from the
newest checkpoint under ``--ckpt``.  Every token-input family trains (the
moe loss adds its load-balance term); the vlm and audio backbones take
embeddings, which this launcher's token stream cannot feed, so it refuses
them before it builds any weights (the JAX launcher fails inside
``forward`` on the missing ``batch["embeddings"]``).

``--mesh`` (``launch.mesh.parse_mesh``; default ``auto``: one rank per
visible card, one on ``--device cpu``) with more than one rank trains on
a ``launch.mesh.TrainMesh``: ``D`` data ranks, ``DxM`` data x model or
``PxDxM`` pod x data x model, ``P*D*M`` ranks in all.  Every token-input
family (dense, moe with its routing over the global batch, ssm, hybrid)
trains over pod and data, with FSDP sharding over data
(``parallel/fsdp.py``) and the batch over pod x data; the dense family
also over a model axis, its projections split Megatron-style (q/k/v and
gate/up by output column, ``wo`` and ``w_down`` by input row, the head by
vocab column).  Rank r is a process of its own on ``cuda:r`` over NCCL
(more ranks than visible cards are refused), or on the CPU over gloo with
``--device cpu``.  Every rank draws the whole global batch and the step
keeps its rows, so a run sees the batches one device would; rank 0
prints, rank 0 writes whole checkpoints (any mesh resumes from them), a
preemption signal stops every rank at the same step, and a failed rank
restarts the whole world from the newest checkpoint (``--max-restarts``).
A model axis for another family, or one that does not divide the heads,
is refused before any weight is built (naming ROADMAP.md's item 17); the
vlm and audio families train under a mesh through ``make_train_step(...,
mesh=)`` on embedding batches.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig, Modes
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.launch.mesh import TrainMesh, mesh_ranks, mesh_tag, parse_mesh, run_ranks
from repro_torch.parallel import fsdp
from repro_torch.train import optim as O
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.fault import PreemptionGuard, StragglerMonitor, run_with_restarts
from repro_torch.train.loop import as_batch, check_data_mesh, init_state, make_train_step


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="auto",
                    help='"auto" (one data rank per visible card; one on --device cpu), '
                         '"D" data ranks, or "DxM" / "PxDxM" as the JAX launcher reads them '
                         "(a model axis above 1 trains the dense family only)")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--multiplier", default="mul8x8_2")
    ap.add_argument("--mode", default="kernel", choices=Modes)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                         "the plain versions)")
    return ap


def _config(args):
    cfg = get_config(args.arch)
    if not cfg.embed_input:
        raise ValueError(f"{cfg.name} takes embedding inputs (frontend stub); this "
                         "launcher trains on token batches: use an embed-input arch")
    if args.reduced:
        cfg = reduced_config(cfg)
    return dataclasses.replace(
        cfg, approx=ApproxConfig(multiplier=args.multiplier, mode=args.mode, band_reg=1e-4)
    )


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = _config(args)
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    shape = parse_mesh(args.mesh, 1 if on_cpu else torch.cuda.device_count())
    n = mesh_ranks(shape)
    if n <= 1:
        return _train(args, cfg, resolve_device(args.device))
    check_data_mesh(cfg, shape)
    if not on_cpu and n > torch.cuda.device_count():
        raise SystemExit(f"--mesh {args.mesh}: {n} ranks > "
                         f"{torch.cuda.device_count()} visible CUDA devices")
    store_dir = tempfile.mkdtemp(prefix="train_dp_")

    def world(attempt: int):
        store = os.path.join(store_dir, f"store{attempt}")
        return run_ranks(_rank, n, (store, args, cfg, on_cpu, attempt, shape),
                         timeout=24 * 3600)[0]

    try:
        return run_with_restarts(world, max_restarts=args.max_restarts,
                                 on_restart=lambda a, e: print(f"restart {a} after {e!r}"))
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank(rank, world, store_path, args, cfg, on_cpu, attempt, shape):
    device = torch.device("cpu") if on_cpu else torch.device("cuda", rank)
    if on_cpu:                          # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = TrainMesh(shape, rank=rank, world=world, store=dist.FileStore(store_path, world),
                     backend="gloo" if on_cpu else "nccl", device=device)
    try:
        return _train(args, cfg, device, mesh, attempt)
    finally:
        mesh.close()


def _train(args, cfg, dev, mesh=None, attempt=None):
    """The training run on ``dev``: under ``mesh`` one rank's, whose
    result is the run's less its state (rank 0 prints); without one the
    job restarts in this process (``--max-restarts``)."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    opt = O.OptConfig(lr=3e-4, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatch=args.microbatch,
                              grad_compression=args.grad_compression, mesh=mesh)

    def job(attempt: int):
        if mesh is None:
            state = init_state(cfg, opt, args.seed, grad_compression=args.grad_compression,
                               device=dev)
        else:
            state = fsdp.init_state(cfg, opt, args.seed, mesh,
                                    grad_compression=args.grad_compression, device=dev)
        start = 0
        if latest_step(args.ckpt) is not None:
            state, start = restore_checkpoint(args.ckpt, state, cfg=cfg, mesh=mesh)
            say(f"[attempt {attempt}] resumed at step {start}")
        losses = []
        mon = StragglerMonitor(threshold=3.0)
        batches = token_batches(cfg.vocab_size, args.batch, args.seq, seed=start)
        out = {"start": start, "losses": losses}
        with PreemptionGuard(mesh=mesh) as guard:
            for i in range(start, args.steps):
                batch = as_batch(next(batches), dev)
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                mon.record(i, time.perf_counter() - t0)
                if i % 10 == 0:
                    say(f"step {i:4d} loss {losses[-1]:.4f} "
                        f"gnorm {float(m['grad_norm']):.3f}")
                stop = guard.poll()
                if (i + 1) % args.ckpt_every == 0 or stop:
                    save_checkpoint(args.ckpt, i + 1, state, keep=3, cfg=cfg, mesh=mesh)
                    if stop:
                        say("preempted: checkpoint flushed")
                        return {**out, "state": state}
        save_checkpoint(args.ckpt, args.steps, state, keep=3, cfg=cfg, mesh=mesh)
        return {**out, "state": state}

    launches0 = approx_matmul.launches
    if mesh is None:
        out = run_with_restarts(job, max_restarts=args.max_restarts,
                                on_restart=lambda a, e: print(f"restart {a} after {e!r}"))
    else:
        out = job(attempt)
        out["step"] = int(out.pop("state")["opt"]["step"])
    if mesh is None:
        ranks = ""
    elif mesh.axis_names == ("data",):
        ranks = f" x {mesh.size} data ranks"
    else:
        ranks = f" on mesh {mesh_tag(mesh)} ({' x '.join(mesh.axis_names)}, {mesh.size} ranks)"
    say(f"training complete on {dev}{ranks}: {len(out['losses'])} steps from step "
        f"{out['start']}; approx_matmul kernel launches {approx_matmul.launches - launches0}")
    return out


if __name__ == "__main__":
    main()
