"""Training launcher: QAT retraining with the approximate multiplier,
checkpoint/restart and fault monitoring, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 4

The JAX package's launcher less its mesh (tensor parallelism is a later
slice of the port), plus ``--device``.  ``--mode kernel`` (the default)
runs every projection's integer simulation through the CUDA
approximate-matmul kernel; ``lowrank`` is that kernel's plain version, and
on ``--device cpu`` both take the plain version.  Without ``--device`` the
run needs a CUDA device and raises without one.  A run resumes from the
newest checkpoint under ``--ckpt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig, Modes
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.train import optim as O
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.fault import PreemptionGuard, StragglerMonitor, run_with_restarts
from repro_torch.train.loop import as_batch, init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(
        cfg, approx=ApproxConfig(multiplier=args.multiplier, mode=args.mode, band_reg=1e-4)
    )
    opt = O.OptConfig(lr=3e-4, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatch=args.microbatch,
                              grad_compression=args.grad_compression)

    def job(attempt: int):
        state = init_state(cfg, opt, args.seed, grad_compression=args.grad_compression,
                           device=dev)
        start = 0
        if latest_step(args.ckpt) is not None:
            state, start = restore_checkpoint(args.ckpt, state)
            print(f"[attempt {attempt}] resumed at step {start}")
        losses = []
        mon = StragglerMonitor(threshold=3.0)
        batches = token_batches(cfg.vocab_size, args.batch, args.seq, seed=start)
        with PreemptionGuard() as guard:
            for i in range(start, args.steps):
                batch = as_batch(next(batches), dev)
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))
                mon.record(i, time.perf_counter() - t0)
                if i % 10 == 0:
                    print(f"step {i:4d} loss {losses[-1]:.4f} "
                          f"gnorm {float(m['grad_norm']):.3f}")
                if (i + 1) % args.ckpt_every == 0 or guard.should_stop:
                    save_checkpoint(args.ckpt, i + 1, state, keep=3)
                    if guard.should_stop:
                        print("preempted: checkpoint flushed")
                        return {"state": state, "start": start, "losses": losses}
        save_checkpoint(args.ckpt, args.steps, state, keep=3)
        return {"state": state, "start": start, "losses": losses}

    launches0 = approx_matmul.launches
    out = run_with_restarts(job, max_restarts=args.max_restarts,
                            on_restart=lambda a, e: print(f"restart {a} after {e!r}"))
    print(f"training complete on {dev}: {len(out['losses'])} steps from step "
          f"{out['start']}; approx_matmul kernel launches "
          f"{approx_matmul.launches - launches0}")
    return out


if __name__ == "__main__":
    main()
