"""Approximate-multiplier QAT on a language model (the JAX package's
``examples/approx_qat_lm.py`` on the port).

Trains a granite-family LM (default ~8M parameters for the CPU; ``--preset
100m`` gives the ~100M-parameter configuration) on synthetic token streams
with the MUL8x8_2 forward, band regularization, checkpoint/restart,
preemption guard and straggler monitoring: the single-device version of
``launch/train.py``.

    python -m repro_torch.examples.approx_qat_lm --steps 200 --mode kernel
    python -m repro_torch.examples.approx_qat_lm --preset 100m --steps 300 --mode kernel
    python -m repro_torch.examples.approx_qat_lm --device cpu --steps 20

``--mode kernel`` runs every projection's integer simulation through the
CUDA approximate-matmul kernel (K1); ``lowrank`` (the JAX example's
default, kept) is its plain version, and on ``--device cpu`` both take the
plain version.  Without ``--device`` the run needs a CUDA device and raises
without one.  A run resumes from the newest checkpoint under ``--ckpt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.train import optim as O
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.fault import PreemptionGuard, StragglerMonitor
from repro_torch.train.loop import as_batch, init_state, make_train_step
from repro_torch.train.tree import leaves

__all__ = ["PRESETS", "main"]

PRESETS = {
    # ~8M: fast on one CPU core; ~100M: the end-to-end scale
    "8m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
               d_ff=1024, vocab_size=2048),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
                 d_ff=3072, vocab_size=8192),
}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="8m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--multiplier", default="mul8x8_2")
    ap.add_argument("--mode", default="lowrank",
                    choices=["float", "exact_quant", "lut", "lowrank", "kernel"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("granite-3-2b"),
        **PRESETS[args.preset],
        dtype="float32",
        remat=False,
        approx=ApproxConfig(multiplier=args.multiplier, mode=args.mode, band_reg=1e-4),
    )
    opt = O.OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps, clip_norm=1.0)
    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(),
                                         f"repro_torch_approx_qat_lm_{args.preset}")

    state = init_state(cfg, opt, 0, device=dev)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    print(f"model: {args.preset} ({n_params / 1e6:.1f}M params), "
          f"approx={args.mode}/{args.multiplier} on {dev}")
    start = 0
    if latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, state)
        print(f"resumed from checkpoint step {start}")

    step_fn = make_train_step(cfg, opt)
    mon = StragglerMonitor(threshold=3.0, on_straggler=lambda s, dt, e: print(
        f"  [straggler] step {s}: {dt:.2f}s vs ewma {e:.2f}s"))
    batches = token_batches(cfg.vocab_size, args.batch, args.seq, seed=1)
    losses: List[float] = []
    launches0 = approx_matmul.launches
    with PreemptionGuard() as guard:
        for i in range(start, args.steps):
            batch = as_batch(next(batches), dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            dt = time.perf_counter() - t0
            mon.record(i, dt)
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {losses[-1]:.4f} ce {float(m['ce']):.4f} "
                      f"band_reg {float(m['band_reg']):.2e} ({dt:.2f}s)")
            if (i + 1) % args.ckpt_every == 0 or guard.should_stop:
                save_checkpoint(ckpt_dir, i + 1, state, keep=3)
                if guard.should_stop:
                    print("preemption requested: checkpoint flushed, exiting cleanly")
                    break
    print(f"done. stragglers observed: {len(mon.events)}; approx_matmul kernel "
          f"launches {approx_matmul.launches - launches0}")
    return {"start": start, "losses": losses, "params": n_params,
            "stragglers": len(mon.events)}


if __name__ == "__main__":
    main()
