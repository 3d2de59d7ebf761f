#!/usr/bin/env python3
"""Tensor-parallel serving and data-parallel training over NCCL across the
host's cards: whether ``launch/serve.py --tp N`` (rank r on ``cuda:r``)
serves the tokens of ``--tp 0`` on one card, at full width, and refuses
more ranks than cards; with ``--train``, whether ``launch/train.py --mesh
N`` (or ``--mesh DxM``, ``PxDxM``) trains step 1 to the loss of ``--mesh
1``.

    python3 scripts/tp_nccl_check.py [--arch qwen2-moe-a2.7b] [--requests 8] [--new 16]
    python3 scripts/tp_nccl_check.py --train [--arch granite-3-2b]
    python3 scripts/tp_nccl_check.py --train --mesh 2x2 --mesh 2x1x2

Runs the launcher (``--arch``, default granite-3-2b; ``--exec approx
--freeze-weights --loop sync``, the seeded weights and trace) at ``--tp
0``, ``--tp 2`` and ``--tp`` = every card, prints each run's output and
wall seconds, compares the ``sample:`` lines (the first request's prompt
and tokens) and exits 1 unless they are equal; then ``--tp`` one past the
cards must exit non-zero.  qwen2-moe-a2.7b's 60 experts split by expert
over 2 and 4 cards and column/row inside each expert over 8.

``--train`` runs the training launcher instead (a dense ``--arch`` at full
width, 1 step, mul8x8_2 through K1, its seeded state and batch) at
``--mesh 1`` and at ``--mesh`` = every card (FSDP over NCCL), or at each
``--mesh`` given (a data x model or pod x data x model mesh: Megatron-split
projections, FSDP over data, the batch over pod x data), exits 1 unless
each step 1's loss agrees with ``--mesh 1``'s to rtol 1e-5; then
``--mesh`` one past the cards must be refused.  Needs at least two cards
(``chip_smoke.py`` checks both on one card over gloo only).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def launch(args, *extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", args.arch,
           "--exec", "approx",
           "--freeze-weights", "--loop", "sync", "--requests", str(args.requests),
           "--new", str(args.new), "--prompt-len", "64", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    print(f"=== {' '.join(extra)}: exit {r.returncode}, {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(r.stdout[-3000:] + (r.stderr[-4000:] if r.returncode else ""), flush=True)
    return r


def train_check(args, n: int) -> int:
    """``--train``: step 1's loss at each of ``args.mesh`` (default: ``n``
    data ranks) against ``--mesh 1``."""
    import gc
    import tempfile

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as launch

    losses = {}
    meshes = args.mesh or [str(n)]
    with tempfile.TemporaryDirectory(prefix="nccl_train_") as tmp:
        for spec in ["1"] + meshes:
            t0 = time.perf_counter()
            out = launch.main(["--arch", args.arch, "--steps", "1", "--mesh", spec,
                               "--ckpt", os.path.join(tmp, f"ck{spec}"), "--ckpt-every", "1000"])
            losses[spec] = out["losses"][0]
            print(f"=== --mesh {spec}: loss {losses[spec]!r}, {time.perf_counter() - t0:.1f}s",
                  flush=True)
            del out                   # cuda:0 is rank 0's card in the next run
            gc.collect()
            torch.cuda.empty_cache()
        same = all(abs(losses[m] - losses["1"]) <= 1e-5 * abs(losses["1"]) for m in meshes)
        print(f"step 1's loss at --mesh {', '.join(meshes)} within rtol 1e-5 of --mesh 1: "
              f"{same}", flush=True)
        try:
            launch.main(["--arch", args.arch, "--steps", "1", "--mesh", str(n + 1),
                         "--ckpt", os.path.join(tmp, "over")])
            refused = False
        except SystemExit as e:
            refused = "visible CUDA devices" in str(e)
    print("--mesh past the cards refused:", refused, flush=True)
    return 0 if same and refused else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    help="a dense or moe config (configs.list_archs()); --train: dense")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--train", action="store_true",
                    help="check launch/train.py --mesh N over NCCL instead of serving")
    ap.add_argument("--mesh", action="append",
                    help="--train: a mesh to hold to --mesh 1 (D, DxM or PxDxM; repeat for "
                         "more; default: one data rank per card)")
    args = ap.parse_args()
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"tp_nccl_check: {n} CUDA device(s); this check needs two or more",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout,
          flush=True)
    if args.train:
        return train_check(args, n)
    runs = {tp: launch(args, "--tp", str(tp)) for tp in sorted({0, 2, n})}
    sample = {tp: next((ln for ln in r.stdout.splitlines() if ln.startswith("sample:")), None)
              for tp, r in runs.items()}
    same = {tp: s is not None and s == sample[0] for tp, s in sample.items()}
    print("same tokens as --tp 0:", same, flush=True)
    over = launch(args, "--tp", str(n + 1))
    refused = over.returncode != 0 and "visible CUDA devices" in over.stderr
    print("--tp past the cards refused:", refused, flush=True)
    return 0 if all(same.values()) and refused else 1


if __name__ == "__main__":
    sys.exit(main())
