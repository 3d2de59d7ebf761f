#!/usr/bin/env python3
"""Sweep the launch plan of the paged decode-attention kernel (K2) on one
card: how many blocks the table walk is split for, and how many bytes
each block's copy ring may take.

    python3 scripts/k2_sweep.py [--targets 264 396 528 660 1056]
        [--budgets 24 32 40 48 64] [--reps 2] [--out sweep.json]

``kernels/paged_attention/ops.py`` picks a call's plan from two constants:
``_TARGET_CTAS``, the blocks in flight that ``split_plan`` splits the walk
for, and ``_RING_BUDGET``, the ring bytes per block from which ``_ring``
picks the blocks copied per round.  For every target and budget (KB) this
sets both (and clears the wrapper's plan cache), holds the kernel to its
plain version as ``chip_smoke.py`` phase 3 does, and times it at the two
shapes phase 3 times, on float32 and bfloat16 pools with a bf16 query:
granite-3-2b's served decode step (40 calls, 4 rows, W = 10) and a call at
4,096 positions (W = 256, four pools).  Each point reports the plan
(splits, chunk, blocks per round, ring slots), the profiler's device ms
and the CUDA-event ms per call.  The points run in ``--reps`` passes, each
over the grid in a fresh random order.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, nargs="+", default=[264, 396, 528, 660, 1056])
    ap.add_argument("--budgets", type=int, nargs="+", default=[24, 32, 40, 48, 64],
                    help="ring bytes per block, in KB")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.paged_attention import ops, paged_attention

    dev = torch.device("cuda", 0)
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    hkv, g, hd = 8, 4, 64
    shapes = {"decode_step": dict(calls=40, B=4, W=10, cur=rng.integers(40, 160, 4)),
              "long_context": dict(calls=4, B=4, W=256, cur=[4095] * 4)}
    pools = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = {(shape, pool): cs.k2_step_inputs(dev, rng, hkv=hkv, g=g, hd=hd, pool_dtype=dt, **kw)
             for shape, kw in shapes.items() for pool, dt in pools.items()}
    defaults = (ops._TARGET_CTAS, ops._RING_BUDGET)
    grid = [(t, b) for t in args.targets for b in args.budgets]
    points = []
    cs.warm_up(dev)
    try:
        for rep in range(args.reps):
            for i in rng.permutation(len(grid)):
                target, kb = grid[i]
                ops._TARGET_CTAS, ops._RING_BUDGET = target, kb * 1024
                ops._plan.cache_clear()
                for (shape, pool), (opnds, tbl_t, cur_t, _, _) in cases.items():
                    calls, B, W = (shapes[shape][k] for k in ("calls", "B", "W"))
                    splits, chunk = ops.split_plan(B, hkv, W)
                    R, nslot = ops._ring(chunk, cs.BLOCK_SIZE, hd, pools[pool].itemsize)
                    cs.k2_check(f"{shape} {pool} target {target} ring {kb} KB",
                                [t[0] for t in opnds] + [tbl_t, cur_t], cs.BLOCK_SIZE)
                    step = cs.k2_step_of(paged_attention, opnds, tbl_t, cur_t)
                    dev_ms = cs.profile_step(step, match="paged_attention_kernel",
                                             key="k2").get("k2")
                    row = {"rep": rep, "shape": shape, "pool": pool, "target": target,
                           "ring_kb": kb, "splits": splits, "chunk": chunk, "R": R,
                           "nslot": nslot,
                           "device_ms_per_call": None if dev_ms is None else dev_ms / calls,
                           "ms_per_call": cs.cuda_ms(step) / calls}
                    points.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        ops._TARGET_CTAS, ops._RING_BUDGET = defaults
        ops._plan.cache_clear()

    # the median device time of each (shape, pool, target, budget) over the reps
    summary = {}
    for p in points:
        key = f"{p['shape']} {p['pool']} target={p['target']} ring={p['ring_kb']}KB"
        summary.setdefault(key, []).append(p["device_ms_per_call"])
    summary = {k: (float(np.median(v)) if None not in v else None) for k, v in summary.items()}
    report = {"card": smi, "defaults": {"target": defaults[0], "ring_kb": defaults[1] // 1024},
              "points": points, "median_device_ms_per_call": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    for k, v in summary.items():
        print(k, v)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
