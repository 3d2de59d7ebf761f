"""Does serving in several processes on one card finish sooner than in one?

Each worker process serves chip_smoke.py's phase-4 trace (granite-3-2b at
full width, ``--layers`` deep, frozen approx weights, the paged pool through
K1 and K2) ``--reps`` times on the one card.  The script runs 1 worker, then
``--workers`` workers at once, and prints each worker's seconds per run and
the wall seconds of each round: serving is host-bound, so the question is
what the card's time-slicing between processes costs.

    python3 scripts/shared_card_probe.py --layers 10 --workers 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def worker(args):
    layers, reps, seed = args
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import freeze_params, resolve_execution_mode

    torch.set_num_threads(2)
    build_all()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(cs.ARCH), num_layers=layers,
                              approx=resolve_execution_mode("approx", act_per_row=True))
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    trace = cs.make_trace(np.random.default_rng(seed), cfg.vocab_size, cs.REQUESTS)
    cs.serve(cfg, params, trace[:1], dev, "kernel", seed)        # warm-up
    walls, tokens = [], None
    for _ in range(reps):
        _, res, wall = cs.serve(cfg, params, trace, dev, "kernel", seed)
        walls.append(wall)
        got = {rid: r.tokens.tolist() for rid, r in res.items()}
        if tokens is not None and got != tokens:
            raise AssertionError("a repeated run served other tokens")
        tokens = got
    return walls, tokens


def round_(n, layers, reps, seed):
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(n) as pool:
        out = pool.map(worker, [(layers, reps, seed)] * n)
    return {"workers": n, "wall_s": time.perf_counter() - t0,
            "s_per_run": [w for w, _ in out]}, [t for _, t in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("shared_card_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import build_all
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows, toks = [], []
    for n in (1, args.workers):
        row, t = round_(n, args.layers, args.reps, args.seed)
        rows.append(row)
        toks += t
        print(json.dumps(row), flush=True)
    same = all(t == toks[0] for t in toks)
    print(json.dumps({"card": smi, "layers": args.layers, "reps": args.reps,
                      "tokens_equal_across_workers": same, "rounds": rows}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
