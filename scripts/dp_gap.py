#!/usr/bin/env python3
"""How far a data-parallel training step lies from one device's step
from the same state, on the card: ``chip_smoke.py``'s phase 19 (dp=2 at
4 layers, dp=4 at 2, granite-3-2b at full width through K1) with bf16
activations, as trained and gated, then once more with float32
activations, where its gates are reported and not required.

    python3 scripts/dp_gap.py [--out dp_gap.json]

Prints each world's row (losses and their relative gaps, each leaf's
moment gap and parameter gaps in lr) and the card's name and power
limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as CS
    from repro_torch.kernels._build import build_all

    if not torch.cuda.is_available():
        print("dp_gap: no CUDA device", file=sys.stderr)
        return 2
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base, out, rc = CS.dp_config, {"card": smi}, 0
    for dtype in ("bfloat16", "float32"):
        CS.dp_config = lambda layers, d=dtype: dataclasses.replace(base(layers), dtype=d)
        t0 = time.perf_counter()
        try:
            out[dtype] = {"report": CS.dp_phase(torch.device("cuda", 0), 0, smi), "held": True}
        except AssertionError as e:
            out[dtype] = {"held": False, "failure": str(e)}
            rc = rc or int(dtype == "bfloat16")
        out[dtype]["seconds"] = time.perf_counter() - t0
        print(dtype, json.dumps({k: v for k, v in out[dtype].items() if k != "report"})[:4000],
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    print(smi)
    return rc


if __name__ == "__main__":
    sys.exit(main())
