#!/usr/bin/env python3
"""Time an earlier version of the paged decode-attention kernel (K2) beside
the current one, on one card, in turns (earlier, current, current,
earlier).

    python3 scripts/k2_previous.py --previous OLD/paged_attention.cu [--out r.json]

The earlier source is the first, one-block-per-(row, KV head) kernel: f32
q, pool and output, and the C entry point
``paged_attention_launch(q, k_new, v_new, k_pool, v_pool, table, cur_len,
out, B, H, Hkv, hd, bs, W, num_blocks, stream)``.  It is built here by
``nvcc`` into a temporary directory.  Both kernels get the same f32
operands: granite-3-2b's served decode step (40 calls, 4 rows, W = 10,
blocks of 16) and one call at 4,096 positions (W = 256, four pools so
that no call finds its blocks in L2).  Each is timed by CUDA events
around back-to-back steps and by the profiler's device time; the current
kernel is checked against the earlier one (within 1e-4).  Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def build_previous(src: Path, tmp: str):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import ARCH_FLAGS, _nvcc

    lib = Path(tmp) / "libk2_previous.so"
    subprocess.run([_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).paged_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def previous(q, kn, vn, kp, vp, tbl, cur, *, block_size):
        B, H, hd = q.shape
        nb, bs, hkv, _ = kp.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tbl.data_ptr(), cur.data_ptr(), out.data_ptr(), B, H, hkv, hd, bs,
                tbl.shape[1], nb, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"previous K2 launch failed: cudaError {rc}")
        return out
    return previous


def case(dev, rng, calls, B, W, cur, hkv=8, g=4, hd=64, bs=16):
    nb = B * W
    f = lambda *s: torch.randn(*s, device=dev)
    ops = [f(calls, B, hkv * g, hd), f(calls, B, hkv, hd), f(calls, B, hkv, hd),
           f(calls, nb, bs, hkv, hd), f(calls, nb, bs, hkv, hd)]
    cur = np.asarray(cur, np.int32)
    tbl = np.full((B, W), nb, np.int32)
    perm = list(rng.permutation(nb))
    for b in range(B):
        n = min(W, int(cur[b]) // bs + 1)
        tbl[b, :n] = [perm.pop() for _ in range(n)]
    return ops, tbl, cur


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--previous", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_previous: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.paged_attention import paged_attention

    dev = torch.device("cuda", 0)
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    report = {"card": smi, "shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        previous = build_previous(Path(args.previous), tmp)
        cs.warm_up(dev)
        shapes = {"decode_step": (40, 4, 10, rng.integers(40, 160, 4)),
                  "long_context": (4, 4, 256, [4095] * 4)}
        for name, (calls, B, W, cur) in shapes.items():
            (q, kn, vn, kp, vp), tbl, cur = case(dev, rng, calls, B, W, cur)
            tbl_t, cur_t = torch.as_tensor(tbl, device=dev), torch.as_tensor(cur, device=dev)

            def step(fn):
                return lambda: [fn(q[i], kn[i], vn[i], kp[i], vp[i], tbl_t, cur_t, block_size=16)
                                for i in range(calls)]
            err = max((a - b).abs().max().item()
                      for a, b in zip(step(paged_attention)(), step(previous)()))
            if not err <= 1e-4:
                raise AssertionError(f"{name}: the kernels differ by {err}")
            row = {"calls": calls, "B": B, "W": W, "cur_len": cur.tolist(), "max_abs_diff": err,
                   "previous_ms": [], "current_ms": []}
            for which in ("previous", "current", "current", "previous"):
                fn = previous if which == "previous" else paged_attention
                row[f"{which}_ms"].append(cs.cuda_ms(step(fn)))
            for which, fn in (("previous", previous), ("current", paged_attention)):
                prof = cs.profile_step(step(fn), match="paged_attention_kernel", key="k2")
                row[f"{which}_device_ms"] = prof.get("k2")
            valid = cs.k2_valid_positions(tbl, cur, B * W, 16)
            row["bound_ms"], row["bound_by"] = cs.k2_bound(B, 32, 8, 64, W, valid, 4, 4, calls)
            report["shapes"][name] = row
            print(name, json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
