#!/usr/bin/env python3
"""Whether the chunked prefill pass rounds the same whatever its batch
width and chunk boundaries: the question behind ``ServeSession``'s fixed
chunk-dispatch width and ``chip_smoke.py``'s phase 12 (c).

    python3 scripts/chunk_width.py [--seed S] [--out width.json]

On the card it reads, bit for bit against row 0 computed alone:

* ``rms_norm`` of 1-4 rows of d 2048 (bf16);
* ``attend_gathered`` (the pass's per-position attention over gathered
  blocks, granite-3-2b's 32/8 heads of 64, 21 blocks of 16) at 1, 2 and 4
  rows;
* ``paged_chunk_prefill_step`` of granite-3-2b at full width (40 layers,
  ``approx`` with per-row scales through K1, frozen weights from
  ``--seed``) over a 105-token prompt in row 0, with 1, 2 or 4 rows in the
  dispatch and chunks of 64 or 32: the logits' largest difference and
  whether the pool's K equals the 1-row, 64-chunk run's.

Needs the card and ``nvcc`` (K1 is built on the first call).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PROMPT, BLOCK, MAX_LEN = 105, 16, 336


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_width: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ref import attend_gathered, gather_blocks
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import (
        init_paged_cache,
        init_params,
        paged_chunk_prefill_step,
    )
    from repro_torch.serve import freeze_params, resolve_execution_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}

    x = torch.randn(4, 1, 2048, generator=g, device=dev).to(torch.bfloat16)
    gamma = torch.randn(2048, generator=g, device=dev)
    alone = L.rms_norm(x[:1], gamma)
    out["rms_norm_row0_equal"] = {A: torch.equal(L.rms_norm(x[:A], gamma)[:1], alone)
                                  for A in (2, 3, 4)}

    nb, hkv, hd, H, W = 64, 8, 64, 32, MAX_LEN // BLOCK
    kp = torch.randn(nb, BLOCK, hkv, hd, generator=g, device=dev)
    vp = torch.randn(nb, BLOCK, hkv, hd, generator=g, device=dev)
    tables = torch.randint(0, nb, (4, W), generator=g, device=dev, dtype=torch.int32)
    q = torch.randn(4, H, hd, generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn(4, hkv, hd, generator=g, device=dev)
    vn = torch.randn(4, hkv, hd, generator=g, device=dev)
    cur = torch.tensor([200, 150, 90, 300], device=dev)

    def attend(A):
        kg, vg = gather_blocks(kp, vp, tables[:A])
        return attend_gathered(q[:A], kn[:A], vn[:A], kg, vg, tables[:A], cur[:A],
                               num_blocks=nb, block_size=BLOCK)[0]

    alone = attend(1)
    out["attend_gathered_row0_equal"] = {A: torch.equal(attend(A), alone) for A in (2, 4)}

    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              approx=resolve_execution_mode("approx", act_per_row=True))
    params = freeze_params(cfg, init_params(cfg, seed=args.seed, device=dev))
    rng = np.random.default_rng(args.seed + 1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, PROMPT)), device=dev)

    def chunk_pass(A, chunk):
        """Row 0's logits over the prompt and the pool's K of row 0's blocks."""
        cache = init_paged_cache(cfg, 4 * W, BLOCK, device=dev)
        tbl = (torch.arange(W, device=dev, dtype=torch.int32)[None]
               + W * torch.arange(A, device=dev, dtype=torch.int32)[:, None])
        parts = []
        with torch.no_grad():
            for s in range(0, PROMPT, chunk):
                e = min(PROMPT, s + chunk)
                parts.append(paged_chunk_prefill_step(
                    cfg, params, cache, prompts[:A, s:e], torch.full((A,), s, device=dev), tbl,
                    block_size=BLOCK)[0])
        return torch.cat(parts), cache["k"][:, :W].clone()

    base, kbase = chunk_pass(1, 64)
    out["chunk_pass_vs_1_row_chunks_of_64"] = {}
    for A, chunk in ((1, 32), (2, 64), (4, 64), (4, 32)):
        lg, k = chunk_pass(A, chunk)
        out["chunk_pass_vs_1_row_chunks_of_64"][f"{A}_rows_chunks_of_{chunk}"] = {
            "logits_equal": torch.equal(lg, base), "k_equal": torch.equal(k, kbase),
            "max_abs_logit_diff": (lg - base).abs().max().item()}
    a, ka = chunk_pass(4, 64)
    b, kb = chunk_pass(4, 32)
    out["chunk_pass_4_rows_chunks_of_32_vs_64"] = {
        "logits_equal": torch.equal(a, b), "k_equal": torch.equal(ka, kb)}
    print(json.dumps(out, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
