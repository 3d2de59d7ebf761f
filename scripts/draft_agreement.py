#!/usr/bin/env python3
"""How far each approximate draft's logits lie from its verifier's: the
self-speculative draft of ``chip_smoke.py``'s phase 11, read without a
serving session.

    python3 scripts/draft_agreement.py [--seed S] [--out agreement.json]

granite-3-2b at full width with random weights from ``--seed`` (40 layers)
and from ``--seed`` + 1 (4 layers), as phase 11 makes them.  The verifier
is ``exact_quant`` with per-row activation scales; each draft is
``draft_config(verifier, "approx", m)`` for the paper's mul8x8_1/2/3
through K1.  Over the prompts of phase 4's first two requests (one
full-sequence ``forward`` per prompt and config), it prints per depth:

* ``verifier_mean_top2_gap``: the verifier's mean gap between its top two
  logits, what a draft's error has to stay under for its argmax to agree;
* per draft, ``share``: the share of positions whose argmax equals the
  verifier's (a draft token's acceptance, read over the prompt), and
  ``mean_abs_logit_diff``: the mean |draft - verifier| logit.

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
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

DRAFTS = ("mul8x8_1", "mul8x8_2", "mul8x8_3")
PROMPTS = 2


def agreement(vcfg, params, prompts, dev):
    """The verifier's mean top-2 gap and each draft's argmax share and mean
    |logit difference| over ``prompts``."""
    from repro_torch.models.transformer import forward
    from repro_torch.serve import draft_config

    vocab = vcfg.vocab_size
    with torch.no_grad():
        logits = lambda cf: torch.cat([
            forward(cf, params, torch.as_tensor(p[None], device=dev))[0, :, :vocab]
            for p in prompts])
        ref = logits(vcfg)
        top2 = ref.topk(2, dim=-1).values
        row = {"verifier_mean_top2_gap": float((top2[:, 0] - top2[:, 1]).mean()),
               "positions": ref.shape[0]}
        for mult in DRAFTS:
            got = logits(draft_config(vcfg, "approx", mult))
            row[mult] = {"share": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                         "mean_abs_logit_diff": float((got - ref).abs().mean())}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("draft_agreement: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import freeze_params, resolve_execution_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # the served config (weights frozen for it) and its verifier, as phase 11
    cfg = dataclasses.replace(get_config(cs.ARCH),
                              approx=resolve_execution_mode("approx", act_per_row=True))
    vcfg = dataclasses.replace(cfg, approx=resolve_execution_mode("exact_quant",
                                                                  act_per_row=True))
    trace = cs.make_trace(np.random.default_rng(args.seed), cfg.vocab_size, cs.REQUESTS)
    prompts = [p for p, _, _ in trace[:PROMPTS]]
    result = {"card": smi}
    for layers, seed in ((cfg.num_layers, args.seed), (cs.ORACLE_LAYERS, args.seed + 1)):
        sc, vc = (dataclasses.replace(c, num_layers=layers) for c in (cfg, vcfg))
        params = freeze_params(sc, init_params(sc, seed=seed, device=dev))
        result[f"{layers}_layers"] = agreement(vc, params, prompts, dev)
        del params
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
