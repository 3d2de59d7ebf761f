"""Serving launcher: a synthetic mixed-length trace through the continuous-
batching ``ServeSession`` over the paged KV pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --engine continuous --cache-layout paged --loop sync --exec approx \
        --attn-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --requests 6 --new 8

This is the continuous/paged branch of the JAX package's launcher.  The
weights are random (``init_params`` from ``--seed``) at the registered
widths and are frozen to uint8 ``QWeight``s for every quantized ``--exec``
mode.  ``--exec approx`` runs every projection through the CUDA
approximate-matmul kernel and ``--attn-impl kernel`` the decode attention
through the CUDA paged-attention kernel; on ``--device cpu`` both take
their plain PyTorch versions.  Without ``--device`` the run needs a CUDA
device and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.transformer import init_params
from repro_torch.serve import (
    ADMISSION_POLICIES,
    EXECUTION_MODES,
    SamplingConfig,
    ServeSession,
    freeze_params,
    resolve_execution_mode,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--multiplier", default="mul8x8_2")
    ap.add_argument("--exec", dest="exec_mode", default="approx", choices=EXECUTION_MODES)
    ap.add_argument("--engine", default="continuous", choices=("continuous",))
    ap.add_argument("--cache-layout", default="paged", choices=("paged",))
    ap.add_argument("--loop", default="sync", choices=("sync",))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--attn-impl", default="kernel", choices=ATTN_IMPLS,
                    help="paged decode attention: the CUDA kernel, or its "
                         "plain clamp-gather version (the oracle)")
    ap.add_argument("--policy", default="priority", choices=ADMISSION_POLICIES)
    ap.add_argument("--pad-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, approx=resolve_execution_mode(args.exec_mode,
                                                                 args.multiplier))
    params = freeze_params(cfg, init_params(cfg, seed=args.seed, device=device))
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              eos_id=args.eos_id)

    buckets = [8]
    while buckets[-1] < args.prompt_len:
        buckets.append(buckets[-1] * 2)
    max_len = max(args.max_len, buckets[-1] + args.new)
    max_len += -max_len % args.block_size
    sess = ServeSession(
        cfg, params, num_slots=args.num_slots, max_len=max_len,
        prompt_buckets=tuple(buckets), sampling=sampling, seed=args.seed,
        block_size=args.block_size, num_blocks=args.num_blocks,
        policy=args.policy, attn_impl=args.attn_impl, pad_id=args.pad_id,
        device=device,
    )
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(min(2, args.prompt_len), args.prompt_len + 1))
        lo = min(max(2, args.new // 4), args.new)
        sess.submit(rng.integers(0, cfg.vocab_size, plen),
                    max_new=int(rng.integers(lo, args.new + 1)))
    approx_matmul.launches = paged_attention.launches = 0
    t0 = time.perf_counter()
    results = sess.run()
    dt = time.perf_counter() - t0
    generated = sum(len(r.tokens) for r in results.values())
    st = sess.stats
    print(f"[continuous/{args.exec_mode}/paged/sync on {device}] {len(results)} "
          f"requests, {generated} tokens in {dt:.3f}s ({generated / dt:.1f} tok/s), "
          f"slot utilization {st.slot_utilization * 100:.1f}% over {st.ticks} "
          f"ticks x {args.num_slots} slots")
    print(f"  ttft p50/p95 = {st.ttft_p50:.0f}/{st.ttft_p95:.0f} ticks "
          f"(p50 {st.ttft_s_p50:.3f}s), latency p50/p95 = "
          f"{st.latency_p50:.0f}/{st.latency_p95:.0f} ticks, peak concurrency "
          f"{st.peak_active}")
    print(f"  KV pool: {sess.num_blocks} x {args.block_size}-row blocks, peak in "
          f"use {st.peak_blocks_in_use}, attention impl {st.attn_impl}")
    print(f"  kernel launches: approx_matmul {approx_matmul.launches}, "
          f"paged_attention {paged_attention.launches}")
    first = results[min(results)]
    print("sample:", first.full_sequence.tolist())
    return results


if __name__ == "__main__":
    main()
