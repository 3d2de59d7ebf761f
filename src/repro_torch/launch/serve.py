"""Serving launcher: batched generation on the slot layout, or a synthetic
mixed-length trace through the continuous-batching ``ServeSession``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --engine continuous --cache-layout paged --loop sync --exec approx \
        --attn-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --requests 6 --new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --engine scan --batch 4 --new 8            # generate; --engine legacy
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --engine continuous --cache-layout slots --requests 6

The JAX package's launcher less the flags of the slices not yet ported.
``--engine scan`` is ``generate`` (fused prefill, then a loop of decode
steps over per-row ``max_len`` stripes), ``--engine legacy`` the per-token
``greedy_generate_legacy`` loop, and ``--engine continuous`` (the port's
default; the JAX launcher's is ``scan``) a ``ServeSession`` on the paged
pool (default) or on per-slot stripes (``--cache-layout slots``).  The
weights are random (``init_params`` from ``--seed``) at the registered
widths and are frozen to uint8 ``QWeight``s for every quantized ``--exec``
mode.  ``--exec approx`` runs every projection through the CUDA
approximate-matmul kernel and, on the paged layout, ``--attn-impl kernel``
(its default there) the decode attention through the CUDA paged-attention
kernel; the slot layout attends with the plain ``attention_core``, as the
JAX package does.  On ``--device cpu`` the kernels take their plain
PyTorch versions.  Without ``--device`` the run needs a CUDA device and
raises without one.
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
    CACHE_LAYOUTS,
    EXECUTION_MODES,
    SamplingConfig,
    ServeSession,
    freeze_params,
    generate,
    greedy_generate_legacy,
    resolve_execution_mode,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="scan/legacy engines: rows generated together")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--multiplier", default="mul8x8_2")
    ap.add_argument("--exec", dest="exec_mode", default="approx", choices=EXECUTION_MODES)
    ap.add_argument("--engine", default="continuous",
                    choices=("scan", "legacy", "continuous"),
                    help="generate, the per-token legacy loop, or the "
                         "continuous-batching ServeSession")
    ap.add_argument("--cache-layout", default="paged", choices=CACHE_LAYOUTS,
                    help="continuous engine: the paged block pool, or a "
                         "max_len stripe per slot")
    ap.add_argument("--loop", default="sync", choices=("sync",))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--attn-impl", default=None, choices=ATTN_IMPLS,
                    help="decode attention: the CUDA kernel (paged only; the "
                         "paged default), or its plain version (the oracle; "
                         "the slot layout's default)")
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
    if args.engine != "continuous":
        return _batched(args, cfg, params, sampling, device)

    buckets = [8]
    while buckets[-1] < args.prompt_len:
        buckets.append(buckets[-1] * 2)
    max_len = max(args.max_len, buckets[-1] + args.new)
    if args.cache_layout == "paged":
        max_len += -max_len % args.block_size
    sess = ServeSession(
        cfg, params, num_slots=args.num_slots, max_len=max_len,
        prompt_buckets=tuple(buckets), sampling=sampling, seed=args.seed,
        block_size=args.block_size, num_blocks=args.num_blocks,
        policy=args.policy, attn_impl=args.attn_impl, pad_id=args.pad_id,
        cache_layout=args.cache_layout, device=device,
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
    print(f"[continuous/{args.exec_mode}/{args.cache_layout}/sync on {device}] {len(results)} "
          f"requests, {generated} tokens in {dt:.3f}s ({generated / dt:.1f} tok/s), "
          f"slot utilization {st.slot_utilization * 100:.1f}% over {st.ticks} "
          f"ticks x {args.num_slots} slots")
    print(f"  ttft p50/p95 = {st.ttft_p50:.0f}/{st.ttft_p95:.0f} ticks "
          f"(p50 {st.ttft_s_p50:.3f}s), latency p50/p95 = "
          f"{st.latency_p50:.0f}/{st.latency_p95:.0f} ticks, peak concurrency "
          f"{st.peak_active}")
    if args.cache_layout == "paged":
        print(f"  KV pool: {sess.num_blocks} x {args.block_size}-row blocks, peak "
              f"in use {st.peak_blocks_in_use}, attention impl {st.attn_impl}")
    else:
        print(f"  KV stripes: {args.num_slots} x {max_len} positions, attention "
              f"impl {st.attn_impl}")
    print(f"  kernel launches: approx_matmul {approx_matmul.launches}, "
          f"paged_attention {paged_attention.launches}")
    first = results[min(results)]
    print("sample:", first.full_sequence.tolist())
    return results


def _batched(args, cfg, params, sampling, device):
    """``--engine scan|legacy``: one batch of seeded prompts, run once to
    warm up (kernel builds, table caches) and once timed."""
    if args.engine == "legacy" and sampling != SamplingConfig():
        print("warning: --engine legacy is greedy-only; "
              "--temperature/--top-k/--eos-id are ignored")
    rng = np.random.default_rng(args.seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    def run():
        if args.engine == "legacy":
            return greedy_generate_legacy(cfg, params, prompt, max_new=args.new,
                                          device=device)
        return generate(cfg, params, prompt, max_new=args.new, sampling=sampling,
                        seed=args.seed, device=device)

    run()
    approx_matmul.launches = 0
    t0 = time.perf_counter()
    out = run().cpu()
    dt = time.perf_counter() - t0
    print(f"[{args.engine}/{args.exec_mode} on {device}] generated "
          f"{args.batch}x{args.new} tokens in {dt:.3f}s "
          f"({args.batch * args.new / dt:.1f} tok/s, after one warm-up run)")
    print(f"  kernel launches: approx_matmul {approx_matmul.launches}")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
