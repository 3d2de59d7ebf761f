"""Serving launcher: batched generation on the slot layout, or a synthetic
mixed-length trace through the continuous-batching ``ServeSession``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --engine continuous --cache-layout paged --loop async --exec approx \
        --attn-impl kernel --steps-per-tick 2 --prefill-decode-ratio 1.0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --requests 6 --new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --engine scan --batch 4 --new 8            # generate; --engine legacy
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --engine continuous --cache-layout slots --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
        --reduced --device cpu --requests 6            # moe, paged, K1 and K2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --reduced --device cpu --cache-layout slots    # ssm; zamba2-2.7b: hybrid

``--arch`` takes every registered config (``configs.list_archs()``): the
dense, moe, ssm and hybrid families.  The ssm and hybrid families keep
per-request conv/ssm state with no sequence axis, so they serve on the
slot layout only (``--cache-layout slots``; the paged default refuses
them, as the JAX session does) and prefill by teacher-forcing the prompt
through the decode step.

``--tp N`` serves tensor parallel (the continuous engine on the paged
layout, dense or moe family; a MoE's routed experts split by expert where
N divides them): N rank processes, rank r on ``cuda:r`` over NCCL
(``--device cpu``: on the CPU over gloo), each with the same weights and
trace; rank 0 prints.  It refuses more ranks than visible cards.

    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --exec approx
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --tp 2 \
        --arch qwen2-moe-a2.7b

On the paged layout ``--prefix-sharing`` shares resident prompt blocks
(copy-on-write), ``--preemption`` oversubscribes the pool and evicts and
replays a resident request when it runs dry (the buckets then widen to
cover the longest replay prompt), and ``--spec-decode`` drafts
``--draft-k`` tokens per tick through ``--draft-mode`` x ``--multiplier``
and verifies them in one pass (``--dynamic-draft-k`` tunes the window).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --prefix-sharing --preemption --num-blocks 12 --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --exec exact_quant --spec-decode --draft-mode approx --draft-k 4

``--tiers`` serves a quality ladder (comma-separated execution modes, best
first, e.g. ``exact,approx_lowrank,approx_msr``): each synthetic request is
routed to a random rung, and ``--shed-queue-depth`` / ``--shed-gap-ticks``
arm the load shedder that demotes new admissions down the ladder under
pressure (``--shed-hold-steps``, ``--shed-restore-fraction``: its
hysteresis).  ``--chunked-prefill`` splits each prompt longer than
``--prefill-chunk`` (a bucket; default the largest) into chunks
interleaved with decode across steps, and admits prompts past the largest
bucket.

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --tiers exact,approx_lowrank,approx_msr --shed-queue-depth 2
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --chunked-prefill --prefill-chunk 8 --prompt-len 20

``--engine scan`` is ``generate`` (fused prefill, then a loop of decode
steps over per-row ``max_len`` stripes), ``--engine legacy`` the per-token
``greedy_generate_legacy`` loop, and ``--engine continuous`` (the port's
default; the JAX launcher's is ``scan``) a ``ServeSession`` on the paged
pool (default) or on per-slot stripes (``--cache-layout slots``), driven
by the async double-buffered loop (``--loop async``, the default) or the
sync loop, ``--steps-per-tick`` decode steps per chunk, with
``--prefill-decode-ratio`` / ``--prefill-token-budget`` rate-limiting the
prompt tokens admitted against resident decodes.  The
weights are random (``init_params`` from ``--seed``) at the registered
widths; ``--freeze-weights`` pre-quantizes them to uint8 ``QWeight``s for
a quantized ``--exec`` mode (off by default, as in the JAX launcher: each
projection then quantizes its float weight per call, which a tier ladder
with an ``exact`` rung needs).  ``--exec approx`` runs every projection through the CUDA
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
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.device import resolve_device
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.launch.mesh import TPMesh, run_ranks
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.transformer import init_params
from repro_torch.serve import (
    ADMISSION_POLICIES,
    CACHE_LAYOUTS,
    EXECUTION_MODES,
    SERVE_LOOPS,
    SamplingConfig,
    ServeSession,
    generate,
    greedy_generate_legacy,
    resolve_execution_mode,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    help=f"registered config: {', '.join(list_archs())}")
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
    ap.add_argument("--loop", default="async", choices=SERVE_LOOPS,
                    help="continuous engine: async double-buffered pipeline "
                         "(default) or the strictly-alternating sync loop")
    ap.add_argument("--steps-per-tick", type=int, default=1,
                    help="continuous engine: decode steps per dispatched chunk")
    ap.add_argument("--prefill-decode-ratio", type=float, default=None,
                    help="continuous engine: admit at most RATIO * resident "
                         "decode tokens of bucketed prefill per step")
    ap.add_argument("--prefill-token-budget", type=int, default=None,
                    help="continuous engine: flat per-step prefill token "
                         "budget (alternative to --prefill-decode-ratio)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--freeze-weights", action="store_true",
                    help="pre-quantize matmul weights to uint8 QWeights")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--attn-impl", default=None, choices=ATTN_IMPLS,
                    help="decode attention: the CUDA kernel (paged only; the "
                         "paged default), or its plain version (the oracle; "
                         "the slot layout's default)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="paged layout: refcounted copy-on-write prefix "
                         "sharing — requests whose prompts share leading "
                         "blocks map them to the same physical blocks")
    ap.add_argument("--preemption", action="store_true",
                    help="paged layout: drop the worst-case block "
                         "reservation and oversubscribe the pool; on "
                         "exhaustion the least-important resident request "
                         "is evicted and replayed")
    ap.add_argument("--spec-decode", action="store_true",
                    help="paged layout: self-speculative decoding — each "
                         "tick runs --draft-k steps through the "
                         "approximate draft path, then one verify pass "
                         "accepts the longest matching prefix")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="spec decode: drafted positions per verify")
    ap.add_argument("--draft-mode", default="approx", choices=EXECUTION_MODES,
                    help="spec decode: the draft path's execution mode (the "
                         "draft multiplier reuses --multiplier; the --exec "
                         "mode itself is the every-token-accepts self-test)")
    ap.add_argument("--dynamic-draft-k", action="store_true",
                    help="spec decode: halve or regrow the draft window on "
                         "a --draft-k -> 1 ladder around the break-even "
                         "accept rate 1/--draft-cost-ratio")
    ap.add_argument("--draft-cost-ratio", type=float, default=4.0,
                    help="dynamic draft: verify-position cost over "
                         "draft-step cost; its inverse is the break-even "
                         "accept rate")
    ap.add_argument("--draft-window", type=int, default=32,
                    help="dynamic draft: rolling (drafted, accepted) rows "
                         "judged before each move")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="paged layout: split each prompt's prefill into "
                         "--prefill-chunk-wide chunks dispatched across "
                         "successive steps and interleaved with decode "
                         "under the prefill budget — a long prompt then "
                         "stalls decode by at most one chunk, not one "
                         "prompt bucket")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: chunk width (must be one of the "
                         "prompt buckets; default: the largest bucket)")
    ap.add_argument("--tiers", default=None,
                    help="continuous engine: comma-separated execution-mode "
                         "quality ladder (best first), e.g. "
                         "'exact,approx_lowrank,approx_msr'; each request is "
                         "routed to a random rung")
    ap.add_argument("--tier-multiplier", default="mul8x8_2",
                    help="tiers: multiplier for approx rungs (MSR rungs "
                         "fall back to mul8x8_msr4 unless an MSR name is "
                         "given)")
    ap.add_argument("--shed-queue-depth", type=int, default=None,
                    help="tiers: demote new admissions one rung when the "
                         "ready queue exceeds this depth")
    ap.add_argument("--shed-gap-ticks", type=int, default=None,
                    help="tiers: demote new admissions one rung when the "
                         "live decode gap exceeds this many work ticks")
    ap.add_argument("--shed-hold-steps", type=int, default=8,
                    help="shedder: consecutive healthy steps before "
                         "restoring one rung")
    ap.add_argument("--shed-restore-fraction", type=float, default=0.5,
                    help="shedder: healthy = load below this fraction of "
                         "the shed thresholds (hysteresis)")
    ap.add_argument("--policy", default="priority", choices=ADMISSION_POLICIES)
    ap.add_argument("--pad-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--tp", type=int, default=0,
                    help="continuous engine, paged layout, dense or moe: "
                         "serve tensor parallel over N rank processes (rank r "
                         "on cuda:r over NCCL; --device cpu: gloo on the "
                         "CPU), params Megatron-split (a MoE's experts by "
                         "expert where N divides them) and the KV pool split "
                         "by KV head")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.tp:
        return _serve_tp(args)
    return _serve(args, resolve_device(args.device))


def _serve_tp(args):
    """``--tp N``: N spawned ranks, each serving the same trace under one
    ``TPMesh``; rank 0 prints and its results are returned."""
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.engine != "continuous":
        raise SystemExit("--tp serves through the continuous engine")
    if args.cache_layout != "paged":
        raise SystemExit("--tp requires --cache-layout paged")
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not on_cpu and args.tp > torch.cuda.device_count():
        raise SystemExit(f"--tp {args.tp} > {torch.cuda.device_count()} visible CUDA devices")
    store_dir = tempfile.mkdtemp(prefix="serve_tp_")
    try:
        return run_ranks(_rank, args.tp, (os.path.join(store_dir, "store"), args, on_cpu),
                         timeout=24 * 3600)[0]
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _rank(rank, world, store_path, args, on_cpu):
    device = torch.device("cpu") if on_cpu else torch.device("cuda", rank)
    if on_cpu:                          # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = TPMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                  backend="gloo" if on_cpu else "nccl", device=device)
    try:
        return _serve(args, device, mesh)
    finally:
        mesh.close()


def _serve(args, device, mesh=None):
    """One serving run on ``device`` (one rank's part under ``mesh``);
    prints unless this is a rank other than 0."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, approx=resolve_execution_mode(args.exec_mode,
                                                                 args.multiplier))
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch} takes embedding inputs (frontend stub); "
                         "use an embed-input arch for token serving")
    # frozen layer by layer: a moe model's float32 weights never all exist
    params = init_params(cfg, seed=args.seed, device=device, freeze=args.freeze_weights)
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              eos_id=args.eos_id)
    if args.engine != "continuous":
        return _batched(args, cfg, params, sampling, device)

    # preemption replays prompt + accepted tokens through the bucketed
    # prefill, so the buckets must cover the longest replay prompt too,
    # unless chunked prefill chunks it through the buckets there are
    top = args.prompt_len
    if args.preemption and not args.chunked_prefill:
        top = args.prompt_len + args.new - 1
    buckets = [8]
    while buckets[-1] < top:
        buckets.append(buckets[-1] * 2)
    max_len = max(args.max_len, buckets[-1] + args.new)
    if args.cache_layout == "paged":
        max_len += -max_len % args.block_size
    tiers = None
    if args.tiers:
        tiers = tuple(t.strip() for t in args.tiers.split(",") if t.strip())
    sess = ServeSession(
        cfg, params, num_slots=args.num_slots, max_len=max_len,
        prompt_buckets=tuple(buckets), sampling=sampling, seed=args.seed,
        block_size=args.block_size, num_blocks=args.num_blocks,
        policy=args.policy, attn_impl=args.attn_impl, pad_id=args.pad_id,
        cache_layout=args.cache_layout, loop=args.loop, steps_per_tick=args.steps_per_tick,
        prefill_decode_ratio=args.prefill_decode_ratio,
        prefill_token_budget=args.prefill_token_budget,
        prefix_sharing=args.prefix_sharing, preemption=args.preemption,
        spec_decode=args.spec_decode, draft_k=args.draft_k, draft_mode=args.draft_mode,
        draft_multiplier=args.multiplier, dynamic_draft_k=args.dynamic_draft_k,
        draft_cost_ratio=args.draft_cost_ratio, draft_window=args.draft_window,
        tiers=tiers, tier_multiplier=args.tier_multiplier,
        shed_queue_depth=args.shed_queue_depth, shed_gap_ticks=args.shed_gap_ticks,
        shed_hold_steps=args.shed_hold_steps,
        shed_restore_fraction=args.shed_restore_fraction,
        chunked_prefill=args.chunked_prefill, prefill_chunk=args.prefill_chunk,
        mesh=mesh, device=device,
    )
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(min(2, args.prompt_len), args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        lo = min(max(2, args.new // 4), args.new)
        max_new = int(rng.integers(lo, args.new + 1))
        tier = str(rng.choice(tiers)) if tiers is not None else None
        sess.submit(prompt, max_new=max_new, tier=tier)
    approx_matmul.launches = paged_attention.launches = 0
    t0 = time.perf_counter()
    results = sess.run()
    dt = time.perf_counter() - t0
    generated = sum(len(r.tokens) for r in results.values())
    st = sess.stats
    say(f"[continuous/{args.exec_mode}/{args.cache_layout}/{args.loop} on {device}] "
        f"{len(results)} "
        f"requests, {generated} tokens in {dt:.3f}s ({generated / dt:.1f} tok/s), "
        f"slot utilization {st.slot_utilization * 100:.1f}% over {st.ticks} "
        f"ticks x {args.num_slots} slots")
    say(f"  ttft p50/p95 = {st.ttft_p50:.0f}/{st.ttft_p95:.0f} ticks "
        f"(p50 {st.ttft_s_p50:.3f}s), latency p50/p95 = "
        f"{st.latency_p50:.0f}/{st.latency_p95:.0f} ticks, peak concurrency "
        f"{st.peak_active}")
    say(f"  host/device overlap {st.overlap_fraction * 100:.0f}% of wall "
        f"(host blocked {st.host_block_s:.3f}s of {st.wall_s:.3f}s), decode-gap gauge "
        f"{st.max_decode_gap_ticks} work ticks, prefill stalls {st.prefill_stall_ticks}")
    if args.cache_layout == "paged":
        say(f"  KV pool: {sess.num_blocks} x {args.block_size}-row blocks, peak "
            f"in use {st.peak_blocks_in_use}, attention impl {st.attn_impl}")
        if mesh is not None:
            say(f"  tensor parallel: tp={st.tp} over {st.devices} devices, peak KV "
                f"{st.peak_block_bytes_per_device / 2**20:.2f} MiB/device")
        if args.prefix_sharing or args.preemption:
            say(f"  sharing: {st.prefix_hit_blocks} prefix-hit blocks, "
                f"{st.cow_forks} CoW forks, {st.preemptions} preemptions")
        if args.chunked_prefill:
            say(f"  chunked prefill: chunk {sess.prefill_chunk}, {st.prefill_chunks} "
                f"chunk rows, prefills by bucket {dict(sorted(st.prefills.items()))}")
        if args.spec_decode:
            say(f"  spec decode: draft {args.draft_mode}/{args.multiplier} "
                f"k={args.draft_k}, accept rate {st.accept_rate * 100:.1f}% "
                f"({st.accepted_tokens}/{st.draft_tokens} drafted tokens "
                f"over {st.verify_calls} verifies)")
            if args.dynamic_draft_k:
                say(f"  dynamic draft: k now {st.draft_k_current} "
                    f"({st.draft_k_shrinks} shrinks, {st.draft_k_grows} grows)")
    else:
        say(f"  KV stripes: {args.num_slots} x {max_len} positions, attention "
            f"impl {st.attn_impl}")
    if tiers is not None:
        served = dict.fromkeys(tiers, 0)
        for r in results.values():
            served[r.tier] += 1
        say(f"  tiers {','.join(tiers)}: served "
            + " ".join(f"{t}={n}" for t, n in served.items())
            + f", demotions {st.tier_demotions}, restorations {st.tier_restorations}, "
            f"shed level now {st.shed_level}")
    say(f"  kernel launches: approx_matmul {approx_matmul.launches}, "
        f"paged_attention {paged_attention.launches}")
    first = results[min(results)]
    say("sample:", first.full_sequence.tolist())
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
