"""Batched serving under the approximate multiplier (the JAX package's
``examples/llm_approx_serve.py`` on the port).

Initializes a small LM, runs batched decoding through ``generate`` under
each execution mode — float, exact-quant, the plain approximate product
(``approx_lowrank``) and, with ``--kernel``, the CUDA approximate-matmul
kernel (K1; its plain version on ``--device cpu``) — and reports agreement
and throughput, plus ``generate`` against the legacy per-token loop.

    python -m repro_torch.examples.llm_approx_serve --batch 4 --new 16
    python -m repro_torch.examples.llm_approx_serve --kernel --continuous
    python -m repro_torch.examples.llm_approx_serve --device cpu --new 4 --continuous

With ``--continuous`` a mixed-length request trace also runs through
``ServeSession`` on the slot layout (async loop) and on the paged layout
(at half the slot layout's KV memory) under the sync and the async loop
with the plain attention, and once more through K2 (``attn_impl=
"kernel"``); each request's output is checked against ``generate`` of its
prompt alone, the order-independence oracle.  Without ``--device`` the run
needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve import ServeSession, generate, greedy_generate_legacy, resolve_execution_mode

__all__ = ["main"]

CONTINUOUS_ARMS = (("slots", "async", "gather"), ("paged", "sync", "gather"),
                   ("paged", "async", "gather"), ("paged", "async", "kernel"))


def _timed(fn):
    """(result on the host, seconds) after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    out = fn().cpu()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--multiplier", default="mul8x8_2")
    ap.add_argument("--kernel", action="store_true",
                    help="add an 'approx' arm that routes every projection through "
                         "the CUDA approximate-matmul kernel (bit-exact to the LUT)")
    ap.add_argument("--continuous", action="store_true",
                    help="also serve a mixed-length trace through ServeSession and "
                         "check each request against a standalone generate() run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = reduced_config(get_config("granite-3-2b"), num_layers=4, d_model=256, num_heads=4,
                          num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1024)
    params = init_params(base, seed=0, device=dev)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, base.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    arms = [
        ("float", resolve_execution_mode("exact")),
        ("exact_quant", resolve_execution_mode("exact_quant")),
        (args.multiplier, resolve_execution_mode("approx_lowrank", args.multiplier)),
    ]
    if args.kernel:
        arms.append(("approx_kernel", resolve_execution_mode("approx", args.multiplier)))

    results = {}
    for label, acfg in arms:
        cfg = dataclasses.replace(base, approx=acfg)
        out, dt = _timed(lambda: generate(cfg, params, prompt, max_new=args.new, device=dev))
        results[label] = out
        print(f"{label:12s}: {args.batch * args.new / dt:8.1f} tok/s  "
              f"sample: {out[0, args.prompt_len:].tolist()}")

    # generate against the legacy per-token loop (float arm)
    legacy, dt = _timed(lambda: greedy_generate_legacy(base, params, prompt,
                                                       max_new=args.new, device=dev))
    same = (legacy == results["float"]).float().mean().item()
    print(f"{'legacy loop':12s}: {args.batch * args.new / dt:8.1f} tok/s  "
          f"(float, per-token prefill and decode; {same * 100:.1f}% of tokens as generate's)")

    new = slice(args.prompt_len, None)
    agree = (results["float"][:, new] == results[args.multiplier][:, new]).float().mean().item()
    agree_q = (results["exact_quant"][:, new]
               == results[args.multiplier][:, new]).float().mean().item()
    print(f"\ntoken agreement vs float: {agree * 100:.1f}%; vs exact-quant: {agree_q * 100:.1f}%")
    if args.kernel:
        agree_k = (results["approx_kernel"][:, new]
                   == results[args.multiplier][:, new]).float().mean().item()
        print(f"kernel vs lowrank agreement (same semantics): {agree_k * 100:.1f}%")
    print("(random-init model: near-uniform logits make argmax quant-sensitive;"
          " see examples/lenet_mnist_qat.py for the trained-model DAL story)")

    if args.continuous:
        results["continuous"] = _continuous(args, base, params, dev)
    return results


def _continuous(args, base, params, dev):
    """Every arm of ``CONTINUOUS_ARMS`` on one trace; each request against
    ``generate`` of its prompt alone.  Returns {arm label: requests equal}."""
    max_len = 8 * -(-max(64, 16 + args.new) // 8)
    rng = np.random.default_rng(0)
    trace = []
    for i in range(10):
        p = rng.integers(0, base.vocab_size, int(rng.integers(2, 13)))
        trace.append((i, p, int(rng.integers(min(2, args.new), args.new + 1))))
    oracle = {rid: generate(base, params, p[None, :].astype(np.int32), max_new=n,
                            device=dev)[0, len(p):].cpu().numpy()
              for rid, p, n in trace}
    exact = {}
    for layout, loop, impl in CONTINUOUS_ARMS:
        print(f"\n-- continuous batching, {layout} KV cache, {loop} loop, "
              f"{impl} attention (float, greedy) --")
        kw = dict(num_slots=4, max_len=max_len, prompt_buckets=(4, 8, 16), loop=loop,
                  cache_layout=layout, attn_impl=impl, device=dev)
        if layout == "paged":
            # half the slot layout's KV memory: blocks are handed out by the
            # actual context length, so the same trace still fits
            kw.update(block_size=8, num_blocks=4 * max_len // 8 // 2)
        sess = ServeSession(base, params, **kw)
        for rid, p, n in trace:
            sess.submit(p, max_new=n, req_id=rid)
        t0 = time.perf_counter()
        out = sess.run()
        dt = time.perf_counter() - t0
        n_gen = sum(len(r.tokens) for r in out.values())
        st = sess.stats
        extra = (f", peak blocks {st.peak_blocks_in_use}/{sess.num_blocks}"
                 if layout == "paged" else "")
        label = f"{layout}/{loop}" + ("/kernel" if impl == "kernel" else "")
        print(f"{label:18s}: {n_gen / dt:8.1f} tok/s  ({len(out)} mixed-length requests, "
              f"slot utilization {st.slot_utilization * 100:.1f}%, overlap "
              f"{st.overlap_fraction * 100:.0f}%{extra})")
        exact[label] = sum(np.array_equal(oracle[rid], out[rid].tokens) for rid, _, _ in trace)
        print(f"order-independence oracle: {exact[label]}/{len(trace)} requests "
              "bit-identical to a standalone generate() run")
    return exact


if __name__ == "__main__":
    main()
