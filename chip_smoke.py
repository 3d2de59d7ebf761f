#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU: granite-3-2b at full width served (on the paged pool and on
per-slot stripes) and retrained, and the paper's CNNs (ResNet-19 at full
width) trained and QAT-retrained, through the hand-written CUDA kernels,
each held against its plain PyTorch version.

    python3 chip_smoke.py [--seed S] [--out report.json] [--profile]

Phases, each of which fails the run (non-zero exit, no result line):

1. build   nvcc builds every kernel under src/repro_torch/kernels/csrc for
           sm_90a; prints build seconds and the card's name and power limit.
2. K1      approx_matmul (CUDA) equals its plain version bit for bit at every
           (K, N) of granite-3-2b's projections with M = num_slots and
           M = one full prefill admission (timed, beside ``torch._int_mm`` on
           int8 views of the same codes: the exact product's cost alone), at
           M = 16, 32, 63, 64, 65 (both sides of the operand swap), for every
           registered multiplier at one mid shape with rhs_max 255 and 31,
           and on ragged shapes; then one decode step's K1 work, and the
           bound of one training step's 521 calls.
3. K2      paged_attention (CUDA) within 1e-4 of its plain version at the
           served shapes (H 32, Hkv 8, hd 64, block 16) and the test shapes,
           with sentinel holes, all-sentinel rows, cur_len on a block
           boundary and cur_len past the table, each on a float32 and on a
           bfloat16 pool and each with a float32 and a bfloat16 query (the
           bf16-query output within 1e-4 plus bf16 rounding, and bit-equal
           to the f32 result rounded to bf16); then one served decode step
           (40 calls, bf16 q as served) and one call at 4,096 positions
           (W = 256), each on both pool dtypes, every call checked the
           same way, then timed by CUDA events and by the profiler's device
           time, beside the bound, the plain version and SDPA over blocks
           gathered beforehand.
4. serve   8 seeded requests (prompts 16-128 tokens, 16-32 new tokens)
           through ServeSession(--exec approx, attn_impl="kernel") on the
           card, 4 slots, 16-row blocks; both kernels' launch counts, zeroed
           just before, must be > 0.
5. oracle  the first 2 requests again through a session on the plain
           versions (approx_lowrank, attn_impl="gather") on the card; the
           greedy tokens must be identical.  One decode step through K2 and
           through its plain version picks the same tokens, on a float32
           and on a bfloat16 pool.
6. K3      approx_mul_eltwise (CUDA, bit logic) on all 65,536 code pairs of
           mul8x8_1/2/3: equal to its plain version, to ``mul8x8_table`` and
           to the table K1 computes in one K = 1 call (``lut_mismatches``,
           the path K3 serves, counted with its launches zeroed just
           before); ragged 1-D (10**6 + 3) and 4-D cases; one 64 M-element
           call timed.
7. train   QAT retraining of granite-3-2b at full width (40 layers),
           mul8x8_2 through K1 (``mode="kernel"``), band_reg 1e-4, AdamW as
           ``launch/train.py`` sets it, batch 8 x seq 64 (every K1 call at
           M = 512): 3 steps through ``train_loop`` on ``token_batches`` with
           ``remat`` on (the config's default), each loss finite and K1's
           launch count (zeroed just before) > 0; step time, peak memory, a
           profiled step (K1's device share; K1 must show device time, so a
           renamed kernel symbol cannot hide) and steps with ``remat`` off.
           Oracle: one step at full width and 4 layers from identical
           state and batch with ``mode="kernel"`` and ``mode="lowrank"``
           (K1's plain version): bit-identical loss, parameters and
           moments.  Then ``launch/train.py --reduced`` runs 2 steps and a
           second call resumes from its checkpoint for 2 more.
8. paper   the paper's experiment through K1: (a) K1 bit-equal to its plain
           version at every im2col and FC shape of the seven Table VIII nets
           at batch 64 and 256 (ResNet-19's at 64 for all four Table VIII
           multipliers, each timed beside its bound); (b) Table VIII
           (``paper.table_viii``, --full protocol: 300 float steps, each
           multiplier's accuracy before and after 30 QAT steps), K1's count
           zeroed before each net and > 0 after it; (c) the JAX system
           test's LeNet-MNIST assertions (float accuracy > 0.8, mul8x8_2 DAL
           < 0.08, mul8x8_2 >= pkm - 0.02) on Table VIII's LeNet-MNIST
           model, with the test's own 80-step protocol run and printed
           beside it (at 80 steps the claim depends on the init,
           ``scripts/lenet_claim_seeds.py``); (d) ResNet-19 at full width,
           batch 64: 21 K1 launches per forward, QAT step time, peak memory,
           K1's device share of a profiled step (it must show device time),
           inference images per second at 256; (e) oracle: a forward of 256
           test images and one QAT step through K1 and through its plain
           version from identical state, bit-identical logits, loss and
           parameters.
9. slots   the slot layout at full width through K1 (``approx``, per-row
           scales, a float32 stripe of MAX_LEN per row), batch 4, prompts
           of 64 tokens, 32 new: (a) ``generate`` through K1 and through
           its plain version (``approx_lowrank``), with the fused and with
           the teacher-forced prefill, 4 layers deep: identical greedy
           tokens in each mode, K1's count (zeroed just before) > 0; (b)
           at 40 layers, ``greedy_generate_legacy`` identical to
           ``generate(prefill_mode="decode")``, and the share of tokens on
           which the two prefills agree, with the first divergence and its
           logit gap; (c) phase
           4's trace through ``ServeSession(cache_layout="slots")``: every
           request's tokens equal those of a paged session attending
           through K2's plain version (the slot layout's own attention
           arithmetic; the tokens that differ from phase 4's K2 session,
           whose online softmax rounds otherwise, are printed), and the
           first two requests equal ``generate`` of each prompt alone; (d) timings:
           ``kernel_bench._decode_bench`` at full width (legacy and
           generate tok/s; its two runs are (b)'s legacy and fused runs),
           the slot session's tok/s and TTFT, and with --profile its
           steady decode tick beside phase 4's.

Activations use per-row scales (``act_per_row``), so a request's tokens do
not depend on which other requests share its batch, and the oracle can
replay a subset of the trace.  The weights are random, from ``--seed``.

Timings are CUDA-event means over repeated launches; a bound is the larger
of the bytes the call must move over 3.35 TB/s and its operations over the
peak rate of their type (int8 1979 TOP/s for the uint8 codes of K1, f32
67 TFLOP/s for K2, which computes in f32 from either pool dtype; K3 moves 2 bytes in and 4 out per element and its
integer logic has no rate in the data sheet), the H100 SXM data-sheet
rates at 700 W.  The line
before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12

ARCH = "granite-3-2b"
NUM_SLOTS = 4
BLOCK_SIZE = 16
BUCKETS = (16, 32, 64, 128)
MAX_NEW = 32
REQUESTS = 8
MAX_LEN = 160                        # largest bucket + MAX_NEW, whole blocks
SLOT_PROMPT = 64                     # phase 9's generate prompts
K2_TOL = 1e-4
K2_POOLS = {"f32": torch.float32, "bf16": torch.bfloat16}
LONG_CONTEXT = 4096                  # granite-3.0-2b's context length
K3_DESIGNS = ("mul8x8_1", "mul8x8_2", "mul8x8_3")
K3_TIMED_N = 1 << 26                 # 64 M elements
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 3
ORACLE_LAYERS = 4
PAPER_BATCH, PAPER_TEST = 64, 256     # Table VIII's training and test batches
RESNET_STEPS = 3


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, min_s: float = 0.2, max_reps: int = 50) -> float:
    """Mean device milliseconds per call: warm up, then CUDA events around
    enough back-to-back calls to fill ``min_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = int(max(1, min(max_reps, min_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_up(dev, seconds: float = 1.0) -> None:
    """Keep the card busy for a moment so the clocks have ramped up before
    the first timed launch."""
    x = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def bound(nbytes: float, ops: float, peak: float):
    """(ms, 'bytes' | 'operations'): the least time for the work."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_step(fn, match="approx_matmul_kernel", key="k1_device_ms"):
    """Device time of one call of ``fn`` under torch.profiler: the ms of the
    kernels whose name holds ``match`` (under ``key``; K1's by default),
    all kernels' ms and the top kernels by device time (empty if the
    profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)
    if not rows:
        return {"note": "the profiler recorded no device time"}
    return {key: sum(us for us, _, k in rows if match in k) / 1e3,
            "device_ms": sum(us for us, _, _ in rows) / 1e3,
            "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                           for us, c, k in rows[:10]]}


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------


def exact_int8_ms(a, b):
    """CUDA-event ms of ``torch._int_mm`` on int8 views of the codes: the
    cost of the exact product alone, a yardstick that nothing in the port
    calls; (None, the reason) where the call refuses the shape."""
    a8, b8 = a.view(torch.int8), b.view(torch.int8)
    try:
        return cuda_ms(lambda: torch._int_mm(a8, b8)), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]


def k1_phase(cfg, params, gen, dev, prefill_rows):
    from repro_torch.core.approx import QWeight
    from repro_torch.core.multipliers import MULTIPLIERS
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    def codes(shape, hi):
        return torch.randint(0, hi + 1, shape, generator=gen, device=dev, dtype=torch.uint8)

    def check(M, K, N, mult, rhs_max, timed=False):
        a, b = codes((M, K), 255), codes((K, N), rhs_max)
        out = approx_matmul(a, b, multiplier=mult, rhs_max=rhs_max)
        ref = approx_matmul_plain(a, b, multiplier=mult, rhs_max=rhs_max)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        if out.dtype != torch.int32 or err != 0:
            bad = (out != ref).sum().item()
            raise AssertionError(f"K1 {mult} M={M} K={K} N={N} rhs_max={rhs_max}: "
                                 f"{bad} of {M * N} outputs differ from the plain version")
        row = {"M": M, "K": K, "N": N, "multiplier": mult, "rhs_max": rhs_max, "max_abs_err": err}
        if timed:
            row["ms"] = cuda_ms(lambda: approx_matmul(a, b, multiplier=mult))
            row["plain_ms"] = cuda_ms(lambda: approx_matmul_plain(a, b, multiplier=mult))
            row["bound_ms"], row["bound_by"] = bound(M * K + K * N + 4 * M * N,
                                                     2.0 * M * N * K, INT8_OPS_PER_S)
            if M > 16:
                row["exact_int8_ms"], why = exact_int8_ms(a, b)
                if why:
                    row["exact_int8_refused"] = why
        log("K1 equal", json.dumps(row))
        return row

    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv, ff, vp = cfg.num_kv_heads * cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    path_kn = sorted({(d, hq), (d, hkv), (hq, d), (d, ff), (ff, d), (d, vp)})
    shapes = [check(M, K, N, "mul8x8_2", 255, timed=True)
              for K, N in path_kn for M in (NUM_SLOTS, prefill_rows)]
    checked = shapes + [check(64, 2048, 2048, mult, rhs_max)
                        for mult in MULTIPLIERS for rhs_max in (255, 31)]
    checked += [check(M, K, N, "mul8x8_3", 255)
                for M, K, N in ((1, 33, 5), (5, 300, 77), (13, 1000, 130), (70, 257, 1000))]
    checked += [check(M, 2048, 512, "mul8x8_2", 255) for M in (16, 32, 63, 64, 65)]

    # one training step's K1 calls at M = batch x seq: each layer's seven
    # projections, again but for w_down in the remat recompute (it stops
    # once the last saved tensor is rebuilt), and the lm_head
    by_kn = {(r["K"], r["N"]): r for r in shapes if r["M"] == prefill_rows}
    layer = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, ff), (d, ff), (ff, d)]
    calls = [kn for _ in range(cfg.num_layers) for kn in layer]
    if cfg.remat:
        calls += [kn for _ in range(cfg.num_layers) for kn in layer[:-1]]
    calls.append((d, vp))
    train_step = {"calls": len(calls), "M": prefill_rows,
                  "bound_ms": sum(by_kn[kn]["bound_ms"] for kn in calls),
                  "events_ms": sum(by_kn[kn]["ms"] for kn in calls),
                  "plain_ms": sum(by_kn[kn]["plain_ms"] for kn in calls)}
    ops_ms = sum(by_kn[kn]["bound_ms"] for kn in calls if by_kn[kn]["bound_by"] == "operations")
    train_step["bound_by"] = "operations" if 2 * ops_ms >= train_step["bound_ms"] else "bytes"
    log("K1 training step (per-call times at M=%d summed)" % prefill_rows, json.dumps(train_step))

    # one decode step's K1 work on the served model's frozen weights
    lay = params["layers"]
    ws = [w.codes[i] for i in range(cfg.num_layers)
          for w in (lay["attn"]["wq"], lay["attn"]["wk"], lay["attn"]["wv"],
                    lay["attn"]["wo"], lay["ffn"]["w_gate"], lay["ffn"]["w_up"],
                    lay["ffn"]["w_down"])]
    ws.append(params["lm_head"].codes)
    assert all(isinstance(w, torch.Tensor) for w in ws) and isinstance(params["lm_head"], QWeight)
    acts = {K: codes((NUM_SLOTS, K), 255) for K in {w.shape[0] for w in ws}}
    mult = cfg.approx.multiplier

    def step(fn):
        return lambda: [fn(acts[w.shape[0]], w, multiplier=mult) for w in ws]

    nbytes = sum(NUM_SLOTS * w.shape[0] + w.numel() + 4 * NUM_SLOTS * w.shape[1] for w in ws)
    ops = sum(2.0 * NUM_SLOTS * w.numel() for w in ws)
    bms, by = bound(nbytes, ops, INT8_OPS_PER_S)
    per_step = {"calls": len(ws), "M": NUM_SLOTS, "ms": cuda_ms(step(approx_matmul)),
                "plain_ms": cuda_ms(step(approx_matmul_plain)), "bound_ms": bms,
                "bound_by": by}
    # "ms" above includes the host's issue rate (281 wrapper calls); the
    # kernels' own device time under the profiler:
    per_step["device_ms"] = profile_step(step(approx_matmul)).get("k1_device_ms")
    log("K1 decode step", json.dumps(per_step))
    return shapes, checked, per_step, train_step


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------


def paged_case(rng, dev, B, W, bs, n_kv, g, hd, *, holes=False, pool_dtype=torch.float32):
    """Random paged decode inputs: each row holds a random number of
    distinct blocks (possibly none: an all-sentinel row) and its cur_len
    lands in its last block (offset 0 included); ``holes`` knocks an
    allocated middle block back to the sentinel.  The pools and the new
    token's K/V are in ``pool_dtype``, q in float32."""
    H = n_kv * g
    nb = B * W + 1
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
    q = f(B, H, hd)
    kn, vn = f(B, n_kv, hd).to(pool_dtype), f(B, n_kv, hd).to(pool_dtype)
    kp, vp = f(nb, bs, n_kv, hd).to(pool_dtype), f(nb, bs, n_kv, hd).to(pool_dtype)
    tbl = np.full((B, W), nb, np.int32)
    cur = np.zeros((B,), np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        n_alloc = int(rng.integers(0, W + 1))
        tbl[b, :n_alloc] = [free.pop() for _ in range(n_alloc)]
        if n_alloc:
            cur[b] = int(rng.integers((n_alloc - 1) * bs, n_alloc * bs))
            if holes and n_alloc > 1:
                tbl[b, int(rng.integers(0, n_alloc - 1))] = nb
        else:
            cur[b] = int(rng.integers(0, W * bs))
    as_i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    return [q, kn, vn, kp, vp, as_i32(tbl), as_i32(cur)]


def k2_valid_positions(tbl, cur, num_blocks, bs):
    """Pool positions the step must read: allocated and < cur_len."""
    n = 0
    for row, c in zip(tbl.tolist(), cur.tolist()):
        n += sum(min(bs, max(0, c - w * bs)) for w, e in enumerate(row) if e < num_blocks)
    return n


def k2_bound(B, H, hkv, hd, W, valid, qsize, esize, calls=1):
    """(ms, by) of ``calls`` K2 calls: q read and out written in q's dtype,
    the new token's K/V, the table and lengths, and the K/V rows of the
    ``valid`` pool positions the rows hold (each read once, in the pool
    dtype); 4 * hd f32 operations per query head and attended position."""
    nbytes = B * (2 * H * hd * qsize + 2 * hkv * hd * esize + 4 * (W + 1)) \
        + 2 * esize * valid * hkv * hd
    ops = 4.0 * H * hd * (valid + B)
    return bound(calls * nbytes, calls * ops, F32_FLOPS_PER_S)


def k2_check(name, args, bs, zero_rows=()):
    """K2 against its plain version on one case, with the query as given
    (if f32) and rounded to bf16 (as served); returns (the worst f32-query
    error, the bf16-query error).  Each f32-query output is within K2_TOL
    of the plain version's.  The bf16-query output is within K2_TOL plus
    bf16's rounding of |ref|, and bit-equal to the output for the same
    query upcast to f32 (exact) rounded to bf16: a kernel that reads a bf16
    q or rounds its output wrongly fails.  All-sentinel rows are exactly 0."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    q, rest = args[0], args[1:]
    q16 = q.to(torch.bfloat16)
    qs = ([q] if q.dtype == torch.float32 else []) + [q16.float()]
    outs = [paged_attention(x, *rest, block_size=bs) for x in qs]
    refs = [paged_attention_plain(x, *rest, block_size=bs) for x in qs]
    out16 = paged_attention(q16, *rest, block_size=bs)
    torch.cuda.synchronize()
    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    if not err <= K2_TOL:
        raise AssertionError(f"K2 {name}: max abs err {err} > {K2_TOL}")
    dev16 = (out16.float() - refs[-1]).abs()
    err16 = dev16.max().item()
    if out16.dtype != torch.bfloat16 or not bool(
            (dev16 <= K2_TOL + refs[-1].abs() * 2.0 ** -8).all()):
        raise AssertionError(f"K2 {name}, bf16 q: {out16.dtype} output, max abs err {err16} "
                             f"beyond {K2_TOL} plus bf16 rounding")
    if not torch.equal(out16, outs[-1].to(torch.bfloat16)):
        raise AssertionError(f"K2 {name}: the bf16-query output is not the f32 result "
                             "rounded to bf16")
    for o in outs + [out16]:
        for b in zero_rows:
            if not torch.equal(o[b], torch.zeros_like(o[b])):
                raise AssertionError(f"K2 {name}: all-sentinel row {b} is not exactly 0")
    return err, err16


def k2_step_inputs(dev, rng, *, calls, B, W, hkv, g, hd, cur, pool_dtype):
    """Operands of ``calls`` K2 calls, each on its own pool (as the layers
    of one decode step are), with a bf16 query as served and rows holding
    the blocks their ``cur`` needs: ([q, kn, vn, kp, vp] stacked by call,
    table and lengths on the card, table and lengths in numpy)."""
    nb, H = B * W, hkv * g
    ops = [torch.randn(calls, B, H, hd, device=dev).to(torch.bfloat16)]
    ops += [torch.randn(calls, *s, device=dev).to(pool_dtype)
            for s in ((B, hkv, hd), (B, hkv, hd), (nb, BLOCK_SIZE, hkv, hd),
                      (nb, BLOCK_SIZE, hkv, hd))]
    cur = np.asarray(cur, np.int32)
    tbl = np.full((B, W), nb, np.int32)
    perm = list(rng.permutation(nb))
    for b in range(B):
        n = min(W, int(cur[b]) // BLOCK_SIZE + 1)
        tbl[b, :n] = [perm.pop() for _ in range(n)]
    return ops, torch.as_tensor(tbl, device=dev), torch.as_tensor(cur, device=dev), tbl, cur


def k2_step_of(fn, ops, tbl_t, cur_t):
    """One step of ``fn`` over every call's operands."""
    return lambda: [fn(*(t[i] for t in ops), tbl_t, cur_t, block_size=BLOCK_SIZE)
                    for i in range(ops[0].shape[0])]


def k2_timed(dev, rng, *, calls, B, W, hkv, g, hd, cur, pool_dtype):
    """Check and time ``calls`` K2 calls (``k2_step_inputs``): every call
    held to its plain version as ``k2_check`` does, then CUDA events around
    back-to-back steps (the wrapper's host time included), the kernel's
    device time under the profiler, the plain version, and SDPA over the
    blocks gathered beforehand (the library yardstick; it never runs in
    the port)."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    ops, tbl_t, cur_t, tbl, cur = k2_step_inputs(dev, rng, calls=calls, B=B, W=W, hkv=hkv, g=g,
                                                 hd=hd, cur=cur, pool_dtype=pool_dtype)
    q, kp, vp = ops[0], ops[3], ops[4]
    pool = str(pool_dtype).replace("torch.", "")
    errs = [k2_check(f"{pool} pool, W={W}, call {i}", [t[i] for t in ops] + [tbl_t, cur_t],
                     BLOCK_SIZE) for i in range(calls)]
    nb, H = B * W, hkv * g
    S = W * BLOCK_SIZE
    idx = tbl_t.clamp(max=nb - 1).long()
    kg = torch.stack([kp[i][idx].reshape(B, S, hkv, hd) for i in range(calls)]).transpose(2, 3)
    vg = torch.stack([vp[i][idx].reshape(B, S, hkv, hd) for i in range(calls)]).transpose(2, 3)
    kg, vg = kg.contiguous(), vg.contiguous()
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= cur_t[:, None].long())[:, None, None, :]
    q4 = q.to(pool_dtype)[:, :, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_step():
        return [sdpa(q4[i], kg[i], vg[i], attn_mask=mask, enable_gqa=True) for i in range(calls)]

    valid = k2_valid_positions(tbl, cur, nb, BLOCK_SIZE)
    esize = pool_dtype.itemsize
    bms, by = k2_bound(B, H, hkv, hd, W, valid, 2, esize, calls)
    step = lambda fn: k2_step_of(fn, ops, tbl_t, cur_t)
    prof = profile_step(step(paged_attention), match="paged_attention_kernel",
                        key="device_ms_k2")
    row = {"calls": calls, "B": B, "W": W, "pool": pool,
           "q": "bfloat16", "cur_len": cur.tolist(), "valid_positions": valid,
           "max_abs_err_f32_q": max(e for e, _ in errs),
           "max_abs_err_bf16_q": max(e for _, e in errs),
           "ms": cuda_ms(step(paged_attention)), "device_ms": prof.get("device_ms_k2"),
           "plain_ms": cuda_ms(step(paged_attention_plain)), "bound_ms": bms, "bound_by": by,
           "library_ms": cuda_ms(library_step)}
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
        if row[k] is not None:
            row[k + "_per_call"] = row[k] / calls
    return row


def k2_phase(cfg, dev, seed):
    rng = np.random.default_rng(seed)
    hkv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    W = MAX_LEN // BLOCK_SIZE
    worst = [0.0, 0.0]

    def check(name, args, bs, zero_rows=()):
        errs = k2_check(name, args, bs, zero_rows)
        worst[:] = [max(a, b) for a, b in zip(worst, errs)]
        log(f"K2 {name}: max abs err {errs[0]:.3g} (f32 q), {errs[1]:.3g} (bf16 q)")

    shapes = [("served", NUM_SLOTS, W, BLOCK_SIZE, hkv, g, hd), ("test", 3, 5, 4, 2, 2, 32),
              ("block1", 2, 6, 1, 2, 3, 16), ("block8", 4, 3, 8, 1, 2, 4)]
    for pool, pool_dtype in K2_POOLS.items():
        for name, B, Wc, bs, n_kv, gg, d in shapes:
            case = lambda **kw: paged_case(rng, dev, B, Wc, bs, n_kv, gg, d,
                                           pool_dtype=pool_dtype, **kw)
            for holes in (False, True):
                check(f"{name} {pool} holes={holes}", case(holes=holes), bs)
            args = case()
            nb = args[3].shape[0]
            args[5][1:] = nb                                      # rows 1.. all sentinel
            check(f"{name} {pool} all-sentinel rows", args, bs, zero_rows=range(1, B))
            args = case()
            args[5] = torch.as_tensor(rng.permutation(nb)[:B * Wc].reshape(B, Wc),
                                      dtype=torch.int32, device=dev)
            args[6] = torch.as_tensor(bs * rng.integers(0, Wc, B), dtype=torch.int32, device=dev)
            check(f"{name} {pool} cur_len on a block boundary", args, bs)
            args[6] = torch.as_tensor(Wc * bs + rng.integers(0, bs + 1, B), dtype=torch.int32,
                                      device=dev)
            check(f"{name} {pool} cur_len past the table", args, bs)

    # one decode step's K2 work (one call per layer on its own pool, rows at
    # served lengths: a quarter to all of the table), and one call at
    # granite-3.0-2b's context length (four pools, so no call finds its
    # blocks in L2), on each pool dtype; every call checked as above
    cur = rng.integers(MAX_LEN // 4, MAX_LEN, NUM_SLOTS)
    step = {pool: k2_timed(dev, rng, calls=cfg.num_layers, B=NUM_SLOTS, W=W, hkv=hkv, g=g,
                           hd=hd, cur=cur, pool_dtype=dt) for pool, dt in K2_POOLS.items()}
    for pool, row in step.items():
        log(f"K2 decode step, {pool} pool", json.dumps(row))
    long = {pool: k2_timed(dev, rng, calls=4, B=NUM_SLOTS, W=LONG_CONTEXT // BLOCK_SIZE,
                           hkv=hkv, g=g, hd=hd, cur=[LONG_CONTEXT - 1] * NUM_SLOTS,
                           pool_dtype=dt) for pool, dt in K2_POOLS.items()}
    for pool, row in long.items():
        log(f"K2 at {LONG_CONTEXT} positions, {pool} pool", json.dumps(row))
    for row in (*step.values(), *long.values()):
        worst = [max(worst[0], row["max_abs_err_f32_q"]), max(worst[1], row["max_abs_err_bf16_q"])]
    return worst, step, long


# ---------------------------------------------------------------------------
# phases 4-5: serve and oracle
# ---------------------------------------------------------------------------


def make_trace(rng, vocab, n):
    """(prompt, max_new, arrival): the first two arrive at tick 0 and are
    admitted as one batch, the rest arrive over the next ticks."""
    return [(rng.integers(0, vocab, int(rng.integers(16, 129))),
             int(rng.integers(16, MAX_NEW + 1)), 0 if i < 2 else 1 + (i - 2) // 2)
            for i in range(n)]


def serve(cfg, params, trace, dev, attn_impl, seed, cache_layout="paged"):
    from repro_torch.serve import ServeSession

    sess = ServeSession(cfg, params, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                        prompt_buckets=BUCKETS, block_size=BLOCK_SIZE, policy="fifo",
                        attn_impl=attn_impl, seed=seed, cache_layout=cache_layout,
                        device=dev)
    for i, (p, n, a) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a, req_id=i)
    t0 = time.perf_counter()
    results = sess.run()
    torch.cuda.synchronize()
    return sess, results, time.perf_counter() - t0


def profile_decode(cfg, params, trace, dev, seed, ticks=6, cache_layout="paged"):
    """Where a decode tick's time goes: host-clock ms per tick without the
    profiler, and the kernels' device ms per tick under torch.profiler
    (first four requests resident, no admission in the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeSession

    sess = ServeSession(cfg, params, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                        prompt_buckets=BUCKETS, block_size=BLOCK_SIZE, policy="fifo",
                        cache_layout=cache_layout, seed=seed, device=dev)
    for i, (p, n, _) in enumerate(trace[:NUM_SLOTS]):
        sess.submit(p, max_new=n, req_id=i)
    for _ in range(3):                      # admission, then two warm decode ticks
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        sess.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            sess.step()
        torch.cuda.synchronize()
    # device-side entries only: a CPU op's own device time repeats its kernels'
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / ticks
    out = {"layout": cache_layout, "ticks": ticks, "n_active": sess.n_active,
           "wall_ms_per_tick": wall_ms,
           "device_ms_per_tick": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
           "top_device": [{"name": k[:80], "ms_per_tick": us / 1e3 / ticks,
                           "calls_per_tick": c / ticks} for us, c, k in rows[:12]]}
    if not device_ms:
        out["note"] = "the profiler recorded no device time"
    return out


def decode_step_diff(cfg, params, trace, toks, dev, cache_dtype=torch.float32):
    """Prefill the first two prompts into a fresh pool of ``cache_dtype``,
    then run one decode step on copies of it through K2 and through its
    plain version (K1 in both): the logits' largest difference and whether
    the argmax agrees."""
    from repro_torch.models.transformer import forward, init_paged_cache, paged_decode_step
    from repro_torch.serve.cache import scatter_prompt_blocks

    W, nbk = MAX_LEN // BLOCK_SIZE, BUCKETS[-1] // BLOCK_SIZE
    with torch.no_grad():
        cache = init_paged_cache(cfg, 2 * W, BLOCK_SIZE, cache_dtype, device=dev)
        logits, kvs = forward(cfg, params, toks, return_kv=True)
        ids = torch.arange(2 * (nbk + 1), dtype=torch.int32, device=dev).reshape(2, nbk + 1)
        scatter_prompt_blocks(cache, kvs, ids[:, :nbk], BLOCK_SIZE)
        tables = torch.full((2, W), 2 * W, dtype=torch.int32, device=dev)
        tables[:, :nbk + 1] = ids
        lens = torch.as_tensor([trace[0][0].size, trace[1][0].size], device=dev)
        nxt = logits[torch.arange(2, device=dev), lens - 1].argmax(-1)[:, None]
        out = {impl: paged_decode_step(cfg, params, {k: v.clone() for k, v in cache.items()},
                                       nxt, lens, tables, block_size=BLOCK_SIZE,
                                       attn_impl=impl)[:, 0, :cfg.vocab_size]
               for impl in ("kernel", "gather")}
    res = {"pool": str(cache_dtype).replace("torch.", ""),
           "max_abs_diff": (out["kernel"] - out["gather"]).abs().max().item(),
           "max_abs_logit": out["gather"].abs().max().item(),
           "argmax_equal": bool(torch.equal(out["kernel"].argmax(-1), out["gather"].argmax(-1)))}
    if not res["argmax_equal"]:
        raise AssertionError(f"decode step through K2 picks other tokens than the plain one: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 6: K3
# ---------------------------------------------------------------------------


def k3_phase(dev, gen):
    from repro_torch.core.multipliers import mul8x8_table
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.approx_mul_eltwise import (approx_mul_eltwise,
                                                        approx_mul_eltwise_plain,
                                                        lut_mismatches)

    # the path: K1's all-pairs table checked against the bit logic, one
    # launch per design
    approx_mul_eltwise.launches = 0
    mismatches = {m: lut_mismatches(m, device=dev) for m in K3_DESIGNS}
    torch.cuda.synchronize()
    launches = approx_mul_eltwise.launches
    if any(mismatches.values()) or launches != len(K3_DESIGNS):
        raise AssertionError(f"K3: K1's table differs from the bit logic {mismatches} "
                             f"({launches} launches)")

    codes = torch.arange(256, device=dev, dtype=torch.uint8)
    a, b = codes.repeat_interleave(256), codes.repeat(256)
    checked = 0

    def check(name, x, y, mult, *others):
        nonlocal checked
        out = approx_mul_eltwise(x, y, multiplier=mult)
        want = [approx_mul_eltwise_plain(x, y, mult), *others]
        torch.cuda.synchronize()
        for w in want:
            if out.dtype != torch.int32 or out.shape != x.shape or not torch.equal(out, w):
                bad = (out != w).sum().item() if out.shape == w.shape else "all"
                raise AssertionError(f"K3 {mult} {name}: {bad} of {x.numel()} outputs differ")
        checked += 1
        log(f"K3 equal: {mult} {name} {tuple(x.shape)} {x.dtype}")

    for m in K3_DESIGNS:
        table = torch.from_numpy(mul8x8_table(m).reshape(-1).copy()).to(dev)
        k1_table = approx_matmul(codes[:, None], codes[None, :], multiplier=m).reshape(-1)
        check("all pairs vs plain, table and K1's table", a, b, m, table, k1_table)
        for dtype in (torch.uint8, torch.int32):
            n = 10**6 + 3
            x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=dtype)
            y = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=dtype)
            check("ragged 1-D", x, y, m)
            shape = (3, 17, 65, 129)
            x = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
            y = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
            check("4-D", x, y, m)
        check("unaligned views", a[1:-3], b[3:-1], m)

    n = K3_TIMED_N
    x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
    y = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
    check("timed shape", x, y, "mul8x8_2")
    bms, by = bound(6.0 * n, 0.0, INT8_OPS_PER_S)
    timed = {"n": n, "multiplier": "mul8x8_2",
             "ms": cuda_ms(lambda: approx_mul_eltwise(x, y, multiplier="mul8x8_2")),
             "plain_ms": cuda_ms(lambda: approx_mul_eltwise_plain(x, y, "mul8x8_2")),
             "bound_ms": bms, "bound_by": by}
    timed["gb_per_s"] = 6.0 * n / (timed["ms"] * 1e-3) / 1e9
    log(f"K3 timed {json.dumps(timed)}")
    return {"launches": launches, "lut_mismatches": mismatches, "checked": checked,
            "max_abs_err": 0, "timed": timed}


# ---------------------------------------------------------------------------
# phase 7: train
# ---------------------------------------------------------------------------


def train_phase(dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim as O
    from repro_torch.train.loop import as_batch, init_state, make_train_step, train_loop
    from repro_torch.train.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(ARCH), approx=ApproxConfig(
        multiplier="mul8x8_2", mode="kernel", band_reg=1e-4))
    opt = O.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS)          # as launch/train.py
    out = {"layers": cfg.num_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "k1_M": TRAIN_BATCH * TRAIN_SEQ, "remat": cfg.remat}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in leaves(state["params"]))
    batches = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)

    approx_matmul.launches = 0
    state, hist = train_loop(cfg, opt, batches, steps=TRAIN_STEPS, state=state)
    torch.cuda.synchronize()
    out["launches"] = approx_matmul.launches
    out["losses"], out["step_s"] = hist["loss"], hist["step_time"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {json.dumps(out)}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"training losses not finite: {hist['loss']}")
    if out["launches"] <= 0:
        raise AssertionError("approx_matmul was never launched on the training path")

    # where a step's time goes: one more step, profiled
    step = make_train_step(cfg, opt)
    batch = as_batch(next(batches), dev)
    holder = {}

    def one():
        holder["state"], holder["m"] = step(state, batch)
    out["profiled_step"] = {**profile_step(one),
                            "k1_launches_per_step": out["launches"] // TRAIN_STEPS}
    state = holder.pop("state")
    log(f"[train] profiled step: {json.dumps(out['profiled_step'])}")
    if not out["profiled_step"].get("k1_device_ms", 0) > 0:
        raise AssertionError("the profiled step shows no device time for approx_matmul_kernel "
                             f"though K1 launched {out['launches']} times")

    # remat off: the same step keeps each layer's activations (about 76 GB
    # at the peak: return the allocator's cached blocks first)
    gc.collect()
    torch.cuda.empty_cache()
    cfg_nr = dataclasses.replace(cfg, remat=False)
    step_nr = make_train_step(cfg_nr, opt)
    times = []
    torch.cuda.reset_peak_memory_stats()
    n0 = approx_matmul.launches
    for _ in range(2):
        batch = as_batch(next(batches), dev)
        t0 = time.perf_counter()
        state, m = step_nr(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    out["remat_off"] = {"step_s": times, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "k1_launches_per_step": (approx_matmul.launches - n0) // 2}
    log(f"[train] remat off: {json.dumps(out['remat_off'])}")
    del state, holder, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # oracle: one 4-layer step through K1 and through its plain version
    cfg4 = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS)
    s_k = init_state(cfg4, opt, seed + 1, device=dev)
    s_l = tree_map(lambda t: t.detach().clone(), s_k)
    batch = as_batch(next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                        seed=seed + 1)), dev)
    n0 = approx_matmul.launches
    s_k, m_k = make_train_step(cfg4, opt)(s_k, batch)
    torch.cuda.synchronize()
    n_k = approx_matmul.launches - n0
    cfg4l = dataclasses.replace(cfg4, approx=dataclasses.replace(cfg4.approx, mode="lowrank"))
    s_l, m_l = make_train_step(cfg4l, opt)(s_l, batch)
    torch.cuda.synchronize()
    if approx_matmul.launches != n0 + n_k or n_k <= 0:
        raise AssertionError(f"oracle launches: kernel step {n_k}, plain step "
                             f"{approx_matmul.launches - n0 - n_k}")
    la, lb = leaves(s_k), leaves(s_l)
    diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(la, lb))
    same = all(torch.equal(x, y) for x, y in zip(la, lb))
    out["oracle"] = {"layers": ORACLE_LAYERS, "loss_kernel": m_k["loss"].item(),
                     "loss_plain": m_l["loss"].item(), "state_identical": same,
                     "max_abs_state_diff": diff, "k1_launches": n_k}
    log(f"[train] oracle: {json.dumps(out['oracle'])}")
    if m_k["loss"].item() != m_l["loss"].item() or not same:
        raise AssertionError("a training step through K1 differs from one through its "
                             f"plain version: {out['oracle']}")
    del s_k, s_l, la, lb
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher at reduced size, then resumed from its checkpoint
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        common = ["--reduced", "--ckpt", tmp, "--ckpt-every", "2", "--seed", str(seed)]
        first = launch_train.main(common + ["--steps", "2"])
        second = launch_train.main(common + ["--steps", "4"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launcher"] = {"first_losses": first["losses"], "resumed_at": second["start"],
                       "second_losses": second["losses"]}
    log(f"[train] launcher: {json.dumps(out['launcher'])}")
    if first["start"] != 0 or second["start"] != 2 or len(second["losses"]) != 2 or not all(
            math.isfinite(x) for x in first["losses"] + second["losses"]):
        raise AssertionError(f"the launcher did not resume from its checkpoint: "
                             f"{out['launcher']}")
    return out


# ---------------------------------------------------------------------------
# phase 8: paper
# ---------------------------------------------------------------------------


def cnn_dense_shapes(model, in_shape, batch, dev):
    """(M, K, N) of each dense call of one forward of ``model`` at ``batch``,
    in call order: a float forward with the CNN module's ``dense`` wrapped."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.models import cnn

    shapes, real = [], cnn.dense

    def record(x, w, cfg):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1], w.shape[-1]))
        return real(x, w, cfg)

    cnn.dense = record
    try:
        with torch.no_grad():
            cnn.cnn_forward(model, torch.zeros(batch, *in_shape, device=dev),
                            ApproxConfig(mode="float"))
    finally:
        cnn.dense = real
    return shapes


def k1_cnn_shapes(dev, gen, seed):
    """K1 bit-equal to its plain version at every im2col and FC shape of the
    seven Table VIII nets, at the training batch and the test batch
    (mul8x8_2; ResNet-19's shapes at the training batch also for the other
    Table VIII multipliers), and each ResNet-19 shape at the training batch
    timed beside its bound and the plain version."""
    from repro_torch.configs.paper_cnns import CNN_SPECS
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
    from repro_torch.models.cnn import init_cnn
    from repro_torch.paper.table_viii import MULTIPLIERS

    def codes(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    per_net, todo = {}, {}
    for key, spec in CNN_SPECS.items():
        model = init_cnn(spec.name, seed, in_shape=spec.in_shape, device=dev)
        per_net[key] = {b: cnn_dense_shapes(model, spec.in_shape, b, dev)
                        for b in (PAPER_BATCH, PAPER_TEST)}
        for b, shapes in per_net[key].items():
            for mkn in shapes:
                mults = MULTIPLIERS if (spec.name == "resnet19" and b == PAPER_BATCH) \
                    else ("mul8x8_2",)
                todo.setdefault(mkn, set()).update(mults)
    checked, timed = 0, {}
    resnet = set(per_net["resnet19-cifar10"][PAPER_BATCH])
    for (M, K, N), mults in sorted(todo.items()):
        a, b = codes((M, K)), codes((K, N))
        for mult in sorted(mults):
            out = approx_matmul(a, b, multiplier=mult)
            ref = approx_matmul_plain(a, b, multiplier=mult)
            torch.cuda.synchronize()
            if out.dtype != torch.int32 or not torch.equal(out, ref):
                bad = (out != ref).sum().item()
                raise AssertionError(f"K1 {mult} M={M} K={K} N={N}: {bad} of {M * N} "
                                     "outputs differ from the plain version")
            checked += 1
        del out, ref
        if (M, K, N) in resnet:
            row = {"M": M, "K": K, "N": N,
                   "ms": cuda_ms(lambda: approx_matmul(a, b, multiplier="mul8x8_2")),
                   "plain_ms": cuda_ms(lambda: approx_matmul_plain(a, b, multiplier="mul8x8_2"),
                                       max_reps=5)}
            row["bound_ms"], row["bound_by"] = bound(M * K + K * N + 4 * M * N,
                                                     2.0 * M * N * K, INT8_OPS_PER_S)
            timed[(M, K, N)] = row
            log("K1 ResNet-19 shape", json.dumps(row))
    calls = per_net["resnet19-cifar10"][PAPER_BATCH]
    forward = {"calls": len(calls), "batch": PAPER_BATCH,
               **{k: sum(timed[c][k] for c in calls) for k in ("ms", "plain_ms", "bound_ms")}}
    ops_ms = sum(timed[c]["bound_ms"] for c in calls if timed[c]["bound_by"] == "operations")
    forward["bound_by"] = "operations" if 2 * ops_ms >= forward["bound_ms"] else "bytes"
    log(f"K1 at the CNN shapes: {len(todo)} shapes, {checked} checks bit-equal; ResNet-19 "
        f"forward at batch {PAPER_BATCH} (per-shape times summed): {json.dumps(forward)}")
    return {"shapes": len(todo), "checked": checked, "max_abs_err": 0,
            "resnet19_shapes": list(timed.values()), "resnet19_forward": forward}


def paper_phase(dev, gen, seed):
    """Phase 8: the paper's experiment through K1 (see the module text)."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.core.metrics import dal
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.cnn import cnn_forward, init_cnn
    from repro_torch.paper import table_viii
    from repro_torch.train.tree import leaves, tree_map

    t_phase = time.perf_counter()
    out = {"k1": k1_cnn_shapes(dev, gen, seed)}

    # (b) Table VIII, every multiplier through K1; the count zeroed per net
    rows = []
    for net, ds in table_viii.nets(full=True):
        approx_matmul.launches = 0
        row = table_viii.run_net(net, ds, steps=table_viii.FULL_STEPS, device=dev, seed=seed)
        row["k1_launches"] = approx_matmul.launches
        rows.append(row)
        log(f"[paper] table_viii/{net}-{ds} {row['seconds']:.1f}s float {row['float_acc']:.4f}; "
            + "; ".join(f"{m} {r['acc']:.4f} (DAL {r['dal']:+.4f}) -> retrained "
                        f"{r['retrained_acc']:.4f} (DAL {r['retrained_dal']:+.4f})"
                        for m, r in row["multipliers"].items())
            + f"; K1 launches {row['k1_launches']}")
        if row["k1_launches"] <= 0:
            raise AssertionError(f"table_viii/{net}-{ds}: approx_matmul was never launched")
    out["table_viii"] = rows

    # (c) the JAX system test's assertions at LeNet-MNIST, held on Table
    # VIII's LeNet-MNIST model; the test's own 80-step protocol run beside
    # it and printed (at 80 steps LeNet is mid-way through learning the
    # task and the claim depends on the init: scripts/lenet_claim_seeds.py)
    lenet_row = next(r for r in rows if (r["net"], r["dataset"]) == ("lenet", "mnist"))
    acc = {"float": lenet_row["float_acc"],
           **{m: lenet_row["multipliers"][m]["acc"] for m in ("mul8x8_2", "pkm")}}
    data = table_viii.on_device(image_dataset("mnist", n_train=1024, n_test=256, seed=0), dev)
    approx_matmul.launches = 0
    fl = ApproxConfig(mode="float")
    lenet = table_viii.train(init_cnn("lenet", seed, in_shape=(28, 28, 1), device=dev),
                             data, fl, steps=80)
    mirror = {"float": table_viii.accuracy(lenet, data, fl)}
    for m in ("mul8x8_2", "pkm"):
        mirror[m] = table_viii.accuracy(lenet, data, ApproxConfig(multiplier=m, mode="kernel"))
    holds = lambda a: {"float_above_0.8": a["float"] > 0.8,
                       "mul8x8_2_dal_below_0.08": dal(a["float"], a["mul8x8_2"]) < 0.08,
                       "mul8x8_2_within_0.02_of_pkm": a["mul8x8_2"] >= a["pkm"] - 0.02}
    out["lenet_assertions"] = {"table_viii_model": {"steps": table_viii.FULL_STEPS, "acc": acc,
                                                    "holds": holds(acc)},
                               "mirror_80_steps": {"acc": mirror, "holds": holds(mirror),
                                                   "k1_launches": approx_matmul.launches}}
    log(f"[paper] LeNet-MNIST system-test assertions: {json.dumps(out['lenet_assertions'])}")
    if not all(holds(acc).values()) or approx_matmul.launches <= 0:
        raise AssertionError(f"LeNet-MNIST: {out['lenet_assertions']}")

    # (d) ResNet-19 at full width: a QAT step, its K1 share, inference
    cifar = table_viii.on_device(image_dataset("cifar10", n_train=1024, n_test=PAPER_TEST,
                                               seed=0), dev)
    model = init_cnn("resnet19", seed, device=dev)
    for p in leaves(model["layers"]):
        p.requires_grad_(True)
    qat = ApproxConfig(multiplier="mul8x8_2", mode="kernel")
    xb, yb = cifar["x_train"][:PAPER_BATCH], cifar["y_train"][:PAPER_BATCH]
    xt = cifar["x_test"][:PAPER_TEST]
    res = {"batch": PAPER_BATCH, "params": sum(p.numel() for p in leaves(model["layers"]))}
    approx_matmul.launches = 0
    with torch.no_grad():
        logits = cnn_forward(model, xb, qat)
    torch.cuda.synchronize()
    res["k1_launches_per_forward"] = approx_matmul.launches
    if res["k1_launches_per_forward"] != 21 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"ResNet-19 forward: {approx_matmul.launches} K1 launches "
                             "(21 expected) or non-finite logits")
    table_viii.sgd_step(model, xb, yb, qat, table_viii.RETRAIN_LR)        # warm
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    steps, losses = [], []
    n0 = approx_matmul.launches
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(table_viii.sgd_step(model, xb, yb, qat, table_viii.RETRAIN_LR).item())
        steps.append(time.perf_counter() - t0)
    res.update(qat_step_s=steps, losses=losses,
               k1_launches_per_step=(approx_matmul.launches - n0) // RESNET_STEPS,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    res["profiled_step"] = profile_step(lambda: table_viii.sgd_step(model, xb, yb, qat,
                                                                    table_viii.RETRAIN_LR))
    k1_ms = res["profiled_step"].get("k1_device_ms", 0)
    if k1_ms:
        res["k1_device_share"] = k1_ms / res["profiled_step"]["device_ms"]
    with torch.no_grad():
        infer = lambda: cnn_forward(model, xt, qat)
        res["inference_ms"] = cuda_ms(infer)
    res["images_per_s"] = PAPER_TEST / (res["inference_ms"] / 1e3)
    log(f"[paper] ResNet-19 at batch {PAPER_BATCH}: {json.dumps(res)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ResNet-19 QAT losses not finite: {losses}")
    if not k1_ms > 0:
        raise AssertionError("the profiled ResNet-19 step shows no device time for "
                             "approx_matmul_kernel")
    out["resnet19"] = res

    # (e) oracle: K1 against its plain version from identical state and batch
    plain = ApproxConfig(multiplier="mul8x8_2", mode="lowrank")
    n0 = approx_matmul.launches
    with torch.no_grad():
        lk, lp = cnn_forward(model, xt, qat), cnn_forward(model, xt, plain)
    n_fwd = approx_matmul.launches - n0
    copy = lambda: dict(model, layers=tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                               model["layers"]))
    mk, mp = copy(), copy()
    loss_k = table_viii.sgd_step(mk, xb, yb, qat, table_viii.RETRAIN_LR).item()
    loss_p = table_viii.sgd_step(mp, xb, yb, plain, table_viii.RETRAIN_LR).item()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(leaves(mk["layers"]), leaves(mp["layers"])))
    out["oracle"] = {"images": PAPER_TEST, "logits_identical": bool(torch.equal(lk, lp)),
                     "max_abs_logit_diff": (lk - lp).abs().max().item(),
                     "loss_kernel": loss_k, "loss_plain": loss_p, "params_identical": same,
                     "k1_launches": approx_matmul.launches - n0, "k1_launches_forward": n_fwd}
    log(f"[paper] oracle: {json.dumps(out['oracle'])}")
    if not (out["oracle"]["logits_identical"] and loss_k == loss_p and same
            and n_fwd == 21 and approx_matmul.launches - n0 == 42):
        raise AssertionError("ResNet-19 through K1 differs from its plain version: "
                             f"{out['oracle']}")
    del model, mk, mp, lk, lp, logits
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["k1_launches_table_viii"] = sum(r["k1_launches"] for r in rows)
    return out


# ---------------------------------------------------------------------------
# phase 9: slots
# ---------------------------------------------------------------------------


def first_divergence(cfg, params, a, b, S0):
    """Where two (B, S0 + n) token runs first part (earliest new position,
    lowest row): the position, both tokens, and the logit gap there in a
    full-sequence forward over ``a``'s prefix (``a``'s token minus ``b``'s)."""
    from repro_torch.models.transformer import forward

    diff = (a[:, S0:] != b[:, S0:]).cpu()
    if not diff.any():
        return None
    pos = int(diff.any(0).nonzero()[0])
    row = int(diff[:, pos].nonzero()[0])
    with torch.no_grad():
        logits = forward(cfg, params, a[row:row + 1, :S0 + pos])[0, -1]
    ta, tb = int(a[row, S0 + pos]), int(b[row, S0 + pos])
    return {"row": row, "new_token_index": pos, "tokens": [ta, tb],
            "logit_gap": (logits[ta] - logits[tb]).item()}


def slots_phase(cfg, ocfg, dev, seed, trace, paged_tokens, smi, profile_paged=None,
                profile=False):
    """Phase 9: the slot layout at full width through K1 (see the module
    text).  ``paged_tokens`` are phase 4's results, by request id."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.transformer import init_params
    from repro_torch.paper.kernel_bench import _decode_bench
    from repro_torch.serve import freeze_params, generate

    t_phase = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    run = dict(max_new=MAX_NEW, max_len=MAX_LEN, device=dev)
    out = {"batch": NUM_SLOTS, "prompt_len": SLOT_PROMPT, "max_new": MAX_NEW,
           "max_len": MAX_LEN}

    # (d) the decode engines at full width, which are also (b)'s legacy run
    # and generate's fused run; every kernel and table is warm by now
    approx_matmul.launches = 0
    engines = {}
    rows = _decode_bench(dev, cfg=cfg, params=params, batch=NUM_SLOTS,
                         prompt_len=SLOT_PROMPT, max_len=MAX_LEN, max_new=MAX_NEW,
                         iters=1, warm=False, outputs=engines)
    launches = n = approx_matmul.launches
    out["decode_bench"] = [{"name": name, "s": us / 1e6, "text": text} for name, us, text in rows]
    for name, us, text in rows:
        log(f"[slots] {name}: {us / 1e6:.3f}s, {text} ({smi})")
    prompts = engines["scan_engine"][:, :SLOT_PROMPT]
    approx_matmul.launches = 0
    toks = {"fused": engines["scan_engine"],
            "decode": generate(cfg, params, prompts, prefill_mode="decode", **run)}
    n_decode = approx_matmul.launches
    launches += n_decode
    out["k1_launches_full_depth"] = {"legacy_and_fused": n, "decode": n_decode}
    if n <= 0 or n_decode <= 0:
        raise AssertionError(f"approx_matmul was never launched by the engines: {n}, {n_decode}")

    # (b) legacy against generate's teacher-forced prefill; fused vs decode
    agree = (toks["fused"] == toks["decode"])[:, SLOT_PROMPT:]
    out["legacy_identical_to_decode"] = torch.equal(engines["legacy_loop"], toks["decode"])
    out["fused_vs_decode"] = {"share_equal": agree.float().mean().item(),
                              "first_divergence": first_divergence(
                                  cfg, params, toks["fused"], toks["decode"], SLOT_PROMPT)}
    log(f"[slots] legacy identical to generate(prefill_mode='decode'): "
        f"{out['legacy_identical_to_decode']}; fused vs decode prefill: "
        f"{json.dumps(out['fused_vs_decode'])}")
    if not out["legacy_identical_to_decode"]:
        raise AssertionError("greedy_generate_legacy differs from generate(prefill_mode='decode')")

    # (a) generate through K1 and through its plain version, both prefills,
    # at full width and ORACLE_LAYERS deep (the plain version's float64
    # products make a 40-layer teacher-forced run cost minutes)
    cfg4 = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS)
    ocfg4 = dataclasses.replace(ocfg, num_layers=ORACLE_LAYERS)
    params4 = freeze_params(cfg4, init_params(cfg4, seed=seed + 1, device=dev))
    for mode in ("fused", "decode"):
        approx_matmul.launches = 0
        got = generate(cfg4, params4, prompts, prefill_mode=mode, **run)
        n = approx_matmul.launches
        launches += n
        plain = generate(ocfg4, params4, prompts, prefill_mode=mode, **run)
        same = torch.equal(got, plain)
        out[f"oracle_{mode}"] = {"layers": ORACLE_LAYERS, "k1_launches": n,
                                 "identical_to_plain": same}
        log(f"[slots] generate prefill={mode}, {ORACLE_LAYERS} layers: K1 launches {n}, "
            f"tokens identical to the plain version's: {same}")
        if not same or n <= 0:
            raise AssertionError(f"generate prefill={mode}: K1 {got[:, SLOT_PROMPT:]} vs "
                                 f"plain {plain[:, SLOT_PROMPT:]}; K1 launches {n}")
    del params4

    # (c) phase 4's trace on the slot layout; the first two requests alone
    approx_matmul.launches = 0
    sess, results, wall = serve(cfg, params, trace, dev, None, seed, cache_layout="slots")
    n = approx_matmul.launches
    launches += n
    st = sess.stats
    generated = sum(len(r.tokens) for r in results.values())
    out["session"] = {"requests": len(results), "generated_tokens": generated, "wall_s": wall,
                      "tok_per_s": generated / wall, "ttft_p50_s": st.ttft_s_p50,
                      "ttft_p50_ticks": st.ttft_p50, "ticks": st.ticks, "k1_launches": n,
                      "attn_impl": st.attn_impl}
    log(f"[slots] session on the slot layout ({smi}): {json.dumps(out['session'])}")
    if n <= 0:
        raise AssertionError("approx_matmul was never launched by the slot session")
    # the layouts held against each other with one attention arithmetic:
    # the slot layout attends with the plain attention_core, so the paged
    # session attends through K2's plain version here.  Against phase 4
    # (K2), whose f32 online softmax sums in another order, a token may
    # flip where two logits tie to a bf16 step; those are reported, and
    # phase 5 holds K2 against its plain version
    _, gathered, _ = serve(cfg, params, trace, dev, "gather", seed)
    for rid, r in gathered.items():
        got, want = results[rid].tokens.tolist(), r.tokens.tolist()
        if got != want:
            raise AssertionError(f"request {rid}: slots {got} vs paged (plain attention) {want}")
    vs_k2 = {rid: [i for i, (a, b) in enumerate(zip(results[rid].tokens.tolist(), want))
                   if a != b] for rid, want in paged_tokens.items()}
    out["session"]["differ_from_phase4_k2"] = {rid: ix for rid, ix in vs_k2.items() if ix}
    log(f"[slots] identical to the paged session through K2's plain version (all "
        f"{len(gathered)} requests); new-token indices that differ from phase 4's K2 "
        f"session: {json.dumps(out['session']['differ_from_phase4_k2'])}")
    for rid in (0, 1):
        p, m, _ = trace[rid]
        alone = generate(cfg, params, p[None, :].astype(np.int32), max_new=m, max_len=MAX_LEN,
                         device=dev)[0, p.size:].tolist()
        log(f"[slots] request {rid}: session {results[rid].tokens.tolist()}")
        log(f"[slots] request {rid}: alone   {alone}")
        if alone != results[rid].tokens.tolist():
            raise AssertionError(f"request {rid}: the slot session differs from generate alone")
    out["session"]["identical_to_paged_plain"] = True
    out["session"]["first_two_equal_generate_alone"] = True

    if profile:
        prof = profile_decode(cfg, params, trace, dev, seed, cache_layout="slots")
        out["profile"] = prof
        log(f"[slots] steady decode tick ({smi}): slots {prof['wall_ms_per_tick']:.2f} host ms, "
            f"idle {prof['device_idle_share']}; paged (phase 4) "
            f"{profile_paged['wall_ms_per_tick']:.2f} host ms, idle "
            f"{profile_paged['device_idle_share']}")
    del params, sess
    gc.collect()
    torch.cuda.empty_cache()
    out["k1_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the full report here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady decode ticks (see profile_decode)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve import freeze_params, resolve_execution_mode

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32/f64
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build_s = build_all()
    report["build_s"] = {"per_source": build_s, "total": time.perf_counter() - t0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    log(f"[build] {json.dumps(report['build_s'])}")
    log(smi)

    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, approx=resolve_execution_mode("approx", act_per_row=True))
    t0 = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=args.seed, device=dev))
    torch.cuda.synchronize()
    log(f"[setup] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} -> {cfg.padded_vocab}; init + freeze "
        f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    warm_up(dev)

    # -- 2. K1 ---------------------------------------------------------------
    k1_shapes, k1_checked, k1_step, k1_train = k1_phase(cfg, params, gen, dev,
                                                        NUM_SLOTS * BUCKETS[-1])
    k1_err = max(r["max_abs_err"] for r in k1_checked)
    report["k1"] = {"shapes": k1_shapes, "checked": len(k1_checked), "max_abs_err": k1_err,
                    "decode_step": k1_step, "train_step": k1_train}

    # -- 3. K2 ---------------------------------------------------------------
    (k2_err, k2_err16), k2_steps, k2_long = k2_phase(cfg, dev, args.seed)
    k2_step = k2_steps["f32"]
    report["k2"] = {"max_abs_err": k2_err, "max_abs_err_bf16_q": k2_err16,
                    "decode_step": k2_steps, "long_context": k2_long}

    # -- 4. serve ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    trace = make_trace(rng, cfg.vocab_size, REQUESTS)
    serve(cfg, params, trace[:1], dev, "kernel", args.seed)   # warm-up
    approx_matmul.launches = paged_attention.launches = 0
    sess, results, wall = serve(cfg, params, trace, dev, "kernel", args.seed)
    launches = {"approx_matmul": approx_matmul.launches,
                "paged_attention": paged_attention.launches}
    st = sess.stats
    generated = sum(len(r.tokens) for r in results.values())
    served = {"requests": len(results), "generated_tokens": generated, "wall_s": wall,
              "tok_per_s": generated / wall, "ttft_p50_s": st.ttft_s_p50,
              "ttft_p50_ticks": st.ttft_p50, "ticks": st.ticks,
              "peak_blocks_in_use": st.peak_blocks_in_use, "num_blocks": sess.num_blocks,
              "prefills": {str(k): v for k, v in st.prefills.items()},
              "admit_calls": st.admit_calls, "launches": launches,
              "launches_per_request": {k: v / len(results) for k, v in launches.items()}}
    report["serve"] = served
    log(f"[serve] {json.dumps(served)}")
    if len(results) != len(trace):
        raise AssertionError(f"served {len(results)} of {len(trace)} requests")
    for rid, r in results.items():
        if r.tokens.shape != (trace[rid][1],) or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: bad tokens {r.tokens.tolist()}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the served path")

    # -- 5. oracle -----------------------------------------------------------
    ocfg = dataclasses.replace(cfg, approx=resolve_execution_mode("approx_lowrank",
                                                                  act_per_row=True))
    _, oracle, owall = serve(ocfg, params, trace[:2], dev, "gather", args.seed)
    if (approx_matmul.launches, paged_attention.launches) != tuple(launches.values()):
        raise AssertionError("the oracle session launched a kernel")
    for rid in (0, 1):
        got, want = results[rid].tokens.tolist(), oracle[rid].tokens.tolist()
        log(f"[oracle] request {rid}: kernels {got}")
        log(f"[oracle] request {rid}: plain   {want}")
        if got != want:
            raise AssertionError(f"request {rid}: greedy tokens differ from the plain oracle")
    # K1 is exact, so a prefill (K1 only; no decode attention) through the
    # kernel and through the plain versions gives bit-identical logits
    with torch.no_grad():
        prompts = np.zeros((2, BUCKETS[-1]), np.int32)
        for i in (0, 1):
            prompts[i, :trace[i][0].size] = trace[i][0]
        toks = torch.as_tensor(prompts, device=dev)
        same_prefill = torch.equal(forward(cfg, params, toks), forward(ocfg, params, toks))
    if not same_prefill:
        raise AssertionError("prefill logits through K1 differ from the plain version's")
    decode_diff = [decode_step_diff(cfg, params, trace, toks, dev, dt) for dt in K2_POOLS.values()]
    for d in decode_diff:
        log(f"[oracle] one decode step, K2 vs its plain version: {json.dumps(d)}")
    distinct = len({t for r in results.values() for t in r.tokens.tolist()})
    log(f"[oracle] prefill logits bit-identical; {distinct} distinct tokens served")
    report["oracle"] = {"requests": 2, "identical": True, "prefill_logits_identical": True,
                        "decode_step": decode_diff, "distinct_served_tokens": distinct,
                        "wall_s": owall}
    if args.profile:
        report["profile"] = profile_decode(cfg, params, trace, dev, args.seed)
        log(f"[profile] {json.dumps(report['profile'])}")

    paged_tokens = {rid: r.tokens.tolist() for rid, r in results.items()}

    # -- 6. K3 ---------------------------------------------------------------
    report["k3"] = k3_phase(dev, gen)

    # -- 7. train ------------------------------------------------------------
    # free the serving weights, sessions and pools first: full-width f32
    # params, grads and Adam moments take about 42 GB of the card's 80
    del params, sess, results, oracle, toks
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = train_phase(dev, args.seed)
    train = report["train"]

    # -- 8. paper ------------------------------------------------------------
    report["paper"] = paper_phase(dev, gen, args.seed)
    paper = report["paper"]
    log(f"[paper] phase 8 took {paper['seconds']:.1f}s")

    # -- 9. slots ------------------------------------------------------------
    report["slots"] = slots_phase(cfg, ocfg, dev, args.seed, trace, paged_tokens, smi,
                                  report.get("profile"), args.profile)
    slots = report["slots"]
    log(f"[slots] phase 9 took {slots['seconds']:.1f}s")

    k3 = report["k3"]
    kernels = [
        {"name": "approx_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
         "replaces": "src/repro/kernels/approx_matmul/kernel.py:85",
         "launches": launches["approx_matmul"] + train["launches"]
         + paper["k1_launches_table_viii"] + slots["k1_launches"],
         "launches_by_path": {"serve": launches["approx_matmul"], "train": train["launches"],
                              "table_viii": paper["k1_launches_table_viii"],
                              "slots": slots["k1_launches"],
                              "table_viii_by_net": {f"{r['net']}-{r['dataset']}": r["k1_launches"]
                                                    for r in paper["table_viii"]}},
         "max_abs_err": max(k1_err, paper["k1"]["max_abs_err"]),
         "ms": k1_step["ms"], "plain_ms": k1_step["plain_ms"],
         "bound_ms": k1_step["bound_ms"], "bound_by": k1_step["bound_by"],
         "library_ms": None,
         "per": f"decode step: {k1_step['calls']} calls at M={NUM_SLOTS}",
         "decode_step": {k: k1_step[k] for k in ("calls", "M", "ms", "device_ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
         "train_step": {"calls": k1_train["calls"], "M": k1_train["M"],
                        "device_ms": train["profiled_step"]["k1_device_ms"],
                        "events_ms": k1_train["events_ms"], "plain_ms": k1_train["plain_ms"],
                        "bound_ms": k1_train["bound_ms"], "bound_by": k1_train["bound_by"]},
         "resnet19_forward": {
             **paper["k1"]["resnet19_forward"],
             "qat_step_device_ms": paper["resnet19"]["profiled_step"].get("k1_device_ms"),
             "launches_per_forward": paper["resnet19"]["k1_launches_per_forward"]}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:141",
         "launches": launches["paged_attention"], "max_abs_err": k2_err,
         "max_abs_err_bf16_q": k2_err16,
         "ms": k2_step["ms"], "plain_ms": k2_step["plain_ms"],
         "bound_ms": k2_step["bound_ms"], "bound_by": k2_step["bound_by"],
         "library_ms": k2_step["library_ms"], "device_ms": k2_step["device_ms"],
         "per": f"decode step: {k2_step['calls']} calls at B={NUM_SLOTS}, f32 pool, bf16 q",
         "bf16_pool_decode_step": {k: k2_steps["bf16"][k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "long_context_per_call": {pool: {k: row.get(k + "_per_call") for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
             for pool, row in k2_long.items()}},
        {"name": "approx_mul_eltwise", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/approx_mul_eltwise.cu",
         "replaces": "src/repro/kernels/approx_mul_eltwise/kernel.py:34",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["timed"]["ms"], "plain_ms": k3["timed"]["plain_ms"],
         "bound_ms": k3["timed"]["bound_ms"], "bound_by": k3["timed"]["bound_by"],
         "library_ms": None,
         "per": f"one call of {k3['timed']['n']} elements"},
    ]
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
