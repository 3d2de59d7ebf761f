"""Continuous-batching serve session over either KV layout, driven by a
sync or an async (double-buffered) host loop.

``ServeSession`` keeps ``num_slots`` decode slots hot and refills each slot
from a request queue the moment its occupant finishes (eos or max-token).
Two cache layouts (``cache_layout=``):

* ``"paged"`` (the port's default): K/V live in a global refcounted
  ``BlockPool`` of fixed-size blocks; each request holds only the blocks
  its context occupies, recorded in a fixed-width per-slot block table.
  Admission reserves each request's worst case (``ceil((prompt_len +
  max_new - 1) / block_size)`` blocks) against the pool, which makes every
  mid-decode block append infallible.  Decode attention runs through K2.
* ``"slots"`` (the JAX package's default): every slot owns a ``max_len``
  KV stripe (``transformer.init_cache``) and decode attends over it with
  the plain ``attention_core``, as the JAX package does.

Each ``step()`` admits what fits, in policy order, with ONE batched fused
prefill (``forward(return_kv=True)``): prompts pad to the largest bucket of
the batch and rows pad to a power-of-two admission width, as in the JAX
package — under per-tensor activation scales the padding rows share the
quantization of the real ones, so the same padding gives the same codes.
The ssm and hybrid families (``prefill_mode == "decode"``) carry conv/ssm
state that no fused pass seeds: their admission teacher-forces the bucket
through ``decode_step`` on a fresh batch cache, freezing each row past its
prompt (``_prefill_decode``, the JAX package's ``_admit_decode``), and
they serve on the slot layout only.  A moe batch routes every token of
the admission (padding included) and, in decode, every slot's row
together, as the JAX package does: capacity couples them.
Then it runs one decode chunk of ``steps_per_tick`` steps across all slots
(``_decode_tick``).  Two host loops (``loop=``):

* ``"sync"`` — block on the chunk's tokens, then do every piece of
  bookkeeping: host work and device work strictly alternate;
* ``"async"`` (the default, as in the JAX package) — dispatch chunk N+1
  (and any admissions) BEFORE waiting on chunk N's tokens.  The decode
  carry (last token and the per-slot request ids that key sampling) stays
  on the device, admissions merge their first tokens into it
  (``cache.merge_admit_carry``), the host's inputs reach the device from
  pinned buffers by non-blocking copies, and tokens come back the same way
  behind a recorded CUDA event that the harvest waits on.  Nothing on the
  dispatch path waits for the device.  A request that finishes inside the
  chunk in flight decodes one more chunk before the host sees it (its
  tokens are discarded and counted idle); a length finish is foreseen
  instead (``_release_predicted_done``), so its successor is admitted when
  the sync loop would admit it.  Every launch goes to the current stream,
  so the successor's prefill runs after the retiring row's last chunk.

``prefill_decode_ratio=R`` (or the flat ``prefill_token_budget``) bounds
the bucketed prompt tokens each step may admit while decodes are
resident, so a burst of long prompts cannot starve them: the queue head is
deferred, never skipped, and ``max_decode_gap_ticks`` stays within
``steps_per_tick + ceil(R * steps_per_tick)``.

On the paged layout, three features of the JAX package share the block
pool's machinery:

* ``prefix_sharing`` — a request's prompt blocks are keyed by content
  (``cache.PrefixCache``); a block already resident is mapped into the new
  table and shared (refcounted) instead of prefilled again, and a row
  about to write a block it shares forks a private copy first
  (``_cow_guard``, ``cache.copy_block``);
* ``preemption`` — admission drops the worst-case reservation and admits
  on the prompt's immediate need; when the pool runs dry the
  least-important resident row is evicted and later replayed as a longer
  prompt (prompt + its accepted tokens);
* ``spec_decode`` — each tick drafts ``draft_k`` tokens per row through
  the approximate path (``engine.draft_config``: the same weights, only
  ``cfg.approx`` swapped), then one exact ``paged_verify_step`` accepts
  each row's longest matching prefix plus a correction token
  (``_spec_tick``).  ``stats.accept_rate`` reads out the draft
  multiplier's error rate end to end.

A freed slot keeps decoding its stale carry (last token, ``cur_len``)
into its own stripe or the trash block, as in the JAX package; under
per-tensor activation scales those rows flow into every row's
quantization, so the carry is kept exactly as the JAX session keeps it.

**Quality tiers** (``tiers=("exact", "approx", "approx_msr")``) route each
REQUEST through its own execution mode: one ``_decode_tick`` per ladder
rung holding resident rows, in ladder order, with the other rungs' rows
made write-inert the way freed rows already are (paged: their rows of that
dispatch's table copy scrubbed to the sentinel, so their writes land in
the trash block and K2 gives their empty rows exactly 0; slots: their
``cur_len`` pinned to ``max_len``, the stripe's trash column).  A request's
rung is frozen at admission; the **load shedder** (``shed_queue_depth`` /
``shed_gap_ticks``) demotes new admissions down the ladder while the
session is overloaded and restores with hysteresis (``shed_hold_steps``).
Every rung scales activations per row (``act_per_row``), so each request's
greedy tokens equal a single-mode session of its rung whatever shares the
batch.  Tier sessions take float params (the rungs quantize differently).

**Chunked prefill** (``chunked_prefill``, paged only) splits a prompt
longer than ``prefill_chunk`` into chunks dispatched across successive
steps through ``paged_chunk_prefill_step`` (the multi-token pass), so a
long prompt stalls resident decodes by one chunk, not one prompt bucket,
and prompts past the largest bucket become admissible.  A mid-prefill row
holds its slot but joins no decode chunk (its table row is scrubbed in the
decode dispatch's copy).

**Tensor parallelism** (``mesh=``, a ``launch.mesh.TPMesh``; paged, dense
or moe family): every rank runs this same host scheduler on the same trace
(SPMD) over its part of the weights (``parallel/tp.shard_params``: Megatron
column/row splits through K1, and a MoE's routed experts split by expert
where they divide the mesh) and its KV heads of the pool (``shard_cache``,
attended through K2 on the rank's heads); the collectives inside the model
pass keep the ranks' device work in lockstep, and every rank gathers the
full logits and samples the same tokens.  Rank 0's results are the
session's.

This is the JAX package's ``ServeSession``.  Greedy tokens are the cross-framework
contract; temperature sampling follows the port's own positional Philox
schedule (``serve.engine``), so a request's tokens never depend on its
slot.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import validate_tp_heads
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.transformer import (
    decode_step,
    forward,
    fuse_params,
    init_cache,
    init_paged_cache,
    paged_chunk_prefill_step,
    paged_decode_step,
    paged_verify_step,
    params_to,
)
from repro_torch.parallel.tp import shard_cache, shard_params
from repro_torch.serve import cache as C
from repro_torch.serve.engine import (
    EXECUTION_MODES,
    SamplingConfig,
    draft_config,
    resolve_execution_mode,
    select_token,
)

__all__ = [
    "Request",
    "CompletedRequest",
    "SchedulerStats",
    "ServeSession",
    "ADMISSION_POLICIES",
    "CACHE_LAYOUTS",
    "SERVE_LOOPS",
]

ADMISSION_POLICIES = ("priority", "fifo", "sjf")
CACHE_LAYOUTS = ("slots", "paged")
SERVE_LOOPS = ("async", "sync")


def _decode_tick(
    cfg: ModelConfig,
    params,
    cache: Dict[str, torch.Tensor],
    last_token: torch.Tensor,          # (N,) int
    cur_len: torch.Tensor,             # (N,) int
    active: torch.Tensor,              # (N,) bool
    slot_req: torch.Tensor,            # (N,) request ids (sampling keys)
    tables: Optional[torch.Tensor],    # (N, W) int32: paged layout; None: slots
    *,
    sampling: SamplingConfig,
    seed: int,
    steps: int,
    block_size: int,
    attn_impl: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` decode steps across all slots (one decode chunk), issued
    without waiting on the device.  Inactive slots compute garbage into
    their own stripe or the trash block (masked to 0 here).  Rows that
    finish mid-chunk (eos here, max-token on the host) overshoot at most
    ``steps - 1`` positions, and the host discards those tokens; a row that
    hit eos emits eos from then on.  Returns ``(toks (steps, N), last
    token)``: the async loop feeds the last-token carry straight into the
    next chunk."""
    eos = sampling.eos_id
    done = torch.zeros_like(active)
    out = []
    for _ in range(steps):
        if tables is None:
            logits = decode_step(cfg, params, cache, last_token[:, None], cur_len)
        else:
            logits = paged_decode_step(cfg, params, cache, last_token[:, None], cur_len,
                                       tables, block_size=block_size, attn_impl=attn_impl)
        # the sampled token lands at position cur_len + 1
        toks = select_token(logits[:, 0], sampling, seed=seed, req_ids=slot_req,
                            positions=cur_len + 1)
        if eos >= 0:
            toks = torch.where(done, torch.full_like(toks, eos), toks)
            done = done | (toks == eos)
        toks = torch.where(active, toks, torch.zeros_like(toks))
        last_token = torch.where(active, toks, last_token)
        cur_len = cur_len + active
        out.append(toks)
    return torch.stack(out), last_token


def _spec_tick(
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    params,
    cache: Dict[str, torch.Tensor],
    last_token: torch.Tensor,          # (N,) int
    cur_len: torch.Tensor,             # (N,) int: position of last_token
    active: torch.Tensor,              # (N,) bool
    slot_req: torch.Tensor,            # (N,) request ids (sampling keys)
    tables: torch.Tensor,              # (N, W) int32: spec decode is paged-only
    *,
    sampling: SamplingConfig,
    seed: int,
    draft_k: int,
    block_size: int,
    attn_impl: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One self-speculative tick, issued without waiting on the device:
    ``draft_k`` decode steps through the draft path (``draft_cfg``, the
    verifier's config with only ``approx`` swapped; ``attn_impl`` as the
    session's decode), then ONE ``paged_verify_step`` over the K+1
    positions [last token; drafts], accepting per row the longest draft
    prefix the verifier's own tokens match plus the verifier's token after
    it, clipped at the first eos.

    The verify pass is bit-equal to K+1 sequential gather decode steps
    (per-row exact projections; see ``paged_verify_step``) and samples
    with the positional keys a sequential decode uses, so every accepted
    token is the non-speculative session's token: the draft decides only
    how many positions one verify covers.  The draft steps write
    approximate K/V at ``cur_len .. cur_len + K - 1`` and the verify
    overwrites ``cur_len .. cur_len + K``; positions past the accept point
    lie beyond the new ``cur_len`` and are rewritten before any horizon
    reaches them.

    Returns ``(toks (K+1, N), n_acc (N,), last token, cur_len)``: row b's
    accepted tokens are ``toks[:n_acc[b], b]`` (1..K+1 for live rows, 0
    for inactive ones), and the carries advance per row by ``n_acc``."""
    S = draft_k + 1
    tok, pos, drafts = last_token, cur_len, []
    for _ in range(draft_k):
        logits = paged_decode_step(draft_cfg, params, cache, tok[:, None], pos, tables,
                                   block_size=block_size, attn_impl=attn_impl)
        # the draft samples with the verifier's positional keys, so a
        # perfect draft is accepted whole
        tok = select_token(logits[:, 0], sampling, seed=seed, req_ids=slot_req,
                           positions=pos + 1)
        tok = torch.where(active, tok, torch.zeros_like(tok))
        drafts.append(tok)
        pos = pos + active
    drafts = torch.stack(drafts, dim=1)                           # (N, K)
    logits = paged_verify_step(cfg, params, cache,
                               torch.cat([last_token[:, None].to(drafts.dtype), drafts], dim=1),
                               cur_len, tables, block_size=block_size)
    N, V = logits.shape[0], logits.shape[-1]
    offs = torch.arange(S, device=logits.device)
    # the verifier's token at position cur_len + j + 1, for j = 0..K
    exact = select_token(logits.reshape(N * S, V), sampling, seed=seed,
                         req_ids=slot_req.repeat_interleave(S),
                         positions=(cur_len[:, None] + 1 + offs).reshape(-1)).reshape(N, S)
    match = (exact[:, :draft_k] == drafts).long()
    n_acc = torch.cumprod(match, dim=1).sum(dim=1) + 1
    if sampling.eos_id >= 0:
        # never emit past the first eos (a sequential decode stops there)
        is_eos = exact == sampling.eos_id
        first = torch.where(is_eos.any(dim=1), is_eos.long().argmax(dim=1),
                            torch.full_like(n_acc, S))
        n_acc = torch.minimum(n_acc, first + 1)
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    toks = torch.where((offs[None, :] < n_acc[:, None]) & active[:, None], exact,
                       torch.zeros_like(exact))
    new_last = exact.gather(1, (n_acc - 1).clamp(min=0)[:, None])[:, 0]
    last_token = torch.where(active, new_last, last_token)
    max_pos = tables.shape[1] * block_size - 1                    # == max_len - 1
    cur_len = torch.where(active, torch.clamp(cur_len + n_acc, max=max_pos), cur_len)
    return toks.T, n_acc, last_token, cur_len


def _prefill_chunk(
    cfg: ModelConfig,
    params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,              # (A, C_bucket) right-padded chunk tokens
    starts: torch.Tensor,              # (A,) position of tokens[:, 0]
    chunk_lens: torch.Tensor,          # (A,) real tokens this chunk
    tables: torch.Tensor,              # (A, W) int32 per-row tables, sentinel-tailed
    req_ids: torch.Tensor,             # (A,) request ids (sampling keys)
    *,
    sampling: SamplingConfig,
    seed: int,
    block_size: int,
) -> torch.Tensor:
    """Chunked prefill: teacher-force one chunk of each row's prompt into
    the pool at positions ``[starts, starts + chunk_lens)``, reading the
    prefix already written through the block table
    (``paged_chunk_prefill_step``, the multi-token pass).  Padding rows
    carry all-sentinel tables, so their writes land in the trash block.
    Returns each row's first token ASSUMING this is its final chunk: it is
    sampled at position ``starts + chunk_lens``, the effective prompt
    length exactly when the chunk completes the prompt (the position the
    one-shot prefill samples at); for other rows the host ignores it."""
    logits = paged_chunk_prefill_step(cfg, params, cache, tokens, starts, tables,
                                      block_size=block_size)
    lens = chunk_lens.long()
    last = logits[torch.arange(tokens.shape[0], device=tokens.device), lens - 1]
    return select_token(last, sampling, seed=seed, req_ids=req_ids,
                        positions=starts.long() + lens)


class _HostCopy:
    """A device tensor's values on their way to the host.  On a CUDA
    device: a non-blocking copy into a pinned buffer and an event recorded
    after it on the current stream; ``wait()`` blocks on that event only.
    On the CPU the values are already there."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.buf = t

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``arrival`` is in scheduler ticks (one decode
    step == one tick); ``priority`` orders admission (lower first, FIFO
    within a class); ``tier`` names the requested quality-ladder rung
    (``None``: the session's best rung; tier sessions only)."""

    req_id: int
    prompt: np.ndarray          # (S0,) int32
    max_new: int
    priority: int = 0
    arrival: int = 0
    tier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    req_id: int
    prompt: np.ndarray
    tokens: np.ndarray          # generated tokens (first token included)
    finish_reason: str          # "eos" | "length"
    admitted_tick: int
    finished_tick: int
    # quality tiers: the EFFECTIVE rung the request was served at (its
    # requested rung, possibly demoted by the load shedder); "" without tiers
    tier: str = ""
    ttft: int = -1              # time-to-first-token, ticks since arrival

    @property
    def full_sequence(self) -> np.ndarray:
        return np.concatenate([self.prompt, self.tokens])


@dataclasses.dataclass
class SchedulerStats:
    """Serve-session counters and gauges (one line per metric in ``DOCS``).

    *Scheduler ticks* count executed decode steps (admission is free) and
    are the unit of ``Request.arrival``; *work ticks* additionally charge
    each admission its prefill, normalized to decode widths."""

    DOCS: ClassVar[Dict[str, str]] = {
        "ticks": "decode ticks executed (1 tick = one decode step across "
                 "all slots; steps_per_tick of them per decode chunk)",
        "busy_slot_steps": "slot-steps that produced an accepted token "
                           "(sum over chunks of accepted tokens)",
        "idle_slot_steps": "slot-steps wasted: empty slots, mid-chunk "
                           "overshoot, and async garbage chunks "
                           "(ticks * num_slots - busy_slot_steps)",
        "admitted": "requests admitted (prefilled into a slot)",
        "completed": "requests finished (eos or length)",
        "generated_tokens": "tokens accepted across all requests, including "
                            "each request's admit-time first token",
        "admit_calls": "batched prefill calls (one per admission batch)",
        "prefills": "prompt-bucket size -> prefill dispatches charged at "
                    "that bucket (each request's OWN effective-prompt "
                    "bucket — replayed preemption victims count at their "
                    "longer replay bucket — not the admit batch's padding "
                    "bucket; under chunked prefill every CHUNK counts at "
                    "its own chunk bucket, so one long request contributes "
                    "several entries)",
        "peak_active": "max concurrently-resident requests",
        "peak_blocks_in_use": "max KV pool blocks held at once",
        "ttft_ticks": "per-request time-to-first-token in scheduler ticks "
                      "since the request's arrival (queue wait + prefill), "
                      "appended at admit — under chunked prefill, at the "
                      "FINAL chunk's dispatch, when the first token is "
                      "actually sampled",
        "ttft_s": "per-request wall seconds from submit() to the host "
                  "holding the request's first token",
        "latency_ticks": "per-request total latency in scheduler ticks since "
                         "arrival, appended at finish",
        "prefill_tokens": "bucketed prompt tokens admitted (the device "
                          "prefill work the interleaving budget meters; "
                          "excludes admit-width padding rows)",
        "work_ticks": "device-work clock: decode steps + prefill charged at "
                      "bucketed tokens / num_slots, integerized through a carry",
        "prefill_stall_ticks": "scheduler steps where the interleaving "
                               "budget deferred an otherwise-admissible "
                               "request (slots and memory both fit)",
        "max_decode_gap_ticks": "starvation gauge: worst work-tick gap "
                                "between a resident request's consecutive "
                                "accepted tokens (<= steps_per_tick + "
                                "ceil(prefill_decode_ratio * "
                                "steps_per_tick) under the ratio policy; "
                                "chunked prefill tightens the per-item "
                                "budget overshoot from one prompt bucket "
                                "to one chunk)",
        "host_block_s": "wall seconds the host spent blocked on device "
                        "results (first tokens and decode tokens: the "
                        "copies' events at harvest in the async loop)",
        "wall_s": "wall seconds spent inside step() in total",
        "attn_impl": "decode-attention implementation: 'kernel' (the CUDA "
                     "kernel; paged layout only) or 'gather' (its plain "
                     "version; the slot layout's attention_core)",
        "slot_utilization": "busy_slot_steps / (busy + idle)",
        "overlap_fraction": "1 - host_block_s / wall_s: fraction of step() "
                            "wall time NOT spent blocked on the device — "
                            "the async loop's pipelining win (sync loop "
                            "reports its serial block share for contrast); "
                            "clamped to [0, 1] because the two timers nest "
                            "imperfectly (a block timed inside a step can "
                            "skew the raw ratio past either end)",
        "ttft_p50": "median time-to-first-token, scheduler ticks",
        "ttft_p95": "95th-percentile time-to-first-token, scheduler ticks",
        "ttft_s_p50": "median time-to-first-token, wall seconds",
        "latency_p50": "median request latency, scheduler ticks",
        "latency_p95": "95th-percentile request latency, scheduler ticks",
        "prefix_hit_blocks": "prefix sharing: prompt blocks admitted by "
                             "pointing the block table at an already-"
                             "resident shared block instead of acquiring "
                             "and prefill-writing a new one",
        "cow_forks": "prefix sharing: copy-on-write forks — a request "
                     "about to write into a block it shares acquired a "
                     "private copy via copy_block first",
        "preemptions": "preemption: resident requests evicted to free "
                       "blocks for another row's append/fork; the victim "
                       "re-enters the ready queue and replays from its "
                       "accepted tokens (bit-identical under the "
                       "positional key schedule)",
        "draft_tokens": "speculative decoding: tokens proposed by the "
                        "approximate draft path (draft_k per live row per "
                        "verify)",
        "accepted_tokens": "speculative decoding: drafted tokens the exact "
                           "verifier accepted — excludes the correction "
                           "token every verify emits, so accepted == "
                           "drafted means a perfect draft",
        "verify_calls": "speculative decoding: per-row exact verify "
                        "passes (one per live row per spec tick)",
        "accept_rate": "speculative decoding: accepted_tokens / "
                       "draft_tokens — the live end-to-end readout of the "
                       "draft multiplier's error rate (0.0 when spec "
                       "decode is off)",
        "draft_k_current": "speculative decoding: the draft window the "
                           "NEXT spec tick will dispatch — equals the "
                           "configured draft_k unless dynamic_draft_k "
                           "shrank/regrew it on the rolling accept rate",
        "draft_k_shrinks": "speculative decoding: times dynamic_draft_k "
                           "halved the draft window (rolling accept rate "
                           "below break-even 1/draft_cost_ratio)",
        "draft_k_grows": "speculative decoding: times dynamic_draft_k "
                         "re-grew the draft window (rolling accept rate "
                         "back at/above break-even)",
        "tier_demotions": "quality tiers: times the load shedder raised "
                          "the shed level (new admissions demoted one rung "
                          "further down the tier ladder)",
        "tier_restorations": "quality tiers: times the shedder lowered the "
                             "shed level after shed_hold_steps consecutive "
                             "healthy steps (the hysteresis window clears "
                             "on every level change)",
        "shed_level": "quality tiers: current shed level — new admissions "
                      "serve at ladder rung max(requested, shed_level); "
                      "0 = no shedding in effect",
        "active_per_tier": "quality tiers: currently-resident requests per "
                           "EFFECTIVE ladder rung (the rung each request "
                           "was admitted at, post-shedding); empty when "
                           "tiers are off",
        "tp": "tensor-parallel degree: size of the session mesh's "
              "'model' axis (1 for single-device serving)",
        "devices": "devices the session mesh spans (1 off-mesh)",
        "peak_block_bytes_per_device": "paged layout: KV pool bytes "
                                       "resident on EACH device for the "
                                       "peak_blocks_in_use blocks — the "
                                       "pool shards along the KV-head dim "
                                       "under TP, so this scales as 1/tp "
                                       "at equal block counts",
        "prefill_chunks": "chunked prefill: partial-prompt chunk rows "
                          "dispatched (each long request contributes "
                          "ceil(effective_prompt / prefill_chunk) rows; 0 "
                          "when chunking is off or every prompt fits one "
                          "chunk)",
    }

    ticks: int = 0
    busy_slot_steps: int = 0
    idle_slot_steps: int = 0
    admitted: int = 0
    completed: int = 0
    generated_tokens: int = 0
    admit_calls: int = 0
    prefills: Dict[int, int] = dataclasses.field(default_factory=dict)
    peak_active: int = 0
    peak_blocks_in_use: int = 0
    ttft_ticks: List[int] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    latency_ticks: List[int] = dataclasses.field(default_factory=list)
    prefill_tokens: int = 0
    work_ticks: int = 0
    prefill_stall_ticks: int = 0
    max_decode_gap_ticks: int = 0
    host_block_s: float = 0.0
    wall_s: float = 0.0
    attn_impl: str = "kernel"
    prefix_hit_blocks: int = 0
    cow_forks: int = 0
    preemptions: int = 0
    draft_tokens: int = 0
    accepted_tokens: int = 0
    verify_calls: int = 0
    tp: int = 1
    devices: int = 1
    peak_block_bytes_per_device: int = 0
    draft_k_current: int = 0
    draft_k_shrinks: int = 0
    draft_k_grows: int = 0
    tier_demotions: int = 0
    tier_restorations: int = 0
    shed_level: int = 0
    active_per_tier: Dict[str, int] = dataclasses.field(default_factory=dict)
    prefill_chunks: int = 0

    @property
    def accept_rate(self) -> float:
        if not self.draft_tokens:
            return 0.0
        return self.accepted_tokens / self.draft_tokens

    @property
    def slot_utilization(self) -> float:
        cap = self.busy_slot_steps + self.idle_slot_steps
        return self.busy_slot_steps / cap if cap else 0.0

    @property
    def overlap_fraction(self) -> float:
        if not self.wall_s:
            return 0.0
        return min(1.0, max(0.0, 1.0 - self.host_block_s / self.wall_s))

    @staticmethod
    def _pct(xs, q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    @property
    def ttft_p50(self) -> float:
        return self._pct(self.ttft_ticks, 50)

    @property
    def ttft_p95(self) -> float:
        return self._pct(self.ttft_ticks, 95)

    @property
    def ttft_s_p50(self) -> float:
        return self._pct(self.ttft_s, 50)

    @property
    def latency_p50(self) -> float:
        return self._pct(self.latency_ticks, 50)

    @property
    def latency_p95(self) -> float:
        return self._pct(self.latency_ticks, 95)


@dataclasses.dataclass
class _ActiveSlot:
    req: Request
    slot: int
    tokens: List[int]
    admitted_tick: int
    ttft: int = -1
    # set by _finish; the async loop skips chunk tokens of rows whose
    # completion was discovered after their last chunk was dispatched
    done: bool = False
    # slot and blocks already freed (predictive early turnover: the row's
    # in-flight chunk provably completes it by length)
    released: bool = False
    # evicted mid-decode to free blocks for another row: the request is back
    # in the ready queue and replays from its accepted tokens; every token
    # this state still has in flight is discarded
    preempted: bool = False
    # async loop: the admit-time first token is on its way to the host (a
    # re-admitted row already holds tokens while it is pending)
    pending_first: bool = False
    # quality tiers: the effective ladder rung this request decodes under,
    # frozen at admission (a preemption replay re-admits at the same rung)
    tier_idx: int = 0
    # chunked prefill: a resident row whose prompt is still being written
    # holds its slot and grows its table chunk by chunk; ``prefill_pos``
    # counts effective-prompt tokens already dispatched, ``eff_prompt`` is
    # the prompt (+ replayed tokens).  One-shot admissions leave both at
    # 0 / None, so ``prefilling`` is False for them.
    prefill_pos: int = 0
    prefill_len: int = 0
    eff_prompt: Optional[np.ndarray] = None

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.prefill_len


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unharvested decode chunk (async loop).

    ``states`` snapshots ``_active`` at dispatch: only those rows may accept
    this chunk's tokens.  ``work_end`` is the work-tick clock just after
    the chunk's steps were charged (the starvation gauge's emission time).
    ``staged`` holds the pinned host buffers of the inputs copied since the
    previous dispatch, alive until the harvest has waited on ``toks``'s
    event, which is recorded after every one of those copies."""

    toks: _HostCopy
    steps: int
    states: List[Optional[_ActiveSlot]]
    work_end: int
    staged: List[torch.Tensor]
    # speculative chunks: the draft window this chunk was dispatched with
    # (0 for a decode chunk); ``toks`` then holds (draft_k + 2, N): the
    # accepted tokens' rows, then each row's accepted count
    draft_k: int = 0


class ServeSession:
    """Continuous-batching serving over the paged KV pool or per-slot
    stripes.

    >>> sess = ServeSession(cfg, params, num_slots=4, max_len=256)
    >>> sess.submit(prompt_ids, max_new=64)
    >>> results = sess.run()          # {req_id: CompletedRequest}

    ``cache_layout`` is ``"paged"`` (default) or ``"slots"``.  Paged:
    ``num_blocks`` defaults to ``num_slots * max_len / block_size`` (every
    slot's worst case); lower it to oversubscribe.  Slots: each slot holds a
    ``max_len`` stripe; ``zero_on_evict`` zeroes a slot's stripe when its
    request finishes (hygiene; slots only, as in the JAX package).
    ``policy`` orders the ready queue: ``"priority"`` (lower
    ``Request.priority`` first, FIFO within a class), ``"fifo"``, or
    ``"sjf"`` (shortest ``max_new + bucketed prompt len`` first).
    ``attn_impl`` picks the decode attention: ``"kernel"`` (K2, the paged
    default) or ``"gather"`` (its plain version, the oracle; the only one
    on slots).  ``cache_dtype`` is the cache's dtype (float32, as in the
    JAX package, or bfloat16, which halves the cache's bytes; K2 takes
    both).  ``params`` may be float or ``freeze_params`` trees; they move
    to ``device`` (default: the CUDA device; without one, this raises).

    ``loop`` is ``"async"`` (default: the double-buffered pipeline) or
    ``"sync"``; ``steps_per_tick`` decode steps run per chunk (rows that
    finish mid-chunk waste at most ``steps_per_tick - 1`` slot-steps).
    ``prefill_decode_ratio`` / ``prefill_token_budget`` bound the bucketed
    prompt tokens each ``step()`` may admit while decodes are resident
    (``ratio * n_active * steps_per_tick``, or a flat budget).
    ``close()`` flushes the in-flight chunk and seals the session: later
    ``submit``/``step``/``run`` raise ``RuntimeError``.

    Paged layout only: ``prefix_sharing`` maps prompt blocks already
    resident into new tables (refcounted, forked on first write);
    ``preemption`` admits on the prompt's immediate need and evicts the
    least-important resident row (highest policy key, then youngest) when
    the pool runs dry, replaying it later as prompt + accepted tokens.
    ``spec_decode`` (``steps_per_tick=1``) runs each tick as ``draft_k``
    draft steps through ``draft_mode`` x ``draft_multiplier`` and one
    verify pass; ``dynamic_draft_k`` halves or regrows the draft window
    on the rolling accept rate of the last ``draft_window`` verifies
    against the break-even ``1 / draft_cost_ratio``.  Accepted tokens equal
    the non-speculative session's where the verify pass is bit-equal to
    sequential gather decode (per-row exact projections: ``exact_quant``
    or ``approx`` with ``act_per_row``, or float on the CPU).

    ``tiers=("exact", "approx", "approx_msr")`` routes each request
    through its own execution mode (the session cfg with only ``approx``
    swapped, per-row scales; ``tier_multiplier`` names the approximate
    design, MSR rungs default to ``mul8x8_msr4``); ``submit(...,
    tier=...)`` picks a request's rung, and every step dispatches one
    decode chunk per rung holding resident rows.  ``shed_queue_depth`` /
    ``shed_gap_ticks`` arm the load shedder: a breach demotes NEW
    admissions one rung down the ladder, and ``shed_hold_steps``
    consecutive steps below ``shed_restore_fraction`` of the thresholds
    restore one rung.  ``chunked_prefill`` (paged) prefills prompts
    longer than ``prefill_chunk`` (a prompt bucket; default the largest)
    chunk by chunk across steps, and admits prompts past the largest
    bucket.

    ``mesh`` (a ``TPMesh``; paged layout, dense or moe family) serves
    tensor parallel over its ``tp_axis`` (``"model"``): the session cuts the
    params (float, or frozen whole before the cut) and the pool into the
    rank's parts, and every rank of the mesh builds the same session and
    drives it with the same calls.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict[str, Any],
        *,
        num_slots: int = 4,
        max_len: int = 256,
        prompt_buckets: Sequence[int] = (8, 16, 32, 64),
        sampling: Optional[SamplingConfig] = None,
        seed: int = 0,
        steps_per_tick: int = 1,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        policy: str = "priority",
        loop: str = "async",
        prefill_decode_ratio: Optional[float] = None,
        prefill_token_budget: Optional[int] = None,
        attn_impl: Optional[str] = None,
        pad_id: int = 0,
        cache_dtype: torch.dtype = torch.float32,
        cache_layout: str = "paged",
        zero_on_evict: bool = False,
        prefix_sharing: bool = False,
        preemption: bool = False,
        spec_decode: bool = False,
        draft_k: int = 4,
        draft_mode: str = "approx",
        draft_multiplier: str = "mul8x8_2",
        dynamic_draft_k: bool = False,
        draft_cost_ratio: float = 4.0,
        draft_window: int = 32,
        tiers: Optional[Sequence[str]] = None,
        tier_multiplier: str = "mul8x8_2",
        shed_queue_depth: Optional[int] = None,
        shed_gap_ticks: Optional[int] = None,
        shed_hold_steps: int = 8,
        shed_restore_fraction: float = 0.5,
        chunked_prefill: bool = False,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        tp_axis: str = "model",
        device=None,
    ):
        if not cfg.embed_input:
            raise ValueError(f"{cfg.name}: token serving requires an embed-input arch")
        if cache_layout not in CACHE_LAYOUTS:
            raise ValueError(f"cache_layout {cache_layout!r} not in {CACHE_LAYOUTS}")
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"policy {policy!r} not in {ADMISSION_POLICIES}")
        if loop not in SERVE_LOOPS:
            raise ValueError(f"loop {loop!r} not in {SERVE_LOOPS}")
        if attn_impl is None:
            attn_impl = "kernel" if cache_layout == "paged" else "gather"
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        if attn_impl != "gather" and cache_layout != "paged":
            raise ValueError(
                f"attn_impl {attn_impl!r} requires cache_layout='paged' — "
                "the slot layout has no block table to walk"
            )
        if prefill_decode_ratio is not None and prefill_token_budget is not None:
            raise ValueError(
                "prefill_decode_ratio and prefill_token_budget are alternative "
                "interleaving policies — set at most one"
            )
        if prefill_decode_ratio is not None and prefill_decode_ratio <= 0:
            raise ValueError(
                f"prefill_decode_ratio must be > 0, got {prefill_decode_ratio}"
            )
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget must be >= 1, got {prefill_token_budget}"
            )
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick must be >= 1, got {steps_per_tick}")
        if (prefix_sharing or preemption) and cache_layout != "paged":
            raise ValueError(
                "prefix_sharing/preemption operate on the shared BlockPool — "
                'they require cache_layout="paged"'
            )
        if spec_decode:
            if cache_layout != "paged":
                raise ValueError(
                    "spec_decode verifies drafted positions against the "
                    'block pool — it requires cache_layout="paged"'
                )
            if steps_per_tick != 1:
                raise ValueError(
                    "spec_decode replaces the decode chunk with draft_k "
                    "drafts + one verify per tick — steps_per_tick must "
                    f"stay 1, got {steps_per_tick}"
                )
            if draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {draft_k}")
            if cfg.family == "moe":
                raise ValueError(
                    "spec_decode requires a dense attention family: moe "
                    "routing is capacity-coupled across the token batch, "
                    "so a batched verify would route differently than "
                    "sequential decode and lose the exactness contract"
                )
        if dynamic_draft_k:
            if not spec_decode:
                raise ValueError("dynamic_draft_k requires spec_decode=True")
            if draft_cost_ratio <= 1.0:
                raise ValueError(
                    "draft_cost_ratio is verify-work / draft-step-work and "
                    f"must be > 1 (break-even accept rate is its inverse), "
                    f"got {draft_cost_ratio}"
                )
            if draft_window < 1:
                raise ValueError(f"draft_window must be >= 1, got {draft_window}")
        if tiers is not None:
            tiers = tuple(tiers)
            if not tiers:
                raise ValueError("tiers must name at least one execution mode")
            if len(set(tiers)) != len(tiers):
                raise ValueError(f"tiers contains duplicate rungs: {tiers}")
            for t in tiers:
                if t not in EXECUTION_MODES:
                    raise ValueError(
                        f"tier {t!r} not in execution modes {EXECUTION_MODES}"
                    )
            if spec_decode:
                raise ValueError(
                    "tiers and spec_decode both repurpose the per-dispatch "
                    "cfg.approx execution routing — set at most one"
                )
            if cfg.family in ("ssm", "hybrid"):
                raise ValueError(
                    "quality tiers dispatch one decode program per rung and "
                    "rely on positional KV writes to keep the other rungs' "
                    f"rows untouched — {cfg.family} carries non-positional "
                    "conv/ssm state, so tier serving requires an attention "
                    "family"
                )
        shed_on = shed_queue_depth is not None or shed_gap_ticks is not None
        if shed_on:
            if tiers is None or len(tiers) < 2:
                raise ValueError(
                    "load shedding demotes admissions down the quality "
                    "ladder — it requires tiers with >= 2 rungs"
                )
            if shed_queue_depth is not None and shed_queue_depth < 1:
                raise ValueError(
                    f"shed_queue_depth must be >= 1, got {shed_queue_depth}"
                )
            if shed_gap_ticks is not None and shed_gap_ticks < 1:
                raise ValueError(
                    f"shed_gap_ticks must be >= 1, got {shed_gap_ticks}"
                )
            if shed_hold_steps < 1:
                raise ValueError(
                    f"shed_hold_steps must be >= 1, got {shed_hold_steps}"
                )
            if not 0.0 < shed_restore_fraction <= 1.0:
                raise ValueError(
                    "shed_restore_fraction must be in (0, 1], got "
                    f"{shed_restore_fraction}"
                )
        if mesh is not None:
            if tp_axis != "model":
                raise ValueError(
                    f"tp_axis must be 'model' (param_pspec/cache_pspecs key "
                    f"their TP rules on it), got {tp_axis!r}"
                )
            if tp_axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh has no {tp_axis!r} axis (axes: {mesh.axis_names})"
                )
            if cache_layout != "paged":
                raise ValueError(
                    "mesh serving shards the paged BlockPool along the "
                    'KV-head dim — it requires cache_layout="paged"'
                )
        # SSM/hybrid caches carry conv/ssm state -> masked teacher-forced admit
        self.prefill_mode = "decode" if cfg.family in ("ssm", "hybrid") else "fused"
        if cache_layout == "paged":
            if cfg.family in ("ssm", "hybrid"):
                raise ValueError(
                    f"{cfg.family} decode state is O(1) per request (no KV "
                    "sequence axis) — there is nothing to page; use "
                    'cache_layout="slots"'
                )
            if zero_on_evict:
                raise ValueError(
                    "zero_on_evict applies to the slot layout only (freed "
                    "blocks are invisible until re-seeded by their next owner)"
                )
            if mesh is not None:
                # both attention paths run on whole heads per rank
                validate_tp_heads(cfg.num_heads, cfg.num_kv_heads, int(mesh.shape[tp_axis]))
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            if max_len % block_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of block_size {block_size} "
                    "(fixed-width block tables)"
                )
        self.layout = cache_layout
        self.cache_dtype = cache_dtype
        self.zero_on_evict = bool(zero_on_evict)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.mesh = mesh
        self.tp = int(mesh.shape[tp_axis]) if mesh is not None else 1
        if mesh is not None:
            self.params = shard_params(self.params, cfg, mesh)
        # the fused frozen leaves (fuse_qkv / fuse_gate_up), built once here,
        # after the cut: each rank concatenates its own parts
        self.params = fuse_params(cfg, self.params)
        self.sampling = sampling if sampling is not None else SamplingConfig()
        self.seed = int(seed)
        self.max_len = int(max_len)
        self.policy = policy
        self.loop = loop
        self.steps_per_tick = int(steps_per_tick)
        self.prefill_decode_ratio = prefill_decode_ratio
        self.prefill_token_budget = prefill_token_budget
        self.attn_impl = attn_impl
        self.pad_id = int(pad_id)
        self.prefix_sharing = bool(prefix_sharing)
        self.preempt = bool(preemption)
        self.spec = bool(spec_decode)
        self.draft_k = int(draft_k)
        self.dynamic_draft = bool(dynamic_draft_k)
        self.draft_cost_ratio = float(draft_cost_ratio)
        self.draft_window = int(draft_window)
        # the halving ladder draft_k -> 1 that dynamic_draft_k may visit
        ks = [max(1, self.draft_k)]
        while ks[-1] > 1:
            ks.append(ks[-1] // 2)
        self._draft_ks: Tuple[int, ...] = tuple(ks)
        self._draft_k_eff = self.draft_k
        # rolling (drafted, accepted) pairs of the last draft_window live
        # rows; cleared on every rung change, so each rung is judged on a
        # full window of its own
        self._accept_hist: deque = deque(maxlen=self.draft_window)
        self.draft_cfg = draft_config(cfg, draft_mode, draft_multiplier) if self.spec else None
        # quality tiers: one ModelConfig per ladder rung, the session cfg
        # with only ``approx`` swapped and per-row activation scales, which
        # make each row's quantized math independent of its neighbours
        self.tiers: Optional[Tuple[str, ...]] = tiers
        self.tier_multiplier = tier_multiplier
        self._tier_cfgs: Tuple[ModelConfig, ...] = tuple(
            dataclasses.replace(cfg, approx=resolve_execution_mode(
                t, tier_multiplier, act_per_row=True))
            for t in (tiers or ()))
        self._shed_on = shed_on
        self.shed_queue_depth = shed_queue_depth
        self.shed_gap_ticks = shed_gap_ticks
        self.shed_hold_steps = int(shed_hold_steps)
        self.shed_restore_fraction = float(shed_restore_fraction)
        self._shed_level = 0
        # consecutive healthy steps toward a restore; cleared on every level
        # change and every unhealthy step (the hysteresis window)
        self._shed_ok_steps = 0
        self._tier_active_counts: List[int] = [0] * len(tiers or ())
        self.buckets = C.PromptBuckets(prompt_buckets)
        if self.buckets.max_size > self.max_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets.max_size} > max_len {self.max_len}"
            )
        if prefill_chunk is not None and not chunked_prefill:
            raise ValueError("prefill_chunk requires chunked_prefill=True")
        if chunked_prefill:
            if cache_layout != "paged":
                raise ValueError(
                    "chunked prefill resumes a partially-written block table "
                    'across ticks — it requires cache_layout="paged" (the '
                    "slot layout has no sentinel-tailed table to grow)"
                )
            if cfg.family == "moe":
                raise ValueError(
                    "chunked prefill teacher-forces chunk tokens through a "
                    "batched pass; moe routing is capacity-coupled across "
                    "the token batch, so chunks would route differently "
                    "than the fused prefill oracle and lose the exactness "
                    "contract"
                )
            if spec_decode:
                raise ValueError(
                    "chunked prefill and spec_decode both repurpose the "
                    "multi-position verify pass with different per-tick "
                    "schedules — composing them is a ROADMAP follow-on; "
                    "set at most one"
                )
            if tiers is not None:
                raise ValueError(
                    "chunked prefill dispatches chunk batches outside the "
                    "per-rung admit grouping — composing it with quality "
                    "tiers is a ROADMAP follow-on"
                )
            if prefix_sharing:
                raise ValueError(
                    "prefix sharing publishes prompt blocks at admission, "
                    "but a chunk-prefilled block is written ticks after its "
                    "table entry exists — a sharer could map it before its "
                    "K/V lands; publish-at-chunk-boundary is a ROADMAP "
                    "follow-on"
                )
            if prefill_chunk is None:
                prefill_chunk = self.buckets.max_size
            if prefill_chunk not in self.buckets.sizes:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be one of the "
                    f"prompt buckets {self.buckets.sizes} — chunk widths are "
                    "drawn from the bucket set so the compiled program set "
                    "stays (admit widths x buckets)"
                )
        self.chunked = bool(chunked_prefill)
        self.prefill_chunk = int(prefill_chunk) if chunked_prefill else 0
        self.pool = C.SlotPool(num_slots)
        self.num_slots = num_slots
        if cache_layout == "paged":
            self.block_size = int(block_size)
            self.table_width = self.max_len // self.block_size
            if num_blocks is None:
                num_blocks = num_slots * self.table_width
            self.blocks = C.BlockPool(num_blocks)
            self.num_blocks = int(num_blocks)
            self.cache = init_paged_cache(cfg, self.num_blocks, self.block_size,
                                          cache_dtype, device=self.device)
            if mesh is not None:
                self.cache = shard_cache(cfg, mesh, self.cache)
            # per-slot block table (sentinel == num_blocks), held blocks, and
            # the not-yet-held part of each row's worst-case reservation
            self._tables = np.full((num_slots, self.table_width), self.num_blocks,
                                   np.int32)
            self._held: List[List[int]] = [[] for _ in range(num_slots)]
            self._future = np.zeros((num_slots,), np.int64)
            self._reserved_total = 0
            # prefix sharing: content -> physical block; the session takes
            # one pool reference per published block on the cache's behalf
            self._prefix = C.PrefixCache() if self.prefix_sharing else None
        else:
            self._prefix = None
            self.cache = init_cache(cfg, num_slots, self.max_len, cache_dtype,
                                    device=self.device)
        # preemption: req_id -> (accepted tokens, first admit tick, effective
        # tier rung, ttft ticks), consumed when the victim is admitted again
        # and replays (at the same rung, so the replay is the same run's)
        self._preempt_resume: Dict[int, Tuple[List[int], int, int, int]] = {}

        # decode carry; a freed slot keeps its last values — they still flow
        # through the decode step (and, under per-tensor activation scales,
        # into every row's quantization), as in the JAX package.  The sync
        # loop keeps last token and request ids on the host; the async loop
        # on the device (_lt_dev, _req_dev).  cur_len is the host's in both.
        self._last_token = np.zeros((num_slots,), np.int32)
        self._cur_len = np.zeros((num_slots,), np.int32)
        self._slot_req = np.zeros((num_slots,), np.int64)   # sampling key per slot
        self._lt_dev = torch.zeros((num_slots,), dtype=torch.int64, device=self.device)
        self._req_dev = torch.zeros((num_slots,), dtype=torch.int64, device=self.device)
        # speculative async loop: rows advance by accepted counts the host
        # learns only at harvest, so cur_len joins the device carry
        # (_cl_dev); the host's _cur_len is then an UPPER bound (each live
        # row charged draft_k + 1 at dispatch, reconciled at harvest) for
        # block allocation, and _cl_true the truth through the last
        # harvested chunk (the copy-on-write guard's lower bound)
        self._cl_dev = torch.zeros((num_slots,), dtype=torch.int64, device=self.device)
        self._cl_true = np.zeros((num_slots,), np.int32)
        # quality tiers: each slot occupant's effective rung (read only where
        # a slot is occupied; the per-rung dispatch masks on it)
        self._slot_tier = np.zeros((num_slots,), np.int32)
        # chunked prefill: resident rows whose prompt is still being written,
        # FIFO; each step resumes their next chunk (budget permitting) BEFORE
        # admitting new work, so started prefills finish first
        self._prefilling: List[_ActiveSlot] = []

        self._active: List[Optional[_ActiveSlot]] = [None] * num_slots
        self._pending: List[Tuple[int, int, Request]] = []   # heap (arrival, seq)
        self._ready: List[Tuple[int, int, Request]] = []     # heap (policy key, seq)
        self._seq = 0
        self._next_id = 0
        self._submit_t: Dict[int, float] = {}
        self.clock = 0
        # bytes of one pool block on this rank (0 for the slot layout): the
        # peak_block_bytes_per_device gauge reads it
        self._block_bytes_dev = (C.pool_bytes_per_device(self.cache) // (self.num_blocks + 1)
                                 if cache_layout == "paged" else 0)
        self.stats = SchedulerStats(attn_impl=attn_impl, tp=self.tp,
                                    devices=mesh.size if mesh is not None else 1,
                                    draft_k_current=self.draft_k if self.spec else 0)
        self._completed: Dict[int, CompletedRequest] = {}
        self._just_finished: List[int] = []
        self._last_emit_work = np.zeros((num_slots,), np.int64)
        self._prefill_carry = 0
        # async pipeline: the chunk in flight, the admissions whose first
        # tokens are on their way to the host, and the pinned buffers of
        # the inputs copied since the last dispatch
        self._closed = False
        self._inflight: Optional[_Inflight] = None
        self._pending_tok0: List[Tuple[List[_ActiveSlot], _HostCopy]] = []
        self._staged: List[torch.Tensor] = []

    # -- queue ---------------------------------------------------------------

    def submit(self, prompt, max_new: int, *, req_id: Optional[int] = None,
               priority: int = 0, arrival: int = 0, tier: Optional[str] = None) -> int:
        """Queue one request; returns its id. ``arrival`` in ticks; ``tier``
        names the requested ladder rung (tier sessions only; ``None``: the
        best rung), which the load shedder may still demote at admission.
        Every shape constraint is checked here, naming the request; a sealed
        session (after ``close()``) refuses."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_id if req_id is None else req_id
        if self._closed:
            raise RuntimeError(
                f"request {rid}: submitted after close() — the session is "
                "sealed and its pipeline flushed; create a new ServeSession"
            )
        if tier is not None:
            if self.tiers is None:
                raise ValueError(
                    f"request {rid}: tier={tier!r} on a session without a "
                    "quality ladder — construct ServeSession(tiers=(...))"
                )
            if tier not in self.tiers:
                raise ValueError(
                    f"request {rid}: tier {tier!r} not in session tiers "
                    f"{self.tiers}"
                )
        if prompt.size < 1:
            raise ValueError(f"request {rid}: empty prompt")
        if max_new < 1:
            raise ValueError(f"request {rid}: max_new must be >= 1, got {max_new}")
        if prompt.size > self.buckets.max_size and not self.chunked:
            raise ValueError(
                f"request {rid}: prompt_len {prompt.size} exceeds the largest "
                f"prompt bucket {self.buckets.max_size} (buckets "
                f"{self.buckets.sizes}) — split the prompt, widen the "
                "buckets, or enable chunked_prefill"
            )
        if prompt.size > self.buckets.max_size:
            # chunked only: each chunk pads to its own bucket and writes stay
            # within the prompt's blocks, so only the raw context binds
            if prompt.size + max_new > self.max_len:
                raise ValueError(
                    f"request {rid}: prompt_len {prompt.size} + max_new "
                    f"{max_new} exceeds cache max_len {self.max_len}"
                )
        else:
            bucket = self.buckets.bucket(prompt.size)
            if max(bucket, prompt.size + max_new) > self.max_len:
                raise ValueError(
                    f"request {rid}: prompt_len {prompt.size} + max_new {max_new} "
                    f"(bucket {bucket}) exceeds cache max_len {self.max_len}"
                )
        if self.layout == "paged":
            worst = self._worst_blocks(prompt.size, max_new)
            if worst > self.num_blocks:
                raise ValueError(
                    f"request {rid}: worst-case context needs {worst} blocks but "
                    f"the pool only has {self.num_blocks} — it could never be "
                    "admitted"
                )
            if (self.prefix_sharing and not self.preempt
                    and prompt.size % self.block_size
                    and worst + 1 > self.num_blocks):
                raise ValueError(
                    f"request {rid}: prefix sharing reserves {worst} + 1 "
                    "blocks (worst case + the partial tail's potential "
                    f"copy-on-write fork) but the pool only has "
                    f"{self.num_blocks} — it could never be admitted"
                )
            # chunked, a replay prompt needs no single bucket either
            if (self.preempt and not self.chunked
                    and prompt.size + max_new - 1 > self.buckets.max_size):
                raise ValueError(
                    f"request {rid}: preemption replays prompt + accepted "
                    f"tokens through the bucketed prefill — its replay "
                    f"prompt can reach {prompt.size + max_new - 1} tokens, "
                    f"exceeding the largest prompt bucket "
                    f"{self.buckets.max_size}; widen the buckets or lower "
                    "max_new"
                )
        if req_id is not None and (
            req_id in self._completed
            or any(r.req_id == req_id for _, _, r in self._pending)
            or any(r.req_id == req_id for _, _, r in self._ready)
            or any(s is not None and s.req.req_id == req_id for s in self._active)
        ):
            raise ValueError(f"req_id {req_id} already in use")
        self._next_id = max(self._next_id, rid) + 1
        req = Request(rid, prompt, int(max_new), int(priority), int(arrival), tier)
        self._submit_t[rid] = time.perf_counter()
        if req.arrival > self.clock:
            heapq.heappush(self._pending, (req.arrival, self._seq, req))
            self._seq += 1
        else:
            self._push_ready(req)
        return rid

    def _ready_key(self, req: Request, eff_len: Optional[int] = None) -> int:
        """Admission-order key under the session policy (ties FIFO by
        submission).  SJF ranks the EFFECTIVE prompt: a preempted request
        is admitted again by replaying prompt + accepted tokens, so its
        cost is the replay's bucket (``_pick_victim`` passes the would-be
        replay length of a resident row the same way)."""
        if self.policy == "sjf":
            if eff_len is None:
                eff_len = int(self._eff_prompt(req).size)
            return req.max_new + self._prefill_cost(eff_len)
        if self.policy == "fifo":
            return 0
        return req.priority

    def _push_ready(self, req: Request) -> None:
        heapq.heappush(self._ready, (self._ready_key(req), self._seq, req))
        self._seq += 1

    # -- host <-> device -----------------------------------------------------

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the session's device, copied now.  On a CUDA
        device it goes through a pinned buffer by a non-blocking copy (a
        pageable copy would wait for the stream to drain); the buffer stays
        referenced until the chunk dispatched after it is harvested."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone().to(self.device)
        pinned = t.pin_memory()
        self._staged.append(pinned)
        return pinned.to(self.device, non_blocking=True)

    def _wait(self, copy: _HostCopy) -> np.ndarray:
        """Block on a device result, timed as ``host_block_s``."""
        tb = time.perf_counter()
        out = copy.wait()
        self.stats.host_block_s += time.perf_counter() - tb
        return out

    # -- admission -----------------------------------------------------------

    def _note_peak_blocks(self) -> None:
        st = self.stats
        st.peak_blocks_in_use = max(st.peak_blocks_in_use, self.blocks.busy_count)
        st.peak_block_bytes_per_device = st.peak_blocks_in_use * self._block_bytes_dev

    def _worst_blocks(self, prompt_len: int, max_new: int) -> int:
        """Blocks the request could ever hold: its last cache write lands at
        position ``prompt_len + max_new - 2`` (the final sampled token is
        output, never written)."""
        return -(-(prompt_len + max_new - 1) // self.block_size)

    # -- chunked-prefill planning ----------------------------------------------

    def _chunks_prefill(self, eff_len: int) -> bool:
        """Whether a prompt of this effective length takes the chunked path;
        one that fits one chunk keeps the one-shot ``_admit_many``, the
        dispatch an unchunked session makes."""
        return self.chunked and eff_len > self.prefill_chunk

    def _chunk_spans(self, eff_len: int) -> List[int]:
        """The chunk plan: ``prefill_chunk``-wide spans and a remainder,
        each dispatched at its own bucket."""
        spans, pos = [], 0
        while pos < eff_len:
            s = min(self.prefill_chunk, eff_len - pos)
            spans.append(s)
            pos += s
        return spans

    def _prefill_cost(self, eff_len: int) -> int:
        """Bucketed prefill tokens this prompt charges in all: its one-shot
        bucket, or the sum of its chunks' buckets (SJF's key and victim
        choice; defined past ``buckets.max_size`` when chunking)."""
        if not self._chunks_prefill(eff_len):
            return self.buckets.bucket(eff_len)
        return sum(self.buckets.bucket(s) for s in self._chunk_spans(eff_len))

    def _head_charge(self, eff_len: int) -> int:
        """Tokens the interleaving budget charges when this request is
        admitted THIS step: its first chunk's bucket when chunked (later
        chunks are charged step by step as they resume), else its whole
        one-shot bucket."""
        if self._chunks_prefill(eff_len):
            return self.prefill_chunk
        return self.buckets.bucket(eff_len)

    # -- prefix sharing and preemption -----------------------------------------

    def _eff_prompt(self, req: Request) -> np.ndarray:
        """The prompt an admission prefills: the original prompt, extended
        by the accepted tokens snapshotted at preemption (the replay; under
        the positional key schedule its samples are the uninterrupted
        run's)."""
        resume = self._preempt_resume.get(req.req_id)
        if resume is None:
            return req.prompt
        return np.concatenate([req.prompt, np.asarray(resume[0], np.int32)]).astype(np.int32)

    def _reclaimable_blocks(self) -> int:
        """Published blocks held ONLY by the prefix cache (refcount 1):
        evictable on demand, so admission may count them as free."""
        if self._prefix is None:
            return 0
        return sum(1 for b in self._prefix.lru_blocks() if self.blocks.refcount(b) == 1)

    def _reclaim_cache_block(self) -> bool:
        """Evict the least recently used cache-only published block back to
        the free heap; False when every published block is still shared
        with a resident request."""
        if self._prefix is None:
            return False
        for b in self._prefix.lru_blocks():
            if self.blocks.refcount(b) == 1:
                self._prefix.drop_block(b)
                self.blocks.release(b)              # the cache's own reference
                return True
        return False

    def _pick_victim(self, excl_slot: int) -> Optional[_ActiveSlot]:
        """Preemption victim: the least important resident row — highest
        policy key (ranked on its replay length), then youngest admission,
        then highest request id — other than the row that needs the
        block."""
        best, best_key = None, None
        for state in self._active:
            if (state is None or state.done or state.released or state.preempted
                    or state.slot == excl_slot):
                continue
            key = (self._ready_key(state.req,
                                   eff_len=state.req.prompt.size + len(state.tokens)),
                   state.admitted_tick, state.req.req_id)
            if best_key is None or key > best_key:
                best, best_key = state, key
        return best

    def _preempt(self, state: _ActiveSlot) -> None:
        """Evict ``state`` mid-decode: snapshot its accepted tokens (and its
        first admission tick and TTFT, so each is counted once) for the
        replay, free its blocks (shared ones lose one reference; its table
        row goes to the sentinel, so a chunk still in flight writes through
        the copy it was dispatched with, ahead of any later owner's writes
        on the same stream), and queue the request again."""
        state.preempted = True
        # a mid-prefill victim (chunked path, TTFT not yet sampled) samples
        # its TTFT at the replay's final chunk
        self._preempt_resume[state.req.req_id] = (list(state.tokens), state.admitted_tick,
                                                  state.tier_idx, state.ttft)
        self._release_resources(state)
        self._push_ready(state.req)
        self.stats.preemptions += 1

    def _acquire_block(self, requesting_slot: int) -> int:
        """One block for ``requesting_slot``: from the free heap, else by
        reclaiming a cache-only published block, else (preemption on) by
        evicting other resident rows until one frees.  ``submit`` bounds
        every worst case by ``num_blocks``, so once every other row is
        evicted and every cache-only block reclaimed, the pool can fund the
        request."""
        b = self.blocks.acquire()
        if b is not None:
            return b
        while self._reclaim_cache_block():
            b = self.blocks.acquire()
            if b is not None:
                return b
        if not self.preempt:
            raise AssertionError("block append failed despite reservation")
        while True:
            victim = self._pick_victim(requesting_slot)
            if victim is None:
                raise AssertionError(
                    "block pool exhausted with no victim left — submit's "
                    "worst-case bound should make this unreachable"
                )
            self._preempt(victim)
            while self._reclaim_cache_block():
                pass
            b = self.blocks.acquire()
            if b is not None:
                return b

    def _admit_block(self) -> int:
        """One block for an admission row.  Never preempts: admission was
        gated on free + reclaimable blocks (preemption) or on the
        reservation, so the free heap and cache reclaim fund it."""
        b = self.blocks.acquire()
        while b is None and self._reclaim_cache_block():
            b = self.blocks.acquire()
        assert b is not None, "admission admitted an unfundable request"
        return b

    def _cow_guard(self, slot: int, idx: int) -> None:
        """Copy-on-write: before a dispatch writes held block ``idx`` of
        ``slot``, make it private and unpublished.  Its publication goes
        first (the content is about to diverge from its key); if another
        row still shares it, this row forks a private copy
        (``cache.copy_block``, queued on the current stream ahead of the
        dispatch).  ``_chunk_inputs`` guards every block of the chunk's
        write span; a private index is a no-op."""
        held = self._held[slot]
        if idx >= len(held):
            return                              # the next write opens a fresh block
        b = held[idx]
        if self._prefix is not None and self._prefix.holds_block(b):
            self._prefix.drop_block(b)
            self.blocks.release(b)              # the cache's reference
        if self.blocks.refcount(b) <= 1:
            return                              # sole owner: write in place
        nb = self._acquire_block(slot)
        C.copy_block(self.cache, b, nb)
        self.blocks.release(b)                  # this row's shared reference
        held[idx] = nb
        self._tables[slot, idx] = nb
        self.stats.cow_forks += 1
        if not self.preempt:
            # the fork spends the +1 reserve _admit_many funded for a
            # shared tail, which keeps appends infallible
            self._future[slot] -= 1
            self._reserved_total -= 1

    def _admit_width(self, n: int) -> int:
        """Admission rows pad to a power of two (capped at ``num_slots``)."""
        w = 1
        while w < n:
            w <<= 1
        return min(w, self.num_slots)

    def _prefill_budget(self) -> float:
        """Bucketed prompt tokens this step may admit under the interleaving
        policy: unlimited without a policy, and while no decode is resident
        (nothing to starve, and the queue must drain; mid-prefill rows do
        not decode)."""
        if self.prefill_decode_ratio is None and self.prefill_token_budget is None:
            return float("inf")
        if self.n_decoding == 0:
            return float("inf")
        if self.prefill_token_budget is not None:
            return float(self.prefill_token_budget)
        return self.prefill_decode_ratio * self.n_decoding * self.steps_per_tick

    def _pop_admissible(self, budget: float = float("inf")
                        ) -> Tuple[List[Request], float, bool]:
        """Pop ready requests that fit the free slots, (paged) the block
        pool, and the prefill-token ``budget``.  Without preemption a
        request's worst case (+1 for a shared partial tail's fork under
        prefix sharing) must fit what the pool can still promise (``free -
        reserved``, after evicting cache-only blocks) and is reserved on
        the spot; with preemption its prompt's immediate need (a chunked
        admission's: its first chunk's blocks) must fit the free plus
        reclaimable blocks.  The budget is charged ``_head_charge``.  The
        queue head blocks admission when it does not fit (no skip-ahead),
        so policy order holds.  Returns ``(batch, remaining budget,
        stalled)``, ``stalled`` meaning the head was deferred by the budget
        alone."""
        batch: List[Request] = []
        stalled = False
        pending_need = 0
        reclaimable = (self._reclaimable_blocks()
                       if self.layout == "paged" and self.preempt else 0)
        while self._ready and len(batch) < self.pool.free_count:
            req = self._ready[0][2]
            eff_len = int(self._eff_prompt(req).size)
            worst = need = 0
            if self.layout == "paged":
                if self.preempt:
                    head = (min(eff_len, self.prefill_chunk)
                            if self._chunks_prefill(eff_len) else eff_len)
                    need = -(-head // self.block_size)
                    if pending_need + need > self.blocks.free_count + reclaimable:
                        break
                else:
                    worst = self._worst_blocks(req.prompt.size, req.max_new)
                    if self._prefix is not None and eff_len % self.block_size:
                        worst += 1
                    while (worst > self.blocks.free_count - self._reserved_total
                           and self._reclaim_cache_block()):
                        pass
                    if worst > self.blocks.free_count - self._reserved_total:
                        break
            charge = self._head_charge(eff_len)
            if charge > budget:
                stalled = True
                break
            if self.layout == "paged":
                pending_need += need
                self._reserved_total += worst
            budget -= charge
            heapq.heappop(self._ready)
            batch.append(req)
        return batch, budget, stalled

    def _prefill(self, cfg: ModelConfig, prompts, prompt_lens, req_ids, seat) -> torch.Tensor:
        """One prefill of an admission batch under ``cfg`` (a tier session's
        rung): seed each row's cache and sample its first token (at
        position ``prompt_len``); (A,) tokens on the device.  ``seat`` is
        the paged layout's (A, nb) block ids, or the slot layout's (slots,
        valid): rows to write and which of them are real (the others
        rewrite what they hold, ``cache.scatter_rows``).  Attention
        families prefill fused (``forward(return_kv=True)``); ssm and
        hybrid teacher-force (``_prefill_decode``)."""
        dev = self.device
        lens = self._h2d(prompt_lens).long()
        if self.prefill_mode == "decode":
            last = self._prefill_decode(cfg, self._h2d(prompts), lens, *seat)
        else:
            logits, kvs = forward(cfg, self.params, self._h2d(prompts), return_kv=True)
            last = logits[torch.arange(len(prompt_lens), device=dev), lens - 1]
            if self.layout == "paged":
                C.scatter_prompt_blocks(self.cache, kvs, self._h2d(seat), self.block_size)
            else:
                slots, valid = seat
                for name, part in zip(("k", "v"), kvs):
                    C.scatter_rows(self.cache[name], part, slots, valid,
                                   s_cap=prompts.shape[1])
        return select_token(last, self.sampling, seed=self.seed,
                            req_ids=self._h2d(req_ids), positions=lens)

    def _prefill_decode(self, cfg: ModelConfig, prompts: torch.Tensor, lens: torch.Tensor,
                        slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The teacher-forced admission of the ssm and hybrid families (the
        JAX package's ``_admit_decode``): the bucket's positions one at a
        time through ``decode_step`` on a fresh batch-A cache, each row's
        state (every leaf) frozen once ``t >= prompt_len``, then every row
        scattered into its slot.  Returns each row's logits at ``t ==
        prompt_len - 1``, (A, Vp); nothing waits on the device."""
        A, Sb = prompts.shape
        part = init_cache(cfg, A, self.max_len, self.cache_dtype, device=self.device)
        last = torch.zeros((A, cfg.padded_vocab), dtype=torch.float32, device=self.device)
        for t in range(Sb):
            logits = decode_step(cfg, self.params, part, prompts[:, t:t + 1],
                                 torch.full((A,), t, dtype=torch.long, device=self.device),
                                 write_rows=t < lens)
            last = torch.where((t == lens - 1)[:, None], logits[:, 0], last)
        for name, leaf in part.items():
            C.scatter_rows(self.cache[name], leaf, slots, valid)
        return last

    def _admit_many(self, reqs: List[Request], tier_idx: int = 0) -> None:
        """Admit ``reqs`` with ONE prefill: effective prompts (a replayed
        victim's prompt + accepted tokens) pad to the batch's largest
        bucket, rows to the admission width (padding rows: prompt of
        ``pad_id``, length 1).  Paged: each request acquires its prompt's
        blocks, converting that much of its reservation, and the padding
        rows' block ids are all the sentinel, so their writes go to the
        trash block.  Under prefix sharing a rolling-key walk over the
        prompt's blocks maps each block already published into the table
        and leaves its block id at the sentinel (the full-shape prefill's
        writes for that span land in the trash block); a miss acquires,
        writes and publishes — before the next request of the batch walks,
        so batch-mates share too.  Slots: the padding rows take distinct
        free slots and rewrite what those hold.  On a tier session the
        batch shares the effective rung ``tier_idx`` (``_admit_phase``
        groups by rung) and prefills under that rung's config, and each
        rung's prefix chain starts from its own root (a block's K/V is
        rung-specific).  The sync loop then waits for the first tokens; the
        async loop merges them into the device carry and reads them at the
        next harvest."""
        acfg = self._tier_cfgs[tier_idx] if self.tiers is not None else self.cfg
        A = self._admit_width(len(reqs))
        effs = [self._eff_prompt(r) for r in reqs]
        bucket = max(self.buckets.bucket(e.size) for e in effs)
        prompts = np.full((A, bucket), self.pad_id, np.int32)
        prompt_lens = np.ones((A,), np.int32)
        req_ids = np.zeros((A,), np.int64)
        row_slot = [self.pool.acquire() for _ in reqs]
        for i, req in enumerate(reqs):
            prompts[i, :effs[i].size] = effs[i]
            prompt_lens[i] = effs[i].size
            req_ids[i] = req.req_id
        # valid rows -> their acquired slots; padding rows -> distinct other
        # slots, which rewrite what they gather
        rest = [s for s in range(self.num_slots) if s not in row_slot]
        slots = np.asarray((row_slot + rest)[:A], np.int64)
        valid = np.arange(A) < len(reqs)
        if self.layout == "paged":
            bs = self.block_size
            seat = np.full((A, -(-bucket // bs)), self.num_blocks, np.int32)
            for i, req in enumerate(reqs):
                slot, eff = row_slot[i], effs[i]
                plen = int(eff.size)
                ninit = -(-plen // bs)
                held: List[int] = []
                parent = C.PrefixCache.ROOT - tier_idx
                for j in range(ninit):
                    hit = None
                    if self._prefix is not None:
                        parent = self._prefix.key(parent, eff[j * bs:(j + 1) * bs])
                        hit = self._prefix.lookup(parent)
                    if hit is not None:
                        self.blocks.share(hit)
                        held.append(hit)
                        self.stats.prefix_hit_blocks += 1
                        continue
                    b = self._admit_block()
                    seat[i, j] = b
                    held.append(b)
                    if self._prefix is not None:
                        self.blocks.share(b)        # the cache's reference
                        self._prefix.insert(parent, b)
                self._held[slot] = held
                self._tables[slot, :] = self.num_blocks
                self._tables[slot, :ninit] = held
                if not self.preempt:
                    # a shared partial tail's eventual fork spends one
                    # reserved block, funded by _pop_admissible's +1
                    fork_reserve = int(self._prefix is not None and plen % bs != 0)
                    self._future[slot] = (self._worst_blocks(req.prompt.size, req.max_new)
                                          - ninit + fork_reserve)
                    self._reserved_total -= ninit      # reservation -> held
            self._note_peak_blocks()
        else:
            seat = (self._h2d(slots), self._h2d(valid))
        tok0s = self._prefill(acfg, prompts, prompt_lens, req_ids, seat)
        self.stats.admit_calls += 1
        # each request is charged its own effective bucket (a replay's is
        # its longer replay prompt's)
        self._charge_prefill([self.buckets.bucket(e.size) for e in effs])

        if self.loop == "async":
            slots_d = seat[0] if self.layout == "slots" else self._h2d(slots)
            valid_d = seat[1] if self.layout == "slots" else self._h2d(valid)
            C.merge_admit_carry(self._lt_dev, self._req_dev, slots_d, tok0s,
                                self._h2d(req_ids), valid_d)
            if self.spec:
                C.merge_spec_len(self._cl_dev, slots_d, self._h2d(prompt_lens), valid_d)
            states = []
            for i, req in enumerate(reqs):
                slot = row_slot[i]
                self._cur_len[slot] = self._cl_true[slot] = int(prompt_lens[i])
                self._last_emit_work[slot] = self.stats.work_ticks
                state = self._admitted_state(req, slot, [], tier_idx)
                state.pending_first = True
                self._active[slot] = state
                states.append(state)
            self._pending_tok0.append((states, _HostCopy(tok0s), list(range(len(states)))))
            return

        tok0s = self._wait(_HostCopy(tok0s))
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            slot, tok0 = row_slot[i], int(tok0s[i])
            self._last_token[slot] = tok0
            self._cur_len[slot] = int(prompt_lens[i])
            self._slot_req[slot] = req.req_id
            self._last_emit_work[slot] = self.stats.work_ticks
            state = self._admitted_state(req, slot, [], tier_idx)
            self._active[slot] = state
            self._take_first(state, tok0, now)

    def _charge_prefill(self, buckets: List[int]) -> None:
        """Charge one prefill dispatch's rows (each at its own bucket: a
        one-shot request's effective prompt, or one chunk) to ``prefills``,
        ``prefill_tokens`` and the work clock, whose integer carry keeps
        rounding from compounding across dispatches."""
        for b in buckets:
            self.stats.prefills[b] = self.stats.prefills.get(b, 0) + 1
        tok_sum = sum(buckets)
        self.stats.prefill_tokens += tok_sum
        self._prefill_carry += tok_sum
        self.stats.work_ticks += self._prefill_carry // self.num_slots
        self._prefill_carry %= self.num_slots

    def _take_first(self, state: _ActiveSlot, tok0: int, now: float) -> None:
        """A resident row's first sampled token reached the host: append it,
        and finish the row when that already ends it (eos, or max_new)."""
        eos = self.sampling.eos_id
        state.tokens.append(tok0)
        self.stats.generated_tokens += 1
        self._first_token_held(state.req.req_id, now)
        if len(state.tokens) >= state.req.max_new or (eos >= 0 and tok0 == eos):
            self._finish(state, "eos" if (eos >= 0 and tok0 == eos) else "length")

    def _admitted_state(self, req: Request, slot: int, first: List[int],
                        tier_idx: int = 0, *, sample_ttft: bool = True) -> _ActiveSlot:
        """The resident state of an admitted request holding ``first``, at
        rung ``tier_idx``.  A new request counts as admitted and samples its
        TTFT now (a chunked one at its final chunk: ``sample_ttft=False``);
        a replayed victim resumes with its accepted tokens, first admission
        tick and TTFT, each counted once (a victim evicted mid-prefill
        samples its TTFT on the replay that reaches a token)."""
        resume = self._preempt_resume.pop(req.req_id, None)
        if resume is not None:
            state = _ActiveSlot(req, slot, list(resume[0]) + first, resume[1],
                                tier_idx=tier_idx)
            state.ttft = resume[3]
        else:
            self.stats.admitted += 1
            state = _ActiveSlot(req, slot, first, self.clock, tier_idx=tier_idx)
        if state.ttft < 0 and sample_ttft:
            state.ttft = self.clock - req.arrival
            self.stats.ttft_ticks.append(state.ttft)
        self._slot_tier[slot] = tier_idx
        self._bump_tier_gauge(tier_idx, +1)
        return state

    def _bump_tier_gauge(self, tier_idx: int, delta: int) -> None:
        """The ``active_per_tier`` residency gauge (tier sessions only): +1
        at each admission, -1 at each release, exactly once by the
        ``state.released`` discipline of the resources."""
        if self.tiers is None:
            return
        self._tier_active_counts[tier_idx] += delta
        self.stats.active_per_tier = {t: int(c) for t, c in
                                      zip(self.tiers, self._tier_active_counts)}

    def _first_token_held(self, req_id: int, now: float) -> None:
        """``ttft_s``: a request's first token reached the host (a replay's
        first token again does not count)."""
        t = self._submit_t.pop(req_id, None)
        if t is not None:
            self.stats.ttft_s.append(now - t)

    def _release_resources(self, state: _ActiveSlot) -> None:
        """Free the slot and (paged) every held block and the unused
        remainder of the worst-case reservation, or (slots, with
        ``zero_on_evict``) zero the slot's stripe — exactly once
        (``state.released``).  Stale cache contents are invisible: a block
        or stripe re-enters attention only after its next owner's writes."""
        state.released = True
        self._bump_tier_gauge(state.tier_idx, -1)
        if state.prefilling:
            # a mid-prefill victim leaves the resume queue with its slot; the
            # replay restarts its chunk plan from position 0
            self._prefilling = [s for s in self._prefilling if s is not state]
        slot = state.slot
        if self._active[slot] is state:       # a successor may already own it
            self._active[slot] = None
        self.pool.release(slot)
        if self.layout == "paged":
            self.blocks.release_many(self._held[slot])
            self._held[slot] = []
            self._tables[slot, :] = self.num_blocks
            self._reserved_total -= int(self._future[slot])
            self._future[slot] = 0
        elif self.zero_on_evict:
            C.evict_slot(self.cache, slot)

    def _finish(self, state: _ActiveSlot, reason: str) -> None:
        state.done = True
        if not state.released:
            self._release_resources(state)
        self.stats.completed += 1
        self.stats.latency_ticks.append(self.clock - state.req.arrival)
        self._just_finished.append(state.req.req_id)
        self._completed[state.req.req_id] = CompletedRequest(
            req_id=state.req.req_id,
            prompt=state.req.prompt,
            tokens=np.asarray(state.tokens, np.int32),
            finish_reason=reason,
            admitted_tick=state.admitted_tick,
            finished_tick=self.clock,
            tier=self.tiers[state.tier_idx] if self.tiers is not None else "",
            ttft=state.ttft,
        )

    def _ensure_blocks(self, slot: int, hi: int) -> None:
        """Append blocks to ``slot``'s table until it covers position
        ``hi``.  Without preemption the admission reservation makes the
        append infallible; with it, ``_acquire_block`` reclaims published
        blocks and evicts other rows until the pool funds it."""
        held = self._held[slot]
        while len(held) * self.block_size <= hi:
            b = self._acquire_block(slot)
            self._tables[slot, len(held)] = b
            held.append(b)
            if not self.preempt:
                self._future[slot] -= 1
                self._reserved_total -= 1

    # -- stepping ------------------------------------------------------------

    def _pull_arrivals(self) -> None:
        while self._pending and self._pending[0][0] <= self.clock:
            self._push_ready(heapq.heappop(self._pending)[2])

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._active)

    @property
    def n_decoding(self) -> int:
        """Resident rows that decode: a mid-prefill row (chunked path) holds
        a slot but joins no decode chunk, so it neither starves nor scales
        the interleaving budget."""
        return sum(s is not None and not s.prefilling for s in self._active)

    @property
    def drained(self) -> bool:
        return not (self._pending or self._ready or self.n_active or self._inflight)

    def _drain_finished(self) -> List[CompletedRequest]:
        done = [self._completed[i] for i in self._just_finished]
        self._just_finished.clear()
        return done

    def _eff_tier(self, req: Request) -> int:
        """The ladder rung ``req`` is admitted at NOW: its requested rung,
        demoted to the shed level when that is further down the ladder.  A
        preemption victim replays at the rung it was first admitted at (its
        accepted tokens came from that rung)."""
        resume = self._preempt_resume.get(req.req_id)
        if resume is not None:
            return resume[2]
        want = self.tiers.index(req.tier) if req.tier is not None else 0
        return max(want, self._shed_level)

    def _group_by_tier(self, batch: List[Request]) -> List[Tuple[int, List[Request]]]:
        """An admission batch split by effective rung (admission order kept
        within a group, groups in ladder order): each group prefills under
        its own rung's config in one dispatch."""
        groups: Dict[int, List[Request]] = {}
        for r in batch:
            groups.setdefault(self._eff_tier(r), []).append(r)
        return sorted(groups.items())

    def _admit_phase(self) -> None:
        """Admit ready requests in policy order, subject to free slots,
        (paged) the block-pool reservation, and the interleaving budget
        shared across every admission batch of this step.  Chunked prefill:
        resident mid-prefill rows spend the budget FIRST (oldest first, no
        skip-ahead; a stalled resident chunk closes admission for the
        step), so every started prefill finishes before new prompts open."""
        budget = self._prefill_budget()
        stalled = False
        if self._prefilling:
            budget, stalled = self._resume_chunks(budget)
        while not stalled and self._ready and self.pool.free_count:
            batch, budget, stalled = self._pop_admissible(budget)
            if not batch:
                break                 # head does not fit the pool or budget yet
            if self.tiers is not None:
                for t, group in self._group_by_tier(batch):
                    self._admit_many(group, tier_idx=t)
                continue
            chunked = [r for r in batch
                       if self._chunks_prefill(int(self._eff_prompt(r).size))]
            oneshot = [r for r in batch if r not in chunked]
            if oneshot:
                self._admit_many(oneshot)
            if chunked:
                # the first chunk goes out the step the budget was charged
                # for it (_head_charge); later chunks resume above
                self._dispatch_chunks([self._start_chunked(r) for r in chunked])
        if stalled:
            self.stats.prefill_stall_ticks += 1
        self.stats.peak_active = max(self.stats.peak_active, self.n_active)

    # -- chunked prefill -------------------------------------------------------

    def _resume_chunks(self, budget: float) -> Tuple[float, bool]:
        """Dispatch the next chunk of every resident mid-prefill row the
        budget covers, in start order (no skip-ahead: a stalled head blocks
        younger rows' chunks, which bounds each prefill's finish).  One
        chunk per row per step: decode interleaves between chunks."""
        rows: List[_ActiveSlot] = []
        stalled = False
        for state in list(self._prefilling):
            b = self.buckets.bucket(min(self.prefill_chunk,
                                        state.prefill_len - state.prefill_pos))
            if b > budget:
                stalled = True
                break
            budget -= b
            rows.append(state)
        if rows:
            self._dispatch_chunks(rows)
        return budget, stalled

    def _start_chunked(self, req: Request) -> _ActiveSlot:
        """Make a chunked admission resident without prefilling anything
        yet: acquire the slot, set its table row to the sentinel (blocks
        come chunk by chunk in ``_dispatch_chunks``) and queue the row for
        its chunks with its cursor at 0.  Without preemption the worst-case
        reservation ``_pop_admissible`` took stays whole in ``_future`` and
        ``_ensure_blocks`` converts it block by block."""
        eff = self._eff_prompt(req)
        slot = self.pool.acquire()
        self._tables[slot, :] = self.num_blocks
        self._held[slot] = []
        self._cur_len[slot] = self._cl_true[slot] = 0
        self._last_emit_work[slot] = self.stats.work_ticks
        if not self.preempt:
            self._future[slot] = self._worst_blocks(req.prompt.size, req.max_new)
        # a replayed victim's accepted tokens are in its effective prompt AND
        # its token list: the final chunk's sampled token appends after them
        state = self._admitted_state(req, slot, [], sample_ttft=False)
        state.prefill_pos, state.prefill_len, state.eff_prompt = 0, int(eff.size), eff
        self._active[slot] = state
        self._prefilling.append(state)
        return state

    def _dispatch_chunks(self, rows: List[_ActiveSlot]) -> None:
        """ONE ``_prefill_chunk`` advancing every row of ``rows`` by its
        next chunk: rows pad to ``num_slots``, chunks to their largest
        bucket; each row reads its prefix through its table and writes this
        chunk's K/V into blocks ensured first.  A row whose chunk ends its
        prompt samples its first token and joins the decode set; for the
        others the sampled token is ignored.  A row evicted by another
        row's block append in this very dispatch (preemption) keeps an
        all-sentinel table here, its writes landing in the trash block.

        The JAX package pads to the admission width; here every dispatch
        has ``num_slots`` rows, because the pass attends each position
        through batched products whose rounding on the card follows the
        batch's row count (cuBLAS picks its kernel by it).  At a fixed width
        a row's chunk K/V and first token depend neither on the rows
        sharing its dispatch nor on where the chunk boundaries fall (the
        pass runs per position)."""
        A = self.num_slots
        clens = [min(self.prefill_chunk, s.prefill_len - s.prefill_pos) for s in rows]
        cb = max(self.buckets.bucket(c) for c in clens)
        for state, clen in zip(rows, clens):
            if not (state.released or state.preempted):
                self._ensure_blocks(state.slot, state.prefill_pos + clen - 1)
        self._note_peak_blocks()
        live = [(i, s, c) for i, (s, c) in enumerate(zip(rows, clens))
                if not (s.released or s.preempted)]
        toks = np.full((A, cb), self.pad_id, np.int32)
        starts = np.zeros((A,), np.int64)
        chunk_lens = np.ones((A,), np.int64)
        req_ids = np.zeros((A,), np.int64)
        tables = np.full((A, self.table_width), self.num_blocks, np.int32)
        for i, state, clen in live:
            pos = state.prefill_pos
            toks[i, :clen] = state.eff_prompt[pos:pos + clen]
            starts[i], chunk_lens[i], req_ids[i] = pos, clen, state.req.req_id
            tables[i] = self._tables[state.slot]
        tok0s = _prefill_chunk(
            self.cfg, self.params, self.cache, self._h2d(toks), self._h2d(starts),
            self._h2d(chunk_lens), self._h2d(tables), self._h2d(req_ids),
            sampling=self.sampling, seed=self.seed, block_size=self.block_size,
        )
        # each chunk is charged its own bucket, so the work clock (and the
        # starvation gauge) meters what the device ran this step
        self._charge_prefill([self.buckets.bucket(c) for _, _, c in live])
        self.stats.prefill_chunks += len(live)
        finals: List[Tuple[int, _ActiveSlot]] = []
        for i, state, clen in live:
            state.prefill_pos += clen
            self._cur_len[state.slot] = self._cl_true[state.slot] = state.prefill_pos
            if not state.prefilling:
                finals.append((i, state))
        for _, state in finals:
            self._prefilling.remove(state)
            self._last_emit_work[state.slot] = self.stats.work_ticks
            if state.ttft < 0:
                state.ttft = self.clock - state.req.arrival
                self.stats.ttft_ticks.append(state.ttft)
        if not finals:
            return
        if self.loop == "async":
            # merge ONLY the final rows' first tokens into the device carry;
            # the other rows borrow distinct unclaimed slot ids with
            # valid False (an exact no-op, see merge_admit_carry)
            final_slot = {i: s.slot for i, s in finals}
            rest = [s for s in range(self.num_slots) if s not in final_slot.values()]
            slots = np.asarray([final_slot[i] if i in final_slot else rest.pop()
                                for i in range(A)], np.int64)
            valid = np.asarray([i in final_slot for i in range(A)])
            C.merge_admit_carry(self._lt_dev, self._req_dev, self._h2d(slots), tok0s,
                                self._h2d(req_ids), self._h2d(valid))
            for _, s in finals:
                s.pending_first = True
            self._pending_tok0.append(([s for _, s in finals], _HostCopy(tok0s),
                                       [i for i, _ in finals]))
            return
        tok0s = self._wait(_HostCopy(tok0s))
        now = time.perf_counter()
        for i, state in finals:
            tok0 = int(tok0s[i])
            self._last_token[state.slot] = tok0
            self._slot_req[state.slot] = state.req.req_id
            self._take_first(state, tok0, now)

    def _decode_states(self) -> List[Optional[_ActiveSlot]]:
        """The rows a decode chunk serves: ``_active`` with mid-prefill rows
        as ``None`` (their table rows are scrubbed at dispatch, and every
        acceptance and advance loop then skips them as it skips empty
        slots)."""
        return [None if (s is not None and s.prefilling) else s for s in self._active]

    def _chunk_inputs(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The active-row mask and (paged) this chunk's block tables, grown
        to cover every position the chunk could write an ACCEPTED token to
        (a decode chunk's last lands at ``cur_len + steps_per_tick - 1``, a
        speculative tick's verify writes through ``cur_len + draft_k``;
        overshoot past ``max_new`` targets sentinel entries and lands in
        the trash block).  Under prefix sharing every block of the write
        span is made private first (``_cow_guard``): K2 and the verify pass
        write the pool in place, so a shared block written here would
        corrupt its sharers.  A speculative async chunk may write anywhere
        from the last harvested length ``_cl_true`` on.  Forks and appends
        may preempt other rows (preemption on); the mask is taken after
        them, and a victim's table row is already the sentinel.  A
        mid-prefill row (chunked) is left out of the mask, and its row of
        the tables' copy is scrubbed to the sentinel: the decode step
        writes every row at its ``cur_len``, which would land in the prompt
        K/V its table already holds."""
        if self.layout != "paged":
            return np.asarray([s is not None for s in self._active], bool), None
        span = self._draft_k_eff if self.spec else self.steps_per_tick - 1
        bs = self.block_size
        for slot, state in enumerate(self._active):
            if state is None or state.prefilling:
                continue
            hi = min(int(self._cur_len[slot]) + span,
                     state.req.prompt.size + state.req.max_new - 2)
            if self._prefix is not None:
                lo = int(self._cl_true[slot] if self.spec and self.loop == "async"
                         else self._cur_len[slot])
                for idx in range(lo // bs, hi // bs + 1):
                    self._cow_guard(slot, idx)
            self._ensure_blocks(slot, hi)
        self._note_peak_blocks()
        active = np.asarray([s is not None and not s.prefilling for s in self._active], bool)
        tables = self._tables.copy()
        for slot, state in enumerate(self._active):
            if state is not None and state.prefilling:
                tables[slot] = self.num_blocks
        return active, tables

    def _dispatch(self, active, tables, last_token, slot_req):
        """Issue one decode chunk; (toks (steps, N), last token) on the
        device.  ``cur_len`` is copied now, since the host advances it
        while the chunk is in flight.  A tier session issues one chunk per
        rung holding active rows (``_dispatch_tiers``)."""
        if self.tiers is not None:
            return self._dispatch_tiers(active, tables, last_token, slot_req)
        return self._decode(self.cfg, active, tables, self._cur_len, last_token, slot_req)

    def _decode(self, cfg, active, tables, cur_len, last_token, slot_req):
        return _decode_tick(
            cfg, self.params, self.cache, last_token, self._h2d(cur_len),
            self._h2d(active), slot_req, None if tables is None else self._h2d(tables),
            sampling=self.sampling, seed=self.seed, steps=self.steps_per_tick,
            block_size=self.block_size if tables is not None else 0,
            attn_impl=self.attn_impl,
        )

    def _dispatch_tiers(self, active, tables, last_token, slot_req):
        """One ``_decode_tick`` per ladder rung holding active rows, in
        ladder order, chaining the last-token carry through them.  Each
        dispatch masks ``active`` to its rung's rows and makes the other
        rungs' rows write-inert: paged, their rows of the dispatch's table
        copy are scrubbed to the sentinel (writes land in the trash block;
        K2 and its plain version give an empty row exactly 0); slots, their
        ``cur_len`` is pinned to ``max_len``, the stripe's trash column.
        ``_decode_tick`` zeroes inactive rows' tokens and keeps their carry,
        so the rung parts merge by elementwise sum (on the device, before
        the one copy to the host)."""
        toks = None
        for t, tcfg in enumerate(self._tier_cfgs):
            mask = active & (self._slot_tier == t)
            if not mask.any():
                continue
            if tables is not None:
                tb, cl = tables.copy(), self._cur_len
                tb[~mask] = self.num_blocks
            else:
                tb, cl = None, np.where(mask, self._cur_len, self.max_len).astype(np.int32)
            part, last_token = self._decode(tcfg, mask, tb, cl, last_token, slot_req)
            toks = part if toks is None else toks + part
        return toks, last_token

    def _dispatch_spec(self, active, tables, last_token, cur_len, slot_req):
        """Issue one speculative tick at the current draft window; returns
        (the tick's tokens with each row's accepted count as their last row
        (draft_k + 2, N), last token, cur_len), on the device."""
        toks, n_acc, last_token, cur_len = _spec_tick(
            self.cfg, self.draft_cfg, self.params, self.cache, last_token, cur_len,
            self._h2d(active), slot_req, self._h2d(tables), sampling=self.sampling,
            seed=self.seed, draft_k=self._draft_k_eff, block_size=self.block_size,
            attn_impl=self.attn_impl,
        )
        return torch.cat([toks, n_acc[None]]), last_token, cur_len

    def _accept_chunk(self, states: List[Optional[_ActiveSlot]], toks: np.ndarray,
                      steps: int, work_end: int) -> None:
        """Accept a fetched chunk's tokens for the rows that were live at its
        dispatch: each row takes tokens until it finishes (eos / max_new)
        and discards the bounded overshoot; rows whose completion was
        discovered after the dispatch (``state.done``) and preempted rows
        (the replay regenerates their tokens) contribute only idle steps.
        Updates the busy/idle accounting and the starvation gauge
        (``work_end`` is the chunk's position on the work clock)."""
        eos = self.sampling.eos_id
        accepted = 0
        for slot, state in enumerate(states):
            if state is None or state.done or state.preempted:
                continue
            # a predictively released row may already have a successor in
            # its slot; leave the successor's emission mark alone
            early = state.released
            for s in range(steps):
                tok = int(toks[s, slot])
                state.tokens.append(tok)
                accepted += 1
                if eos >= 0 and tok == eos:
                    self._finish(state, "eos")
                    break
                if len(state.tokens) >= state.req.max_new:
                    self._finish(state, "length")
                    break
            if not early:
                gap = int(work_end - self._last_emit_work[slot])
                self.stats.max_decode_gap_ticks = max(self.stats.max_decode_gap_ticks, gap)
                self._last_emit_work[slot] = work_end
        self.stats.busy_slot_steps += accepted
        self.stats.idle_slot_steps += self.num_slots * steps - accepted
        self.stats.generated_tokens += accepted

    def _accept_spec_chunk(self, states: List[Optional[_ActiveSlot]], toks: np.ndarray,
                           n_acc: np.ndarray, work_end: int, draft_k: int) -> None:
        """``_accept_chunk`` for a speculative tick: each live row takes its
        own ``n_acc`` tokens (1..draft_k+1), finishing on eos / max_new as a
        sequential decode would.  A tick's capacity is ``num_slots *
        (draft_k + 1)`` token-slots.  The accept counters count the drafted
        tokens the verifier kept (``n_acc - 1``, clipped to what the row
        could still emit, so the end of a request never inflates the
        readout); ``draft_k`` is the window the tick was dispatched with,
        and each live row also feeds the rolling window of
        ``dynamic_draft_k``."""
        eos = self.sampling.eos_id
        accepted = 0
        for slot, state in enumerate(states):
            if state is None or state.done or state.preempted:
                continue
            early = state.released
            na = int(n_acc[slot])
            self.stats.verify_calls += 1
            self.stats.draft_tokens += draft_k
            emitted = 0
            for s in range(na):
                tok = int(toks[s, slot])
                state.tokens.append(tok)
                emitted += 1
                if eos >= 0 and tok == eos:
                    self._finish(state, "eos")
                    break
                if len(state.tokens) >= state.req.max_new:
                    self._finish(state, "length")
                    break
            accepted += emitted
            kept = max(0, min(na - 1, emitted))
            self.stats.accepted_tokens += kept
            if self.dynamic_draft:
                self._accept_hist.append((draft_k, kept))
            if not early:
                gap = int(work_end - self._last_emit_work[slot])
                self.stats.max_decode_gap_ticks = max(self.stats.max_decode_gap_ticks, gap)
                self._last_emit_work[slot] = work_end
        self.stats.busy_slot_steps += accepted
        self.stats.idle_slot_steps += self.num_slots * (draft_k + 1) - accepted
        self.stats.generated_tokens += accepted
        if self.dynamic_draft:
            self._update_draft_k()

    def _update_draft_k(self) -> None:
        """The ``dynamic_draft_k`` rule, for the NEXT dispatch.  A drafted
        token costs ``1 / draft_cost_ratio`` of a verified one, so drafting
        pays when the accept rate reaches that break-even.  Over a full
        rolling window of (drafted, accepted) pairs: strictly below it,
        halve the window (one rung down the ladder); at or above it, grow
        one rung back.  The window clears on every move, so each rung is
        judged on a full window of its own ticks."""
        if len(self._accept_hist) < self.draft_window:
            return
        drafted = sum(d for d, _ in self._accept_hist)
        acc = sum(a for _, a in self._accept_hist)
        if not drafted:
            return
        rate = acc / drafted
        i = self._draft_ks.index(self._draft_k_eff)
        if rate < 1.0 / self.draft_cost_ratio and i + 1 < len(self._draft_ks):
            self._draft_k_eff = self._draft_ks[i + 1]
            self.stats.draft_k_shrinks += 1
            self._accept_hist.clear()
        elif rate >= 1.0 / self.draft_cost_ratio and i > 0:
            self._draft_k_eff = self._draft_ks[i - 1]
            self.stats.draft_k_grows += 1
            self._accept_hist.clear()
        self.stats.draft_k_current = self._draft_k_eff

    # -- quality tiers: the load shedder ---------------------------------------

    def _current_decode_gap(self) -> int:
        """The LIVE starvation signal: the worst work-tick gap since a
        resident decoding row's latest accepted token
        (``max_decode_gap_ticks`` is its high-water mark, which cannot show
        recovery).  Mid-prefill rows have not emitted yet; TTFT meters
        them."""
        g = 0
        for slot, state in enumerate(self._active):
            if state is None or state.done or state.released or state.prefilling:
                continue
            g = max(g, int(self.stats.work_ticks - self._last_emit_work[slot]))
        return g

    def _update_shed(self) -> None:
        """Load-adaptive shedding, once per step before admission.  A breach
        (ready-queue depth above ``shed_queue_depth``, or the live decode
        gap above ``shed_gap_ticks``) raises the shed level one rung; new
        admissions then serve at ``max(requested, level)``.  The level drops
        one rung only after ``shed_hold_steps`` CONSECUTIVE steps below
        ``shed_restore_fraction`` of the thresholds, and that count clears
        on every level change and every unhealthy step, so the level cannot
        flap."""
        if not self._shed_on:
            return
        depth = len(self._ready)
        gap = self._current_decode_gap()
        breach = ((self.shed_queue_depth is not None and depth > self.shed_queue_depth)
                  or (self.shed_gap_ticks is not None and gap > self.shed_gap_ticks))
        if breach:
            self._shed_ok_steps = 0
            if self._shed_level + 1 < len(self.tiers):
                self._shed_level += 1
                self.stats.tier_demotions += 1
                self.stats.shed_level = self._shed_level
            return
        healthy = ((self.shed_queue_depth is None
                    or depth <= self.shed_restore_fraction * self.shed_queue_depth)
                   and (self.shed_gap_ticks is None
                        or gap <= self.shed_restore_fraction * self.shed_gap_ticks))
        if not healthy:
            self._shed_ok_steps = 0
            return
        if self._shed_level == 0:
            return
        self._shed_ok_steps += 1
        if self._shed_ok_steps >= self.shed_hold_steps:
            self._shed_level -= 1
            self.stats.tier_restorations += 1
            self.stats.shed_level = self._shed_level
            self._shed_ok_steps = 0

    def step(self) -> List[CompletedRequest]:
        """Admit what fits (under the interleaving budget), run one decode
        chunk, release finished slots.  Returns the requests completed
        during this call — under ``loop="async"`` completions surface one
        step after their chunk was dispatched."""
        if self._closed:
            raise RuntimeError(
                "ServeSession is closed — its pipeline was flushed by "
                "close(); create a new session"
            )
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                if self.loop == "async":
                    return self._step_async()
                return self._step_sync()
        finally:
            self.stats.wall_s += time.perf_counter() - t0

    def _step_sync(self) -> List[CompletedRequest]:
        """Dispatch one chunk (or speculative tick), block on its tokens,
        then do every piece of bookkeeping."""
        self._pull_arrivals()
        self._update_shed()
        self._admit_phase()
        if self.n_active == 0:
            # idle: jump to the next arrival instead of burning empty ticks
            if self._pending:
                self.clock = max(self.clock + 1, self._pending[0][0])
            else:
                self.clock += 1
            return self._drain_finished()
        if self.n_decoding == 0:
            # only mid-prefill rows resident (their chunks went out in
            # _admit_phase): nothing to decode, but the clock advances
            self.clock += 1
            return self._drain_finished()
        active, tables = self._chunk_inputs()
        if self.spec:
            k = self._draft_k_eff
            out_d, _, _ = self._dispatch_spec(active, tables, self._h2d(self._last_token),
                                              self._h2d(self._cur_len),
                                              self._h2d(self._slot_req))
            out = self._wait(_HostCopy(out_d))
            self._staged.clear()
            toks, n_acc = out[:-1], out[-1]
            # one tick on the scheduler clock; the device ran draft_k + 1
            # token-steps' worth of work
            self.clock += 1
            self.stats.ticks += 1
            self.stats.work_ticks += k + 1
            states = self._decode_states()
            self._accept_spec_chunk(states, toks, n_acc, self.stats.work_ticks, k)
            for slot, state in enumerate(states):
                if state is None:
                    continue
                # each row advanced by its own accepted count on the device
                na = int(n_acc[slot])
                self._cur_len[slot] = min(self._cur_len[slot] + na, self.max_len - 1)
                if na:
                    self._last_token[slot] = int(toks[na - 1, slot])
            return self._drain_finished()
        steps = self.steps_per_tick
        toks_d, _ = self._dispatch(active, tables, self._h2d(self._last_token),
                                   self._h2d(self._slot_req))
        toks = self._wait(_HostCopy(toks_d))             # (steps, N)
        self._staged.clear()
        self.clock += steps
        self.stats.ticks += steps
        self.stats.work_ticks += steps
        states = self._decode_states()
        self._accept_chunk(states, toks, steps, self.stats.work_ticks)
        for slot, state in enumerate(states):
            if state is None:
                continue
            # the device advanced this row all `steps` steps whether or not
            # it finished mid-chunk; keep the host view in lockstep
            self._cur_len[slot] = min(self._cur_len[slot] + steps, self.max_len - 1)
            self._last_token[slot] = int(toks[steps - 1, slot])
        return self._drain_finished()

    def _release_predicted_done(self) -> None:
        """Predictive early slot turnover (async loop): a row whose
        in-flight chunk provably completes it by length — pending first
        token + accepted tokens + what the chunk surely emits (its steps;
        1 for a speculative tick) reach ``max_new``; an eos can only finish
        it sooner — releases its slot and blocks NOW, so this step's
        admissions refill the slot without waiting for the harvest.  The
        successor's prefill and first chunk queue behind the in-flight
        chunk on the same stream, so the retiring row's last writes land
        before the successor's prefill overwrites them.  Its tokens still
        arrive at the next harvest (``_Inflight.states`` holds the state);
        ``state.released`` keeps the frees exactly-once."""
        fl = self._inflight
        if fl is None:
            return
        min_emit = 1 if fl.draft_k else fl.steps
        for state in fl.states:
            if state is None or state.done or state.released:
                continue
            if len(state.tokens) + state.pending_first + min_emit >= state.req.max_new:
                self._release_resources(state)

    def _step_async(self) -> List[CompletedRequest]:
        """Double-buffered step: admit (no wait — first tokens merge into
        the device carry), dispatch chunk N+1, and only then block on chunk
        N's tokens, so queue management, admission and finish bookkeeping
        for chunk N overlap the device computing N+1."""
        self._release_predicted_done()
        self._pull_arrivals()
        self._update_shed()
        self._admit_phase()
        prev, new = self._inflight, None
        if self.n_decoding:
            active, tables = self._chunk_inputs()
            if self.spec:
                # cur_len is a device carry (_cl_dev): rows advance by their
                # own accepted counts, which the host learns at harvest;
                # _cur_len meanwhile charges every live row the full
                # draft_k + 1, an upper bound, which is all block
                # allocation needs
                k = self._draft_k_eff
                out_d, self._lt_dev, self._cl_dev = self._dispatch_spec(
                    active, tables, self._lt_dev, self._cl_dev, self._req_dev)
                self.clock += 1
                self.stats.ticks += 1
                self.stats.work_ticks += k + 1
                new = _Inflight(_HostCopy(out_d), 1, self._decode_states(),
                                self.stats.work_ticks, self._staged, draft_k=k)
                advance = k + 1
            else:
                steps = self.steps_per_tick
                toks_d, self._lt_dev = self._dispatch(active, tables, self._lt_dev,
                                                      self._req_dev)
                self.clock += steps
                self.stats.ticks += steps
                self.stats.work_ticks += steps
                new = _Inflight(_HostCopy(toks_d), steps, self._decode_states(),
                                self.stats.work_ticks, self._staged)
                advance = steps
            self._staged = []
            # the device carry advances identically (speculative: at most);
            # the clamp matches the sync loop's post-harvest update
            self._cur_len = np.minimum(self._cur_len + advance * active,
                                       self.max_len - 1).astype(np.int32)
        elif self.n_active:
            # only mid-prefill rows resident (their chunks went out in
            # _admit_phase): nothing to decode, but the clock advances
            self.clock += 1
        elif prev is None:
            # idle: jump to the next arrival instead of burning empty ticks
            if self._pending:
                self.clock = max(self.clock + 1, self._pending[0][0])
            else:
                self.clock += 1
        self._inflight = new
        if prev is not None:
            self._harvest(prev)
        return self._drain_finished()

    def _harvest(self, fl: _Inflight) -> None:
        """Wait for an in-flight chunk's tokens (the device is already on
        the next chunk) and run the deferred bookkeeping: first tokens of
        the admissions since the previous harvest (a row preempted before
        its first token arrived discards it; the replay samples it again),
        then the chunk's tokens for the rows that were live at its
        dispatch.  A speculative chunk first brings the host's length views
        of the rows it still owns up to their accepted counts."""
        toks = self._wait(fl.toks)
        pend, self._pending_tok0 = self._pending_tok0, []
        drained = [(states, self._wait(copy), idxs) for states, copy, idxs in pend]
        now = time.perf_counter()
        for states, tok0s, idxs in drained:
            # ``idxs``: each state's row of its dispatch (a chunk dispatch
            # merges only its final rows)
            for state, i in zip(states, idxs):
                state.pending_first = False
                if state.preempted:
                    continue
                # a row finished here was discovered one chunk late: it
                # decoded one garbage chunk meanwhile (skipped below
                # through state.done)
                self._take_first(state, int(tok0s[i]), now)
        if not fl.draft_k:
            self._accept_chunk(fl.states, toks, fl.steps, fl.work_end)
            return
        toks, n_acc = toks[:-1], toks[-1]
        for slot, state in enumerate(fl.states):
            # a finished or preempted row's slot values are set again at its
            # slot's next admission, which may already have happened
            if (state is None or state.done or state.preempted
                    or self._active[slot] is not state):
                continue
            self._cl_true[slot] = min(int(self._cl_true[slot]) + int(n_acc[slot]),
                                      self.max_len - 1)
            ub = int(self._cl_true[slot])
            if self._inflight is not None and self._inflight.states[slot] is state:
                ub += self._inflight.draft_k + 1          # the chunk still in flight
            self._cur_len[slot] = min(ub, self.max_len - 1)
        self._accept_spec_chunk(fl.states, toks, n_acc, fl.work_end, fl.draft_k)

    def close(self) -> Dict[int, CompletedRequest]:
        """Flush the pipeline (harvest the in-flight chunk and any pending
        first tokens) and seal the session: later ``submit``/``step``/
        ``run`` raise ``RuntimeError``.  Requests never admitted stay
        unserved.  Idempotent; returns the completed results."""
        if not self._closed:
            fl, self._inflight = self._inflight, None
            if fl is not None:
                self._harvest(fl)
            self._closed = True
        return dict(self._completed)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, CompletedRequest]:
        """Drive until every queued request completes, or ``max_steps``
        calls to ``step()`` (each runs up to ``steps_per_tick`` decode
        ticks)."""
        if self._closed:
            raise RuntimeError(
                "ServeSession is closed — its pipeline was flushed by "
                "close(); create a new session"
            )
        n = 0
        while not self.drained:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return dict(self._completed)

    @property
    def results(self) -> Dict[int, CompletedRequest]:
        return dict(self._completed)
