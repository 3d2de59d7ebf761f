"""Continuous-batching serve session over either KV layout, driven by a
sync or an async (double-buffered) host loop.

``ServeSession`` keeps ``num_slots`` decode slots hot and refills each slot
from a request queue the moment its occupant finishes (eos or max-token).
Two cache layouts (``cache_layout=``):

* ``"paged"`` (the port's default): K/V live in a global ``BlockPool`` of
  fixed-size blocks; each request holds only the blocks its context
  occupies, recorded in a fixed-width per-slot block table.  Admission
  reserves each request's worst case (``ceil((prompt_len + max_new - 1) /
  block_size)`` blocks) against the pool, which makes every mid-decode
  block append infallible.  Decode attention runs through K2.
* ``"slots"`` (the JAX package's default): every slot owns a ``max_len``
  KV stripe (``transformer.init_cache``) and decode attends over it with
  the plain ``attention_core``, as the JAX package does.

Each ``step()`` admits what fits, in policy order, with ONE batched fused
prefill (``forward(return_kv=True)``): prompts pad to the largest bucket of
the batch and rows pad to a power-of-two admission width, as in the JAX
package — under per-tensor activation scales the padding rows share the
quantization of the real ones, so the same padding gives the same codes.
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

A freed slot keeps decoding its stale carry (last token, ``cur_len``)
into its own stripe or the trash block, as in the JAX package; under
per-tensor activation scales those rows flow into every row's
quantization, so the carry is kept exactly as the JAX session keeps it.

This is the JAX package's ``ServeSession`` less prefix sharing,
preemption, speculative decoding, quality tiers, chunked prefill and
meshes, which arrive with later slices of the port.  Greedy tokens are
the cross-framework contract; temperature sampling follows the port's own
positional Philox schedule (``serve.engine``), so a request's tokens never
depend on its slot.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    paged_decode_step,
    params_to,
)
from repro_torch.serve import cache as C
from repro_torch.serve.engine import SamplingConfig, select_token

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
    within a class)."""

    req_id: int
    prompt: np.ndarray          # (S0,) int32
    max_new: int
    priority: int = 0
    arrival: int = 0


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    req_id: int
    prompt: np.ndarray
    tokens: np.ndarray          # generated tokens (first token included)
    finish_reason: str          # "eos" | "length"
    admitted_tick: int
    finished_tick: int
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
        "prefills": "prompt-bucket size -> requests prefilled at that bucket",
        "peak_active": "max concurrently-resident requests",
        "peak_blocks_in_use": "max KV pool blocks held at once",
        "ttft_ticks": "per-request time-to-first-token in scheduler ticks "
                      "since the request's arrival, appended at admit",
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
                                "steps_per_tick) under the ratio policy)",
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
    # async loop: the admit-time first token is on its way to the host
    pending_first: bool = False


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
        device=None,
    ):
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
        if cache_layout == "paged":
            if zero_on_evict:
                raise ValueError(
                    "zero_on_evict applies to the slot layout only (freed "
                    "blocks are invisible until re-seeded by their next owner)"
                )
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            if max_len % block_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of block_size {block_size} "
                    "(fixed-width block tables)"
                )
        self.layout = cache_layout
        self.zero_on_evict = bool(zero_on_evict)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
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
        self.buckets = C.PromptBuckets(prompt_buckets)
        if self.buckets.max_size > self.max_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets.max_size} > max_len {self.max_len}"
            )
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
            # per-slot block table (sentinel == num_blocks), held blocks, and
            # the not-yet-held part of each row's worst-case reservation
            self._tables = np.full((num_slots, self.table_width), self.num_blocks,
                                   np.int32)
            self._held: List[List[int]] = [[] for _ in range(num_slots)]
            self._future = np.zeros((num_slots,), np.int64)
            self._reserved_total = 0
        else:
            self.cache = init_cache(cfg, num_slots, self.max_len, cache_dtype,
                                    device=self.device)

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

        self._active: List[Optional[_ActiveSlot]] = [None] * num_slots
        self._pending: List[Tuple[int, int, Request]] = []   # heap (arrival, seq)
        self._ready: List[Tuple[int, int, Request]] = []     # heap (policy key, seq)
        self._seq = 0
        self._next_id = 0
        self._submit_t: Dict[int, float] = {}
        self.clock = 0
        self.stats = SchedulerStats(attn_impl=attn_impl)
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
               priority: int = 0, arrival: int = 0) -> int:
        """Queue one request; returns its id. ``arrival`` in ticks.  Every
        shape constraint is checked here, naming the request; a sealed
        session (after ``close()``) refuses."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_id if req_id is None else req_id
        if self._closed:
            raise RuntimeError(
                f"request {rid}: submitted after close() — the session is "
                "sealed and its pipeline flushed; create a new ServeSession"
            )
        if prompt.size < 1:
            raise ValueError(f"request {rid}: empty prompt")
        if max_new < 1:
            raise ValueError(f"request {rid}: max_new must be >= 1, got {max_new}")
        if prompt.size > self.buckets.max_size:
            raise ValueError(
                f"request {rid}: prompt_len {prompt.size} exceeds the largest "
                f"prompt bucket {self.buckets.max_size} (buckets {self.buckets.sizes})"
            )
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
        if req_id is not None and (
            req_id in self._completed
            or any(r.req_id == req_id for _, _, r in self._pending)
            or any(r.req_id == req_id for _, _, r in self._ready)
            or any(s is not None and s.req.req_id == req_id for s in self._active)
        ):
            raise ValueError(f"req_id {req_id} already in use")
        self._next_id = max(self._next_id, rid) + 1
        req = Request(rid, prompt, int(max_new), int(priority), int(arrival))
        self._submit_t[rid] = time.perf_counter()
        if req.arrival > self.clock:
            heapq.heappush(self._pending, (req.arrival, self._seq, req))
            self._seq += 1
        else:
            self._push_ready(req)
        return rid

    def _ready_key(self, req: Request) -> int:
        if self.policy == "sjf":
            return req.max_new + self.buckets.bucket(req.prompt.size)
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

    def _worst_blocks(self, prompt_len: int, max_new: int) -> int:
        """Blocks the request could ever hold: its last cache write lands at
        position ``prompt_len + max_new - 2`` (the final sampled token is
        output, never written)."""
        return -(-(prompt_len + max_new - 1) // self.block_size)

    def _admit_width(self, n: int) -> int:
        """Admission rows pad to a power of two (capped at ``num_slots``)."""
        w = 1
        while w < n:
            w <<= 1
        return min(w, self.num_slots)

    def _prefill_budget(self) -> float:
        """Bucketed prompt tokens this step may admit under the interleaving
        policy: unlimited without a policy, and while no decode is resident
        (nothing to starve, and the queue must drain)."""
        if self.prefill_decode_ratio is None and self.prefill_token_budget is None:
            return float("inf")
        if self.n_active == 0:
            return float("inf")
        if self.prefill_token_budget is not None:
            return float(self.prefill_token_budget)
        return self.prefill_decode_ratio * self.n_active * self.steps_per_tick

    def _pop_admissible(self, budget: float = float("inf")
                        ) -> Tuple[List[Request], float, bool]:
        """Pop ready requests that fit the free slots, (paged) what the
        block pool can still promise (``free - reserved``, reserving each
        one's worst case), and the prefill-token ``budget``.  The queue
        head blocks admission when it does not fit (no skip-ahead), so
        policy order holds.  Returns ``(batch, remaining budget, stalled)``,
        ``stalled`` meaning the head was deferred by the budget alone."""
        batch: List[Request] = []
        stalled = False
        while self._ready and len(batch) < self.pool.free_count:
            req = self._ready[0][2]
            worst = 0
            if self.layout == "paged":
                worst = self._worst_blocks(req.prompt.size, req.max_new)
                if worst > self.blocks.free_count - self._reserved_total:
                    break
            charge = self.buckets.bucket(req.prompt.size)
            if charge > budget:
                stalled = True
                break
            if self.layout == "paged":
                self._reserved_total += worst
            budget -= charge
            heapq.heappop(self._ready)
            batch.append(req)
        return batch, budget, stalled

    def _prefill(self, prompts, prompt_lens, req_ids, seat) -> torch.Tensor:
        """One fused prefill of an admission batch: seed each row's cache
        and sample its first token (at position ``prompt_len``); (A,) tokens
        on the device.  ``seat`` is the paged layout's (A, nb) block ids, or
        the slot layout's (slots, valid): rows to write and which of them
        are real (the others rewrite what they hold,
        ``cache.scatter_rows``)."""
        dev = self.device
        logits, kvs = forward(self.cfg, self.params, self._h2d(prompts), return_kv=True)
        lens = self._h2d(prompt_lens).long()
        last = logits[torch.arange(len(prompt_lens), device=dev), lens - 1]
        if self.layout == "paged":
            C.scatter_prompt_blocks(self.cache, kvs, self._h2d(seat), self.block_size)
        else:
            slots, valid = seat
            for name, part in zip(("k", "v"), kvs):
                C.scatter_rows(self.cache[name], part, slots, valid, s_cap=prompts.shape[1])
        return select_token(last, self.sampling, seed=self.seed,
                            req_ids=self._h2d(req_ids), positions=lens)

    def _admit_many(self, reqs: List[Request]) -> None:
        """Admit ``reqs`` with ONE prefill: prompts pad to the batch's largest
        bucket, rows to the admission width (padding rows: prompt of
        ``pad_id``, length 1).  Paged: each request acquires its prompt's
        blocks, converting that much of its reservation, and the padding
        rows' block ids are all the sentinel, so their writes go to the
        trash block.  Slots: the padding rows take distinct free slots and
        rewrite what those hold.  The sync loop then waits for the first
        tokens; the async loop merges them into the device carry and reads
        them at the next harvest."""
        A = self._admit_width(len(reqs))
        bucket = max(self.buckets.bucket(r.prompt.size) for r in reqs)
        prompts = np.full((A, bucket), self.pad_id, np.int32)
        prompt_lens = np.ones((A,), np.int32)
        req_ids = np.zeros((A,), np.int64)
        row_slot = [self.pool.acquire() for _ in reqs]
        for i, req in enumerate(reqs):
            prompts[i, :req.prompt.size] = req.prompt
            prompt_lens[i] = req.prompt.size
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
                slot, plen = row_slot[i], req.prompt.size
                ninit = -(-plen // bs)
                held = [self.blocks.acquire() for _ in range(ninit)]
                seat[i, :ninit] = held
                self._held[slot] = held
                self._tables[slot, :] = self.num_blocks
                self._tables[slot, :ninit] = held
                self._future[slot] = self._worst_blocks(plen, req.max_new) - ninit
                self._reserved_total -= ninit      # reservation -> held
            self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                                self.blocks.busy_count)
        else:
            seat = (self._h2d(slots), self._h2d(valid))
        tok0s = self._prefill(prompts, prompt_lens, req_ids, seat)
        self.stats.admit_calls += 1
        tok_sum = 0
        for r in reqs:
            b = self.buckets.bucket(r.prompt.size)
            self.stats.prefills[b] = self.stats.prefills.get(b, 0) + 1
            tok_sum += b
        self.stats.prefill_tokens += tok_sum
        self._prefill_carry += tok_sum
        self.stats.work_ticks += self._prefill_carry // self.num_slots
        self._prefill_carry %= self.num_slots

        if self.loop == "async":
            slots_d = seat[0] if self.layout == "slots" else self._h2d(slots)
            valid_d = seat[1] if self.layout == "slots" else self._h2d(valid)
            C.merge_admit_carry(self._lt_dev, self._req_dev, slots_d, tok0s,
                                self._h2d(req_ids), valid_d)
            states = []
            for i, req in enumerate(reqs):
                slot = row_slot[i]
                self._cur_len[slot] = int(prompt_lens[i])
                self._last_emit_work[slot] = self.stats.work_ticks
                self.stats.admitted += 1
                state = _ActiveSlot(req, slot, [], self.clock, pending_first=True)
                state.ttft = self.clock - req.arrival
                self.stats.ttft_ticks.append(state.ttft)
                self._active[slot] = state
                states.append(state)
            self._pending_tok0.append((states, _HostCopy(tok0s)))
            return

        tok0s = self._wait(_HostCopy(tok0s))
        now = time.perf_counter()
        eos = self.sampling.eos_id
        for i, req in enumerate(reqs):
            slot, tok0 = row_slot[i], int(tok0s[i])
            self._last_token[slot] = tok0
            self._cur_len[slot] = int(prompt_lens[i])
            self._slot_req[slot] = req.req_id
            self._last_emit_work[slot] = self.stats.work_ticks
            self.stats.admitted += 1
            state = _ActiveSlot(req, slot, [tok0], self.clock)
            state.ttft = self.clock - req.arrival
            self.stats.ttft_ticks.append(state.ttft)
            self.stats.ttft_s.append(now - self._submit_t.pop(req.req_id))
            self.stats.generated_tokens += 1
            if len(state.tokens) >= req.max_new or (eos >= 0 and tok0 == eos):
                self._finish(state, "eos" if (eos >= 0 and tok0 == eos) else "length")
            else:
                self._active[slot] = state

    def _release_resources(self, state: _ActiveSlot) -> None:
        """Free the slot and (paged) every held block and the unused
        remainder of the worst-case reservation, or (slots, with
        ``zero_on_evict``) zero the slot's stripe — exactly once
        (``state.released``).  Stale cache contents are invisible: a block
        or stripe re-enters attention only after its next owner's writes."""
        state.released = True
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
            ttft=state.ttft,
        )

    def _ensure_blocks(self, slot: int, hi: int) -> None:
        """Append blocks to ``slot``'s table until it covers position ``hi``;
        the admission reservation makes the acquire infallible."""
        held = self._held[slot]
        while len(held) * self.block_size <= hi:
            b = self.blocks.acquire()
            if b is None:
                raise AssertionError("block append failed despite reservation")
            self._tables[slot, len(held)] = b
            held.append(b)
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
    def drained(self) -> bool:
        return not (self._pending or self._ready or self.n_active or self._inflight)

    def _drain_finished(self) -> List[CompletedRequest]:
        done = [self._completed[i] for i in self._just_finished]
        self._just_finished.clear()
        return done

    def _admit_phase(self) -> None:
        """Admit ready requests in policy order, subject to free slots,
        (paged) the block-pool reservation, and the interleaving budget
        shared across every admission batch of this step."""
        budget = self._prefill_budget()
        stalled = False
        while not stalled and self._ready and self.pool.free_count:
            batch, budget, stalled = self._pop_admissible(budget)
            if not batch:
                break                 # head does not fit the pool or budget yet
            self._admit_many(batch)
        if stalled:
            self.stats.prefill_stall_ticks += 1
        self.stats.peak_active = max(self.stats.peak_active, self.n_active)

    def _chunk_inputs(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The active-row mask and (paged) this chunk's block tables, grown
        to cover every position the chunk could write an ACCEPTED token to
        (``cur_len + steps_per_tick - 1``; overshoot past ``max_new``
        targets sentinel entries and lands in the trash block)."""
        active = np.asarray([s is not None for s in self._active], bool)
        if self.layout != "paged":
            return active, None
        for slot, state in enumerate(self._active):
            if state is None:
                continue
            hi = min(int(self._cur_len[slot]) + self.steps_per_tick - 1,
                     state.req.prompt.size + state.req.max_new - 2)
            self._ensure_blocks(slot, hi)
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            self.blocks.busy_count)
        return active, self._tables.copy()

    def _dispatch(self, active, tables, last_token, slot_req):
        """Issue one decode chunk; (toks (steps, N), last token) on the
        device.  ``cur_len`` is copied now, since the host advances it
        while the chunk is in flight."""
        return _decode_tick(
            self.cfg, self.params, self.cache, last_token, self._h2d(self._cur_len),
            self._h2d(active), slot_req, None if tables is None else self._h2d(tables),
            sampling=self.sampling, seed=self.seed, steps=self.steps_per_tick,
            block_size=self.block_size if tables is not None else 0,
            attn_impl=self.attn_impl,
        )

    def _accept_chunk(self, states: List[Optional[_ActiveSlot]], toks: np.ndarray,
                      steps: int, work_end: int) -> None:
        """Accept a fetched chunk's tokens for the rows that were live at its
        dispatch: each row takes tokens until it finishes (eos / max_new)
        and discards the bounded overshoot; rows whose completion was
        discovered after the dispatch (``state.done``) contribute only idle
        steps.  Updates the busy/idle accounting and the starvation gauge
        (``work_end`` is the chunk's position on the work clock)."""
        eos = self.sampling.eos_id
        accepted = 0
        for slot, state in enumerate(states):
            if state is None or state.done:
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
        """Dispatch one chunk, block on its tokens, then do every piece of
        bookkeeping."""
        self._pull_arrivals()
        self._admit_phase()
        if self.n_active == 0:
            # idle: jump to the next arrival instead of burning empty ticks
            if self._pending:
                self.clock = max(self.clock + 1, self._pending[0][0])
            else:
                self.clock += 1
            return self._drain_finished()
        steps = self.steps_per_tick
        active, tables = self._chunk_inputs()
        toks_d, _ = self._dispatch(active, tables, self._h2d(self._last_token),
                                   self._h2d(self._slot_req))
        toks = self._wait(_HostCopy(toks_d))             # (steps, N)
        self._staged.clear()
        self.clock += steps
        self.stats.ticks += steps
        self.stats.work_ticks += steps
        states = list(self._active)
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
        token + accepted tokens + the chunk's steps reach ``max_new``; an
        eos can only finish it sooner — releases its slot and blocks NOW,
        so this step's admissions refill the slot without waiting for the
        harvest.  The successor's prefill and first chunk queue behind the
        in-flight chunk on the same stream, so the retiring row's last
        writes land before the successor's prefill overwrites them.  Its
        tokens still arrive at the next harvest (``_Inflight.states`` holds
        the state); ``state.released`` keeps the frees exactly-once."""
        fl = self._inflight
        if fl is None:
            return
        for state in fl.states:
            if state is None or state.done or state.released:
                continue
            if len(state.tokens) + state.pending_first + fl.steps >= state.req.max_new:
                self._release_resources(state)

    def _step_async(self) -> List[CompletedRequest]:
        """Double-buffered step: admit (no wait — first tokens merge into
        the device carry), dispatch chunk N+1, and only then block on chunk
        N's tokens, so queue management, admission and finish bookkeeping
        for chunk N overlap the device computing N+1."""
        self._release_predicted_done()
        self._pull_arrivals()
        self._admit_phase()
        prev, new = self._inflight, None
        if self.n_active:
            steps = self.steps_per_tick
            active, tables = self._chunk_inputs()
            toks_d, self._lt_dev = self._dispatch(active, tables, self._lt_dev, self._req_dev)
            self.clock += steps
            self.stats.ticks += steps
            self.stats.work_ticks += steps
            new = _Inflight(_HostCopy(toks_d), steps, list(self._active),
                            self.stats.work_ticks, self._staged)
            self._staged = []
            # the device carry advances identically; the clamp matches the
            # sync loop's post-harvest update
            self._cur_len = np.minimum(self._cur_len + steps * active,
                                       self.max_len - 1).astype(np.int32)
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
        the admissions since the previous harvest, then the chunk's tokens
        for the rows that were live at its dispatch."""
        toks = self._wait(fl.toks)                        # (steps, N)
        pend, self._pending_tok0 = self._pending_tok0, []
        drained = [(states, self._wait(copy)) for states, copy in pend]
        now = time.perf_counter()
        eos = self.sampling.eos_id
        for states, tok0s in drained:
            for i, state in enumerate(states):
                state.pending_first = False
                tok0 = int(tok0s[i])
                state.tokens.append(tok0)
                self.stats.generated_tokens += 1
                self.stats.ttft_s.append(now - self._submit_t.pop(state.req.req_id))
                if len(state.tokens) >= state.req.max_new or (eos >= 0 and tok0 == eos):
                    # discovered one chunk late: the row decoded one garbage
                    # chunk meanwhile (skipped below through state.done)
                    self._finish(state, "eos" if (eos >= 0 and tok0 == eos) else "length")
        self._accept_chunk(fl.states, toks, fl.steps, fl.work_end)

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
