"""Continuous-batching serve session over the paged KV pool (sync loop).

``ServeSession`` keeps ``num_slots`` decode slots hot and refills each slot
from a request queue the moment its occupant finishes (eos or max-token).
K/V live in a global ``BlockPool`` of fixed-size blocks; each request holds
only the blocks its context occupies, recorded in a fixed-width per-slot
block table.  Admission reserves each request's worst case
(``ceil((prompt_len + max_new - 1) / block_size)`` blocks) against the
pool, which makes every mid-decode block append infallible.

Each ``step()``:

* admits what fits, in policy order, with ONE batched fused prefill
  (``forward(return_kv=True)``): prompts pad to the largest bucket of the
  batch and rows pad to a power-of-two admission width, as in the JAX
  package — under per-tensor activation scales the padding rows share the
  quantization of the real ones, so the same padding gives the same codes;
* runs one decode step across all slots (``paged_decode_step``) and blocks
  on its tokens before any bookkeeping.

This is the JAX package's ``ServeSession`` restricted to its paged layout,
sync loop and ``steps_per_tick=1``; the async loop, prefix sharing,
preemption, speculative decoding, quality tiers, chunked prefill, the slot
layout and meshes arrive with later slices of the port.  Greedy tokens are
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
    forward,
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
]

ADMISSION_POLICIES = ("priority", "fifo", "sjf")


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
        "ticks": "decode ticks executed (1 tick = one decode step across all slots)",
        "busy_slot_steps": "slot-steps that produced an accepted token",
        "idle_slot_steps": "slot-steps wasted on empty slots "
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
        "prefill_tokens": "bucketed prompt tokens admitted (excludes "
                          "admit-width padding rows)",
        "work_ticks": "device-work clock: decode steps + prefill charged at "
                      "bucketed tokens / num_slots, integerized through a carry",
        "max_decode_gap_ticks": "worst work-tick gap between a resident "
                                "request's consecutive accepted tokens",
        "host_block_s": "wall seconds the host spent blocked on device "
                        "results (first tokens and decode tokens)",
        "wall_s": "wall seconds spent inside step() in total",
        "attn_impl": "paged decode-attention implementation: 'kernel' (the "
                     "CUDA kernel) or 'gather' (its plain version)",
        "slot_utilization": "busy_slot_steps / (busy + idle)",
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
    max_decode_gap_ticks: int = 0
    host_block_s: float = 0.0
    wall_s: float = 0.0
    attn_impl: str = "kernel"

    @property
    def slot_utilization(self) -> float:
        cap = self.busy_slot_steps + self.idle_slot_steps
        return self.busy_slot_steps / cap if cap else 0.0

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
    done: bool = False


class ServeSession:
    """Continuous-batching serving over the paged KV pool.

    >>> sess = ServeSession(cfg, params, num_slots=4, max_len=256)
    >>> sess.submit(prompt_ids, max_new=64)
    >>> results = sess.run()          # {req_id: CompletedRequest}

    ``num_blocks`` defaults to ``num_slots * max_len / block_size`` (every
    slot's worst case); lower it to oversubscribe.  ``policy`` orders the
    ready queue: ``"priority"`` (lower ``Request.priority`` first, FIFO
    within a class), ``"fifo"``, or ``"sjf"`` (shortest ``max_new +
    bucketed prompt len`` first).  ``attn_impl`` picks the decode
    attention: ``"kernel"`` (K2) or ``"gather"`` (its plain version, the
    oracle).  ``cache_dtype`` is the paged pool's dtype (float32, as in the
    JAX package, or bfloat16, which halves the pool's bytes and K2's
    reads; K2 takes both).  ``params`` may be float or ``freeze_params``
    trees; they move to ``device`` (default: the CUDA device; without one,
    this raises).
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
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        policy: str = "priority",
        attn_impl: str = "kernel",
        pad_id: int = 0,
        cache_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"policy {policy!r} not in {ADMISSION_POLICIES}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size {block_size} "
                "(fixed-width block tables)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.sampling = sampling if sampling is not None else SamplingConfig()
        self.seed = int(seed)
        self.max_len = int(max_len)
        self.policy = policy
        self.attn_impl = attn_impl
        self.pad_id = int(pad_id)
        self.buckets = C.PromptBuckets(prompt_buckets)
        if self.buckets.max_size > self.max_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets.max_size} > max_len {self.max_len}"
            )
        self.pool = C.SlotPool(num_slots)
        self.num_slots = num_slots
        self.block_size = int(block_size)
        self.table_width = self.max_len // self.block_size
        if num_blocks is None:
            num_blocks = num_slots * self.table_width
        self.blocks = C.BlockPool(num_blocks)
        self.num_blocks = int(num_blocks)
        self.cache = init_paged_cache(cfg, self.num_blocks, self.block_size, cache_dtype,
                                      device=self.device)
        # per-slot block table (sentinel == num_blocks), held blocks, and the
        # not-yet-held part of each row's worst-case reservation
        self._tables = np.full((num_slots, self.table_width), self.num_blocks, np.int32)
        self._held: List[List[int]] = [[] for _ in range(num_slots)]
        self._future = np.zeros((num_slots,), np.int64)
        self._reserved_total = 0

        # decode carry, host side; a freed slot keeps its last values — they
        # still flow through the decode step (and, under per-tensor
        # activation scales, into every row's quantization), as in the JAX
        # package
        self._last_token = np.zeros((num_slots,), np.int32)
        self._cur_len = np.zeros((num_slots,), np.int32)
        self._slot_req = np.zeros((num_slots,), np.int64)   # sampling key per slot

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

    # -- queue ---------------------------------------------------------------

    def submit(self, prompt, max_new: int, *, req_id: Optional[int] = None,
               priority: int = 0, arrival: int = 0) -> int:
        """Queue one request; returns its id. ``arrival`` in ticks.  Every
        shape constraint is checked here, naming the request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_id if req_id is None else req_id
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
        worst = self._worst_blocks(prompt.size, max_new)
        if worst > self.num_blocks:
            raise ValueError(
                f"request {rid}: worst-case context needs {worst} blocks but the "
                f"pool only has {self.num_blocks} — it could never be admitted"
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

    def _pop_admissible(self) -> List[Request]:
        """Pop ready requests that fit the free slots and what the block pool
        can still promise (``free - reserved``), reserving each one's worst
        case.  The queue head blocks admission when it does not fit (no
        skip-ahead), so policy order holds."""
        batch: List[Request] = []
        while self._ready and len(batch) < self.pool.free_count:
            req = self._ready[0][2]
            worst = self._worst_blocks(req.prompt.size, req.max_new)
            if worst > self.blocks.free_count - self._reserved_total:
                break
            self._reserved_total += worst
            heapq.heappop(self._ready)
            batch.append(req)
        return batch

    @torch.no_grad()
    def _prefill(self, prompts, prompt_lens, block_ids, req_ids) -> np.ndarray:
        """One fused prefill of an admission batch: seed each row's blocks
        and sample its first token (at position ``prompt_len``)."""
        dev = self.device
        logits, kvs = forward(self.cfg, self.params,
                              torch.as_tensor(prompts, device=dev), return_kv=True)
        lens = torch.as_tensor(prompt_lens, device=dev).long()
        last = logits[torch.arange(len(prompt_lens), device=dev), lens - 1]
        C.scatter_prompt_blocks(self.cache, kvs,
                                torch.as_tensor(block_ids, device=dev), self.block_size)
        tok0s = select_token(last, self.sampling, seed=self.seed,
                             req_ids=torch.as_tensor(req_ids, device=dev),
                             positions=lens)
        tb = time.perf_counter()
        out = tok0s.cpu().numpy()
        self.stats.host_block_s += time.perf_counter() - tb
        return out

    def _admit_many(self, reqs: List[Request]) -> None:
        """Admit ``reqs`` with ONE prefill: prompts pad to the batch's largest
        bucket, rows to the admission width (padding rows: prompt of
        ``pad_id``, length 1, every block id the sentinel, so their writes
        go to the trash block).  Each request acquires its prompt's blocks,
        converting that much of its reservation."""
        A = self._admit_width(len(reqs))
        bucket = max(self.buckets.bucket(r.prompt.size) for r in reqs)
        prompts = np.full((A, bucket), self.pad_id, np.int32)
        prompt_lens = np.ones((A,), np.int32)
        req_ids = np.zeros((A,), np.int64)
        row_slot = [self.pool.acquire() for _ in reqs]
        bs = self.block_size
        block_ids = np.full((A, -(-bucket // bs)), self.num_blocks, np.int32)
        for i, req in enumerate(reqs):
            plen = req.prompt.size
            prompts[i, :plen] = req.prompt
            prompt_lens[i] = plen
            req_ids[i] = req.req_id
            slot = row_slot[i]
            ninit = -(-plen // bs)
            held = [self.blocks.acquire() for _ in range(ninit)]
            block_ids[i, :ninit] = held
            self._held[slot] = held
            self._tables[slot, :] = self.num_blocks
            self._tables[slot, :ninit] = held
            self._future[slot] = self._worst_blocks(plen, req.max_new) - ninit
            self._reserved_total -= ninit          # reservation -> held
        tok0s = self._prefill(prompts, prompt_lens, block_ids, req_ids)
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            self.blocks.busy_count)
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
        """Free the slot, every held block and the unused remainder of the
        worst-case reservation.  Stale pool contents are invisible: a block
        re-enters attention only after its next owner's writes."""
        slot = state.slot
        if self._active[slot] is state:
            self._active[slot] = None
        self.pool.release(slot)
        self.blocks.release_many(self._held[slot])
        self._held[slot] = []
        self._tables[slot, :] = self.num_blocks
        self._reserved_total -= int(self._future[slot])
        self._future[slot] = 0

    def _finish(self, state: _ActiveSlot, reason: str) -> None:
        state.done = True
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
        return not (self._pending or self._ready or self.n_active)

    def _drain_finished(self) -> List[CompletedRequest]:
        done = [self._completed[i] for i in self._just_finished]
        self._just_finished.clear()
        return done

    def _admit_phase(self) -> None:
        while self._ready and self.pool.free_count:
            batch = self._pop_admissible()
            if not batch:
                break                 # head does not fit the pool yet
            self._admit_many(batch)
        self.stats.peak_active = max(self.stats.peak_active, self.n_active)

    def _decode_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """The active-row mask and this step's block tables, grown to cover
        the position each live row writes (its ``cur_len``)."""
        for slot, state in enumerate(self._active):
            if state is None:
                continue
            hi = min(int(self._cur_len[slot]),
                     state.req.prompt.size + state.req.max_new - 2)
            self._ensure_blocks(slot, hi)
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            self.blocks.busy_count)
        active = np.asarray([s is not None for s in self._active], bool)
        return active, self._tables.copy()

    @torch.no_grad()
    def _decode(self, active: np.ndarray, tables: np.ndarray) -> np.ndarray:
        """One decode step over every slot; (N,) tokens, 0 on empty slots."""
        dev = self.device
        cur = torch.as_tensor(self._cur_len, device=dev)
        logits = paged_decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(self._last_token, device=dev)[:, None], cur,
            torch.as_tensor(tables, device=dev),
            block_size=self.block_size, attn_impl=self.attn_impl,
        )
        # the sampled token lands at position cur_len + 1
        toks = select_token(logits[:, 0], self.sampling, seed=self.seed,
                            req_ids=torch.as_tensor(self._slot_req, device=dev),
                            positions=cur + 1)
        toks = torch.where(torch.as_tensor(active, device=dev), toks, 0)
        tb = time.perf_counter()
        out = toks.cpu().numpy()
        self.stats.host_block_s += time.perf_counter() - tb
        return out

    def _accept(self, toks: np.ndarray) -> None:
        """Each live row takes its token, finishing on eos / max_new."""
        eos = self.sampling.eos_id
        work_end = self.stats.work_ticks
        accepted = 0
        for slot, state in enumerate(list(self._active)):
            if state is None:
                continue
            tok = int(toks[slot])
            state.tokens.append(tok)
            accepted += 1
            if eos >= 0 and tok == eos:
                self._finish(state, "eos")
            elif len(state.tokens) >= state.req.max_new:
                self._finish(state, "length")
            gap = int(work_end - self._last_emit_work[slot])
            self.stats.max_decode_gap_ticks = max(self.stats.max_decode_gap_ticks, gap)
            self._last_emit_work[slot] = work_end
            self._cur_len[slot] = min(self._cur_len[slot] + 1, self.max_len - 1)
            self._last_token[slot] = tok
        self.stats.busy_slot_steps += accepted
        self.stats.idle_slot_steps += self.num_slots - accepted
        self.stats.generated_tokens += accepted

    def step(self) -> List[CompletedRequest]:
        """Admit what fits, run one decode step, release finished slots.
        Returns the requests completed during this call."""
        t0 = time.perf_counter()
        try:
            self._pull_arrivals()
            self._admit_phase()
            if self.n_active == 0:
                # idle: jump to the next arrival instead of burning empty ticks
                if self._pending:
                    self.clock = max(self.clock + 1, self._pending[0][0])
                else:
                    self.clock += 1
                return self._drain_finished()
            active, tables = self._decode_inputs()
            toks = self._decode(active, tables)
            self.clock += 1
            self.stats.ticks += 1
            self.stats.work_ticks += 1
            self._accept(toks)
            return self._drain_finished()
        finally:
            self.stats.wall_s += time.perf_counter() - t0

    def run(self, max_steps: Optional[int] = None) -> Dict[int, CompletedRequest]:
        """Drive until every queued request completes, or ``max_steps``
        calls to ``step()``."""
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
