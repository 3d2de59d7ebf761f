"""KV-cache management: the slot layout's row ops, the paged layout's
prompt-block scatter, and the host-side pools.

Slot layout (``transformer.init_cache`` leaves ``(L, num_slots, max_len +
1, Hkv, hd)``): every request owns one batch row's stripe for its
lifetime.  ``insert_slot`` / ``slot_view`` / ``evict_slot`` move one row,
``scatter_rows`` writes a batched admission's rows and
``insert_prefill_kv`` one prompt's fused-prefill K/V.  Each writes IN
PLACE (the JAX package's ops return new trees).  Correctness never needs
``evict_slot``: a stripe re-enters attention only up to its next owner's
``cur_len``, and every position below that is rewritten first.

Paged layout: K/V live in a global pool of fixed-size blocks (``transformer.
init_paged_cache`` leaves ``(L, num_blocks + 1, block_size, Hkv, hd)``,
the last block a write-only trash row) handed out by ``BlockPool``; each
request holds only the blocks its actual context occupies, recorded in a
fixed-width per-slot block table whose unallocated entries hold the
sentinel ``num_blocks`` — which is also the trash row's index, so a write
through a sentinel entry lands in the trash and is never read.

Under tensor parallelism each rank holds its KV heads of the pool
(``parallel/tp.shard_cache``); ``pool_bytes_per_device`` counts the bytes
of the pool a rank holds.

Prefix sharing: ``copy_block`` copies one physical block in every layer
(the copy-on-write fork).

Async serve loop: ``merge_admit_carry`` writes an admission batch's first
tokens and request ids into the device-resident decode carry, and
``merge_spec_len`` its prompt lengths into the speculative loop's
device-resident ``cur_len`` carry.

Host-side bookkeeping: ``SlotPool`` (decode-row free list), ``BlockPool``
(refcounted KV-block free list — both min-heaps with O(1) membership),
``PrefixCache`` (prompt-prefix content -> the physical block holding its
K/V) and ``PromptBuckets`` (fixed prompt-length buckets).
"""
from __future__ import annotations

import bisect
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "insert_slot",
    "slot_view",
    "evict_slot",
    "scatter_rows",
    "insert_prefill_kv",
    "scatter_prompt_blocks",
    "merge_admit_carry",
    "merge_spec_len",
    "copy_block",
    "pool_bytes_per_device",
    "PromptBuckets",
    "SlotPool",
    "BlockPool",
    "PrefixCache",
]


def insert_slot(cache: Dict[str, torch.Tensor], slot_cache: Dict[str, torch.Tensor],
                slot: int) -> None:
    """Write a batch-1 cache (leaves (L, 1, ...)) into row ``slot`` of the
    pooled cache (leaves (L, B, ...))."""
    for name, one in slot_cache.items():
        full = cache[name]
        full[:, slot:slot + 1] = one.to(full.dtype)


def slot_view(cache: Dict[str, torch.Tensor], slot: int) -> Dict[str, torch.Tensor]:
    """Batch-1 view of one row (leaves (L, 1, ...); views, not copies)."""
    return {name: a[:, slot:slot + 1] for name, a in cache.items()}


def evict_slot(cache: Dict[str, torch.Tensor], slot: int) -> None:
    """Zero one row of every leaf.  Hygiene only (see the module
    docstring); ``ServeSession(zero_on_evict=True)`` calls it."""
    for a in cache.values():
        a[:, slot] = 0


def scatter_rows(
    full: torch.Tensor,
    part: torch.Tensor,
    slots: torch.Tensor,
    valid: torch.Tensor,
    s_cap: Optional[int] = None,
) -> None:
    """Write ``part`` (lead, A, [S,] ...) into batch rows ``slots`` of
    ``full`` (lead, B, [Smax,] ...) IN PLACE: the batched-admission write.

    ``slots`` must hold distinct row ids (the session passes its acquired
    slots followed by other, unused ones); rows with ``valid == False``
    rewrite the values they gathered, an exact no-op, so one admission
    width serves any number <= A of requests, as in the JAX package.
    ``s_cap`` restricts the write to sequence positions [0, s_cap) (fused
    prefill K/V, where ``part`` covers only the prompt bucket): positions a
    valid row holds past its prompt then carry the K/V of pad tokens, which
    decode overwrites before it reads them."""
    vb = valid.reshape((1, -1) + (1,) * (full.ndim - 2))
    idx = slots.long()
    if s_cap is None:
        full[:, idx] = torch.where(vb, part.to(full.dtype), full[:, idx])
    else:
        full[:, idx, :s_cap] = torch.where(vb, part.to(full.dtype), full[:, idx, :s_cap])


def insert_prefill_kv(cache: Dict[str, torch.Tensor],
                      kvs: Tuple[torch.Tensor, torch.Tensor], slot: int) -> None:
    """Write fused-prefill K/V stacks (each (L, 1, S_bucket, Hkv, hd), from
    ``forward(..., return_kv=True)`` on one prompt) into positions
    [0, S_bucket) of row ``slot``."""
    for name, part in zip(("k", "v"), kvs):
        full = cache[name]
        full[:, slot:slot + 1, :part.shape[2]] = part.to(full.dtype)


def scatter_prompt_blocks(
    cache: Dict[str, torch.Tensor],
    kvs: Tuple[torch.Tensor, torch.Tensor],
    block_ids: torch.Tensor,
    block_size: int,
) -> None:
    """Write fused-prefill K/V stacks (each (L, A, S_bucket, Hkv, hd)) into
    the paged pool IN PLACE.

    ``block_ids`` is (A, nb) with ``nb == ceil(S_bucket / block_size)``:
    row ``i``'s ``j``-th entry is the physical block receiving positions
    ``[j*block_size, (j+1)*block_size)`` of prompt ``i``.  The bucket is
    zero-padded to whole blocks first.  Entries equal to ``num_blocks`` (the
    sentinel for unallocated / padding rows) write the trash block, so one
    fixed-width call admits any number of requests holding any number of
    blocks; bucket positions past a row's last allocated block hold only
    right-pad garbage, so sending them to the trash is exact."""
    k, v = kvs
    A, nb = block_ids.shape
    Lyr = k.shape[0]
    pad = nb * block_size - k.shape[2]
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    ids = block_ids.reshape(-1).long()
    for name, part in (("k", k), ("v", v)):
        full = cache[name]
        full[:, ids] = part.reshape(Lyr, A * nb, block_size, *part.shape[3:]).to(full.dtype)


def merge_admit_carry(
    last_token: torch.Tensor,   # (N,) device-resident decode carry
    slot_req: torch.Tensor,     # (N,) per-slot request ids (sampling keys)
    slots: torch.Tensor,        # (A,) distinct slot ids
    tok0s: torch.Tensor,        # (A,) first sampled tokens (admission output)
    req_ids: torch.Tensor,      # (A,) request ids
    valid: torch.Tensor,        # (A,) bool: rows actually admitted
) -> None:
    """Scatter an admission batch's first tokens and request ids into the
    decode carry at rows ``slots``, IN PLACE (the JAX package's op returns
    new arrays and carries PRNG keys where the port carries the request
    ids its positional sampling is keyed by).

    The async serve loop keeps the carry on the device between chunks; this
    merge lets freshly admitted rows join the next chunk without the host
    ever reading the prefill's outputs.  ``slots`` must hold distinct ids
    (the session pads its acquired slots with distinct unused ones); rows
    with ``valid == False`` rewrite the values they gathered, an exact
    no-op, so one admission width merges any number <= A of requests."""
    idx = slots.long()
    last_token[idx] = torch.where(valid, tok0s.to(last_token.dtype), last_token[idx])
    slot_req[idx] = torch.where(valid, req_ids.to(slot_req.dtype), slot_req[idx])


def merge_spec_len(
    cur_len: torch.Tensor,      # (N,) device-resident length carry
    slots: torch.Tensor,        # (A,) distinct slot ids
    lens: torch.Tensor,         # (A,) admitted prompt lengths
    valid: torch.Tensor,        # (A,) bool: rows actually admitted
) -> None:
    """Scatter an admission batch's prompt lengths into the ``cur_len``
    carry at rows ``slots``, IN PLACE.  Speculative decoding advances rows
    by data-dependent accepted counts, so the async serve loop keeps
    ``cur_len`` on the device beside the decode carry.  Same no-op
    discipline as ``merge_admit_carry``: rows with ``valid == False``
    rewrite the values they gathered."""
    idx = slots.long()
    cur_len[idx] = torch.where(valid, lens.to(cur_len.dtype), cur_len[idx])


def copy_block(cache: Dict[str, torch.Tensor], src: int, dst: int) -> None:
    """Copy physical block ``src``'s K/V rows, in every layer, to block
    ``dst`` IN PLACE: the copy-on-write fork.  An indexed device copy on
    the current stream (the JAX package's is an XLA dynamic update, not a
    kernel either); Python-int indices keep it free of host-to-device
    copies."""
    for a in cache.values():
        a[:, dst] = a[:, src]


def pool_bytes_per_device(cache: Dict[str, torch.Tensor]) -> int:
    """Bytes of the pool this rank holds (its trash block included): under
    tensor parallelism its KV-head shard, ``1/tp`` of each leaf, as
    ``cache_pspecs(layout="paged")`` splits it."""
    return sum(t.numel() * t.element_size() for t in cache.values())


class PromptBuckets:
    """Fixed prompt-length buckets: prefill runs at one of a few widths, so
    no request length ever yields a new prefill shape."""

    def __init__(self, sizes: Sequence[int]):
        if not sizes:
            raise ValueError("need at least one prompt bucket")
        self.sizes: Tuple[int, ...] = tuple(sorted(set(int(s) for s in sizes)))
        if self.sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.sizes}")

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket(self, prompt_len: int) -> int:
        """Smallest bucket >= prompt_len."""
        i = bisect.bisect_left(self.sizes, prompt_len)
        if i == len(self.sizes):
            raise ValueError(
                f"prompt_len={prompt_len} exceeds largest bucket {self.sizes[-1]}"
            )
        return self.sizes[i]

    def pad(self, prompt: np.ndarray, pad_id: int = 0) -> np.ndarray:
        """(S0,) -> (1, bucket) int32, padded on the right."""
        n = int(prompt.shape[0])
        out = np.full((1, self.bucket(n)), pad_id, np.int32)
        out[0, :n] = prompt
        return out


class _IdPool:
    """Min-heap free list over ``count`` integer ids with an O(1) membership
    set; lowest free id first keeps allocation deterministic."""

    _what = "id"

    def __init__(self, count: int):
        if count < 1:
            raise ValueError(f"need at least one {self._what}, got {count}")
        self._count = count
        self._heap: List[int] = list(range(count))   # range is already a heap
        self._free_set = set(self._heap)

    @property
    def free_count(self) -> int:
        return len(self._heap)

    @property
    def busy_count(self) -> int:
        return self._count - len(self._heap)

    def acquire(self) -> Optional[int]:
        if not self._heap:
            return None
        i = heapq.heappop(self._heap)
        self._free_set.discard(i)
        return i

    def release(self, i: int) -> None:
        if not 0 <= i < self._count:
            raise ValueError(f"{self._what} {i} out of range")
        if i in self._free_set:
            raise ValueError(f"{self._what} {i} double-released")
        heapq.heappush(self._heap, i)
        self._free_set.add(i)

    def _validate_release_many(self, ids: Sequence[int]) -> None:
        seen: set = set()
        for i in ids:
            if not 0 <= i < self._count:
                raise ValueError(f"{self._what} {i} out of range")
            if i in self._free_set or i in seen:
                raise ValueError(f"{self._what} {i} double-released")
            seen.add(i)

    def release_many(self, ids: Sequence[int]) -> None:
        """Atomic batch release: the whole batch is validated before any id
        returns to the pool."""
        self._validate_release_many(ids)
        for i in ids:
            self.release(i)


class SlotPool(_IdPool):
    """Free list over ``num_slots`` decode slots (batch rows of the decode
    step)."""

    _what = "slot"

    def __init__(self, num_slots: int):
        super().__init__(num_slots)
        self.num_slots = num_slots


class BlockPool(_IdPool):
    """Refcounted free list over ``num_blocks`` physical KV blocks; the
    sentinel id ``num_blocks`` marks unallocated table entries.

    ``acquire`` hands out a block with refcount 1; ``share`` takes one more
    reference on a live block (prefix sharing: several block tables, and
    the session's prefix cache, point at one physical block); ``release``
    drops one reference and returns the block to the free heap only at
    zero.  ``free_count`` / ``busy_count`` count physical blocks."""

    _what = "block"

    def __init__(self, num_blocks: int):
        super().__init__(num_blocks)
        self.num_blocks = num_blocks
        self._ref: List[int] = [0] * num_blocks

    def refcount(self, i: int) -> int:
        if not 0 <= i < self._count:
            raise ValueError(f"block {i} out of range")
        return self._ref[i]

    def acquire(self) -> Optional[int]:
        i = super().acquire()
        if i is not None:
            self._ref[i] = 1
        return i

    def share(self, i: int) -> int:
        """Take one more reference on a live block; returns the new count."""
        if not 0 <= i < self._count:
            raise ValueError(f"block {i} out of range")
        if self._ref[i] < 1:
            raise ValueError(f"block {i} is free; cannot share")
        self._ref[i] += 1
        return self._ref[i]

    def release(self, i: int) -> None:
        if not 0 <= i < self._count:
            raise ValueError(f"block {i} out of range")
        if self._ref[i] < 1:
            raise ValueError(f"block {i} double-released")
        self._ref[i] -= 1
        if self._ref[i] == 0:
            heapq.heappush(self._heap, i)
            self._free_set.add(i)

    def _validate_release_many(self, ids: Sequence[int]) -> None:
        # an id may appear up to its refcount times in one batch
        mult: Dict[int, int] = {}
        for i in ids:
            if not 0 <= i < self._count:
                raise ValueError(f"block {i} out of range")
            mult[i] = mult.get(i, 0) + 1
        for i, n in mult.items():
            if n > self._ref[i]:
                raise ValueError(
                    f"block {i}: batch releases {n} refs but only {self._ref[i]} held"
                )


class PrefixCache:
    """Host-side map from prompt-prefix content to the physical block that
    already holds its K/V (copy-on-write prefix sharing).

    The key of a prompt's block ``j`` is ``intern((key of block j-1, the
    tokens of block j))``, with ``ROOT`` as block 0's parent: interning
    compares exact token tuples, so two prefixes share a key iff their
    contents are identical, and keys are content-bound, not block-bound
    (evicting an entry only un-publishes its block).  The cache never
    touches the ``BlockPool``: the session takes one pool reference per
    published block on its behalf and drops it on eviction.  Entries keep
    LRU order; ``lru_blocks`` lists the eviction candidates."""

    ROOT = -1

    def __init__(self) -> None:
        self._intern: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._entries: "OrderedDict[int, int]" = OrderedDict()   # key -> block
        self._by_block: Dict[int, int] = {}                      # block -> key

    def __len__(self) -> int:
        return len(self._entries)

    def key(self, parent: int, tokens: Sequence[int]) -> int:
        """The interned key of a block holding ``tokens`` whose predecessor
        block has key ``parent`` (``ROOT`` for block 0)."""
        k = (int(parent), tuple(int(t) for t in tokens))
        kid = self._intern.get(k)
        if kid is None:
            kid = len(self._intern)
            self._intern[k] = kid
        return kid

    def lookup(self, key_id: int) -> Optional[int]:
        """The block published under ``key_id`` (now most recently used),
        else None."""
        blk = self._entries.get(key_id)
        if blk is not None:
            self._entries.move_to_end(key_id)
        return blk

    def insert(self, key_id: int, block: int) -> None:
        """Publish ``block`` under ``key_id``; a second publication of
        either raises."""
        if key_id in self._entries:
            raise ValueError(f"prefix key {key_id} already published")
        if block in self._by_block:
            raise ValueError(f"block {block} already published")
        self._entries[key_id] = block
        self._by_block[block] = key_id

    def holds_block(self, block: int) -> bool:
        return block in self._by_block

    def drop_block(self, block: int) -> bool:
        """Un-publish ``block`` (before it mutates, or to reclaim it); True
        if an entry was dropped, and the caller then releases the cache's
        pool reference."""
        kid = self._by_block.pop(block, None)
        if kid is None:
            return False
        del self._entries[kid]
        return True

    def lru_blocks(self) -> List[int]:
        """Published blocks, least recently used first (a snapshot)."""
        return list(self._entries.values())
