"""Approximate multiplier library (Lu et al., ISCAS 2022).

This module is the bit-exact functional model of the paper's circuits:

* Two approximate 3x3 multipliers, ``MUL3x3_1`` and ``MUL3x3_2``, defined by
  K-map modifications of the exact 3x3 truth table (paper Tables II / III).
* An 8x8 aggregation scheme (paper Fig. 1): each 8-bit operand is split into
  3+3+2-bit pieces ``lo = x[2:0]``, ``mid = x[5:3]``, ``hi = x[7:6]``; the nine
  partial products are produced by eight 3x3 multipliers (2-bit pieces are
  zero-extended) and one exact 2x2 multiplier for ``hi*hi``.
* Three 8x8 approximate multipliers (paper Table IV):
    - MUL8x8_1: all 3x3 pieces use MUL3x3_1, hi*hi exact 2x2.
    - MUL8x8_2: all 3x3 pieces use MUL3x3_2, hi*hi exact 2x2.
    - MUL8x8_3: MUL8x8_2 with the partial product M2 and its shifter removed.
      With row-major indexing M_{3i+j} over (lo, mid, hi) pieces, M2 =
      A[2:0] * B[7:6] (involves B[7:6]) and M6 = A[7:6] * B[2:0] (involves
      A[7:6]) -- exactly the paper's "A[7:6] or B[7:6] is 00, so that we can
      remove M2 or M6".  Weights (retrained into (0,31)) sit on the RHS here,
      so MUL8x8_3 removes M2 = A_lo x B_hi.

Fidelity note (see DESIGN.md): the paper's own 3x3 metrics (ER 9.375%, MED
1.125 / 0.5) are reproduced exactly by this module.  The 8x8 rows of paper
Table V are *not* reachable from the described disjoint 3+3+2 aggregation --
with sign-consistent piece errors MED(MUL8x8_1) = 1.125 * sum(2^shifts) <=
91.125 < the printed 137.04 -- while our exhaustive PKM/ETM baselines do land
close to the paper's printed values.  We therefore report exhaustive-domain
metrics of the architecture-faithful aggregation (which are strictly better
than Table V's printed values).
* Literature baselines used in the paper's comparison: PKM (Kulkarni 2x2
  underdesigned multiplier aggregated to 8x8) and ETM (error-tolerant
  multiplier, Kyaw et al.).

Everything is expressed as dense lookup tables (LUTs) over the full input
domain, so downstream layers (quantized matmul simulation, the CUDA kernels,
low-rank decomposition) can consume exact semantics.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "MUL3X3_1_OVERRIDES",
    "MUL3X3_2_OVERRIDES",
    "exact_table",
    "table_from_overrides",
    "mul3x3_1_table",
    "mul3x3_2_table",
    "Piece",
    "PIECES_332",
    "AggregationSpec",
    "aggregate_8x8",
    "piece_error_tables",
    "mul8x8_table",
    "pkm_2x2_table",
    "pkm_8x8_table",
    "etm_8x8_table",
    "MSRSpec",
    "MSR_SPECS",
    "msr_8x8_table",
    "MULTIPLIERS",
    "get_multiplier",
]

# ---------------------------------------------------------------------------
# 3x3 approximate multipliers (paper Section II.A)
# ---------------------------------------------------------------------------

#: Paper Table II: the six truth-table rows of the exact 3x3 multiplier whose
#: product exceeds 31 are rewritten so that O5 = 0 (output width shrinks to 5).
MUL3X3_1_OVERRIDES: Dict[Tuple[int, int], int] = {
    (5, 7): 27,
    (6, 6): 24,
    (6, 7): 30,
    (7, 5): 27,
    (7, 6): 30,
    (7, 7): 29,
}

#: Paper Table III: MUL3x3_2 adds a prediction unit.  For the four rows with
#: a2*a1*b2*b1 == 1 it forces O5=1, O4=0 on top of the MUL3x3_1 encoding,
#: halving the MED (1.125 -> 0.5).  Note: Table III's printed Value' of 38 for
#: (7,6) is inconsistent with its own O-bits (101110 = 46); the bit pattern
#: (and the claimed MED of 0.5) is authoritative, giving 46.
MUL3X3_2_OVERRIDES: Dict[Tuple[int, int], int] = {
    (5, 7): 27,
    (7, 5): 27,
    (6, 6): 40,   # 24 + 32 (O5=1, O4=0)
    (6, 7): 46,   # 30 + 32 - 16
    (7, 6): 46,
    (7, 7): 45,   # 29 + 32 - 16
}


def exact_table(bits_a: int, bits_b: int) -> np.ndarray:
    """Dense exact product LUT of shape (2**bits_a, 2**bits_b), int32."""
    a = np.arange(2 ** bits_a, dtype=np.int64)
    b = np.arange(2 ** bits_b, dtype=np.int64)
    return (a[:, None] * b[None, :]).astype(np.int32)


def table_from_overrides(
    bits: int, overrides: Mapping[Tuple[int, int], int]
) -> np.ndarray:
    """Exact ``bits x bits`` LUT with the given truth-table rows replaced."""
    t = exact_table(bits, bits)
    for (x, y), v in overrides.items():
        t[x, y] = v
    return t


@functools.lru_cache(maxsize=None)
def mul3x3_1_table() -> np.ndarray:
    return table_from_overrides(3, MUL3X3_1_OVERRIDES)


@functools.lru_cache(maxsize=None)
def mul3x3_2_table() -> np.ndarray:
    return table_from_overrides(3, MUL3X3_2_OVERRIDES)


# ---------------------------------------------------------------------------
# 8x8 aggregation (paper Section II.B, Fig. 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Piece:
    """A bit-field slice of an 8-bit operand."""

    name: str
    shift: int   # LSB position
    bits: int    # field width

    def extract(self, x: np.ndarray) -> np.ndarray:
        return (x >> self.shift) & ((1 << self.bits) - 1)


#: The paper's 3+3+2 split.
PIECES_332: Tuple[Piece, ...] = (
    Piece("lo", 0, 3),
    Piece("mid", 3, 3),
    Piece("hi", 6, 2),
)


@dataclasses.dataclass(frozen=True)
class AggregationSpec:
    """Which low-bit-width multiplier serves each partial product.

    ``removed`` lists (a_piece_name, b_piece_name) partial products that are
    physically removed from the array (paper's MUL8x8_3: M2 + shifter gone).
    """

    name: str
    mul3x3: str                    # "mul3x3_1" | "mul3x3_2" | "exact"
    removed: Tuple[Tuple[str, str], ...] = ()
    pieces: Tuple[Piece, ...] = PIECES_332

    def table3(self) -> np.ndarray:
        if self.mul3x3 == "mul3x3_1":
            return mul3x3_1_table()
        if self.mul3x3 == "mul3x3_2":
            return mul3x3_2_table()
        if self.mul3x3 == "exact":
            return exact_table(3, 3)
        raise ValueError(self.mul3x3)


def aggregate_8x8(spec: AggregationSpec) -> np.ndarray:
    """Build the dense 256x256 LUT of the aggregated 8x8 multiplier.

    The nine piece-products: both-3-bit pieces and mixed 3/2-bit pieces go
    through the (possibly approximate) 3x3 LUT with the 2-bit piece
    zero-extended (values <= 3 never trigger the K-map error cases, so mixed
    products are exact regardless); hi*hi goes through an exact 2x2 multiplier.
    """
    t3 = spec.table3()
    t2 = exact_table(2, 2)
    A = np.arange(256, dtype=np.int64)
    B = np.arange(256, dtype=np.int64)
    out = np.zeros((256, 256), dtype=np.int64)
    for pa in spec.pieces:
        xa = pa.extract(A)
        for pb in spec.pieces:
            if (pa.name, pb.name) in spec.removed:
                continue
            xb = pb.extract(B)
            if pa.bits == 2 and pb.bits == 2:
                pp = t2[xa[:, None], xb[None, :]].astype(np.int64)
            else:
                pp = t3[xa[:, None], xb[None, :]].astype(np.int64)
            out += pp << (pa.shift + pb.shift)
    return out.astype(np.int32)


def piece_error_tables(spec: AggregationSpec) -> Dict[Tuple[str, str], np.ndarray]:
    """Per-piece-pair error LUTs: err[x, y] = exact(x*y) - approx_piece(x, y).

    For a removed partial product the error is the full exact piece product.
    Shapes are (2**bits_a, 2**bits_b).  The total multiplier error decomposes
    exactly as  err8x8(A, B) = sum_{pa,pb} err[pa,pb][a_pa, b_pb] << (sa+sb),
    which is the basis of the low-rank MXU correction (core/lowrank.py).
    """
    t3 = spec.table3()
    t2 = exact_table(2, 2)
    errs: Dict[Tuple[str, str], np.ndarray] = {}
    for pa in spec.pieces:
        for pb in spec.pieces:
            na, nb = 2 ** pa.bits, 2 ** pb.bits
            exact = exact_table(pa.bits, pb.bits).astype(np.int64)
            if (pa.name, pb.name) in spec.removed:
                err = exact
            elif pa.bits == 2 and pb.bits == 2:
                err = exact - t2[:na, :nb]
            else:
                err = exact - t3[:na, :nb].astype(np.int64)
            if np.any(err):
                errs[(pa.name, pb.name)] = err.astype(np.int32)
    return errs


# ---------------------------------------------------------------------------
# Named designs
# ---------------------------------------------------------------------------

SPEC_EXACT = AggregationSpec("exact8x8", "exact")
SPEC_MUL8X8_1 = AggregationSpec("mul8x8_1", "mul3x3_1")
SPEC_MUL8X8_2 = AggregationSpec("mul8x8_2", "mul3x3_2")
#: M2 = the A[2:0] x B[7:6] partial product (see module docstring / DESIGN.md).
SPEC_MUL8X8_3 = AggregationSpec("mul8x8_3", "mul3x3_2", removed=(("lo", "hi"),))


# ---------------------------------------------------------------------------
# Literature baselines reproduced for the paper's comparison tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pkm_2x2_table() -> np.ndarray:
    """Kulkarni et al. underdesigned 2x2 multiplier: 3*3 -> 7 (0b111)."""
    t = exact_table(2, 2)
    t[3, 3] = 7
    return t


def _aggregate_from_2x2(t2: np.ndarray) -> np.ndarray:
    """Recursive 2x2 -> 4x4 -> 8x8 aggregation used by PKM."""

    def up(t: np.ndarray, bits: int) -> np.ndarray:
        n = 2 ** bits
        half = bits // 2
        mask = (1 << half) - 1
        x = np.arange(n, dtype=np.int64)
        lo, hi = x & mask, x >> half
        tl = t.astype(np.int64)
        return (
            tl[lo[:, None], lo[None, :]]
            + (tl[hi[:, None], lo[None, :]] << half)
            + (tl[lo[:, None], hi[None, :]] << half)
            + (tl[hi[:, None], hi[None, :]] << (2 * half))
        )

    t4 = up(t2, 4)
    t8 = up(t4, 8)
    return t8.astype(np.int32)


@functools.lru_cache(maxsize=None)
def pkm_8x8_table() -> np.ndarray:
    return _aggregate_from_2x2(pkm_2x2_table())


@functools.lru_cache(maxsize=None)
def etm_8x8_table(split: int = 4) -> np.ndarray:
    """Error-tolerant multiplier (Kyaw et al.): exact multiplication on the
    MSB halves when either MSB half is non-zero, otherwise a non-multiplication
    LSB approximation.  This is the standard ETM model used in comparison
    surveys: if A[7:4] == 0 and B[7:4] == 0 -> exact LSB product; else
    multiply MSB halves exactly, and saturate every LSB product bit to 1.
    """
    A = np.arange(256, dtype=np.int64)
    a_hi, a_lo = A >> split, A & ((1 << split) - 1)
    out = np.zeros((256, 256), dtype=np.int64)
    lsb_ones = (1 << split) - 1  # all-ones LSB approximation
    for i in range(256):
        ah, al = int(a_hi[i]), int(a_lo[i])
        bh, bl = A >> split, A & ((1 << split) - 1)
        msb_zero = (ah == 0) & (bh == 0)
        exact_lo = al * bl
        approx = (ah * bh) << (2 * split)
        approx = approx | ((lsb_ones << split) * ((al > 0) | (bl > 0)))
        out[i] = np.where(msb_zero, exact_lo, approx)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# MSR fixed-shift truncation family (ROADMAP: Most-Significant-Run)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MSRSpec:
    """Most-Significant-Run fixed-shift truncation of the weight operand.

    DRUM-style designs keep a ``keep_bits``-wide window below the leading
    one, which needs a runtime leading-one detector and a barrel shifter.
    The MSR observation: in a two's-complement weight the run of identical
    sign bits below the MSB carries one bit of information, so the window
    start can be quantized to a SMALL FIXED set of shifts ``shifts`` —
    each shift is a hard-wired tap, selected by a priority encoder over
    ``len(shifts)`` range comparators instead of a full LOD + barrel
    shifter.  For an (unsigned, post-affine-quant) operand ``b`` the
    selected shift is the least ``s`` with ``b < 2**(keep_bits + s)`` and
    the low ``s`` bits are truncated::

        msr(b) = b & ~((1 << s) - 1)

    ``keep_bits + max(shifts)`` must cover the full operand width so every
    value selects a tap.  The multiplier then computes ``a * msr(b)``: a
    ``keep_bits``-wide multiplier plus the fixed shift network, in place
    of a full-width array.
    """

    keep_bits: int
    shifts: Tuple[int, ...]

    def __post_init__(self) -> None:
        if tuple(sorted(self.shifts)) != self.shifts or 0 not in self.shifts:
            raise ValueError("shifts must be ascending and include 0")
        if self.keep_bits + self.shifts[-1] < 8:
            raise ValueError("keep_bits + max shift must cover 8 bits")

    def shift_of(self, b: np.ndarray) -> np.ndarray:
        """Per-value selected shift: least s with b < 2**(keep_bits+s)."""
        b = np.asarray(b, dtype=np.int64)
        s = np.full(b.shape, self.shifts[-1], dtype=np.int64)
        for cand in reversed(self.shifts):
            s = np.where(b < (1 << (self.keep_bits + cand)), cand, s)
        return s

    def truncate(self, b: np.ndarray) -> np.ndarray:
        """msr(b): b with the selected shift's low bits cleared."""
        b = np.asarray(b, dtype=np.int64)
        return b & ~((1 << self.shift_of(b)) - 1)


#: The registered rungs.  msr4 is the serving-tier default: one comparator
#: (b < 16) picks between the identity tap and a single 4-bit truncation.
MSR_SPECS: Dict[str, MSRSpec] = {
    "mul8x8_msr2": MSRSpec(keep_bits=2, shifts=(0, 2, 4, 6)),
    "mul8x8_msr4": MSRSpec(keep_bits=4, shifts=(0, 4)),
    "mul8x8_msr6": MSRSpec(keep_bits=6, shifts=(0, 2)),
}


@functools.lru_cache(maxsize=None)
def msr_8x8_table(name: str) -> np.ndarray:
    """Dense 256x256 LUT of ``a * msr(b)`` for a registered MSR rung.

    Truncation is applied to the RHS operand only — weights sit on the RHS
    throughout this repo (see MUL8x8_3's M2-removal rationale above).
    """
    spec = MSR_SPECS[name.lower()]
    a = np.arange(256, dtype=np.int64)
    return (a[:, None] * spec.truncate(np.arange(256))[None, :]).astype(np.int32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mul8x8_table(name: str) -> np.ndarray:
    """256x256 int32 LUT for a named 8x8 multiplier."""
    name = name.lower()
    if name in ("exact", "exact8x8"):
        return exact_table(8, 8)
    if name == "mul8x8_1":
        return aggregate_8x8(SPEC_MUL8X8_1)
    if name == "mul8x8_2":
        return aggregate_8x8(SPEC_MUL8X8_2)
    if name == "mul8x8_3":
        return aggregate_8x8(SPEC_MUL8X8_3)
    if name == "pkm":
        return pkm_8x8_table()
    if name == "etm":
        return etm_8x8_table()
    if name in MSR_SPECS:
        return msr_8x8_table(name)
    raise KeyError(f"unknown multiplier {name!r}")


MULTIPLIERS: Tuple[str, ...] = (
    "exact",
    "mul8x8_1",
    "mul8x8_2",
    "mul8x8_3",
    "pkm",
    "etm",
    "mul8x8_msr2",
    "mul8x8_msr4",
    "mul8x8_msr6",
)


def get_multiplier(name: str) -> np.ndarray:
    return mul8x8_table(name)


def aggregation_spec(name: str) -> AggregationSpec:
    name = name.lower()
    return {
        "exact": SPEC_EXACT,
        "exact8x8": SPEC_EXACT,
        "mul8x8_1": SPEC_MUL8X8_1,
        "mul8x8_2": SPEC_MUL8X8_2,
        "mul8x8_3": SPEC_MUL8X8_3,
    }[name]
