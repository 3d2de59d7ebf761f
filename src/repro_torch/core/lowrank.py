"""Exact low-rank decomposition of approximate-multiplier error -> MXU form.

The paper's aggregated 8x8 multipliers satisfy, bit-exactly,

    approx(a, b) = a * b - err(a, b)
    err(a, b)    = sum_{(pa, pb)} E[pa, pb][ piece_pa(a), piece_pb(b) ] << (s_pa + s_pb)

where each per-piece-pair error LUT ``E`` is nonzero on at most three rows
(the K-map rewrites need both 3-bit operands >= 5), and a *removed* partial
product (MUL8x8_3) contributes the exact piece product (a rank-1 term).

This module factors ``err`` into a sum of F separable features

    err(a, b) = sum_f  u_f(a) * v_f(b)

so that a whole approximate matmul becomes dense matmuls:

    approx_matmul(A, B) = A @ B - U(A) @ V(B)        # U: (M, K*F), V: (K*F, N)

with ``u_f`` / ``v_f`` elementwise (indicator bits / tiny LUT sums -- VPU-cheap,
expressible with shifts+compares inside a kernel; no gathers needed).

Feature construction (indicators on the ``side`` operand):
  * indicator feature (piece pa, residue x):  u = 1[piece_pa(a) == x],
    v = sum_pb 2^{s_pa+s_pb} * E[pa,pb][x, piece_pb(b)]
  * linear feature (piece pa, for removed exact products):  u = piece_pa(a)*2^{s_pa},
    v = sum_{pb removed with pa} piece_pb(b) * 2^{s_pb}

Co-optimization-aware **range pruning**: if operands are known to satisfy
``a <= lhs_max`` / ``b <= rhs_max`` (e.g. the paper's retrained weights in
(0,31)), features whose ``u`` or ``v`` vanish on the restricted domain are
dropped — F falls from 6 to 3 for MUL8x8_2 with weights < 32, and the
MUL8x8_3 rank-1 term vanishes entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import multipliers as mul

__all__ = [
    "Feature",
    "LowRankCorrection",
    "build_correction",
    "piece_max",
    "u_map",
    "v_map",
]


def u_map(x: torch.Tensor, kind: str, shift: int, bits: int, residue: int,
          u_terms=(), dtype=torch.float64) -> torch.Tensor:
    """Indicator/linear/lut feature map as shift/mask/compare tensor ops on
    the codes (no gathers); ``dtype`` out.

    ``kind == "lut"`` evaluates a term list of the same shape as ``v_terms``
    (see ``v_map``) — used by the non-aggregated families (PKM / ETM / MSR)
    whose u-side maps are not a single indicator or bit-field."""
    if kind == "lut":
        return v_map(x, u_terms, dtype)
    piece = (x.to(torch.int32) >> shift) & ((1 << bits) - 1)
    if kind == "indicator":
        return (piece == residue).to(dtype)
    return (piece << shift).to(dtype)


def v_map(x: torch.Tensor, v_terms, dtype=torch.float64) -> torch.Tensor:
    """Small-LUT sum via compares+selects (``dtype`` out)."""
    xi = x.to(torch.int32)
    out = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for (shift, bits, row) in v_terms:
        piece = (xi >> shift) & ((1 << bits) - 1)
        for y, coef in enumerate(row):
            if coef != 0:
                out += (piece == y).to(dtype) * float(coef)
    return out


def piece_max(piece: mul.Piece, operand_max: int) -> int:
    """Maximum value the piece can take when the operand is <= operand_max."""
    full = (1 << piece.bits) - 1
    if operand_max >= 255:
        return full
    # piece values are <= operand_max >> shift, but can reach ``full`` whenever
    # operand_max >= (full << shift); tightest simple bound:
    return min(full, operand_max >> piece.shift if operand_max < ((full << piece.shift) | ((1 << piece.shift) - 1)) else full)


@dataclasses.dataclass(frozen=True)
class Feature:
    """One separable error feature: err contribution = u_tab[a] * v_tab[b]."""

    kind: str                  # "indicator" | "linear" | "lut"
    piece: str                 # A-side piece name carrying u
    residue: int               # indicator residue (-1 for linear/lut)
    u_tab: np.ndarray          # int32[256], elementwise map of the indicator side
    v_tab: np.ndarray          # int32[256], elementwise map of the other side
    # Structured form for in-kernel computation (no 256-gathers):
    u_shift: int               # piece LSB position
    u_bits: int                # piece width
    v_terms: Tuple[Tuple[int, int, Tuple[int, ...]], ...]
    # each v term: (pb_shift, pb_bits, row) with
    #   v(b) = sum_terms row[(b >> pb_shift) & mask]
    # "lut" features carry the u side in the same term form (see u_map):
    u_terms: Tuple[Tuple[int, int, Tuple[int, ...]], ...] = ()


@dataclasses.dataclass(frozen=True)
class LowRankCorrection:
    """err(a,b) = sum_f u_f(a)*v_f(b); ``side`` says which matmul operand the
    indicator (u) features are computed from ("lhs" or "rhs")."""

    multiplier: str
    side: str
    lhs_max: int
    rhs_max: int
    features: Tuple[Feature, ...]

    @property
    def num_features(self) -> int:
        return len(self.features)

    def u_stack(self) -> np.ndarray:
        """(F, 256) int32 stack of u tables."""
        if not self.features:
            return np.zeros((0, 256), np.int32)
        return np.stack([f.u_tab for f in self.features])

    def v_stack(self) -> np.ndarray:
        if not self.features:
            return np.zeros((0, 256), np.int32)
        return np.stack([f.v_tab for f in self.features])

    def error_table(self) -> np.ndarray:
        """Reconstructed 256x256 err LUT: err[a, b] for lhs value a, rhs b."""
        a = np.arange(256)
        b = np.arange(256)
        out = np.zeros((256, 256), np.int64)
        for f in self.features:
            if self.side == "lhs":
                out += f.u_tab[a][:, None].astype(np.int64) * f.v_tab[b][None, :]
            else:
                out += f.v_tab[a][:, None].astype(np.int64) * f.u_tab[b][None, :]
        return out.astype(np.int32)


def _error_tables_for_side(
    spec: mul.AggregationSpec, side: str
) -> Dict[Tuple[str, str], np.ndarray]:
    """Piece error tables keyed (indicator_piece, other_piece), transposed so
    the indicator side is always axis 0."""
    errs = mul.piece_error_tables(spec)
    if side == "lhs":
        return dict(errs)
    return {(pb, pa): e.T for (pa, pb), e in errs.items()}


def _terms_tab(terms) -> np.ndarray:
    """Dense int64[256] table of a term-list map (numpy mirror of v_map)."""
    x = np.arange(256, dtype=np.int64)
    out = np.zeros(256, np.int64)
    for (shift, bits, row) in terms:
        out += np.asarray(row, np.int64)[(x >> shift) & ((1 << bits) - 1)]
    return out


def _linear_terms(width: int, chunk: int = 4):
    """Term list computing ``x & (2**width - 1)`` in <= ``chunk``-bit pieces
    (each term has only 2**chunk - 1 nonzero coefficients -> cheap selects)."""
    terms = []
    s = 0
    while s < width:
        w = min(chunk, width - s)
        terms.append((s, w, tuple(y << s for y in range(1 << w))))
        s += w
    return terms


def _dense_term(tab: np.ndarray):
    """A single full-width term for an arbitrary 256-entry map."""
    return (0, 8, tuple(int(v) for v in np.asarray(tab, np.int64)))


def _generic_feature_pairs(name: str):
    """Exact separable factorizations  err(a, b) = sum_f A_f(a) * B_f(b)  for
    the non-aggregated families, as (a_terms, b_terms) pairs.

    * **PKM** is rank 1: every 2x2 Kulkarni cell errs by -2 exactly on the
      (3, 3) input, so  err(a, b) = u(a) * 2*u(b)  with
      ``u(x) = sum_i 4**i * [pair_i(x) == 3]`` over the four 2-bit pairs.
    * **ETM** (split 4, Z(x) = [x < 16], al/ah = low/high nibble): seven
      rank-1 features covering the cross terms, the dropped exact-low region
      and the all-ones LSB saturation.
    * **MSR** is rank 1:  err(a, b) = a * d(b)  with ``d(b) = b - msr(b)``
      (the truncated low bits).  ``d`` splits as a linear bit-field base plus
      a sparse dense-row correction so the in-kernel map stays select-cheap.
    """
    r16 = tuple(range(16))
    if name == "pkm":
        pair3 = lambda i, c: (2 * i, 2, (0, 0, 0, c))
        return [(
            [pair3(i, 4 ** i) for i in range(4)],
            [pair3(i, 2 * 4 ** i) for i in range(4)],
        )]
    if name == "etm":
        lo_lin = [(0, 4, r16)]
        hi_lin4 = [(4, 4, tuple(y << 4 for y in r16))]
        full_lin = lo_lin + hi_lin4
        below16 = lambda c: np.array([c * (0 < y < 16) for y in range(256)])
        x_below16 = lambda c: np.array([c * y * (y < 16) for y in range(256)])
        return [
            (full_lin, lo_lin),                                   # a * bl
            (lo_lin, hi_lin4),                                    # al * (bh<<4)
            ([_dense_term(x_below16(-1))], [_dense_term(x_below16(1))]),
            ([(0, 4, (0,) + (-240,) * 15)], [(0, 0, (1,))]),      # -240[al>0]
            ([(0, 4, (-240,) + (0,) * 15)], [(0, 4, (0,) + (1,) * 15)]),
            ([_dense_term(below16(240))], [(4, 4, (1,) + (0,) * 15)]),
            ([(0, 8, (240,) + (0,) * 255)], [_dense_term(below16(1))]),
        ]
    if name in mul.MSR_SPECS:
        spec = mul.MSR_SPECS[name]
        b = np.arange(256, dtype=np.int64)
        d = b - spec.truncate(b)
        base_terms = _linear_terms(spec.shifts[-1])
        resid = d - _terms_tab(base_terms)
        b_terms = base_terms + ([_dense_term(resid)] if np.any(resid) else [])
        return [(_linear_terms(8), b_terms)]
    raise KeyError(f"no generic factorization for {name!r}")


def _build_generic_correction(
    name: str, *, side: str, lhs_max: int, rhs_max: int
) -> LowRankCorrection:
    """Feature set for a non-aggregated family, verified exact at build time
    on the restricted domain (the factorizations above are hand-derived, so
    the reconstruction assert is the safety net, not a formality)."""
    ind_max = rhs_max if side == "rhs" else lhs_max
    oth_max = lhs_max if side == "rhs" else rhs_max
    features: List[Feature] = []
    for a_terms, b_terms in _generic_feature_pairs(name):
        a_tab, b_tab = _terms_tab(a_terms), _terms_tab(b_terms)
        if side == "rhs":
            u_tab, v_tab, u_terms, v_terms = b_tab, a_tab, b_terms, a_terms
        else:
            u_tab, v_tab, u_terms, v_terms = a_tab, b_tab, a_terms, b_terms
        # Range pruning: a feature vanishing on either restricted operand
        # domain contributes nothing (MSR goes fully exact for
        # rhs_max < 2**keep_bits — the identity tap always wins).
        if not np.any(u_tab[: ind_max + 1]) or not np.any(v_tab[: oth_max + 1]):
            continue
        features.append(
            Feature(
                kind="lut",
                piece="lut",
                residue=-1,
                u_tab=u_tab.astype(np.int32),
                v_tab=v_tab.astype(np.int32),
                u_shift=0,
                u_bits=0,
                v_terms=tuple(v_terms),
                u_terms=tuple(u_terms),
            )
        )
    corr = LowRankCorrection(
        multiplier=name,
        side=side,
        lhs_max=lhs_max,
        rhs_max=rhs_max,
        features=tuple(features),
    )
    want = (
        mul.exact_table(8, 8).astype(np.int64) - mul.mul8x8_table(name)
    )[: lhs_max + 1, : rhs_max + 1]
    got = corr.error_table()[: lhs_max + 1, : rhs_max + 1]
    assert np.array_equal(got, want), (
        f"generic factorization for {name!r} is not exact on "
        f"[0,{lhs_max}]x[0,{rhs_max}]"
    )
    return corr


def build_correction(
    multiplier: str,
    *,
    side: str = "rhs",
    lhs_max: int = 255,
    rhs_max: int = 255,
) -> LowRankCorrection:
    """Build the exact feature factorization for a named multiplier.

    ``side``: which matmul operand carries the 0/1 indicator features.  Use
    "rhs" when the rhs (weights) is static so U(W) can be precomputed, or when
    the weights are range-constrained by co-optimization (fewer rows survive).
    ``lhs_max``/``rhs_max``: known value bounds (inclusive) used for pruning.
    The result is exact on the restricted domain [0, lhs_max] x [0, rhs_max].

    Aggregated designs (exact / mul8x8_*) factor through their per-piece error
    tables; PKM / ETM / MSR take the generic hand-derived factorizations in
    ``_generic_feature_pairs`` (build-time verified).
    """
    if side not in ("lhs", "rhs"):
        raise ValueError(side)
    lname = multiplier.lower()
    if lname in ("pkm", "etm") or lname in mul.MSR_SPECS:
        return _build_generic_correction(
            lname, side=side, lhs_max=lhs_max, rhs_max=rhs_max
        )
    spec = mul.aggregation_spec(multiplier)
    pieces = {p.name: p for p in spec.pieces}
    ind_max = rhs_max if side == "rhs" else lhs_max   # bound on indicator operand
    oth_max = lhs_max if side == "rhs" else rhs_max   # bound on the other operand
    errs = _error_tables_for_side(spec, side)
    removed = {
        (pa, pb) if side == "lhs" else (pb, pa): True for (pa, pb) in spec.removed
    }

    vals = np.arange(256, dtype=np.int64)
    features: List[Feature] = []

    # --- rank-1 linear features for removed exact partial products ----------
    lin_pairs = [k for k in errs if removed.get(k)]
    for pa_name in sorted({pa for pa, _ in lin_pairs}):
        pa = pieces[pa_name]
        pa_cap = piece_max(pa, ind_max)
        if pa_cap == 0:
            continue  # u identically zero on restricted domain
        v_tab = np.zeros(256, np.int64)
        v_terms: List[Tuple[int, int, Tuple[int, ...]]] = []
        for (qa, qb) in lin_pairs:
            if qa != pa_name:
                continue
            pb = pieces[qb]
            if piece_max(pb, oth_max) == 0:
                continue  # v contribution identically zero
            v_tab += pb.extract(vals) << pb.shift
            row = tuple(int(y) << pb.shift for y in range(1 << pb.bits))
            v_terms.append((pb.shift, pb.bits, row))
        if not v_terms:
            continue
        u_tab = (pa.extract(vals) << pa.shift).astype(np.int32)
        features.append(
            Feature(
                kind="linear",
                piece=pa_name,
                residue=-1,
                u_tab=u_tab,
                v_tab=v_tab.astype(np.int32),
                u_shift=pa.shift,
                u_bits=pa.bits,
                v_terms=tuple(v_terms),
            )
        )

    # --- indicator features for approximate (LUT-error) partial products ----
    lut_pairs = [k for k in errs if not removed.get(k)]
    by_pa: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for (pa_name, pb_name) in lut_pairs:
        by_pa.setdefault(pa_name, []).append((pb_name, errs[(pa_name, pb_name)]))
    for pa_name in sorted(by_pa):
        pa = pieces[pa_name]
        pa_cap = piece_max(pa, ind_max)
        for x in range(1 << pa.bits):
            if x > pa_cap:
                continue
            v_tab = np.zeros(256, np.int64)
            v_terms = []
            for pb_name, e in by_pa[pa_name]:
                pb = pieces[pb_name]
                row = e[x].astype(np.int64) << (pa.shift + pb.shift)
                pb_cap = piece_max(pb, oth_max)
                if not np.any(row[: pb_cap + 1]):
                    continue
                v_tab += row[pb.extract(vals)]
                v_terms.append((pb.shift, pb.bits, tuple(int(r) for r in row)))
            if not v_terms:
                continue
            u_tab = (pa.extract(vals) == x).astype(np.int32)
            features.append(
                Feature(
                    kind="indicator",
                    piece=pa_name,
                    residue=x,
                    u_tab=u_tab,
                    v_tab=v_tab.astype(np.int32),
                    u_shift=pa.shift,
                    u_bits=pa.bits,
                    v_terms=tuple(v_terms),
                )
            )

    return LowRankCorrection(
        multiplier=multiplier,
        side=side,
        lhs_max=lhs_max,
        rhs_max=rhs_max,
        features=tuple(features),
    )
