"""Mixture-of-Experts FFN: a sigmoid-gated shared expert plus routed top-k
experts with a capacity (the JAX package's ``models/moe.py``).

Dispatch is sort-based with static shapes: token->expert assignments are
stably sorted by expert, each takes a rank within its expert, and
assignments past the expert's capacity are dropped (GShard semantics).
Expert weights are stacked (E, ...); a frozen stack is a ``QWeight`` whose
fields carry the expert axis, and each expert's slice is a view.

Every expert runs one ``dense`` per projection over its ``capacity`` rows,
all E of them, empty ones included: the JAX package scans its experts, and
skipping an empty one would need its count on the host.  The router stays
float32 (a control path; quantizing it is not part of the paper).  Nothing
here waits on the device.

Under a tensor-parallel mesh (``parallel/tp.shard_params``) the router,
the routing, the dispatch buffer and the combine are computed whole on
every rank, from the replicated activations.  Where the experts divide the
mesh, the stacks are expert ``Shard``s: a rank runs only its ``E/tp``
experts over their rows of the buffer, and one all-gather along the
expert axis (``collectives.all_gather_first``, bytes, exact) gives every
rank the whole output buffer.  Each expert's projections keep tp=1's
shapes, so the routed experts' sum is bit-identical to tp=1's, and so is
the block's output in the integer modes, where the shared expert's row
split sums exact integers (in float mode its float partial sums round
apart within 1e-6 relative); a SUM of per-rank combines would add the
floats in another order.  Otherwise the stacks are column
(``w_gate``/``w_up``) and row (``w_down``) ``Shard``s and every expert
runs through ``dense``'s Megatron split, its ``w_down`` reducing the
ranks' partial products.  The shared expert takes the column/row split.

Under a data mesh (``make_train_step(..., mesh=DataMesh)``, the leaves
``DataPart``s) each rank routes its own tokens as the JAX package routes
the whole global batch, whose tokens run rank after rank
(``parallel/fsdp.rank_rows``): the capacity is the global T's, and an
assignment's rank within its expert is its rank among the rank's own
plus the assignments of the lower ranks to that expert, from one
all-gather of every rank's per-expert counts, so the kept and dropped
assignments are the global ones.  Each rank writes its kept tokens at
their global rows of the dispatch buffer and one float32 SUM of the
ranks' buffers (``collectives.sum_rows``, exact: each row is one rank's)
gives every rank the global buffer, so every expert runs on JAX's rows
and its per-tensor activation range is the global buffer's, empty rows
counted as zeros; a rank reads back its own tokens' rows.  The expert
stacks are gathered once per layer and use, then cut by expert
(``core.approx.Gathered``), their gradient's bf16 rounding after the
ranks' sum.  The load-balance term ``E * sum_e f_e * P_e`` is bilinear
in the tokens: each rank returns ``E * sum_e f_e * P_e^rank``, with
``f`` the global fraction routed (from the same counts; it has no
gradient) and ``P^rank`` the mean router probability over its own
tokens, so the ranks' mean, which the training step takes, is the
global term and its gradient.  Over a pod axis (``launch.mesh.TrainMesh``)
the same runs over the batch group, pod x data, whose ranks hold the
global batch; the stacks are gathered over the data axis and their
gradients summed across the pods too.

The combine is deterministic: each token sums its k contributions in one
fixed order, by expert ascending from zero, which is the order of the JAX
package's scatter-add over the stably sorted assignments on the CPU (a
CUDA ``index_add_`` on floats would sum in the order its atomics land).
So is the backward: no read on the forward path gathers two nonzero
cotangents into one row.  The dispatch reads each token's k copies as a
permutation of its rows repeated k times (an ``expand``, whose backward
sums the k copies in one fixed order).  The combine's read repeats a row
only for dropped assignments, whose weight is 0: their cotangents are
exact zeros, which add the same in any order.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig, DataPart, Gathered, Shard
from repro_torch.models import layers as L
from repro_torch.parallel.collectives import all_gather_first, sum_rows

__all__ = ["Routing", "init_moe", "load_balance_loss", "moe_capacity", "moe_ffn", "route"]


def init_moe(gen: Optional[torch.Generator], d_model: int, d_ff: int, n_experts: int, *,
             shared_d_ff: int = 0, device=None) -> Dict[str, Any]:
    """The JAX package's ``MoEParams`` as a dict; without a shared expert
    (``shared_d_ff == 0``, as grok-1) its four fields are ``None``."""
    def ed(i, o):
        return L.truncated_normal_init((n_experts, i, o), gen, device=device)

    def shared(i, o):
        return L.init_dense(i, o, gen, device) if shared_d_ff else None

    return {
        "router": L.init_dense(d_model, n_experts, gen, device),
        "w_gate": ed(d_model, d_ff),
        "w_up": ed(d_model, d_ff),
        "w_down": ed(d_ff, d_model),
        "shared_gate": shared(d_model, shared_d_ff),
        "shared_up": shared(d_model, shared_d_ff),
        "shared_down": shared(shared_d_ff, d_model),
        "shared_router": shared(d_model, 1),
    }


def load_balance_loss(router_probs: torch.Tensor, expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    E = router_probs.shape[-1]
    f = expert_mask.mean(dim=0)                 # fraction routed per expert
    p = router_probs.mean(dim=0)                # mean router prob per expert
    return float(E) * (f * p).sum()


def moe_capacity(T: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Rows per expert: ``top_k * T * capacity_factor / E``, at least 1 and
    at most T, rounded down to a multiple of 8 and at least 8."""
    capacity = int(max(top_k * T * capacity_factor / n_experts, 1))
    capacity = min(capacity, T)
    return max(8, (capacity // 8) * 8)


class Routing(NamedTuple):
    """One routing of T tokens: ``probs`` (T, E) and ``top_e`` (T, k), then
    the T*k assignments stably sorted by expert: ``order`` (their flat
    (token, choice) index), weight ``sw``, whether each is
    ``keep``-t and its row ``slot`` of the (E * capacity) dispatch buffer;
    under a data mesh ``frac`` (E,), the global fraction of tokens routed
    to each expert (else None)."""

    probs: torch.Tensor
    top_e: torch.Tensor
    order: torch.Tensor
    sw: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    frac: Optional[torch.Tensor] = None


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int,
          mesh=None) -> Routing:
    """Top-k routing with capacity for (T, d) tokens: a float32 router,
    softmax, top-k, renormalization, a stable sort by expert, the rank
    within each expert, and drops past ``capacity``.  Under a data
    ``mesh`` ``x`` is the rank's block of the global tokens and the ranks
    within experts, the drops and the slots are the global batch's (one
    all-gather of the ranks' per-expert counts; module text).

    ``torch.topk`` promises no order among equal values (``jax.lax.top_k``
    takes the lower index); float32 softmax probabilities of a real router
    do not tie exactly, so the two pick the same experts."""
    T = x.shape[0]
    logits = x.to(torch.float32) @ router.to(torch.float32)            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)                    # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)                    # renorm
    flat_e = top_e.reshape(-1)                                         # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], top_p.reshape(-1)[order]
    # rank within expert: position minus the first position of its expert
    # (a search of the sorted ids: bincount would read its size on the host)
    rank = torch.arange(T * top_k, device=x.device) - torch.searchsorted(se, se)
    frac = None
    if mesh is not None:
        # the lower ranks' assignments to each expert come first in its
        # global order; their sum over every rank gives the fraction routed
        E = probs.shape[-1]
        counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        every = all_gather_first(counts, mesh).view(mesh.size, E)
        rank = rank + every[:mesh.rank].sum(dim=0)[se]
        frac = every.sum(dim=0).to(torch.float32) / float(T * mesh.size)
    keep = rank < capacity
    slot = se * capacity + torch.where(keep, rank, torch.zeros_like(rank))
    return Routing(probs, top_e, order, sw, keep, slot, frac)


def _expert_ffn(xb, wg, wu, wd, cfg: ApproxConfig):
    h = F.silu(L.dense(xb, wg, cfg)) * L.dense(xb, wu, cfg)
    return L.dense(h, wd, cfg)


def moe_ffn(
    x: torch.Tensor,                 # (T, d) tokens
    p: Dict[str, Any],
    *,
    top_k: int,
    cfg: ApproxConfig,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (T, d) in x's dtype, aux_loss float32 scalar).  Under
    a data mesh (``DataPart`` leaves) ``x`` is the rank's block of the
    global tokens and ``aux`` the rank's term (module text); over a pod
    axis too, the ranks that hold the global batch are its batch group
    (pod x data)."""
    T, d = x.shape
    E = p["router"].shape[-1]
    data = p["router"].batch if isinstance(p["router"], DataPart) else None
    capacity = moe_capacity(T * (data.size if data is not None else 1), top_k, E,
                            capacity_factor)
    r = route(x, L.whole(p["router"]), top_k, capacity, mesh=data)

    # ---- dispatch: kept slots are unique; dropped assignments write one
    # trash row past the buffer, which no expert reads.  The sorted
    # assignments' rows are a permutation of the (token, choice) rows of x
    # repeated top_k times
    trash = torch.full_like(r.slot, E * capacity)
    buf = x.new_zeros((E * capacity + 1, d))
    repeated = x[:, None, :].expand(T, top_k, d).reshape(T * top_k, d)
    buf[torch.where(r.keep, r.slot, trash)] = repeated[r.order]
    buf = buf[:-1]
    if data is not None:             # every rank's rows: the global buffer
        buf = sum_rows(buf, data)
    buf = buf.reshape(E, capacity, d)

    # ---- experts: one dense per projection and expert, empty ones
    # included; under an expert split the rank's experts, then every rank's
    # rows gathered in expert order; under a data mesh every expert, each
    # stack gathered once
    ws = [p[k] for k in ("w_gate", "w_up", "w_down")]
    ep = ws[0] if isinstance(ws[0], Shard) and ws[0].split == "expert" else None
    n = E // ep.mesh.size if ep is not None else E
    lo = ep.mesh.rank * n if ep is not None else 0
    if data is not None:
        per = [_gathered_experts(w, cfg) for w in ws]
    else:
        per = [L.unstack(w.w if ep is not None else w, n) for w in ws]
    out_buf = torch.stack([_expert_ffn(buf[lo + e], per[0][e], per[1][e], per[2][e], cfg)
                           for e in range(n)])
    if ep is not None:
        out_buf = all_gather_first(out_buf, ep.mesh)
    out_buf = out_buf.reshape(E * capacity, d)

    # ---- combine: back to (token, choice) order, then each token's k
    # contributions summed by expert ascending (the sorted order)
    w = torch.where(r.keep, r.sw, torch.zeros_like(r.sw))
    gathered = out_buf[r.slot] * w[:, None].to(x.dtype)
    contrib = torch.empty_like(gathered)
    contrib[r.order] = gathered
    contrib = contrib.reshape(T, top_k, d)
    by_expert = torch.argsort(r.top_e, dim=1)
    contrib = torch.take_along_dim(contrib, by_expert[..., None], dim=1)
    out = torch.zeros_like(x)
    for j in range(top_k):
        out = out + contrib[:, j]

    # ---- shared expert (qwen2-moe style, sigmoid-gated)
    if p["shared_gate"] is not None:
        sh = _expert_ffn(x, p["shared_gate"], p["shared_up"], p["shared_down"], cfg)
        gate = torch.sigmoid(x.to(torch.float32)
                             @ L.whole(p["shared_router"]).to(torch.float32))
        out = out + sh * gate.to(x.dtype)

    if r.frac is not None:           # the global fraction routed, the rank's probabilities
        return out, float(E) * (r.frac * r.probs.mean(dim=0)).sum()
    mask = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    mask.scatter_(1, r.top_e, 1.0)
    return out, load_balance_loss(r.probs, mask)


def _gathered_experts(stack: DataPart, cfg: ApproxConfig):
    """A layer's (E, K, N) expert stack on a data mesh, gathered whole once
    (one all-gather; for a replicated stack, none) and cut by expert into
    ``Gathered`` pieces: the backward sums the E experts' float32
    cotangents over the ranks in one reduce-scatter (one all-reduce; over
    a pod axis one more across the pods) and then rounds them to bf16
    where the straight-through product would have, as on one device."""
    bf = None if cfg.mode == "float" else torch.bfloat16
    whole = stack.owned(stack.value(), round_to=bf)
    return [Gathered(w) for w in whole.unbind(0)]
