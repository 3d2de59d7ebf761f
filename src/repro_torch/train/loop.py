"""Training step and loop: QAT with the approximate multiplier as the
forward semantics (every projection's value from the integer simulation,
K1 on the card, its gradient from the straight-through estimator),
microbatched gradient accumulation, the paper's band regularizer, optional
int8 gradient compression, for every family: the loss adds the MoE
load-balance term, and the vlm and audio backbones train on embeddings.
The JAX package's ``train/loop.py`` is the reference; where it traces one
jitted step, the port runs the same operations eagerly and takes gradients
with ``torch.autograd.grad``.

Under a data mesh (``make_train_step(..., mesh=DataMesh)``) one step on
``size`` ranks computes what the JAX package's step computes on the whole
global batch, up to float32 summation order: each rank runs its rows
(``parallel/fsdp.rank_rows``) through the forward on its FSDP parts
(``fsdp.wrap``) and differentiates its rows' share of the global mean CE
(its local mean over ``size``) plus the band term, whose backward gives
each rank its part's gradient of it (``_BandChunk``), so the ranks'
gradients summed are the global batch's; the optimizer updates the
parts.  A MoE layer routes over the global batch (``models/moe.py``)
and returns the rank's load-balance term, whose ranks' mean is the global
term, so it takes its share as the CE does.

On a ``launch.mesh.TrainMesh`` the same holds with the batch group (pod x
data) in the data axis's place: each rank's share is its local mean over
the batch group's size, its metrics the batch group's means.  The dense
family also trains over a model axis: the projections split Megatron-style
(``core.approx.DataPart``'s split), every rank of a model group holds the
same rows and computes the same loss, and the band term takes each
weight whole on every rank (``_BandChunk``), each rank's block its slice
of the term's gradient.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.core.approx import DataPart
from repro_torch.launch.mesh import mesh_tag, train_axes
from repro_torch.models.attention import check_tp_heads
from repro_torch.models.transformer import forward, init_params
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import all_reduce_sum, gather_value
from repro_torch.quant.affine import calibrate
from repro_torch.quant.qat import band_regularizer
from repro_torch.train import optim as O
from repro_torch.train.compression import compress_decompress
from repro_torch.train.tree import LEAF_CHUNK, leaves, tree_map, unflatten

__all__ = ["TrainState", "as_batch", "cross_entropy", "init_state", "make_loss_fn",
           "make_train_step", "train_loop"]

TrainState = Dict[str, Any]   # {"params": ..., "opt": {"step", "m", "v"}, ["grad_err"]}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE; logits (B, S, V) f32, labels (B, S) int.  The gold
    logit comes from an iota-compare masked sum, as in the JAX package."""
    logz = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    onehot = torch.arange(V, device=logits.device) == labels[..., None].long()
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return (logz - gold).mean()


def _band_term(w: torch.Tensor, qmax: int) -> torch.Tensor:
    qp = calibrate(w, axis=(w.dim() - 2,), qmax=qmax)
    return band_regularizer(w, qp, band=(0, 31))


def _band_value_and_grad(w: torch.Tensor, qmax: int):
    """One chunk's band term and its gradient for a unit cotangent."""
    with torch.enable_grad():
        w = w.detach().requires_grad_(True)
        t = _band_term(w, qmax)
        (g,) = torch.autograd.grad(t, w)
    return t.detach(), g


class _BandChunk(torch.autograd.Function):
    """One chunk's band term, whose backward is its cotangent times the
    term's gradient for a unit cotangent.  On one device (``cuts`` None)
    the gradient is recomputed in the backward from the chunk, so no
    intermediates are held until then.  On a mesh the rank's block is
    gathered whole once, in the forward (``cuts``: over the data axis,
    then over the model axis), where its gradient is taken at once and the
    rank's block of it kept: one all-gather an axis and chunk, where a
    recompute would gather it again and reduce-scatter the cotangent.
    Every rank computes the same term and gradient (and takes the term
    into its objective whole), so each block gets the gradient one device
    would give it (a row split's per-channel ranges span the model ranks,
    so a model part's own term would not), and the two paths compute
    alike: a one-rank mesh step is the no-mesh step bit for bit.  A leaf
    no rule covers (a norm scale, a plain tensor on every rank, its
    gradient summed over the batch group by ``fsdp.reduce_grads``) takes
    its band gradient on one rank of the batch group alone (``own`` False
    elsewhere)."""

    @staticmethod
    def forward(ctx, w, qmax, cuts, own=True):
        ctx.qmax, ctx.cuts, ctx.own = qmax, cuts, own
        if cuts is None:
            ctx.save_for_backward(w)
            return _band_term(w.detach(), qmax)
        whole = w.detach()
        for dim, axis in cuts:
            whole = gather_value(whole, dim, axis)
        t, g = _band_value_and_grad(whole, qmax)
        for dim, axis in reversed(cuts):
            n = g.shape[dim] // axis.size
            g = g.narrow(dim, axis.rank * n, n)
        ctx.save_for_backward(g.contiguous())
        return t

    @staticmethod
    def backward(ctx, grad):
        (saved,) = ctx.saved_tensors
        g = _band_value_and_grad(saved, ctx.qmax)[1] if ctx.cuts is None else saved
        return (grad * g if ctx.own else torch.zeros_like(g)), None, None, None


def _leaf_band_term(leaf, qmax: int, own: bool = True) -> torch.Tensor:
    """One weight's band term, the mean over its elements.  A stacked
    weight (layers, experts) calibrates each (K, N) matrix alone (its
    scales are per output channel), so its mean is taken over chunks of
    matrices of at most ``LEAF_CHUNK`` elements, each weighted by its
    share: the same value up to float32 summation order.  Each chunk is a
    ``_BandChunk``, so no more than a few copies of one chunk exist at
    once (a whole stack's would be about five copies of 5.8 GB for
    zamba2-2.7b's stacked ``in_proj``).  A ``DataPart``'s chunks are its
    block's, each gathered whole once and chunked by the whole matrices'
    size; ``own``: whether this rank takes a plain leaf's band gradient
    (``_BandChunk``)."""
    data = isinstance(leaf, DataPart)
    part = leaf.w if data else leaf
    cuts = tuple(leaf.cuts()) if data else None
    if part.dim() == 2:
        return _BandChunk.apply(part, qmax, cuts, own)
    mats = part.reshape(-1, *part.shape[-2:])
    size = leaf.shape[-2] * leaf.shape[-1] * (leaf.model.size if data and leaf.split else 1)
    per = max(1, LEAF_CHUNK // size)
    total = None
    for chunk in mats.split(per):
        t = _BandChunk.apply(chunk, qmax, cuts, own) * (chunk.shape[0] / mats.shape[0])
        total = t if total is None else total + t
    return total


def _band_reg_term(cfg: ModelConfig, params) -> torch.Tensor:
    """The paper's weight-band regularizer over every 2-D+ weight, in the JAX
    package's leaf order, each weight's term by chunks (``_leaf_band_term``);
    a ``DataPart`` (training mesh) enters whole."""
    a = cfg.approx
    dev = leaves(params)[0].device
    if a.band_reg <= 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    # under a mesh a plain leaf's band gradient is one rank's of the batch
    # group alone: its ranks' gradients of such a leaf are summed
    # (fsdp.reduce_grads)
    parts = [x for x in leaves(params) if isinstance(x, DataPart)]
    own = not parts or parts[0].batch is None or parts[0].batch.rank == 0
    total, n = torch.zeros((), dtype=torch.float32, device=dev), 0
    for leaf in leaves(params):
        if len(leaf.shape) >= 2 and leaf.shape[-1] > 1:
            total = total + _leaf_band_term(leaf, a.w_qmax, own or isinstance(leaf, DataPart))
            n += 1
    return a.band_reg * total / max(n, 1)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, batch) -> (loss, {"ce", "aux", "band_reg"}): token
    CE plus ``aux_weight`` times the MoE load-balance loss (0 for the other
    families) plus the band regularizer, as in the JAX package.  On a
    data mesh's rank (``fsdp.wrap``'d parameters, the rank's rows) ``ce``
    is the mean over its rows and ``aux`` its load-balance term, whose
    mean over the ranks is the global batch's (``make_train_step``
    differentiates their share, ``(ce + aux_weight * aux)`` over the batch
    group's size, and the band term on every rank).  ``batch``
    holds ``"labels"`` and ``"tokens"``, or ``"embeddings"`` (and, for
    multimodal rope, ``"positions_thw"``) for a model without token
    inputs."""

    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, batch.get("tokens"),
                              embeddings=batch.get("embeddings"),
                              positions_thw=batch.get("positions_thw"), return_aux=True)
        ce = cross_entropy(logits, batch["labels"])
        reg = _band_reg_term(cfg, params)
        loss = ce + aux_weight * aux + reg
        return loss, {"ce": ce, "aux": aux, "band_reg": reg}

    return loss_fn


def _detached(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in m.items()}


def check_data_mesh(cfg: ModelConfig, mesh) -> None:
    """Refuse what training on a mesh (a ``MeshShape``, a ``TrainMesh`` or
    a one-axis data mesh) does not cover, before any weight is built:
    axes other than pod, data and model; a model axis above 1 for any
    family but dense (the JAX rules turn a MoE's model axis into expert
    parallelism and split the Mamba blocks' scan parameters over it), or
    one that does not divide the heads (``TPHeadsError``), each naming
    ROADMAP.md's item 17.  Every family trains over pod and data."""
    names = tuple(mesh.axis_names)
    if not set(names) <= {"pod", "data", "model"}:
        raise NotImplementedError(f"training over mesh axes {names}: the axes are pod, data "
                                  "and model")
    tp = int(mesh.shape.get("model", 1)) if "model" in names else 1
    if tp > 1 and cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family} family over a model axis ({mesh_tag(mesh)}) is not "
            "ported: only the dense family trains tensor-parallel (ROADMAP.md section 1, "
            "item 17)")
    if tp > 1:
        check_tp_heads(cfg.num_heads, cfg.num_kv_heads, tp)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: O.OptConfig,
    *,
    microbatch: int = 0,
    grad_compression: bool = False,
    mesh=None,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens", "labels"} (B, S) tensors on the params' device,
    or {"embeddings" (B, S, d), "labels"[, "positions_thw" (B, 3, S)]} for
    a model without token inputs (the JAX package's batch dict).
    ``microbatch``: if > 1, split the batch into that many accumulation
    steps, run one after another (the JAX package's ``lax.scan``), and
    average their gradients and losses; the other metrics are the last
    microbatch's.  The step updates ``state`` in place (see ``optim``).

    ``mesh``: a ``launch.mesh.DataMesh`` (any family) or a
    ``launch.mesh.TrainMesh`` (any family over pod and data; the dense
    family over a model axis too).  ``state`` is then the rank's part
    (``parallel/fsdp.init_state`` or ``shard_state``) and ``batch`` the
    global batch, of which the step keeps the rank's rows; the metrics
    are global (the loss and CE the batch group's mean), the same on
    every rank."""
    aux_weight = 0.01
    loss_fn = make_loss_fn(cfg, aux_weight)
    rows = None
    if mesh is not None:
        check_data_mesh(cfg, mesh)
        rows = train_axes(mesh).batch
    share = 1 if rows is None else rows.size

    def grads_of(params, batch):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        if mesh is None:
            loss, m = loss_fn(params, batch)
            objective = loss
        else:
            loss, m = loss_fn(fsdp.wrap(params, cfg, mesh), batch)
            # the rank's rows' share of the global mean: the batch group's
            # gradients then sum to the global batch's, each cotangent at
            # one device's scale before its bf16 rounding (dividing a
            # rounded sum by a size such as 3 would not); the band term
            # whole, whose backward gives each part its own gradient
            objective = (m["ce"] + aux_weight * m["aux"]) / share + m["band_reg"]
        gs = torch.autograd.grad(objective, ps)
        return loss.detach(), _detached(m), unflatten(params, gs)

    def compute_grads(params, batch):
        if microbatch <= 1:
            return grads_of(params, batch)
        B = batch["labels"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} does not split into {microbatch} microbatches")
        size = B // microbatch
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        for j in range(microbatch):
            mb = {k: v[j * size:(j + 1) * size] for k, v in batch.items()}
            loss, m, grads = grads_of(params, mb)
            for a_, g in zip(leaves(acc), leaves(grads)):
                a_.add_(g)
            loss_sum = loss_sum + loss
            del grads
        for a_ in leaves(acc):
            a_.div_(microbatch)
        return loss_sum / microbatch, m, acc

    def global_metrics(loss, m):
        """The batch group's means of the loss and the metrics, in one
        all-reduce (the model ranks hold the same)."""
        if rows is None:
            return loss, m
        keys = sorted(m)
        t = all_reduce_sum(torch.stack([loss] + [m[k] for k in keys]), rows) / rows.size
        return t[0], {k: v for k, v in zip(keys, t[1:].unbind())}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        split = None
        if mesh is not None:
            batch = fsdp.rank_rows(batch, cfg, mesh, microbatch)
        loss, m, grads = compute_grads(state["params"], batch)
        if mesh is not None:
            grads = unflatten(grads, fsdp.reduce_grads(leaves(grads), cfg, mesh))
            loss, m = global_metrics(loss, m)
            split = fsdp.split_axes(cfg, mesh)
        if grad_compression:
            grads, state_err = compress_decompress(grads, state.get("grad_err"), mesh)
        else:
            state_err = state.get("grad_err")
        params, opt, om = O.apply_updates(opt_cfg, state["params"], grads, state["opt"],
                                          mesh=mesh, split=split)
        del grads
        new_state = {"params": params, "opt": opt}
        if state_err is not None:
            new_state["grad_err"] = state_err
        return new_state, {"loss": loss, **m, **om}

    return train_step


def init_state(cfg: ModelConfig, opt_cfg: O.OptConfig, seed: int = 0, *,
               grad_compression: bool = False, device=None) -> TrainState:
    """Seeded parameters (``init_params``) and zero optimizer state on
    ``device`` (default: the CUDA device, raising without one)."""
    params = init_params(cfg, seed, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    state: TrainState = {"params": params, "opt": O.init_opt_state(opt_cfg, params)}
    if grad_compression:
        state["grad_err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return state


def as_batch(pair, device) -> Dict[str, torch.Tensor]:
    """The ``(tokens, labels)`` pair that ``data.synthetic.token_batches``
    yields, as the step's ``{"tokens", "labels"}`` tensors on ``device``."""
    tokens, labels = pair
    return {"tokens": torch.as_tensor(tokens, device=device),
            "labels": torch.as_tensor(labels, device=device)}


def train_loop(
    cfg: ModelConfig,
    opt_cfg: O.OptConfig,
    batches: Iterable,
    *,
    steps: int,
    seed: int = 0,
    state: Optional[TrainState] = None,
    hooks: Tuple[Callable, ...] = (),
    device=None,
) -> Tuple[TrainState, Dict[str, list]]:
    """Single-process loop over ``(tokens, labels)`` batches (as
    ``token_batches`` yields them); the launcher (``launch/train.py``) adds
    checkpoint/restart and fault monitoring.  Step times are host seconds
    around a step that ends when its loss reaches the host."""
    if state is None:
        state = init_state(cfg, opt_cfg, seed, device=resolve_device(device))
    dev = leaves(state["params"])[0].device
    step_fn = make_train_step(cfg, opt_cfg)
    history: Dict[str, list] = {"loss": [], "step_time": []}
    it = iter(batches)
    for i in range(steps):
        batch = as_batch(next(it), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history["loss"].append(loss)
        history["step_time"].append(dt)
        for h in hooks:
            h(i, state, metrics, dt)
    return state, history
