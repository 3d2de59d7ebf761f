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
(its local mean over ``size``) plus, on rank 0 alone, the band term, so
the ranks' gradients summed are the global batch's; the optimizer updates
the parts.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.core.approx import DataPart
from repro_torch.models.transformer import forward, init_params
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import all_reduce_sum
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


def _band_term(leaf, qmax: int) -> torch.Tensor:
    if isinstance(leaf, DataPart):
        leaf = leaf.whole()
    qp = calibrate(leaf, axis=(leaf.dim() - 2,), qmax=qmax)
    return band_regularizer(leaf, qp, band=(0, 31))


def _leaf_band_term(leaf, qmax: int) -> torch.Tensor:
    """One weight's band term, the mean over its elements.  A stacked
    weight (layers, experts) calibrates each (K, N) matrix alone (its
    scales are per output channel), so its mean is taken over chunks of
    matrices of at most ``LEAF_CHUNK`` elements, each weighted by its
    share: the same value up to float32 summation order.  Under autograd
    each chunk is recomputed in the backward instead of holding its
    intermediates, so no more than a few copies of one chunk exist at once
    (a whole stack's would be about five copies of 5.8 GB for zamba2-2.7b's
    stacked ``in_proj``).  A ``DataPart``'s chunks are its part's, each
    gathered whole inside the recomputed term (so the recompute gathers
    it again) and chunked by the whole matrices' size."""
    part = leaf.w if isinstance(leaf, DataPart) else leaf
    if part.dim() == 2:
        return checkpoint(_band_term, leaf, qmax, use_reentrant=False)
    mats = part.reshape(-1, *part.shape[-2:])
    per = max(1, LEAF_CHUNK // (leaf.shape[-2] * leaf.shape[-1]))
    total = None
    for chunk in mats.split(per):
        piece = leaf._replace(w=chunk) if isinstance(leaf, DataPart) else chunk
        t = checkpoint(_band_term, piece, qmax, use_reentrant=False) * (
            chunk.shape[0] / mats.shape[0])
        total = t if total is None else total + t
    return total


def _band_reg_term(cfg: ModelConfig, params) -> torch.Tensor:
    """The paper's weight-band regularizer over every 2-D+ weight, in the JAX
    package's leaf order, each weight's term recomputed in the backward
    (``_leaf_band_term``); a ``DataPart`` (data mesh) enters whole."""
    a = cfg.approx
    dev = leaves(params)[0].device
    if a.band_reg <= 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    total, n = torch.zeros((), dtype=torch.float32, device=dev), 0
    for leaf in leaves(params):
        if len(leaf.shape) >= 2 and leaf.shape[-1] > 1:
            total = total + _leaf_band_term(leaf, a.w_qmax)
            n += 1
    return a.band_reg * total / max(n, 1)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, batch) -> (loss, {"ce", "aux", "band_reg"}): token
    CE plus ``aux_weight`` times the MoE load-balance loss (0 for the other
    families) plus the band regularizer, as in the JAX package.  ``batch``
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
    """Refuse what data-parallel training does not cover: a mesh other
    than one data axis, and every family but the dense one (each named
    with its ROADMAP.md item)."""
    if tuple(mesh.axis_names) != ("data",):
        raise NotImplementedError(
            f"training over mesh axes {tuple(mesh.axis_names)}: only a data axis is ported "
            "(ROADMAP.md section 1, items 9-10: TP training, the pod axis)")
    if cfg.family == "moe":
        raise NotImplementedError(
            "data-parallel training of the moe family: its capacity, dropped assignments "
            "and load-balance term span the global batch (ROADMAP.md section 1, item 8: "
            "MoE data parallelism with global routing)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"data-parallel training of the {cfg.family} family is not ported "
            "(ROADMAP.md section 1, item 7: the ssm, hybrid, vlm and audio families "
            "under a data mesh)")


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

    ``mesh``: a ``launch.mesh.DataMesh`` (dense family).  ``state`` is
    then the rank's part (``parallel/fsdp.init_state`` or ``shard_state``)
    and ``batch`` the global batch, of which the step keeps the rank's
    rows; the metrics are global (the loss and CE the ranks' mean), the
    same on every rank."""
    aux_weight = 0.01
    loss_fn = make_loss_fn(cfg, aux_weight)
    if mesh is not None:
        check_data_mesh(cfg, mesh)

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
            # the rank's rows' share of the global mean, and the band term
            # once (rank 0's): the ranks' gradients then sum to the global
            # batch's, each cotangent at one device's scale before its bf16
            # rounding (dividing a rounded sum by a size such as 3 would not)
            objective = ((m["ce"] + aux_weight * m["aux"]) / mesh.size
                         + m["band_reg"] * float(mesh.rank == 0))
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
        """The ranks' means of the loss and the metrics, in one all-reduce."""
        keys = sorted(m)
        t = all_reduce_sum(torch.stack([loss] + [m[k] for k in keys]), mesh) / mesh.size
        return t[0], {k: v for k, v in zip(keys, t[1:].unbind())}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        split = None
        if mesh is not None:
            batch = fsdp.rank_rows(batch, cfg, mesh, microbatch)
        loss, m, grads = compute_grads(state["params"], batch)
        if mesh is not None:
            grads = unflatten(grads, fsdp.reduce_grads(leaves(grads), cfg, mesh))
            loss, m = global_metrics(loss, m)
            split = [d is not None for d in fsdp.data_dims(cfg, mesh.size)]
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
