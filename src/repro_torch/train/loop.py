"""Training step and loop: QAT with the approximate multiplier as the
forward semantics (every projection's value from the integer simulation,
K1 on the card, its gradient from the straight-through estimator),
microbatched gradient accumulation, the paper's band regularizer, optional
int8 gradient compression.  The JAX package's ``train/loop.py`` is the
reference; where it traces one jitted step, the port runs the same
operations eagerly and takes gradients with ``torch.autograd.grad``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import forward, init_params
from repro_torch.quant.affine import calibrate
from repro_torch.quant.qat import band_regularizer
from repro_torch.train import optim as O
from repro_torch.train.compression import compress_decompress
from repro_torch.train.tree import leaves, tree_map, unflatten

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


def _band_term(leaf: torch.Tensor, qmax: int) -> torch.Tensor:
    qp = calibrate(leaf, axis=(leaf.dim() - 2,), qmax=qmax)
    return band_regularizer(leaf, qp, band=(0, 31))


def _band_reg_term(cfg: ModelConfig, params) -> torch.Tensor:
    """The paper's weight-band regularizer over every 2-D+ weight, in the JAX
    package's leaf order.  Under autograd each leaf's term is recomputed in
    the backward instead of holding its full-size intermediates (about four
    copies of every weight at full width)."""
    a = cfg.approx
    dev = params["embed"].device
    if a.band_reg <= 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    total, n = torch.zeros((), dtype=torch.float32, device=dev), 0
    for leaf in leaves(params):
        if leaf.dim() >= 2 and leaf.shape[-1] > 1:
            total = total + checkpoint(_band_term, leaf, a.w_qmax, use_reentrant=False)
            n += 1
    return a.band_reg * total / max(n, 1)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01) -> Callable:
    def loss_fn(params, batch):
        logits = forward(cfg, params, batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)  # dense: no aux
        ce = cross_entropy(logits, batch["labels"])
        reg = _band_reg_term(cfg, params)
        loss = ce + aux_weight * aux + reg
        return loss, {"ce": ce, "aux": aux, "band_reg": reg}

    return loss_fn


def _detached(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in m.items()}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: O.OptConfig,
    *,
    microbatch: int = 0,
    grad_compression: bool = False,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens", "labels"} (B, S) tensors on the params' device.
    ``microbatch``: if > 1, split the batch into that many accumulation
    steps, run one after another (the JAX package's ``lax.scan``), and
    average their gradients and losses; the other metrics are the last
    microbatch's.  The step updates ``state`` in place (see ``optim``)."""
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, m = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, ps)
        return loss.detach(), _detached(m), unflatten(params, gs)

    def compute_grads(params, batch):
        if microbatch <= 1:
            return grads_of(params, batch)
        B = batch["tokens"].shape[0]
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

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, m, grads = compute_grads(state["params"], batch)
        if grad_compression:
            grads, state_err = compress_decompress(grads, state.get("grad_err"))
        else:
            state_err = state.get("grad_err")
        params, opt, om = O.apply_updates(opt_cfg, state["params"], grads, state["opt"])
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
