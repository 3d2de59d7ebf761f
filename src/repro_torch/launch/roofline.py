"""Roofline of a step on one card: its work counted from the operations
it runs, and the least time the card could take for it.

Three terms, in seconds (``roofline_terms``):

    compute    = sum over operation classes of ops / the class's peak rate
    memory     = bytes / HBM rate
    collective = wire bytes / NVLink rate (per direction)

The rates are the card's data-sheet peaks (``CARDS``, keyed by
``torch.cuda.get_device_name()``); an unknown card raises
``UnknownCardError``.  The classes: bfloat16 (and float16) products at
the bf16 tensor rate; float32 products at the TF32 tensor rate when
``torch.backends.cuda.matmul.allow_tf32`` is on and at the float32 rate
(outside the tensor cores) when it is off; float64 products at the FP64
tensor rate; K1's products of uint8 codes at the int8 rate.

``count_costs(fn, *args)`` counts one call of ``fn`` (a training step, a
prefill, a decode step) under a ``TorchDispatchMode`` (``CostCounter``),
on any device, ``meta`` included, where nothing is allocated or launched:

* ``flops``: the products' operations, by class, from the formulas of
  ``torch.utils.flop_counter``;
* ``bytes``: operand plus result bytes of the operations that must
  round-trip HBM (products, reductions, gathers and scatters, embeddings,
  sorts, concatenations and pads, copies); pointwise operations are left
  out as fused into their neighbours.  A gather reads only the rows it
  gathers, and a scatter reads and writes only the rows it writes (twice
  its updates, plus its indices);
* ``bytes_raw``: the operand and result bytes of every operation that is
  not a view: what eager execution pays around the kernels;
* per hand-written kernel, its calls and work as its wrapper reports them
  (``kernels/work.py``: the work of the function, not of its design);
* ``peak_bytes``: the largest sum of the storages allocated during the
  call and alive at once (arguments excluded), and ``trace``: after each
  counted operation, its name and the bytes alive then (a storage's
  release is seen when it happens, through a weak reference to it).

The ``hlo_`` keys of ``roofline_terms`` keep the JAX package's names;
here they are counted from the executed operation stream, not from a
compiled module.  No collective is issued on one card yet, so the
collective term of every count here is 0; ``collective_wire_bytes`` holds
the ring factors for when one is.
"""
from __future__ import annotations

import dataclasses
import weakref
from array import array
from collections import defaultdict
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.work import KernelWork, k2_work

__all__ = [
    "CARDS",
    "CardRates",
    "CostCounter",
    "Costs",
    "F32_FLOPS_PER_S",
    "HBM_BYTES_PER_S",
    "INT8_OPS_PER_S",
    "TARGET_CARD",
    "UnknownCardError",
    "bound",
    "card_rates",
    "collective_wire_bytes",
    "combine",
    "count_costs",
    "k2_bound",
    "roofline_terms",
]


class CardRates(NamedTuple):
    """A card's peak rates: operations per second by class, bytes per
    second of HBM and of one NVLink direction."""

    bfloat16: float
    tf32: float
    float32: float
    float64: float
    int8: float
    hbm: float
    link: float


# NVIDIA's H100 SXM5 data sheet, dense rates (no sparsity) at its 700 W
# power limit; a card set below it runs slower under load
CARDS: Dict[str, CardRates] = {
    "NVIDIA H100 80GB HBM3": CardRates(
        bfloat16=989.4e12,      # BF16/FP16 tensor core
        tf32=494.7e12,          # TF32 tensor core
        float32=67e12,          # FP32, outside the tensor cores
        float64=67e12,          # FP64 tensor core
        int8=1978.9e12,         # INT8 tensor core
        hbm=3.35e12,            # HBM3
        link=450e9,             # NVLink 4, per direction
    ),
}
TARGET_CARD = "NVIDIA H100 80GB HBM3"    # the card the port is built for

_H100 = CARDS[TARGET_CARD]
HBM_BYTES_PER_S = _H100.hbm
INT8_OPS_PER_S = _H100.int8
F32_FLOPS_PER_S = _H100.float32


class UnknownCardError(KeyError):
    """No rates are known for this card."""


def card_rates(card: Optional[str] = None) -> CardRates:
    """The rates of ``card`` (default: ``torch.cuda.get_device_name()``)."""
    name = torch.cuda.get_device_name() if card is None else card
    if name not in CARDS:
        raise UnknownCardError(f"no data-sheet rates for the card {name!r}; known: "
                               f"{sorted(CARDS)}")
    return CARDS[name]


def _class_rate(rates: CardRates, op_class: str, tf32: bool) -> float:
    if op_class == "float32":
        return rates.tf32 if tf32 else rates.float32
    if op_class in ("bfloat16", "float64", "int8"):
        return getattr(rates, op_class)
    raise ValueError(f"no peak rate for operations of class {op_class!r}")


def bound(nbytes: float, ops: float, peak: float):
    """(ms, 'bytes' | 'operations'): the least time for the work on the
    target card."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound(B, H, hkv, hd, W, valid, qsize, esize, calls=1):
    """(ms, by) of ``calls`` K2 calls (``kernels/work.k2_work``)."""
    w = k2_work(B, H, hkv, hd, W, valid, qsize, esize)
    return bound(calls * w.bytes, calls * w.ops, F32_FLOPS_PER_S)


def collective_wire_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Wire bytes per device of one collective over ``group_size``
    devices, with the ring factors: all-reduce 2(n-1)/n of its result,
    all-gather, reduce-scatter and all-to-all (n-1)/n, a permute its
    result; 0 for a group of one."""
    n = group_size
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "collective-permute":
        return float(result_bytes)
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n * result_bytes
    raise ValueError(f"unknown collective {op!r}")


def roofline_terms(
    *,
    flops_per_device: Union[float, Dict[str, float]],
    bytes_per_device: float,
    wire_bytes_per_device: float,
    n_devices: int,
    model_flops_global: Optional[float] = None,
    card: Optional[str] = None,
) -> Dict[str, Any]:
    """The three terms and the bound of one step's per-device work on
    ``card`` (default: this process's CUDA device).  ``flops_per_device``
    is operations by class (``Costs.compute_by_class``), or one number
    counted at the bf16 tensor rate; float32's rate follows
    ``torch.backends.cuda.matmul.allow_tf32``.  ``roofline_fraction`` is
    the model FLOPs per second at the bound over the bf16 peak."""
    rates = card_rates(card)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    by_class = flops_per_device if isinstance(flops_per_device, dict) else {
        "bfloat16": float(flops_per_device)}
    t_c = sum(f / _class_rate(rates, c, tf32) for c, f in by_class.items())
    flops = float(sum(by_class.values()))
    t_m = bytes_per_device / rates.hbm
    t_x = wire_bytes_per_device / rates.link
    dominant = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])
    out: Dict[str, Any] = {
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "bound": dominant[0],
        "t_bound_s": dominant[1],
        "hlo_flops_global": flops * n_devices,
        "hlo_bytes_global": bytes_per_device * n_devices,
        "wire_bytes_global": wire_bytes_per_device * n_devices,
    }
    if isinstance(flops_per_device, dict):
        out["flops_by_class"] = dict(by_class)
    if model_flops_global:
        out["model_flops_global"] = model_flops_global
        out["useful_flop_fraction"] = model_flops_global / max(out["hlo_flops_global"], 1.0)
        t = max(dominant[1], 1e-30)
        out["model_flops_per_s"] = model_flops_global / t / n_devices
        out["roofline_fraction"] = out["model_flops_per_s"] / rates.bfloat16
    return out


# ---------------------------------------------------------------------------
# Counting the operations of one call
# ---------------------------------------------------------------------------

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv", "convolution",
             "_convolution", "convolution_backward", "_slow_conv2d_forward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp", "_softmax",
               "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
               "var", "std", "var_mean", "norm", "linalg_vector_norm", "argmax", "argmin",
               "cumsum", "cumprod", "any", "all"}
_GATHERS = {"index", "_unsafe_index", "index_select", "gather", "embedding"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put", "index_add",
             "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_",
             "masked_scatter", "masked_scatter_", "index_copy", "index_copy_"}
_MOVES = {"embedding_dense_backward", "searchsorted", "sort", "topk", "cat",
          "constant_pad_nd", "slice_backward", "select_backward", "slice_scatter",
          "select_scatter", "copy_", "clone", "repeat"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "_local_scalar_dense", "lift_fresh",
               "detach", "alias"}


def _class_of(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bfloat16"
    if dtype in (torch.float32, torch.float64):
        return str(dtype).replace("torch.", "")
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return str(dtype).replace("torch.", "")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Costs:
    """What ``count_costs`` counted (see the module text).  ``trace`` is
    (operation names, bytes alive after each), or None for a sum of
    counts (``combine``)."""

    flops: Dict[str, float]
    bytes: float
    bytes_raw: float
    peak_bytes: int
    kernels: Dict[str, Dict[str, Any]]
    n_ops: int
    trace: Optional[Tuple[Tuple[str, ...], array]] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def flops_total(self) -> float:
        return float(sum(self.flops.values()))

    def compute_by_class(self) -> Dict[str, float]:
        """Products' operations by class, each kernel's work in its own."""
        out = defaultdict(float, self.flops)
        for k in self.kernels.values():
            out[k["op_class"]] += k["ops"]
        return {c: f for c, f in out.items() if f}

    def total_bytes(self) -> float:
        """HBM bytes: the operations' and the kernels'."""
        return self.bytes + sum(k["bytes"] for k in self.kernels.values())


def combine(*terms: Tuple[float, Costs]) -> Costs:
    """The sum of ``coefficient * costs`` over ``terms`` (the dry run's
    extrapolation in depth); the peak is the largest of the terms'."""
    flops: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, Dict[str, Any]] = {}
    for k, c in terms:
        for cls, f in c.flops.items():
            flops[cls] += k * f
        for name, kw in c.kernels.items():
            acc = kernels.setdefault(name, {"calls": 0, "bytes": 0.0, "ops": 0.0,
                                            "design_ops": 0.0, "op_class": kw["op_class"]})
            for f in ("calls", "bytes", "ops", "design_ops"):
                acc[f] += k * kw[f]
    for kw in kernels.values():
        kw["calls"] = int(round(kw["calls"]))
    return Costs(dict(flops), sum(k * c.bytes for k, c in terms),
                 sum(k * c.bytes_raw for k, c in terms),
                 max(c.peak_bytes for _, c in terms), kernels,
                 int(round(sum(k * c.n_ops for k, c in terms))))


class CostCounter(TorchDispatchMode):
    """Counts the operations dispatched while it is active (see the
    module text); the kernels' wrappers report their calls through
    ``kernel_call``."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.bytes_raw = 0.0
        self.n_ops = 0
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self._live: Dict[int, tuple] = {}     # storage id -> (weak ref, bytes)
        self._live_bytes = 0
        self.peak_bytes = 0
        self._names: list = []
        self._alive = array("q")

    # -- storage lifetimes ---------------------------------------------------
    def _adopt(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()      # its Python object lives as long as the storage
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, lambda ref, key=key: self._release(key, ref)), n)
        self._live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def _release(self, key: int, ref) -> None:
        held = self._live.get(key)
        if held is not None and held[0] is ref:
            del self._live[key]
            self._live_bytes -= held[1]

    def _step(self, name: str) -> None:
        self._names.append(name)
        self._alive.append(self._live_bytes)

    # -- the kernels' reports ------------------------------------------------
    def kernel_call(self, name: str, work: KernelWork, run: Callable[[], Any]) -> Any:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0, "ops": 0.0,
                                           "design_ops": 0.0, "op_class": work.op_class})
        k["calls"] += 1
        k["bytes"] += work.bytes
        k["ops"] += work.ops
        k["design_ops"] += work.design_ops
        with _disable_current_modes():
            out = run()
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._adopt(t)
        self._step(name)
        return out

    # -- every other operation -----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if all(t.dim() == 0 for t in ins + outs):
            return out              # scalar arithmetic: no device work worth a count
        name = func._overloadpacket.__name__
        in_st = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in in_st]
        self.n_ops += 1
        for t in fresh:
            self._adopt(t)
        self._step(name)
        view = func.is_view or (not func._schema.is_mutable and outs and not fresh)
        if view or name in _NO_TRAFFIC:
            return out
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, fresh))
        self.bytes_raw += moved
        if func._overloadpacket in flop_registry and ins:
            self.flops[_class_of(ins[0].dtype)] += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if name in _GATHERS:          # the source (first operand) reads only what it gives
            self.bytes += 2 * sum(map(_nbytes, fresh)) + sum(map(_nbytes, ins[1:]))
        elif name in _SCATTERS:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        elif name in _PRODUCTS or name in _REDUCTIONS or name in _MOVES or (
                name == "_to_copy" and ins and outs and ins[0].dtype == outs[0].dtype):
            self.bytes += moved
        return out

    def costs(self) -> Costs:
        return Costs(dict(self.flops), self.bytes, self.bytes_raw, self.peak_bytes,
                     {k: dict(v) for k, v in self.kernels.items()}, self.n_ops,
                     (tuple(self._names), array("q", self._alive)))


def count_costs(fn: Callable[..., Any], *args, **kwargs) -> Costs:
    """The costs of one call ``fn(*args, **kwargs)`` (see the module
    text).  On ``meta`` tensors nothing is allocated and no kernel is
    launched; on the CPU the kernels' plain versions run unseen."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.costs()
