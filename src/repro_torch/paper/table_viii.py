"""Paper Table VIII on the port: DNN accuracy under approximate multipliers,
with and without hardware-driven co-optimization (retraining).  The JAX
package's ``benchmarks/table_viii.py``, with every multiplier's matmuls
through K1 (``mode="kernel"``) on the card.

    python -m repro_torch.paper.table_viii [--full] [--device D]

The protocol is the paper's: train in float, quantize with each multiplier
and measure the accuracy loss (DAL), retrain (QAT: a short fine-tune with
the multiplier in the forward pass) and measure again.  The data are the
synthetic MNIST/CIFAR-shaped sets of ``data/synthetic.image_dataset`` (1,024
train and 256 test images, as in the JAX benchmark), so accuracies are on
that data, not on MNIST or CIFAR-10.  The four LeNet rows always run;
AlexNet, VGG16 and ResNet-19 join under ``--full`` (which also trains 300
steps instead of 120).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig
from repro_torch.core.metrics import dal
from repro_torch.data.synthetic import ImageData, image_dataset
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.train.tree import leaves, tree_map

__all__ = ["MULTIPLIERS", "accuracy", "cross_entropy", "nets", "on_device", "run", "run_net",
           "sgd_step", "train"]

MULTIPLIERS = ("mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm")
BATCH = 64
N_TRAIN, N_TEST = 1024, 256
STEPS, FULL_STEPS = 120, 300          # float training steps, without and with --full
RETRAIN_STEPS, RETRAIN_LR = 30, 0.01


def nets(full: bool = False) -> List[Tuple[str, str]]:
    """(net, dataset) rows of the table: the LeNets, and the CIFAR CNNs
    when ``full``."""
    out = [("lenet", "mnist"), ("lenet_plus", "mnist"), ("lenet", "cifar10"),
           ("lenet_plus", "cifar10")]
    if full:
        out += [("alexnet", "cifar10"), ("vgg16", "cifar10"), ("resnet19", "cifar10")]
    return out


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy on ``one_hot(y, 10)``, as the JAX benchmark writes it."""
    return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * F.one_hot(y.long(), 10), -1))


def sgd_step(model: Dict[str, Any], x: torch.Tensor, y: torch.Tensor, cfg: ApproxConfig,
             lr: float) -> torch.Tensor:
    """One plain SGD step on ``model``'s parameters, in place; the loss."""
    params = leaves(model["layers"])
    loss = cross_entropy(cnn_forward(model, x, cfg), y)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return loss.detach()


def train(model: Dict[str, Any], data: Dict[str, torch.Tensor], cfg: ApproxConfig, steps: int,
          lr: float = 0.05, bs: int = BATCH) -> Dict[str, Any]:
    """``steps`` SGD steps over consecutive train batches, on a copy of
    ``model`` (the model passed in is left as it was)."""
    model = dict(model, layers=tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                        model["layers"]))
    n = data["x_train"].shape[0]
    for i in range(steps):
        j = (i * bs) % (n - bs)
        sgd_step(model, data["x_train"][j:j + bs], data["y_train"][j:j + bs], cfg, lr)
    return model


def accuracy(model: Dict[str, Any], data: Dict[str, torch.Tensor], cfg: ApproxConfig,
             n: int = N_TEST) -> float:
    with torch.no_grad():
        logits = cnn_forward(model, data["x_test"][:n], cfg)
    return (logits.argmax(-1) == data["y_test"][:n]).float().mean().item()


def on_device(data: ImageData, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(getattr(data, k)).to(device)
            for k in ("x_train", "y_train", "x_test", "y_test")}


def run_net(net: str, dataset: str, *, steps: int, device=None, seed: int = 0) -> Dict[str, Any]:
    """One row of the table: float accuracy, then each multiplier's accuracy
    before and after retraining, with the DAL of each."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    data = on_device(image_dataset(dataset, n_train=N_TRAIN, n_test=N_TEST, seed=0), dev)
    shape = (28, 28, 1) if dataset == "mnist" else (32, 32, 3)
    model = init_cnn(net, seed, in_shape=shape, device=dev)
    fl = ApproxConfig(mode="float")
    model = train(model, data, fl, steps)
    acc0 = accuracy(model, data, fl)
    row: Dict[str, Any] = {"net": net, "dataset": dataset, "steps": steps, "float_acc": acc0,
                           "multipliers": {}}
    for mname in MULTIPLIERS:
        acfg = ApproxConfig(multiplier=mname, mode="kernel")
        a = accuracy(model, data, acfg)
        # co-optimization: a short QAT fine-tune under the approximate forward
        retrained = train(model, data, acfg, RETRAIN_STEPS, lr=RETRAIN_LR)
        a_re = accuracy(retrained, data, acfg)
        row["multipliers"][mname] = {"acc": a, "dal": dal(acc0, a), "retrained_acc": a_re,
                                     "retrained_dal": dal(acc0, a_re)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    row["seconds"] = time.perf_counter() - t0
    return row


def row_text(row: Dict[str, Any]) -> str:
    """The JAX benchmark's result text for one row."""
    parts = [f"exact={row['float_acc']:.3f}"]
    for mname, m in row["multipliers"].items():
        parts.append(f"{mname}={m['acc']:.3f}->retrain {m['retrained_acc']:.3f} "
                     f"(DAL {m['retrained_dal']:+.3f})")
    return "; ".join(parts)


def run(full: bool = False, device=None) -> List[Tuple[str, float, str]]:
    """Rows (name, microseconds, result text) as the JAX benchmark's run()."""
    steps = FULL_STEPS if full else STEPS
    rows = []
    for net, ds in nets(full):
        row = run_net(net, ds, steps=steps, device=device)
        rows.append((f"table_viii/{net}-{ds}", row["seconds"] * 1e6, row_text(row)))
    return rows


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, float, str]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="add AlexNet, VGG16 and ResNet-19; 300 training steps")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run(full=args.full, device=dev)
    for name, us, text in rows:
        print(f"{name:30s} {us / 1e6:8.1f}s  {text}", flush=True)
    return rows


if __name__ == "__main__":
    main()
