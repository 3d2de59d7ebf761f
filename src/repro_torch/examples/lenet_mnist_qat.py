"""The paper's own experiment on LeNet (the JAX package's
``examples/lenet_mnist_qat.py`` on the port): train LeNet on synthetic
MNIST-shaped data, measure the DNN accuracy loss (DAL) of each approximate
multiplier, then apply the hardware-driven co-optimization (QAT retraining
with the weight-band regularizer) and measure the recovery.  A checkpoint
is written during training and restored at the end.

    python -m repro_torch.examples.lenet_mnist_qat [--device D] [--steps 150] \
        [--net lenet_plus] [--ckpt DIR]

Every multiplier's matmuls go through K1 (``mode="kernel"``) on the card;
``exact`` runs the exact integer product (``exact_quant``).
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.approx import ApproxConfig
from repro_torch.core.metrics import dal
from repro_torch.data.synthetic import image_dataset
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.paper.table_viii import accuracy, cross_entropy, on_device
from repro_torch.quant.affine import calibrate
from repro_torch.quant.qat import band_regularizer
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.tree import leaves, tree_map


def make_step(defs, cfg: ApproxConfig, lr: float, band_reg: float = 0.0):
    """An SGD step on a list of layer dicts (in place): cross-entropy plus
    ``band_reg`` times the band regularizer of every weight of rank >= 2
    (codes pulled into (0, 31)); returns the loss."""
    def step(layers, x, y):
        params = leaves(layers)
        loss = cross_entropy(cnn_forward({"defs": defs, "layers": layers}, x, cfg), y)
        if band_reg > 0:
            reg = 0.0
            for p in params:
                if p.dim() >= 2:
                    qp = calibrate(p, axis=(p.dim() - 2,), qmax=255)
                    reg = reg + band_regularizer(p, qp, band=(0, 31))
            loss = loss + band_reg * reg
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return loss.detach()

    return step


def _fresh(layers):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), layers)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="lenet", choices=["lenet", "lenet_plus"])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--retrain-steps", type=int, default=40)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--ckpt", default="", help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = on_device(image_dataset("mnist", n_train=2048, n_test=512, seed=0), dev)
    model = init_cnn(args.net, 0, in_shape=(28, 28, 1), device=dev)
    fl = ApproxConfig(mode="float")
    step = make_step(model["defs"], fl, lr=0.05)
    n_test = data["x_test"].shape[0]

    with tempfile.TemporaryDirectory(prefix="lenet_qat_ckpt-") as tmp:
        ckpt_dir = args.ckpt or tmp
        layers, n = _fresh(model["layers"]), data["x_train"].shape[0]
        for i in range(args.steps):
            j = (i * args.bs) % (n - args.bs)
            loss = step(layers, data["x_train"][j:j + args.bs], data["y_train"][j:j + args.bs])
            if i % 50 == 49:
                save_checkpoint(ckpt_dir, i + 1, {"layers": layers}, keep=2)
                print(f"step {i + 1}: loss {loss.item():.4f} (checkpointed)")
        model["layers"] = layers

        def acc(cfg, lyr=None):
            return accuracy(dict(model, layers=lyr if lyr is not None else model["layers"]),
                            data, cfg, n=n_test)

        acc0 = acc(fl)
        out: Dict[str, Any] = {"float_acc": acc0, "multipliers": {}}
        print(f"\nfloat accuracy: {acc0:.4f}")
        print(f"{'multiplier':12s} {'acc':>7s} {'DAL':>8s} {'retrained':>10s} {'DAL':>8s}")
        for mult in ("exact", "mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm"):
            acfg = ApproxConfig(multiplier=mult,
                                mode="exact_quant" if mult == "exact" else "kernel")
            a = acc(acfg)
            # co-optimization: QAT fine-tune under the approximate forward, with
            # the band regularizer pushing weight codes into (0, 31)
            qstep = make_step(model["defs"], acfg, lr=0.01, band_reg=1e-3)
            lyr = _fresh(model["layers"])
            for i in range(args.retrain_steps):
                j = (i * args.bs) % (n - args.bs)
                qstep(lyr, data["x_train"][j:j + args.bs], data["y_train"][j:j + args.bs])
            a_re = acc(acfg, lyr)
            out["multipliers"][mult] = {"acc": a, "retrained_acc": a_re}
            print(f"{mult:12s} {a:7.4f} {dal(acc0, a):+8.4f} {a_re:10.4f} {dal(acc0, a_re):+8.4f}")

        # restart path: restore the float checkpoint (fault-tolerance exercise)
        restored, s = restore_checkpoint(ckpt_dir, {"layers": model["layers"]})
        out["restored_step"], out["restored_acc"] = s, acc(fl, restored["layers"])
        print(f"\nrestored checkpoint at step {s}: accuracy {out['restored_acc']:.4f}")
    return out


if __name__ == "__main__":
    main()
