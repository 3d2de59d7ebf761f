"""The JAX system test's LeNet claim (``tests/test_system.py::
test_lenet_dal_and_cooptimization``) at several init keys, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/lenet_claim_seeds.py [--keys 8]

The test trains LeNet for 80 float steps on synthetic MNIST-shaped data
and asserts float accuracy > 0.8, a mul8x8_2 accuracy loss < 0.08 and
mul8x8_2 accuracy >= pkm's - 0.02.  Each line gives one key's three
accuracies and whether all three assertions hold, which shows how far the
claim at 80 steps depends on the init.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from repro.core.approx import ApproxConfig
from repro.data.synthetic import image_dataset
from repro.models.cnn import cnn_forward, init_cnn


def train(model, data, cfg, steps=80, lr=0.05, bs=64):
    def loss_fn(layers, x, y):
        logits = cnn_forward(dict(model, layers=layers), x, cfg)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(y, 10), -1))

    @jax.jit
    def step(layers, x, y):
        g = jax.grad(loss_fn)(layers, x, y)
        return jax.tree.map(lambda p, gr: p - lr * gr, layers, g)

    layers, n = model["layers"], data.x_train.shape[0]
    for i in range(steps):
        j = (i * bs) % (n - bs)
        layers = step(layers, jnp.asarray(data.x_train[j:j + bs]),
                      jnp.asarray(data.y_train[j:j + bs]))
    return dict(model, layers=layers)


def accuracy(model, data, cfg):
    logits = cnn_forward(model, jnp.asarray(data.x_test[:256]), cfg)
    return float(jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(data.y_test[:256])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=8)
    args = ap.parse_args()
    data = image_dataset("mnist", n_train=1024, n_test=256, seed=0)
    held = 0
    for k in range(args.keys):
        model = train(init_cnn("lenet", jax.random.PRNGKey(k), in_shape=(28, 28, 1)), data,
                      ApproxConfig(mode="float"))
        f = accuracy(model, data, ApproxConfig(mode="float"))
        m2 = accuracy(model, data, ApproxConfig(multiplier="mul8x8_2", mode="lowrank"))
        pkm = accuracy(model, data, ApproxConfig(multiplier="pkm", mode="lut"))
        ok = f > 0.8 and f - m2 < 0.08 and m2 >= pkm - 0.02
        held += ok
        print(f"key {k}: float {f:.4f} mul8x8_2 {m2:.4f} pkm {pkm:.4f} claim holds: {ok}",
              flush=True)
    print(f"the claim holds at {held} of {args.keys} keys")


if __name__ == "__main__":
    main()
