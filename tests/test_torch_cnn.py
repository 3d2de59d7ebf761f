"""The port's CNNs (``repro_torch.models.cnn``) against the JAX package's.

Inputs come from numpy seeds; weights are drawn in numpy at the JAX
``init_cnn`` shapes and brought across with ``bridge.cnn_from_numpy``.
Every size is small (batch 1-4, ResNet-19 at an 8x8x3 input with its full
channel widths).  Tolerances, each with its reason:

* im2col patches and max pooling move values without arithmetic: bit-equal
  to XLA's ``conv_general_dilated_patches`` and ``reduce_window``, at every
  (kernel, stride, padding) the seven nets use, stride-2 "SAME" on even
  and odd maps included;
* mean pooling, batch norm and one conv or FC layer fed identical inputs:
  float32 summation order, 1e-5 of the output's largest magnitude;
* a whole net in float: the same, 1e-5 of the largest logit.  VGG16 stacks
  13 batch norms whose statistics come from as few as 4 values at batch 1,
  and each multiplies the roundoff it receives; measured per layer the two
  frameworks drift apart by about 1e-6 of the scale per conv-BN pair, which
  reaches 1-2e-5 at the logits, so VGG16 is held to 1e-4 there and every
  one of its layers, fed identical inputs, to 1e-5;
* quantized modes: each dense call's activation and weight codes, fed the
  port's input, are bit-equal to the JAX package's, and its int32 product
  equals the sum over the JAX package's multiplier table bit for bit
  (``kernel``, ``lowrank`` and ``lut`` alike), for every net.  Whole nets:
  LeNet's loss and gradients through one quantized SGD step are held to the
  JAX package's ``lowrank`` mode run op by op (below), and ResNet-19's
  logits to its ``lut`` mode op by op (its integer products jitted, which
  leaves them exact) to 0.05 of the largest logit.  The JAX ``lowrank``
  mode sums in float32 and is inexact once a dot's sums pass 2**24
  (K >= 1152 with full-range codes, as in ResNet-19's deeper convs), so it
  cannot be ResNet-19's yardstick; under ``jit`` XLA moves some weight
  codes (see ``_jax_codes``), and float32 roundoff that differs across the
  frameworks can move an activation code.  ResNet-19 amplifies each such
  step of one code: against ``lut`` under ``jit`` the gap is 4.6% of the
  largest logit at this size (the LeNets: 1.7-2.2%), while op by op it
  measures 0 (bit-equal logits) on the CPU the suite runs on; the 0.05
  bound leaves room for one such step of roundoff on another CPU, not for
  a fault in the glue between the dense calls (residual adds, batch norm);
* one SGD step: the loss to rtol 1e-5; float gradients to 1e-5 of each
  leaf's largest; through the quantized forward to one bf16 ulp (2**-7) of
  each leaf's largest, since the STE rounds every cotangent to bf16 and a
  float32 sum that differs in its last bit can round to the neighbouring
  bf16 value.  A conv bias that feeds a batch norm has a true gradient of 0
  (the norm subtracts the mean), so both frameworks' values for it are
  roundoff: each leaf is held against the larger of its own largest
  gradient and a tenth of the step's largest.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro.core.multipliers import mul8x8_table
from repro.kernels.approx_matmul.ref import approx_matmul_ref
from repro.models import cnn as jcnn
from repro.quant import affine as jaffine
from repro_torch.bridge import cnn_from_numpy
from repro_torch.configs.paper_cnns import CNN_SPECS
from repro_torch.core import approx as tapprox
from repro_torch.models import cnn as tcnn
from repro_torch.paper import table_viii
from repro_torch.quant import affine as taffine
from repro_torch.train.tree import leaves

FLOAT_J = japprox.ApproxConfig(mode="float")
FLOAT_T = tapprox.ApproxConfig(mode="float")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's thread pool spinning on cores that other workers hold slows
    these CPU-heavy tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


def _models(name, in_shape, seed=0):
    """The JAX model of ``name`` and the port's, through the bridge, with
    numpy weights at the JAX ``init_cnn`` shapes and scales: weights He
    normals clipped at 2 std, biases and shifts small normals, BN scales
    about 1 (the JAX init itself costs seconds of compilation per net, and
    zero biases would hide a bias mixed up)."""
    shapes = jax.eval_shape(lambda: jcnn.init_cnn(name, jax.random.PRNGKey(0),
                                                  in_shape=in_shape)["layers"])
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            gain = 2.0 if len(s.shape) == 4 else 1.0
            std = np.sqrt(gain / np.prod(s.shape[:-1]))
            return (np.clip(rng.normal(size=s.shape), -2, 2) * std).astype(np.float32)
        base = 1.0 if key.endswith(("['gamma']", "['g1']", "['g2']")) else 0.0
        return (base + 0.1 * rng.normal(size=s.shape)).astype(np.float32)

    layers = jax.tree_util.tree_map_with_path(draw, shapes)
    jm = {"name": name, "layers": layers, "defs": jcnn._layer_defs(name, in_shape[-1], 10)}
    return jm, cnn_from_numpy(jm)


def _bucket(n):
    return 1 << max(10, (n - 1).bit_length())


def _jax_codes(x2, w):
    """The JAX package's activation and weight codes, op by op (under
    ``jit`` XLA turns the division by a per-channel scale into a product
    with its reciprocal, which moves a weight code at a rounding boundary
    now and then).  Each operand is padded to a power-of-two shape with
    copies of its own entries, which leaves every minimum and maximum, and
    so every code, as it was, and lets one compiled op serve many calls."""
    n = x2.size
    xf = x2.reshape(-1)
    xf = np.concatenate([xf, np.full(_bucket(n) - n, xf[0], xf.dtype)])
    K, N = w.shape
    wp = np.pad(w, ((0, _bucket(K) - K), (0, _bucket(N) - N)), mode="edge")
    xj, wj = jnp.asarray(xf), jnp.asarray(wp)
    qx = np.asarray(jaffine.quantize(xj, jaffine.calibrate(xj, qmax=255)))[:n]
    qw = np.asarray(jaffine.quantize(wj, jaffine.calibrate(wj, axis=(0,), qmax=255)))
    return qx.reshape(x2.shape), qw[:K, :N]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


CONVS = [  # (kernel, stride, padding, H, W): every conv the seven nets run
    (5, 1, "SAME", 28, 28), (5, 1, "VALID", 14, 14), (5, 1, "SAME", 32, 32),
    (5, 1, "VALID", 16, 16), (3, 1, "SAME", 10, 10), (3, 1, "SAME", 8, 8),
    (3, 2, "SAME", 32, 32), (3, 2, "SAME", 16, 16), (3, 2, "SAME", 7, 9),
    (1, 2, "SAME", 32, 32), (1, 2, "SAME", 7, 9), (3, 1, "SAME", 2, 2), (3, 1, "SAME", 1, 1),
]


@pytest.mark.parametrize("k,stride,padding,H,W", CONVS)
def test_conv_patches_bit_equal_xla_and_conv_matches(k, stride, padding, H, W):
    rng = np.random.default_rng(k * 100 + stride * 10 + H)
    C, O = 3, 5
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    w = rng.normal(size=(k, k, C, O)).astype(np.float32)
    b = rng.normal(size=(O,)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(k, k), window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tcnn.conv_patches(torch.from_numpy(x), k, k, stride, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    jy = np.asarray(jcnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                padding=padding, cfg=FLOAT_J))
    ty = tcnn.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                     stride=stride, padding=padding, cfg=FLOAT_T).numpy()
    assert ty.shape == jy.shape and _rel(jy, ty) <= 1e-5


def test_unknown_padding_raises():
    with pytest.raises(ValueError, match="padding"):
        tcnn.conv_patches(torch.zeros(1, 4, 4, 1), 3, 3, 1, "FULL")


@pytest.mark.parametrize("H,W", [(8, 8), (7, 9), (2, 3), (28, 28)])
def test_pools_and_batch_norm_match_jax(H, W):
    rng = np.random.default_rng(H * 10 + W)
    x = rng.normal(size=(3, H, W, 4)).astype(np.float32)
    np.testing.assert_array_equal(tcnn.max_pool(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcnn.max_pool(jnp.asarray(x))))
    ja = np.asarray(jcnn.avg_pool(jnp.asarray(x)))
    ta = tcnn.avg_pool(torch.from_numpy(x)).numpy()
    assert ta.shape == ja.shape and _rel(ja, ta) <= 1e-5
    g = rng.normal(size=(4,)).astype(np.float32)
    be = rng.normal(size=(4,)).astype(np.float32)
    jb = np.asarray(jcnn.batch_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be)))
    tb = tcnn.batch_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(be)).numpy()
    assert _rel(jb, tb) <= 1e-5


# ---------------------------------------------------------------------------
# whole nets
# ---------------------------------------------------------------------------


def _size(spec):
    shape = (8, 8, 3) if spec.name == "resnet19" else spec.in_shape
    return shape, (1 if spec.name == "vgg16" else 2)


def test_init_cnn_matches_the_reference_shapes():
    for key, spec in CNN_SPECS.items():
        jl = jax.tree.leaves(jax.eval_shape(lambda: jcnn.init_cnn(
            spec.name, jax.random.PRNGKey(0), in_shape=spec.in_shape)["layers"]))
        tm = tcnn.init_cnn(spec.name, 0, in_shape=spec.in_shape, device="cpu")
        assert tm["defs"] == jcnn._layer_defs(spec.name, spec.in_shape[-1], 10), key
        tl = leaves(tm["layers"])
        assert [x.shape for x in jl] == [tuple(t.shape) for t in tl], key
        # the same init: He-scaled truncated normals (within 2 std), zero
        # biases and shifts, unit BN scales
        for t in tl:
            if t.dim() >= 2:
                gain = 2.0 if t.dim() == 4 else 1.0
                std = np.sqrt(gain / np.prod(t.shape[:-1]))
                assert 0 < t.abs().max().item() <= 2.0 * std * (1 + 1e-6)
            else:
                assert set(t.unique().tolist()) <= {0.0, 1.0}
    assert tcnn.CNN_NAMES == jcnn.CNN_NAMES


def _jax_layer_outputs(jm, x, cfg):
    """Every layer's output of the JAX net, from one compiled function."""
    def run(layers, x):
        outs = []
        for d, p in zip(jm["defs"], layers):
            x = jcnn.cnn_forward({"defs": [d], "layers": [p]}, x, cfg)
            outs.append(x)
        return outs

    return [np.asarray(o) for o in jax.jit(run)(jm["layers"], jnp.asarray(x))]


@pytest.mark.parametrize("key", list(CNN_SPECS))
def test_cnn_float_forward_matches_jax(key):
    """Layer by layer: each port layer fed the JAX layer's input within 1e-5;
    the whole net's logits within 1e-5 (VGG16: 1e-4, see the module text)."""
    spec = CNN_SPECS[key]
    shape, B = _size(spec)
    jm, tm = _models(spec.name, shape)
    x = np.random.default_rng(1).random((B, *shape)).astype(np.float32)
    outs = _jax_layer_outputs(jm, x, FLOAT_J)
    for d, tp, j_in, j_out in zip(jm["defs"], tm["layers"], [x] + outs[:-1], outs):
        layer = tcnn.cnn_forward({"defs": [d], "layers": [tp]}, torch.from_numpy(j_in), FLOAT_T)
        assert layer.shape == j_out.shape
        assert _rel(j_out, layer.numpy()) <= 1e-5, d
    tx = tcnn.cnn_forward(tm, torch.from_numpy(x), FLOAT_T)
    assert tx.shape == (B, spec.num_classes)
    assert _rel(outs[-1], tx.numpy()) <= (1e-4 if spec.name == "vgg16" else 1e-5)


def _record_dense(monkeypatch, tm, x, cfg):
    """Logits of the port's net and every dense call's (input, weight)."""
    calls = []
    real = tcnn.dense

    def dense(x, w, cfg):
        calls.append((x.detach().clone(), w.detach().clone()))
        return real(x, w, cfg)

    with monkeypatch.context() as m:
        m.setattr(tcnn, "dense", dense)
        logits = tcnn.cnn_forward(tm, torch.from_numpy(x), cfg)
    return logits.numpy(), calls


@pytest.mark.parametrize("key", list(CNN_SPECS))
def test_cnn_quantized_dense_calls_bit_exact(key, monkeypatch):
    """``kernel`` (the plain version here), ``lowrank`` and (LeNets) ``lut``
    give the same logits, and every dense call of the net, fed the port's input,
    gives the JAX package's activation and weight codes and the int32 sum
    over its multiplier table (``sum_k LUT[a, b]``, evaluated in numpy on
    up to 2**20 / (K*N) rows) bit for bit."""
    spec = CNN_SPECS[key]
    shape, B = _size(spec)
    jm, tm = _models(spec.name, shape)
    x = np.random.default_rng(2).random((B, *shape)).astype(np.float32)
    mult = "mul8x8_2"
    tcfg = tapprox.ApproxConfig(multiplier=mult, mode="kernel")
    logits, calls = _record_dense(monkeypatch, tm, x, tcfg)
    # the LUT gather of a whole deep net is slow on the CPU; test_torch_paper
    # holds the lut mode to the others on every multiplier
    for mode in ("lowrank", "lut") if spec.name.startswith("lenet") else ("lowrank",):
        other = tcnn.cnn_forward(tm, torch.from_numpy(x),
                                 tapprox.ApproxConfig(multiplier=mult, mode=mode)).numpy()
        np.testing.assert_array_equal(other, logits)
    n_dense = sum(d[0] in ("conv", "fc") for d in jm["defs"]) + sum(
        2 + ("wp" in p) for d, p in zip(jm["defs"], jm["layers"]) if d[0] == "resblock")
    assert len(calls) == n_dense == (21 if spec.name == "resnet19" else n_dense)

    table = mul8x8_table(mult).astype(np.int64)
    for xin, w in calls:
        x2 = xin.reshape(-1, xin.shape[-1])
        _, t_qx = tapprox._act_codes(x2, tcfg)
        t_qw = taffine.quantize(w, taffine.calibrate(w, axis=(0,), qmax=255))
        j_qx, j_qw = _jax_codes(x2.numpy(), w.numpy())
        np.testing.assert_array_equal(t_qx.numpy(), j_qx)
        np.testing.assert_array_equal(t_qw.numpy(), j_qw)
        K, N = w.shape
        rows = max(1, min(x2.shape[0], (1 << 20) // (K * N)))
        want = table[j_qx[:rows].astype(np.int64)[:, :, None], j_qw.astype(np.int64)[None]].sum(1)
        got = tapprox.quantized_matmul(t_qx[:rows], t_qw, tcfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_resnet19_quantized_logits_match_jax(monkeypatch):
    """ResNet-19 in ``kernel`` against the JAX net in ``lut`` op by op, to
    the tolerance the module text states.  The JAX LUT gather runs under
    ``jit`` (an integer sum, exact either way; op by op it would add about
    20 s of compilation); the quantization around it stays op by op."""
    spec = CNN_SPECS["resnet19-cifar10"]
    shape, B = _size(spec)
    jm, tm = _models(spec.name, shape)
    x = np.random.default_rng(2).random((B, *shape)).astype(np.float32)
    jcfg = japprox.ApproxConfig(multiplier="mul8x8_2", mode="lut")
    monkeypatch.setattr(japprox, "quantized_matmul",
                        jax.jit(japprox.quantized_matmul, static_argnums=(2,)))
    jy = np.asarray(jcnn.cnn_forward(jm, jnp.asarray(x), jcfg))
    ty = tcnn.cnn_forward(tm, torch.from_numpy(x),
                          tapprox.ApproxConfig(multiplier="mul8x8_2", mode="kernel")).numpy()
    assert _rel(jy, ty) <= 0.05


# ---------------------------------------------------------------------------
# one SGD step
# ---------------------------------------------------------------------------


def _jax_grads(jm, x, y, cfg, jit):
    def loss_fn(layers):
        logits = jcnn.cnn_forward(dict(jm, layers=layers), jnp.asarray(x), cfg)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(y, 10), -1))

    vg = jax.value_and_grad(loss_fn)
    loss, g = (jax.jit(vg) if jit else vg)(jm["layers"])
    return float(loss), [np.asarray(t) for t in jax.tree.leaves(g)]


@pytest.mark.parametrize("key,mode", [("lenet-mnist", "float"), ("lenet-mnist", "kernel"),
                                      ("resnet19-cifar10", "float")])
def test_sgd_step_matches_jax(key, mode):
    spec = CNN_SPECS[key]
    shape, _ = _size(spec)
    jm, tm = _models(spec.name, shape, seed=3)
    rng = np.random.default_rng(3)
    x = rng.random((4, *shape)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    # the quantized step against the JAX package's lowrank mode op by op
    # (under jit its weight codes move now and then, see _jax_codes)
    jcfg = japprox.ApproxConfig(multiplier="mul8x8_2", mode="lowrank" if mode == "kernel" else mode)
    tcfg = tapprox.ApproxConfig(multiplier="mul8x8_2", mode=mode)
    jloss, jg = _jax_grads(jm, x, y, jcfg, jit=mode == "float")

    params = leaves(tm["layers"])
    for p in params:
        p.requires_grad_(True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss = table_viii.cross_entropy(tcnn.cnn_forward(tm, xt, tcfg), yt)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    tol = 1e-5 if mode == "float" else 2.0 ** -7
    assert len(grads) == len(jg)
    floor = 0.1 * max(np.abs(g).max() for g in jg)
    for g, want in zip(grads, jg):
        assert g.shape == want.shape
        assert np.abs(g.numpy() - want).max() <= tol * max(np.abs(want).max(), floor)

    # the step itself: p - lr * g, in place, with the same gradient
    lr = 0.05
    before = [p.detach().clone() for p in params]
    step_loss = table_viii.sgd_step(tm, xt, yt, tcfg, lr)
    assert step_loss.item() == loss.item()
    for p0, p1, g in zip(before, leaves(tm["layers"]), grads):
        assert torch.equal(p1.detach(), p0 - lr * g)


def test_cnn_checkpoint_crosses_from_jax(tmp_path):
    """A CNN's per-layer list checkpoints under the JAX package's keys: a
    checkpoint the JAX package wrote restores into the port's model."""
    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as tckpt

    jm, tm = _models("lenet", (28, 28, 1), seed=4)
    jckpt.save_checkpoint(str(tmp_path), 7, {"layers": jm["layers"]})
    target = {"layers": tcnn.init_cnn("lenet", 0, in_shape=(28, 28, 1), device="cpu")["layers"]}
    restored, step = tckpt.restore_checkpoint(str(tmp_path), target)
    assert step == 7
    for a, b in zip(leaves(restored["layers"]), leaves(tm["layers"])):
        assert torch.equal(a, b)
