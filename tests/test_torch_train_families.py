"""Training of every family in the port against the JAX package's.

One ``make_train_step`` step of the reduced moe (qwen2-moe-a2.7b), ssm
(falcon-mamba-7b), hybrid (zamba2-2.7b), vlm (qwen2-vl-2b, on embeddings
with a ``positions_thw`` grid) and audio (musicgen-large, on embeddings)
models from the JAX step's own state, against JAX's ``make_train_step``,
in float32 at ``reduced_config``, with and without the band regularizer:
the loss, ``ce``, ``aux`` (the MoE load-balance term), ``band_reg`` and
the new moments and parameters.  In ``float`` every family is held to
``tests/test_torch_train.py``'s tolerances (its ``_check_step``).

In a quantized mode the two packages' float32 elementwise functions
(RMSNorm's sum, ``silu``, ``softplus``, ``exp``) round one ulp apart now
and then, on the CPU as on the card, and a quantization input one ulp
across a rounding boundary takes the neighbouring code.  Each family's
quantized step is held in the mode, and to the tolerance, that this
leaves it (ROADMAP section 3, "ssm/hybrid sessions"):

* vlm: ``lowrank``, at ``test_torch_train.py``'s quantized tolerances
  (moments to one bf16 ulp, 2**-7, of their leaf's largest value);
* hybrid: ``exact_quant``, at the same tolerances;
* moe and audio: ``exact_quant``.  In ``lowrank`` a float weight's value
  ``y_lin + (y_int - y_lin)`` keeps ``y_lin``'s float32 summation order
  (the approximate product is too far from ``y_lin`` for the subtraction
  to be exact, as it is for the exact product), so the two packages'
  activations part by an ulp at every projection and codes flip
  downstream.  In ``exact_quant`` their forward agrees to float32
  roundoff (the moe's loss and ``aux`` bit for bit); their moments to
  two bf16 ulps (2**-6): every projection rounds its cotangent to bf16,
  and a routed expert's or a wider stack's gradient crosses more of those
  casts than granite's.  The moe's gradient norm, which sums the
  experts' rounded gradients, is held to rtol 2e-4 (1.3e-4 measured);
* ssm: ``exact_quant``, with code flips: its quantization inputs come out
  of ``silu`` (the conv), ``softplus`` and the scan's float32 sums, many
  of them per layer, so a few codes flip in either quantized mode.  The
  flips moved the loss by 8.6e-5 of itself, a moment by up to 4% of its
  leaf's largest and a weight with a gradient of certain sign by up to
  0.02 lr: the loss and metrics are held to rtol 2e-4, the moments to
  2**-4 of their leaf's largest and such weights' moves to 0.03 lr.

Whether a ``lowrank`` step flips a code is a matter of the data, not of
the family: on this batch (seed 0) granite's step in
``tests/test_torch_train.py`` flips none, but on the batch of seed 1 its
loss parts from JAX's by 6.0e-5; musicgen's (granite's dense stack at the
same reduced widths, on embeddings plus sinusoids) parts by 1.6e-4 on
this batch and by under 1e-7 on those of seeds 1-3, and sinusoids equal
to JAX's bit for bit change none of it.  So the moe, ssm, hybrid and
audio steps are held in ``lowrank`` too, the mode K1 replaces, at the
tightest tolerances this batch's step passes (``LOWRANK``; the vlm's is
the quantized case above).  Measured, as the share of the loss, of the
gradient norm and of a leaf's largest moment: moe 5.6e-5, 4.9e-4, 3.8e-2;
ssm 2.5e-5, 8.4e-5, 3.2e-2; hybrid 3.2e-4, 8.3e-3, 0.22; audio 1.6e-4,
2.4e-4, 2.4e-2; ``aux`` to 1.3e-6 and ``band_reg`` to 1.4e-7; every
weight whose gradient's sign is certain at that moment tolerance moves
as JAX's does.

Also: the MoE's input gradient against JAX's, a MoE step run twice bit for
bit (its backward adds no two nonzero cotangents into one row), remat
changing nothing, the checkpoint keys of each family's state against
JAX's, a MoE without a shared expert, and the training launcher on every
token-input family at ``--reduced --device cpu``, refusing an
embedding-input model before it builds weights.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import approx as japprox
from repro.models import moe as jM
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optim as JO
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import approx
from repro_torch.models import moe as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves

from test_torch_train import _batch, _jnp_leaves, _np

ARCHS = {"moe": "qwen2-moe-a2.7b", "ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
         "vlm": "qwen2-vl-2b", "audio": "musicgen-large"}
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, mode, band_reg):
    ja = japprox.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=band_reg)
    ta = approx.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=band_reg)
    return (dataclasses.replace(jreduced(jget_config(arch)), approx=ja),
            dataclasses.replace(reduced_config(get_config(arch)), approx=ta))


def _thw_grid(B_, S_):
    """A text prefix of 4 tokens, then an image of 3 x 4 patches (t fixed,
    h and w over the grid), then text again: three distinct streams."""
    thw = np.zeros((3, S_), np.int32)
    thw[:, :4] = np.arange(4)
    h, w = np.divmod(np.arange(12), 4)
    thw[0, 4:16], thw[1, 4:16], thw[2, 4:16] = 4, 4 + h, 4 + w
    thw[:, 16:] = 8 + np.arange(S_ - 16)
    return np.broadcast_to(thw, (B_, 3, S_)).copy()


def batches(tcfg, seed=0):
    """The same batch as numpy for both packages: tokens, or embeddings
    (and, for the vlm, a positions grid) with labels."""
    toks, labels = _batch(tcfg, B, S, seed)
    if tcfg.embed_input:
        return {"tokens": toks, "labels": labels}
    rng = np.random.default_rng(seed + 10)
    out = {"embeddings": rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32),
           "labels": labels}
    if tcfg.pos_embedding == "m_rope":
        out["positions_thw"] = _thw_grid(B, S)
    return out


# a family's quantized mode and its tolerances (see the module text): the
# loss's rtol, the other metrics' rtol, the moments' as a share of their
# leaf's largest value, and the move of a weight whose gradient's sign is
# certain, in units of lr; float: ``test_torch_train._check_step``'s
QUANTIZED = {"moe": ("exact_quant", 1e-5, 2e-4, 2**-6, 1e-3),
             "ssm": ("exact_quant", 2e-4, 2e-4, 2**-4, 3e-2),
             "hybrid": ("exact_quant", 1e-5, 1e-4, 2**-7, 1e-3),
             "vlm": ("lowrank", 1e-5, 1e-4, 2**-7, 1e-3),
             "audio": ("exact_quant", 1e-5, 1e-4, 2**-6, 1e-3)}
FLOAT = ("float", 1e-5, 1e-4, 1e-3, 1e-3)
# the same tolerances for each family's ``lowrank`` step (see the module text)
LOWRANK = {"moe": (1e-4, 1e-3, 2**-4, 1e-3),
           "ssm": (1e-4, 2e-4, 2**-4, 2e-2),
           "hybrid": (4e-4, 1e-2, 2**-2, 1e-3),
           "audio": (2e-4, 4e-4, 2**-5, 1e-3)}


def check_step(jst, jm, tst, tm, lr, loss_rtol, rtol, tol, move):
    """``test_torch_train._check_step`` with the tolerances given: the
    metrics, the moments, and each weight's move."""
    assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=loss_rtol)
    for k in ("ce", "aux", "band_reg", "grad_norm", "lr"):
        assert tm[k].item() == pytest.approx(float(jm[k]), rel=rtol, abs=1e-9), k
    for key in ("m", "v"):
        for a, b in zip(_np(tst["opt"][key]), _jnp_leaves(jst["opt"][key])):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    for a, b, m in zip(_np(tst["params"]), _jnp_leaves(jst["params"]),
                       _jnp_leaves(jst["opt"]["m"])):
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()     # the gradient's sign is certain
        assert sure.any() and d[sure].max() <= move * lr


def _step_against_jax(family, mode, band_reg, tols):
    jcfg, tcfg = _cfgs(ARCHS[family], mode, band_reg)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    jst = jloop.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    if not tcfg.embed_input:
        assert "embed" not in tst["params"]
    batch = batches(tcfg)
    jst, jm = jax.jit(jloop.make_train_step(jcfg, jopt))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst, tm = loop.make_train_step(tcfg, topt)(
        tst, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert (tm["aux"].item() > 0) == (family == "moe")
    assert (tm["band_reg"].item() > 0) == (band_reg > 0)
    check_step(jst, jm, tst, tm, float(jm["lr"]), *tols)


@pytest.mark.parametrize("band_reg", [0.0, 1e-4])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("family", list(ARCHS))
def test_train_step_matches_jax(family, quantized, band_reg):
    mode, *tols = QUANTIZED[family] if quantized else FLOAT
    _step_against_jax(family, mode, band_reg, tols)


@pytest.mark.parametrize("band_reg", [0.0, 1e-4])
@pytest.mark.parametrize("family", list(LOWRANK))
def test_lowrank_step_matches_jax(family, band_reg):
    _step_against_jax(family, "lowrank", band_reg, LOWRANK[family])


@pytest.mark.parametrize("mode", ["float", "lowrank"])
def test_moe_input_gradient_matches_jax(mode):
    """The gradient of ``moe_ffn`` with respect to its tokens, through the
    dispatch, the experts, the combine, the router and the shared expert,
    with the capacity binding."""
    T_, d, E, ff, k = 64, 16, 4, 24, 2
    p = jM.init_moe(jax.random.PRNGKey(0), d, ff, E, shared_d_ff=8)
    p = p._replace(router=p.router.at[:, 0].add(4.0))
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(T_, d)) + 1.0).astype(np.float32)
    c = rng.normal(size=(T_, d)).astype(np.float32)
    jcfg, tcfg = japprox.ApproxConfig(mode=mode), approx.ApproxConfig(mode=mode)

    def jfn(x_):
        out, aux = jM.moe_ffn(x_, p, top_k=k, cfg=jcfg)
        return jnp.sum(out * c) + aux

    jg = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = M.moe_ffn(xt, params_from_numpy(jax.tree.map(np.asarray, p)), top_k=k,
                         cfg=tcfg)
    ((out * torch.from_numpy(c)).sum() + aux).backward()
    assert not M.route(xt.detach(), torch.from_numpy(np.array(p.router)), k,
                       M.moe_capacity(T_, k, E, 1.25)).keep.all()
    # float: f32 roundoff; lowrank: the STE's bf16 casts (one bf16 ulp)
    tol = 1e-5 if mode == "float" else 2**-7
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=tol, atol=tol * np.abs(jg).max())


def test_moe_step_repeats_bit_for_bit():
    _, tcfg = _cfgs(ARCHS["moe"], "lowrank", 1e-4)
    batch = loop.as_batch(_batch(tcfg, B, S), "cpu")
    out = []
    for _ in range(2):
        st = loop.init_state(tcfg, O.OptConfig(), 0, device="cpu")
        st, m = loop.make_train_step(tcfg, O.OptConfig())(st, batch)
        out.append((m["loss"].item(), m["aux"].item(), _np(st)))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", list(ARCHS))
def test_remat_changes_nothing(family):
    """Recomputing each layer in the backward (the MoE routing, the scans)
    gives the step without it, bit for bit."""
    _, tcfg = _cfgs(ARCHS[family], QUANTIZED[family][0], 1e-4)
    batch = {k: torch.from_numpy(v) for k, v in batches(tcfg, seed=1).items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        st = loop.init_state(cfg, O.OptConfig(), 0, device="cpu")
        st, m = loop.make_train_step(cfg, O.OptConfig())(st, batch)
        out.append((m["loss"].item(), m["grad_norm"].item(), _np(st["params"])))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "vlm"])
def test_checkpoint_keys_match_jax(family):
    jcfg, tcfg = _cfgs(ARCHS[family], "float", 0.0)
    jst = jloop.init_state(jcfg, JO.OptConfig(), jax.random.PRNGKey(0))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    assert [k for k, _ in ckpt._flatten(tst)] == [k for k, _ in jckpt._flatten(jst)]
    assert [t.shape for t in leaves(tst)] == [x.shape for x in jax.tree.leaves(jst)]


def test_grok_moe_without_shared_expert_trains():
    """A MoE tree with ``None`` fields (grok-1: no shared expert) steps,
    and its ``None`` fields are no leaves, as in ``jax.tree``."""
    jcfg, tcfg = _cfgs("grok-1-314b", "float", 0.0)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    jst = jloop.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    assert tst["params"]["layers"]["moe"]["shared_gate"] is None
    assert len(leaves(tst)) == len(jax.tree.leaves(jst))
    toks, labels = _batch(tcfg, B, S)
    jst, jm = jax.jit(jloop.make_train_step(jcfg, jopt))(
        jst, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tst, tm = loop.make_train_step(tcfg, topt)(tst, loop.as_batch((toks, labels), "cpu"))
    check_step(jst, jm, tst, tm, float(jm["lr"]), *FLOAT[1:])


@functools.lru_cache(maxsize=None)
def _launch(arch, tmp):
    from repro_torch.launch import train as launch

    common = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt", tmp, "--ckpt-every", "1"]
    return launch.main(common + ["--steps", "2"]), launch.main(common + ["--steps", "3"])


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_launcher_trains_family_and_resumes(family, tmp_path):
    first, second = _launch(ARCHS[family], str(tmp_path / "ck"))
    assert first["start"] == 0 and len(first["losses"]) == 2
    assert second["start"] == 2 and len(second["losses"]) == 1
    assert np.isfinite(first["losses"] + second["losses"]).all()


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_launcher_refuses_embedding_inputs(family, monkeypatch):
    from repro_torch.launch import train as launch

    def no_weights(*a, **kw):
        raise AssertionError("weights built before the refusal")

    monkeypatch.setattr(launch, "init_state", no_weights)
    with pytest.raises(ValueError, match="takes embedding inputs"):
        launch.main(["--arch", ARCHS[family], "--reduced", "--device", "cpu", "--steps", "1"])
