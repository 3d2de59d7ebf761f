"""The port's QAT training slice against the JAX package's.

Inputs come from numpy seeds; parameters and optimizer state cross over
through ``repro_torch.bridge``.  Everything runs in float32 on
``reduced_config(granite-3-2b)`` (quantized modes amplify bf16 ulps into
code flips, so they are held to the reference in float32).  Tolerances,
each with its reason:

* elementwise float32 operations done in the same order (fake-quant,
  compression, the schedule, one optimizer update): equal to a few f32
  ulps (rtol 1e-6) — XLA and torch may round ``pow``/``cos``/``sqrt`` one
  ulp apart;
* sums and matmuls (norms, cross entropy, the band regularizer, the STE
  product): float32 summation order, rtol 1e-5 or an atol of 1e-5 on
  values of order 1;
* gradients that pass back through a bf16 cast (``approx_dense``): one
  bf16 ulp, rtol 2**-7, because a float32 sum that differs in its last
  bit can round to the neighbouring bf16 value;
* one whole training step: loss to rtol 1e-5; the new moments (which hold
  the gradient) to rtol 1e-3 and an atol of 1e-3 of their largest value.
  AdamW's first step moves each weight by lr times about the sign of its
  gradient, so a weight whose gradient lies within the moments' tolerance
  of zero may move by anything up to 2 lr (none may differ by more than
  2.1 lr); every other weight must move alike, to 1e-3 lr.  In a quantized mode
  every projection rounds its cotangents to bf16 (the STE product's casts),
  and a float32 sum that differs in its last bit now and then rounds to the
  neighbouring bf16 value, a difference that spreads through the layers
  below: there the moments are held to one bf16 ulp (2**-7) of their
  leaf's largest value.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import approx as japprox
from repro.data.synthetic import token_batches as jtoken_batches
from repro.quant import affine as jaffine
from repro.quant import qat as jqat
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import fault as jfault
from repro.train import loop as jloop
from repro.train import optim as JO
from repro_torch.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import approx
from repro_torch.data.synthetic import token_batches
from repro_torch.quant import affine, qat
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import fault
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves, leaves_with_path


def _np(tree):
    """A port tree (dicts of tensors) as numpy leaves in JAX flatten order."""
    return [t.detach().numpy() for t in leaves(tree)]


def _jnp_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _cfgs(mode="float", band_reg=0.0, **over):
    ja = japprox.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=band_reg)
    ta = approx.ApproxConfig(multiplier="mul8x8_2", mode=mode, band_reg=band_reg)
    jcfg = dataclasses.replace(jreduced(jget_config("granite-3-2b")), approx=ja, **over)
    tcfg = dataclasses.replace(reduced_config(get_config("granite-3-2b")), approx=ta, **over)
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 37)).astype(np.float32) * 3
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    got = loop.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    want = float(jloop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert got == pytest.approx(want, rel=1e-5)


def test_cosine_schedule_matches_jax():
    cfg = O.OptConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    jcfg = JO.OptConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 7, 99, 100, 101, 550, 999, 1000, 1500):
        got = O.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32)).item()
        want = float(JO.cosine_schedule(jcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _grad_tree(rng, scale=1.0):
    return {"b": {"w": rng.normal(size=(6, 5)).astype(np.float32) * scale,
                  "u": rng.normal(size=(3,)).astype(np.float32) * scale},
            "a": rng.normal(size=(4, 2, 3)).astype(np.float32) * scale}


def test_clip_by_global_norm_matches_jax():
    tree = _grad_tree(np.random.default_rng(1), scale=3.0)
    got, gn = O.clip_by_global_norm(params_from_numpy(tree), 1.0)
    want, jgn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    assert gn.item() == pytest.approx(float(jgn), rel=1e-6)
    for a, b in zip(_np(got), _jnp_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_optimizer_updates_match_jax(kind, clip):
    rng = np.random.default_rng(2)
    params = _grad_tree(rng)
    kw = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg, cfg = JO.OptConfig(**kw), O.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JO.init_opt_state(jcfg, jp)
    tp = params_from_numpy(params)
    tst = O.init_opt_state(cfg, tp)
    for _ in range(3):
        grads = _grad_tree(rng, scale=2.0)
        jp, jst, jm = JO.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, grads), jst)
        tp, tst, tm = O.apply_updates(cfg, tp, params_from_numpy(grads), tst)
        assert tm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert tm["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    for key in ("m", "v") if kind == "adamw" else ("m",):
        for a, b in zip(_np(tst[key]) + _np(tp), _jnp_leaves(jst[key]) + _jnp_leaves(jp)):
            # the clip scale carries the norm's summation order into every
            # element, and m = b1 m + (1 - b1) g may cancel: a few ulps of
            # the leaf's largest value
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def test_fake_quant_value_and_grad_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 9)).astype(np.float32)
    c = rng.normal(size=(7, 9)).astype(np.float32)
    jqp = jaffine.calibrate(jnp.asarray(x), axis=(0,), qmax=31)
    jv, jg = jax.value_and_grad(
        lambda x_: jnp.sum(jqat.fake_quant(x_, jqp) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    qp = affine.calibrate(xt.detach(), axis=(0,), qmax=31)
    fq = qat.fake_quant(xt, qp)
    np.testing.assert_array_equal(fq.detach().numpy(),
                                  np.asarray(jqat.fake_quant(jnp.asarray(x), jqp)))
    total = (fq * torch.from_numpy(c)).sum()
    total.backward()
    assert total.item() == pytest.approx(float(jv), rel=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))   # the identity: c


def test_band_regularizer_value_and_grad_match_jax():
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(3, 16, 8)) * 0.2).astype(np.float32)

    def jfn(w_):
        return jqat.band_regularizer(w_, jaffine.calibrate(w_, axis=(1,), qmax=255))

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    v = qat.band_regularizer(wt, affine.calibrate(wt, axis=(1,), qmax=255))
    v.backward()
    assert v.item() == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


def test_compress_decompress_matches_jax():
    rng = np.random.default_rng(5)
    g1, g2 = _grad_tree(rng), _grad_tree(rng)
    jg, je = jcomp.compress_decompress(jax.tree.map(jnp.asarray, g1), None)
    tg, te = comp.compress_decompress(params_from_numpy(g1), None)
    jg, je = jcomp.compress_decompress(jax.tree.map(jnp.asarray, g2), je)
    tg, te = comp.compress_decompress(params_from_numpy(g2), te)
    for a, b in zip(_np(tg) + _np(te), _jnp_leaves(jg) + _jnp_leaves(je)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["exact_quant", "lowrank"])
@pytest.mark.parametrize("per_row", [False, True])
def test_approx_dense_value_and_grads_match_jax(mode, per_row):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    w = (rng.normal(size=(40, 24)) * 0.2).astype(np.float32)
    c = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jcfg = japprox.ApproxConfig(multiplier="mul8x8_2", mode=mode, act_per_row=per_row)
    tcfg = approx.ApproxConfig(multiplier="mul8x8_2", mode=mode, act_per_row=per_row)

    def jfn(x_, w_):
        y = japprox.approx_dense(x_, w_, jcfg)
        return jnp.sum(y * c), y

    (_, jy), (jgx, jgw) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = approx.approx_dense(xt, wt, tcfg)
    assert y.dtype == torch.float32 and y.shape == (2, 3, 24)
    (y * torch.from_numpy(c)).sum().backward()
    # value: identical codes and integer products; y_lin's float32 sum order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    # the value is the integer simulation, not the STE product
    qx = affine.quantize(xt.detach().reshape(-1, 40), affine.calibrate(
        xt.detach().reshape(-1, 40), axis=(1,) if per_row else None))
    assert qx.dtype == torch.uint8
    # gradients: one bf16 ulp (they pass back through the bf16 casts)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=2**-7, atol=1e-6)


def test_approx_dense_value_is_the_integer_simulation():
    """The STE sum's value is y_int to float32 roundoff, far from the STE
    product alone (which differs by the multiplier's error)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 16)) * 0.2).astype(np.float32))
    cfg = approx.ApproxConfig(multiplier="mul8x8_3", mode="lowrank")
    y = approx.approx_dense(x, w, cfg)
    frozen = approx.prequantize_tree({"wq": w}, cfg)["wq"]
    np.testing.assert_allclose(y.numpy(), approx.approx_dense(x, frozen, cfg).numpy(),
                               rtol=0, atol=1e-5)


def test_token_batches_bit_equal_to_jax():
    a, b = token_batches(512, 4, 16, seed=3), jtoken_batches(512, 4, 16, seed=3)
    for _ in range(5):
        (ta, la), (tb, lb) = next(a), next(b)
        assert ta.dtype == tb.dtype == np.int32
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------


def _batch(cfg, B=4, S=16, seed=0):
    toks, labels = next(token_batches(cfg.vocab_size, B, S, seed=seed))
    return toks, labels


def _check_step(jst, jm, tst, tm, lr, quantized):
    assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    for k in ("ce", "band_reg", "grad_norm", "lr"):
        assert tm[k].item() == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-9), k
    tol = 2**-7 if quantized else 1e-3
    for key in ("m", "v"):
        for a, b in zip(_np(tst["opt"][key]), _jnp_leaves(jst["opt"][key])):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    for a, b, m in zip(_np(tst["params"]), _jnp_leaves(jst["params"]),
                       _jnp_leaves(jst["opt"]["m"])):
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()     # the gradient's sign is certain
        assert sure.any() and d[sure].max() <= 1e-3 * lr


@pytest.mark.parametrize("mode,band_reg", [("float", 0.0), ("lowrank", 1e-4)])
def test_train_step_matches_jax(mode, band_reg):
    jcfg, tcfg = _cfgs(mode, band_reg)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    jst = jloop.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    toks, labels = _batch(tcfg)
    jst, jm = jax.jit(jloop.make_train_step(jcfg, jopt))(
        jst, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tst, tm = loop.make_train_step(tcfg, topt)(tst, loop.as_batch((toks, labels), "cpu"))
    if band_reg:
        assert tm["band_reg"].item() > 0
    _check_step(jst, jm, tst, tm, float(jm["lr"]), quantized=mode != "float")


def test_remat_changes_nothing():
    _, tcfg = _cfgs("lowrank", 1e-4)
    toks, labels = _batch(tcfg)
    batch = loop.as_batch((toks, labels), "cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        st = loop.init_state(cfg, O.OptConfig(), 0, device="cpu")
        st, m = loop.make_train_step(cfg, O.OptConfig())(st, batch)
        out.append((m["loss"].item(), m["grad_norm"].item(), _np(st["params"])))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(a, b)


def test_microbatch_accumulation_equals_whole_batch():
    _, tcfg = _cfgs("float")
    opt = O.OptConfig(kind="sgd", lr=1e-2, clip_norm=0.0, warmup_steps=0)
    batch = loop.as_batch(_batch(tcfg, B=8), "cpu")
    res = []
    for mb in (1, 4):
        st = loop.init_state(tcfg, opt, 0, device="cpu")
        st, m = loop.make_train_step(tcfg, opt, microbatch=mb)(st, batch)
        res.append((m["loss"].item(), _np(st["params"])))
    assert res[0][0] == pytest.approx(res[1][0], rel=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)   # the JAX test's bound


def test_grad_compression_step_matches_jax():
    jcfg, tcfg = _cfgs("float")
    kw = dict(kind="sgd", lr=1e-2, warmup_steps=0, total_steps=10)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    jst = jloop.init_state(jcfg, jopt, jax.random.PRNGKey(1), grad_compression=True)
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    toks, labels = _batch(tcfg, seed=1)
    jst, jm = jax.jit(jloop.make_train_step(jcfg, jopt, grad_compression=True))(
        jst, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tst, tm = loop.make_train_step(tcfg, topt, grad_compression=True)(
        tst, loop.as_batch((toks, labels), "cpu"))
    assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    # SGD moves each weight by lr times its (int8-rounded) gradient
    for a, b in zip(_np(tst["params"]), _jnp_leaves(jst["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * float(jm["lr"]))


def test_train_loop_runs_on_token_batches():
    tcfg = dataclasses.replace(reduced_config(get_config("granite-3-2b")),
                               approx=approx.ApproxConfig(mode="kernel", band_reg=1e-4))
    opt = O.OptConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    seen = []
    state, hist = loop.train_loop(tcfg, opt, token_batches(tcfg.vocab_size, 4, 16),
                                  steps=3, device="cpu",
                                  hooks=(lambda i, s, m, dt: seen.append(i),))
    assert seen == [0, 1, 2] and len(hist["loss"]) == len(hist["step_time"]) == 3
    assert np.isfinite(hist["loss"]).all()
    assert int(state["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------


def test_checkpoint_keys_match_jax():
    jcfg, tcfg = _cfgs()
    jst = jloop.init_state(jcfg, JO.OptConfig(), jax.random.PRNGKey(0))
    tst = state_from_numpy(jax.tree.map(np.asarray, jst))
    want = [k for k, _ in jckpt._flatten(jst)]
    assert [k for k, _ in ckpt._flatten(tst)] == want
    assert "params/layers/attn/.wq" in want
    assert [p for p, _ in leaves_with_path(tst)] == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]


def test_jax_checkpoint_restores_into_the_port_and_back(tmp_path):
    jcfg, tcfg = _cfgs()
    opt = JO.OptConfig()
    jst = jloop.init_state(jcfg, opt, jax.random.PRNGKey(2))
    jst = jax.tree.map(lambda x: x + 1 if x.dtype == jnp.float32 else x + 5, jst)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, jst)
    target = loop.init_state(tcfg, O.OptConfig(), 0, device="cpu")
    tst, step = ckpt.restore_checkpoint(str(tmp_path / "j"), target)
    assert step == 7 and int(tst["opt"]["step"]) == 5
    for a, b in zip(_np(tst), _jnp_leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ckpt.save_checkpoint(str(tmp_path / "t"), 8, tst)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "t"), jst)
    assert step == 8
    for a, b in zip(_jnp_leaves(back), _jnp_leaves(jst)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_keep_latest_and_missing(tmp_path):
    d = str(tmp_path / "c")
    tree = {"params": {"w": torch.ones(2, 3)}, "opt": {"step": torch.tensor(1, dtype=torch.int32)}}
    for s in range(5):
        ckpt.save_checkpoint(d, s, tree, keep=2)
    assert ckpt.list_steps(d) == [3, 4] and ckpt.latest_step(d) == 4
    (tmp_path / "c" / "LATEST").write_text("garbage")
    assert ckpt.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(d, {"params": {"x": torch.ones(1)}})


def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch

    d = str(tmp_path / "ck")
    common = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt", d,
              "--ckpt-every", "1"]
    out = launch.main(common + ["--steps", "2"])
    assert out["start"] == 0 and len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert ckpt.latest_step(d) == 2
    out2 = launch.main(common + ["--steps", "4"])
    assert out2["start"] == 2 and len(out2["losses"]) == 2
    assert int(out2["state"]["opt"]["step"]) == 4 and ckpt.latest_step(d) == 4
    text = capsys.readouterr().out
    assert "resumed at step 2" in text and "approx_matmul kernel launches 0" in text


def test_fault_pieces_match_jax():
    dts = [1.0] * 12 + [5.0] + [1.0] * 7 + [100.0, 1.0]
    a, b = fault.StragglerMonitor(threshold=2.0, warmup=3), jfault.StragglerMonitor(
        threshold=2.0, warmup=3)
    assert [a.record(i, dt) for i, dt in enumerate(dts)] == [
        b.record(i, dt) for i, dt in enumerate(dts)]
    assert a.events == b.events == [12, 20] and a.ewma == pytest.approx(b.ewma)
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("node lost")
        return attempt

    assert fault.run_with_restarts(flaky, max_restarts=3) == 2 and calls == [0, 1, 2]
    with pytest.raises(RuntimeError, match="attempt 1"):
        fault.run_with_restarts(_always_fails, max_restarts=1)


def _always_fails(attempt):
    raise RuntimeError(f"attempt {attempt}")
