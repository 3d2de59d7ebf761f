"""The port's vlm (qwen2-vl-2b) and audio (musicgen-large) backbones
against the JAX package's.

Both take embeddings in place of tokens: qwen2-vl positions them with
multimodal rope over ``positions_thw`` (B, 3, S), musicgen adds sinusoids
to the input and rotates nothing.  On the JAX package's own weights
(``bridge.params_from_numpy``) and the same embeddings, ``forward`` with
and without a positions grid, with ``return_kv``, ``decode_step`` on the
slot layout, ``paged_decode_step`` (the gather, and K2's plain version
against JAX's Pallas kernel in interpret mode) and ``paged_verify_step``
equal JAX's to ``tests/test_torch_model.py``'s tolerance (atol 1e-4 on
logits of order 1), in float32 (``exact``).  Not in a quantized mode: the
two packages' RMSNorm, softmax and ``silu`` round one ulp apart now and
then, and an activation one ulp across a rounding boundary takes the
neighbouring code (ROADMAP section 3), which at these seeds happens in one
case of four per mode and parts the logits by up to 0.13; the projection
path itself is the dense family's, which ``tests/test_torch_model.py``
holds in every mode, and the backbones' training steps are held in a
quantized mode in ``tests/test_torch_train_families.py``.  ``apply_m_rope`` and
``sinusoidal_at`` equal JAX's; m_rope with equal streams is rope; the
teacher-forced decode of each backbone equals its ``forward`` at default
positions within JAX's tolerance.  The port registers JAX's ten
architectures, and ``generate``, ``ServeSession`` and ``launch/serve.py``
refuse an embedding-input model with JAX's messages.
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
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced_config as jreduced
from repro.core.approx import prequantize_tree as jprequantize
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.serve.engine import generate as jgenerate
from repro.serve.engine import resolve_execution_mode as jresolve
from repro.serve.scheduler import ServeSession as JServeSession
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import ServeSession, generate, resolve_execution_mode

ATOL = 1e-4
VLM, AUDIO = "qwen2-vl-2b", "musicgen-large"
B, S = 2, 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch, mode="exact"):
    """The reduced ``arch`` in both packages with JAX's weights (frozen in
    a quantized mode)."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), q_chunk=16, approx=jresolve(mode))
    tcfg = dataclasses.replace(reduced_config(get_config(arch)),
                               approx=resolve_execution_mode(mode))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.approx.is_quantized:
        jp = jprequantize(jp, jcfg.approx)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _emb(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _thw(b=B, s=S):
    """A 4-token text prefix, an image of 4 x 4 patches (t held, h and w
    over the grid), then text from the next free position."""
    thw = np.empty((3, s), np.int32)
    thw[:, :4] = np.arange(4)
    h, w = np.divmod(np.arange(16), 4)
    thw[0, 4:20], thw[1, 4:20], thw[2, 4:20] = 4, 4 + h, 4 + w
    thw[:, 20:] = 8 + np.arange(s - 20)
    return np.broadcast_to(thw, (b, 3, s)).copy()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def test_apply_m_rope_matches_jax_and_equals_rope_on_equal_streams():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    thw = rng.integers(0, 50, (2, 3, 9)).astype(np.int32)
    jq, jk = jL.apply_m_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(thw), (4, 6, 6), 1e6)
    tq, tk = L.apply_m_rope(_t(q), _t(k), _t(thw), (4, 6, 6), 1e6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    # equal streams: the sections' frequencies concatenate to rope's
    pos = thw[:, 0]
    same = np.broadcast_to(pos[:, None], thw.shape)
    mq, mk = L.apply_m_rope(_t(q), _t(k), _t(same), (4, 6, 6), 1e6)
    rq, rk = L.apply_rope(_t(q), _t(k), _t(pos), 1e6)
    np.testing.assert_allclose(mq.numpy(), rq.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(mk.numpy(), rk.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="do not sum"):
        L.apply_m_rope(_t(q), _t(k), _t(thw), (4, 6, 5))


def test_sinusoidal_matches_jax():
    pos = np.array([[0, 1, 7], [100, 3999, 12]], np.int32)
    got = L.sinusoidal_at(_t(pos), 64).numpy()
    np.testing.assert_allclose(got, np.asarray(jL.sinusoidal_at(jnp.asarray(pos), 64)),
                               rtol=0, atol=1e-5)
    assert got.shape == (2, 3, 64)
    assert got[0, 0, 0] == 0.0 and got[0, 0, 1] == 1.0     # even columns sin, odd cos
    np.testing.assert_allclose(L.sinusoidal_positions(5, 32, 3).numpy(),
                               np.asarray(jL.sinusoidal_positions(5, 32, 3)), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# forward, decode, paged decode, verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_jax(arch, grid):
    jcfg, jp, tcfg, tp = _models(arch)
    emb = _emb(tcfg)
    batch = {"embeddings": jnp.asarray(emb)}
    kw = {}
    if grid:
        batch["positions_thw"] = jnp.asarray(_thw())
        kw["positions_thw"] = _t(_thw())
    jl, jaux, (jk, jv) = jT.forward(jcfg, jp, batch, return_kv=True)
    with torch.no_grad():
        tl, taux, (tk, tv) = T.forward(tcfg, tp, embeddings=_t(emb), return_aux=True,
                                       return_kv=True, **kw)
    assert tl.shape == (B, S, tcfg.padded_vocab) and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if arch == VLM:   # the grid moves the logits; musicgen has no positions to take
        with torch.no_grad():
            other = T.forward(tcfg, tp, embeddings=_t(emb),
                              **({} if grid else {"positions_thw": _t(_thw())}))
        assert not torch.allclose(other, tl, atol=1e-3)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_steps_match_jax(arch):
    """Teacher-forced ``decode_step`` (slots) and ``paged_decode_step``
    (the gather, and K2's plain version against JAX's Pallas kernel) on
    the same embeddings, step by step, against JAX's; then each against
    the port's own ``forward`` at default positions."""
    jcfg, jp, tcfg, tp = _models(arch)
    emb = _emb(tcfg, seed=1)
    bs, W = 8, S // 8
    jc = jT.init_cache(jcfg, B, S, jnp.float32)
    tc = T.init_cache(tcfg, B, S)
    tables = np.arange(B * W, dtype=np.int32).reshape(B, W)
    jpc = {impl: jT.init_paged_cache(jcfg, B * W, bs, jnp.float32) for impl in ("gather", "pallas")}
    tpc = {impl: T.init_paged_cache(tcfg, B * W, bs) for impl in ("gather", "kernel")}
    jstep = jax.jit(jT.decode_step, static_argnums=0)
    jpaged = jax.jit(jT.paged_decode_step, static_argnums=0,
                     static_argnames=("block_size", "attn_impl"))
    slot = []
    for i in range(S):
        e = emb[:, i:i + 1]
        cur = np.full((B,), i, np.int32)
        jlg, jc = jstep(jcfg, jp, jc, {"embeddings": jnp.asarray(e)}, jnp.asarray(cur))
        with torch.no_grad():
            tlg = T.decode_step(tcfg, tp, tc, None, _t(cur), embeddings=_t(e))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=ATOL)
        slot.append(tlg[:, 0])
        for jimpl, timpl in (("gather", "gather"), ("pallas", "kernel")):
            jplg, jpc[jimpl] = jpaged(jcfg, jp, jpc[jimpl], {"embeddings": jnp.asarray(e)},
                                      jnp.asarray(cur), jnp.asarray(tables), block_size=bs,
                                      attn_impl=jimpl)
            with torch.no_grad():
                tplg = T.paged_decode_step(tcfg, tp, tpc[timpl], None, _t(cur), _t(tables),
                                           block_size=bs, attn_impl=timpl, embeddings=_t(e))
            np.testing.assert_allclose(tplg.numpy(), np.asarray(jplg), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc["k"][:, :, :S].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tpc["kernel"]["k"][:, :-1].numpy(),
                               np.asarray(jpc["pallas"]["k"]), rtol=0, atol=1e-5)
    # teacher-forced decode against forward at default positions: JAX's
    # forward-vs-decode tolerance (tests/test_models.py)
    with torch.no_grad():
        ref = T.forward(tcfg, tp, embeddings=_t(emb))
    got = torch.stack(slot, 1)
    assert ((got - ref).abs() <= 2e-3 + 2e-2 * ref.abs()).all()


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_paged_verify_step_matches_jax(arch):
    """The multi-token paged pass on embeddings: rope (or the sinusoid) at
    each position ``cur_len + j``."""
    jcfg, jp, tcfg, tp = _models(arch)
    bs, W = 8, 3
    emb = _emb(tcfg, s=13, seed=2)
    tables = np.arange(B * W, dtype=np.int32).reshape(B, W)
    jc = jT.init_paged_cache(jcfg, B * W, bs, jnp.float32)
    tc = T.init_paged_cache(tcfg, B * W, bs)
    cur = np.array([0, 3], np.int32)
    jlg, jc = jT.paged_verify_step(jcfg, jp, jc, {"embeddings": jnp.asarray(emb[:, :8])},
                                   jnp.asarray(cur), jnp.asarray(tables), block_size=bs)
    with torch.no_grad():
        tlg = T.paged_verify_step(tcfg, tp, tc, None, _t(cur), _t(tables), block_size=bs,
                                  embeddings=_t(emb[:, :8]))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tc["k"][:, :-1].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_inputs_follow_embed_input(arch):
    """A backbone has no embedding table and takes embeddings only; a
    token model takes tokens only."""
    _, _, tcfg, tp = _models(arch)
    assert "embed" not in tp and "embed" not in T.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="takes embeddings"):
        T.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="takes embeddings"):
        T.decode_step(tcfg, tp, T.init_cache(tcfg, 1, 4), None, torch.zeros(1))
    dcfg = reduced_config(get_config("granite-3-2b"))
    dp = T.init_params(dcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="takes token inputs"):
        T.forward(dcfg, dp, embeddings=torch.zeros((1, 4, dcfg.d_model)))


def test_init_params_shapes_match_jax():
    for arch in (VLM, AUDIO):
        jcfg, jp, tcfg, tp = _models(arch)
        mine = T.init_params(tcfg, 0, device="cpu")
        want = jax.tree_util.tree_flatten_with_path(jp)[0]
        from repro_torch.train.tree import leaves_with_path

        assert [(p, tuple(t.shape)) for p, t in leaves_with_path(mine)] == [
            (jax.tree_util.keystr(p), x.shape) for p, x in want]


# ---------------------------------------------------------------------------
# registry and refusals
# ---------------------------------------------------------------------------


def test_all_ten_archs_registered():
    """The port's counterpart of ``tests/test_models.py``'s test."""
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    for a in ("musicgen-large", "yi-34b", "granite-3-2b", "deepseek-7b",
              "deepseek-coder-33b", "falcon-mamba-7b", "qwen2-moe-a2.7b",
              "grok-1-314b", "qwen2-vl-2b", "zamba2-2.7b"):
        assert a in list_archs()
    assert get_config(VLM).m_rope_sections == (16, 24, 24)
    assert reduced_config(get_config(VLM)).m_rope_sections == (4, 6, 6)
    assert (get_config(AUDIO).pos_embedding, get_config(AUDIO).embed_input) == (
        "sinusoidal", False)


def _same_error(exc, jfn, tfn):
    with pytest.raises(exc) as jerr:
        jfn()
    with pytest.raises(exc) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serving_refusals_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    prompt = np.zeros((1, 4), np.int32)
    _same_error(ValueError, lambda: jgenerate(jcfg, jp, jnp.asarray(prompt), max_new=2),
                lambda: generate(tcfg, tp, prompt, max_new=2, device="cpu"))
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(4, 8))
    _same_error(ValueError, lambda: JServeSession(jcfg, jp, **kw),
                lambda: ServeSession(tcfg, tp, device="cpu", **kw))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_launcher_refusal_matches_jax(arch):
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain

    _same_error(SystemExit, lambda: jmain(["--arch", arch, "--reduced"]),
                lambda: tmain(["--arch", arch, "--reduced", "--device", "cpu"]))
