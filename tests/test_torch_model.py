"""The port's dense decoder against the JAX package's, through the bridge.

The JAX package's own ``init_params`` weights (frozen where the mode
quantizes) cross over as numpy; the same tokens, pools and block tables go
through ``forward(return_kv=True)`` and ``paged_decode_step`` in both.  In
float32 the two agree to matmul roundoff (atol 1e-4 on logits of order 1);
the quantized modes share every integer code, so their logits agree to the
same roundoff.
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
from repro.models import transformer as jT
from repro.serve.engine import freeze_params as jfreeze
from repro.serve.engine import resolve_execution_mode as jresolve
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import resolve_execution_mode

ATOL = 1e-4
MODES = ["exact", "approx", "approx_msr"]


def _pair(mode, dtype="float32", per_row=False):
    jcfg = dataclasses.replace(jreduced(jget_config("granite-3-2b")), q_chunk=16, dtype=dtype,
                               approx=jresolve(mode, act_per_row=per_row))
    tcfg = dataclasses.replace(reduced_config(get_config("granite-3-2b")), dtype=dtype,
                               approx=resolve_execution_mode(mode, act_per_row=per_row))
    jp = jfreeze(jcfg, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_reduced_config_matches_reference_widths():
    j, t = jreduced(jget_config("granite-3-2b")), reduced_config(get_config("granite-3-2b"))
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab", "dtype", "rope_theta"):
        assert getattr(j, f) == getattr(t, f), f
    full_j, full_t = jget_config("granite-3-2b"), get_config("granite-3-2b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "padded_vocab", "dtype"):
        assert getattr(full_j, f) == getattr(full_t, f), f


@pytest.mark.parametrize("mode", MODES)
def test_forward_return_kv_matches_jax(mode):
    jcfg, jp, tcfg, tp = _pair(mode)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _, (jk, jv) = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, return_kv=True)
    tl, (tk, tv) = T.forward(tcfg, tp, torch.from_numpy(toks), return_kv=True)
    assert tl.shape == jl.shape == (2, 12, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    assert (tl.numpy()[..., tcfg.vocab_size:] < -1e29).all()     # padded vocab masked


def test_forward_bfloat16_activations_match_jax():
    """The registered activation dtype, in float execution.  XLA's CPU
    sigmoid rounds differently from torch's in about a third of bf16
    elements (one ulp), so the logits agree to a few bf16 ulps of their
    largest value, not bitwise; the quantized modes would amplify those
    ulps through code flips and are held to the JAX package in float32."""
    jcfg, jp, tcfg, tp = _pair("exact", dtype="bfloat16")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jl, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl = T.forward(tcfg, tp, torch.from_numpy(toks))
    jl = np.asarray(jl)[..., :tcfg.vocab_size]
    tl = tl.numpy()[..., :tcfg.vocab_size]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=4 * 2.0**-8 * np.abs(jl).max())


def _paged_inputs(rng, cfg, B=3, W=4, bs=4):
    """Random pools, tables with a sentinel hole, an all-sentinel row and a
    row whose position lies past its table."""
    nb = B * W + 2
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    perm = rng.permutation(nb)
    tbl = np.full((B, W), nb, np.int32)
    tbl[0, :3] = perm[:3]                        # cur in block 2
    tbl[1, :] = perm[3:3 + W]
    tbl[1, 1] = nb                               # hole below cur
    cur = np.asarray([2 * bs + 1, W * bs + 2, 5], np.int32)   # row 1 past table, row 2 empty
    toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return k, v, tbl, cur, toks, bs


@pytest.mark.parametrize("mode,per_row", [("exact", False), ("approx", False), ("approx", True)])
def test_paged_decode_step_matches_jax(mode, per_row):
    jcfg, jp, tcfg, tp = _pair(mode, per_row=per_row)
    k, v, tbl, cur, toks, bs = _paged_inputs(np.random.default_rng(3), tcfg)
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    jl, jc = jT.paged_decode_step(jcfg, jp, jcache, {"tokens": jnp.asarray(toks)},
                                  jnp.asarray(cur), jnp.asarray(tbl), block_size=bs,
                                  attn_impl="pallas")
    tcache = T.init_paged_cache(tcfg, k.shape[1], bs, device="cpu")
    tcache["k"][:, :-1] = torch.from_numpy(k)
    tcache["v"][:, :-1] = torch.from_numpy(v)
    tl = T.paged_decode_step(tcfg, tp, tcache, torch.from_numpy(toks), torch.from_numpy(cur),
                             torch.from_numpy(tbl), block_size=bs, attn_impl="kernel")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    # the new token lands where JAX's scatter puts it; the writes JAX drops
    # (sentinel entry, past the table) go to the trash block only
    np.testing.assert_allclose(tcache["k"][:, :-1].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcache["v"][:, :-1].numpy(), np.asarray(jc["v"]), rtol=0, atol=1e-5)
    changed = (tcache["k"][:, :-1].numpy() != k).any(axis=(0, 2, 3, 4))
    assert changed.sum() == 1 and changed[tbl[0, 2]]


def test_kernel_and_gather_decode_agree():
    _, _, tcfg, tp = _pair("approx")
    k, v, tbl, cur, toks, bs = _paged_inputs(np.random.default_rng(4), tcfg)
    out = []
    for impl in ("kernel", "gather"):
        cache = T.init_paged_cache(tcfg, k.shape[1], bs, device="cpu")
        cache["k"][:, :-1] = torch.from_numpy(k)
        cache["v"][:, :-1] = torch.from_numpy(v)
        out.append(T.paged_decode_step(tcfg, tp, cache, torch.from_numpy(toks),
                                       torch.from_numpy(cur), torch.from_numpy(tbl),
                                       block_size=bs, attn_impl=impl))
    assert torch.equal(out[0], out[1])           # on the CPU both are the plain version


def test_init_params_tree_and_std_match_reference():
    tcfg = reduced_config(get_config("granite-3-2b"))
    jcfg = jreduced(jget_config("granite-3-2b"))
    tp = T.init_params(tcfg, seed=0, device="cpu")
    jp = jax.tree.map(np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(0)))
    bridged = params_from_numpy(jp)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tp)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, bridged))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tp)[0],
                            jax.tree.leaves(bridged)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dim() >= 2:      # truncated normal, std 1/sqrt(fan_in) times the unit TN's 0.88
            np.testing.assert_allclose(a.std().item(), b.std().item(), rtol=0.15)
