"""Decoder stack of every served family: the training and prefill
forward, one-token decode on the slot layout (a per-row ``max_len`` stripe,
plus per-row conv/ssm state) and on the paged pool, and the multi-token
pass over the paged pool (speculative verification, chunked prefill).

* dense  : pre-RMSNorm GQA + SwiGLU FFN
* moe    : GQA + (shared + routed top-k) MoE FFN (``models/moe.py``)
* ssm    : Mamba-1 blocks (``models/ssm.py``)
* hybrid : Mamba-2 blocks + a weight-shared attention block applied after
           every ``attn_every`` layers (Zamba2-style)
* vlm    : the dense stack over patch embeddings, multimodal rope
           (``positions_thw``; qwen2-vl)
* audio  : the dense stack over frame embeddings, sinusoidal positions
           added to the input and no rope (musicgen)

The vlm and audio backbones have no embedding table: every entry point
takes ``embeddings=`` (B, S, d) in place of ``tokens``, exactly one of the
two as ``cfg.embed_input`` says.

Under tensor parallelism (``serve.ServeSession(mesh=...)``) the tree holds
``Shard``s (``parallel/tp.shard_params``): attention runs on the rank's
heads, ``wo`` and ``w_down`` sum their products over the ranks, the
vocab-split head gathers its logits and a vocab-split embedding sums its
lookups; the pool holds the rank's KV heads (``parallel/tp.shard_cache``).
Training over a model axis (``parallel/fsdp.wrap`` on a
``launch.mesh.TrainMesh``) gives the same splits as ``DataPart``s, which
``layers.dense``, ``embed`` and ``gather_columns`` run under autograd.
The calls below are the same with and without a mesh.

Parameters are a dict with the JAX package's tree shape: layer weights are
stacked on a leading layer axis under ``params["layers"]`` and the loop
below walks them (the JAX package scans them).  Under autograd with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, as the JAX
package wraps its scan body in ``jax.checkpoint``.  Both decode steps
and the multi-token pass update their cache in place and return the
logits only (the JAX package returns a new cache).  The SSM and hybrid
families keep O(1) state per request (no sequence axis), so they have no
paged layout and no fused prefill: they prefill by teacher-forcing the
prompt through ``decode_step``, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx import (
    ApproxConfig,
    QWeight,
    Shard,
    concat_weights,
    prequantize_tree,
    w_dim,
)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
    seed_kv_cache,
    self_attention,
)
from repro_torch.models.moe import init_moe, moe_ffn

__all__ = [
    "init_params",
    "fuse_params",
    "forward",
    "init_cache",
    "seed_cache",
    "decode_step",
    "cache_max_len",
    "init_paged_cache",
    "paged_decode_step",
    "paged_verify_step",
    "paged_chunk_prefill_step",
    "params_to",
]


def _ffn(x, p: Dict[str, Any], cfg: ApproxConfig, fuse_gate_up: bool = False):
    """SwiGLU.  gate and up come from one product over the fused
    ``w_gate_up`` where the tree holds one (frozen serving weights,
    ``fuse_params``) or, with ``fuse_gate_up``, over ``concat_weights`` of
    the two (one activation quantization, one wide product)."""
    if "w_gate_up" in p or fuse_gate_up:
        w = p["w_gate_up"] if "w_gate_up" in p else concat_weights([p["w_gate"], p["w_up"]])
        gu = L.dense(x, w, cfg)
        ff = w_dim(w, -1) // 2
        h = F.silu(gu[..., :ff]) * gu[..., ff:]
    else:
        h = F.silu(L.dense(x, p["w_gate"], cfg)) * L.dense(x, p["w_up"], cfg)
    return L.dense(h, p["w_down"], cfg)


def fuse_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The serving tree with the fused leaves built once: with
    ``cfg.fuse_qkv`` each layer's frozen ``wq``/``wk``/``wv`` become one
    ``wqkv``, with ``cfg.fuse_gate_up`` each FFN's frozen ``w_gate``/
    ``w_up`` one ``w_gate_up`` (the layers' and the hybrid's shared block's,
    where the JAX package's ``_ffn`` fuses them), so no pass concatenates
    codes.  Per-channel weight scales concatenate losslessly, so every pass
    (decode and verify too, where the JAX package keeps three products)
    computes what the separate leaves give, bit for bit.  Column
    ``Shard``s concatenate the rank's parts (``parallel/tp.py``).  Float
    weights stay separate (training concatenates per pass, as in JAX); a
    tree fused already passes through."""
    def frozen(w):
        return isinstance(w.w if isinstance(w, Shard) else w, QWeight)

    def fused(node, names, key, rest):
        if not isinstance(node, dict) or not all(n in node and frozen(node[n]) for n in names):
            return node
        return {key: concat_weights([node[n] for n in names]), rest: node[rest]}

    out = dict(params)
    if "layers" in out and isinstance(out["layers"], dict):
        layers = dict(out["layers"])
        if cfg.fuse_qkv and "attn" in layers:
            layers["attn"] = fused(layers["attn"], ("wq", "wk", "wv"), "wqkv", "wo")
        if cfg.fuse_gate_up and "ffn" in layers:
            layers["ffn"] = fused(layers["ffn"], ("w_gate", "w_up"), "w_gate_up", "w_down")
        out["layers"] = layers
    if cfg.fuse_gate_up and isinstance(out.get("shared_attn"), dict):
        shared = dict(out["shared_attn"])
        shared["ffn"] = fused(shared["ffn"], ("w_gate", "w_up"), "w_gate_up", "w_down")
        out["shared_attn"] = shared
    return out


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                freeze: bool = False) -> Dict[str, Any]:
    """Random float32 master weights at the config's widths from a seeded
    ``torch.Generator`` on ``device``, with the JAX package's init
    (truncated normal, std 1/sqrt(fan_in); norms at one; the Mamba blocks'
    conv, decay and skip inits).  For runs without JAX; the tests bring the
    JAX package's own weights across with ``bridge.params_from_numpy``
    instead.  ``device`` defaults to the CUDA device (raising without one).

    ``freeze`` returns ``engine.freeze_params`` of the same weights (equal
    codes and scales: a stacked weight calibrates per layer; float
    execution keeps them float; the fused leaves ``fuse_params`` builds).
    Every float32 leaf is cast to ``cfg.param_dtype`` as it is drawn (the
    same float32 draw, then the cast, as the JAX package's ``astype``),
    before any freezing.  The moe, ssm, hybrid, vlm and audio
    families build and freeze one layer at a time, so no more than one
    layer's float32 weights are ever held (qwen2-moe-a2.7b's are 57 GB);
    the dense family draws each weight's stack whole, as before.  A model
    without token inputs (vlm, audio) has no ``embed``.

    On ``device="meta"`` the tree has every shape and dtype and holds no
    data: no generator, no draw (``launch/specs.py``)."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    freeze = freeze and cfg.approx.is_quantized
    pd = getattr(torch, cfg.param_dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(pd) if tree is not None and tree.dtype == torch.float32 else tree

    if cfg.family == "dense":
        params = _init_dense(cfg, gen, dev, cast)
        return fuse_params(cfg, prequantize_tree(params, cfg.approx)) if freeze else params

    def frozen(tree):
        tree = cast(tree)
        return prequantize_tree(tree, cfg.approx) if freeze else tree

    d = cfg.d_model
    stack = None
    for i in range(cfg.num_layers):
        layer = frozen(_init_layer(cfg, gen, dev))
        if stack is None:
            stack = _empty_stack(layer, cfg.num_layers)
        _put_layer(stack, i, layer)
    params = {"layers": stack}
    if cfg.embed_input:
        params["embed"] = cast(L.truncated_normal_init((cfg.vocab_size, d), gen, device=dev))
    params["final_norm"] = cast(torch.ones((d,), device=dev))
    params.update(frozen({"lm_head": L.init_dense(d, cfg.padded_vocab, gen, dev)}))
    if cfg.family == "hybrid":
        params["shared_attn"] = frozen({
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev),
            "attn": _init_attn(cfg, gen, dev),
            "ffn": _init_ffn(d, cfg.d_ff, gen, dev),
        })
    return fuse_params(cfg, params) if freeze else params


def _init_dense(cfg: ModelConfig, gen: torch.Generator, dev, cast) -> Dict[str, Any]:
    """The dense tree, each leaf drawn whole and then ``cast``."""
    d, Lyr, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    hq, hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def stacked(d_in, d_out):
        return cast(torch.stack([L.init_dense(d_in, d_out, gen, dev) for _ in range(Lyr)]))

    return {
        "layers": {
            "ln1": cast(torch.ones((Lyr, d), device=dev)),
            "ln2": cast(torch.ones((Lyr, d), device=dev)),
            "attn": {"wq": stacked(d, hq), "wk": stacked(d, hkv),
                     "wv": stacked(d, hkv), "wo": stacked(hq, d)},
            "ffn": {"w_gate": stacked(d, ff), "w_up": stacked(d, ff),
                    "w_down": stacked(ff, d)},
        },
        "embed": cast(L.truncated_normal_init((cfg.vocab_size, d), gen, device=dev)),
        "final_norm": cast(torch.ones((d,), device=dev)),
        "lm_head": cast(L.init_dense(d, cfg.padded_vocab, gen, dev)),
    }


def _init_attn(cfg: ModelConfig, gen, dev) -> Dict[str, torch.Tensor]:
    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    return {"wq": L.init_dense(d, hq, gen, dev), "wk": L.init_dense(d, hkv, gen, dev),
            "wv": L.init_dense(d, hkv, gen, dev), "wo": L.init_dense(hq, d, gen, dev)}


def _init_ffn(d: int, ff: int, gen, dev) -> Dict[str, torch.Tensor]:
    return {"w_gate": L.init_dense(d, ff, gen, dev), "w_up": L.init_dense(d, ff, gen, dev),
            "w_down": L.init_dense(ff, d, gen, dev)}


def _init_layer(cfg: ModelConfig, gen, dev) -> Dict[str, Any]:
    """One layer of the moe, ssm, hybrid, vlm or audio family (the JAX
    package's ``_init_layer``)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln": torch.ones((d,), device=dev),
                "mamba": S.init_mamba1(gen, d, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                                       cfg.conv_width, device=dev)}
    if cfg.family == "hybrid":
        return {"ln": torch.ones((d,), device=dev),
                "mamba": S.init_mamba2(gen, d, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                                       cfg.conv_width, device=dev)}
    layer = {"ln1": torch.ones((d,), device=dev), "ln2": torch.ones((d,), device=dev),
             "attn": _init_attn(cfg, gen, dev)}
    if cfg.family == "moe":
        layer["moe"] = init_moe(gen, d, cfg.d_ff, cfg.moe_experts,
                                shared_d_ff=cfg.moe_shared_ff, device=dev)
    else:
        layer["ffn"] = _init_ffn(d, cfg.d_ff, gen, dev)
    return layer


def _empty_stack(tree, n: int):
    """A tree shaped as the per-layer ``tree`` with a leading axis of ``n``,
    uninitialised (``None`` stays), for ``_put_layer`` to fill: the layers
    are written in place, so building never holds a second copy of them
    (qwen2-moe-a2.7b's frozen layers: 12.5 GB)."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    if isinstance(tree, QWeight):
        return QWeight(*(_empty_stack(t, n) for t in tree))
    return None if tree is None else tree.new_empty((n, *tree.shape))


def _put_layer(stack, i: int, tree) -> None:
    """Write the per-layer ``tree`` into entry ``i`` of ``stack``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put_layer(stack[k], i, v)
    elif isinstance(tree, QWeight):
        for s, t in zip(stack, tree):
            s[i].copy_(t)
    elif tree is not None:
        stack[i].copy_(tree)


# ---------------------------------------------------------------------------
# Forward (training and prefill)
# ---------------------------------------------------------------------------


def _use_rope(cfg: ModelConfig) -> bool:
    return cfg.pos_embedding in ("rope", "m_rope")


def _attn_block(cfg: ModelConfig, x, layer, positions_thw=None):
    """(x, (k, v), aux) of one dense, moe, vlm or audio block;
    ``positions_thw`` (B, 3, S) for a model with multimodal rope."""
    h, kv = self_attention(
        L.rms_norm(x, layer["ln1"]), layer["attn"],
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, cfg=cfg.approx,
        m_rope=None if positions_thw is None else (positions_thw, cfg.m_rope_sections),
        rope_theta=cfg.rope_theta, use_rope=_use_rope(cfg), q_chunk=cfg.q_chunk,
        fuse_qkv=cfg.fuse_qkv,
    )
    x = x + h
    if cfg.family == "moe":
        B, Sq, d = x.shape
        h2, aux = moe_ffn(L.rms_norm(x, layer["ln2"]).reshape(B * Sq, d), layer["moe"],
                          top_k=cfg.moe_top_k, cfg=cfg.approx,
                          capacity_factor=cfg.capacity_factor)
        return x + h2.reshape(B, Sq, d), kv, aux
    x = x + _ffn(L.rms_norm(x, layer["ln2"]), layer["ffn"], cfg.approx, cfg.fuse_gate_up)
    return x, kv, None


def _block_out(cfg: ModelConfig, x, layer, positions_thw=None):
    x, _, aux = _attn_block(cfg, x, layer, positions_thw)
    return x, aux


def _ssm_block(cfg: ModelConfig, x, layer):
    mamba = S.mamba1_forward if cfg.family == "ssm" else S.mamba2_forward
    h, _ = mamba(L.rms_norm(x, layer["ln"]), layer["mamba"], cfg=cfg.approx,
                 chunk=cfg.ssm_chunk)
    return x + h


def _shared_attn_block(cfg: ModelConfig, x, shared):
    """The hybrid's weight-shared attention block (attention then FFN)."""
    h, _ = self_attention(L.rms_norm(x, shared["ln1"]), shared["attn"],
                          n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, cfg=cfg.approx,
                          rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk)
    x = x + h
    return x + _ffn(L.rms_norm(x, shared["ln2"]), shared["ffn"], cfg.approx, cfg.fuse_gate_up)


def _n_groups(cfg: ModelConfig) -> int:
    """The hybrid's attention groups: ``attn_every`` layers each."""
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not split into groups of "
                         f"{cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def _run_state_family(cfg: ModelConfig, params, x, remat: bool):
    """The ssm stack, or the hybrid's groups of ``attn_every`` Mamba-2
    layers each followed by the shared attention block."""
    shared = params.get("shared_attn")
    for i, layer in enumerate(L.unstack(params["layers"], cfg.num_layers)):
        x = checkpoint(_ssm_block, cfg, x, layer, use_reentrant=False) if remat \
            else _ssm_block(cfg, x, layer)
        if shared is not None and (i + 1) % cfg.attn_every == 0:
            x = checkpoint(_shared_attn_block, cfg, x, shared, use_reentrant=False) \
                if remat else _shared_attn_block(cfg, x, shared)
    return x


def _inputs(cfg: ModelConfig, params, tokens, embeddings, cur_len=None):
    """The stack's input (B, S, d) in the activation dtype: the embedded
    ``tokens``, or the caller's ``embeddings`` for a model without an
    embedding table (exactly one of the two, as ``cfg.embed_input`` says),
    plus sinusoidal positions for the audio family, from ``cur_len`` (B,)
    on in a decode pass and from 0 in ``forward``."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.embed_input:
        if tokens is None or embeddings is not None:
            raise ValueError(f"{cfg.name} takes token inputs, not embeddings")
        x = L.embed(tokens, params["embed"]).to(dtype)
    else:
        if embeddings is None or tokens is not None:
            raise ValueError(f"{cfg.name} takes embeddings (B, S, d_model), not tokens")
        x = embeddings.to(dtype)
    if cfg.pos_embedding == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)
        if cur_len is not None:
            pos = cur_len.long()[:, None] + pos
        x = x + L.sinusoidal_at(pos, cfg.d_model).to(dtype)
    return x


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: Optional[torch.Tensor] = None,
            *, embeddings: Optional[torch.Tensor] = None,
            positions_thw: Optional[torch.Tensor] = None,
            return_kv: bool = False, return_aux: bool = False):
    """tokens (B, S), or ``embeddings`` (B, S, d) for the vlm and audio
    families, -> logits (B, S, Vp) float32; with ``return_aux`` also the
    MoE load-balance loss summed over layers (0 for the other families),
    and with ``return_kv`` (attention families only) the stacked (L, B, S,
    Hkv, hd) post-rope K and V — the fused-prefill cache seed — in the JAX
    package's order ``(logits, aux, (k, v))``.  ``positions_thw`` (B, 3,
    S) are the multimodal rope's position ids (default: ``arange(S)`` in
    all three streams, which is plain rope); other families ignore them,
    as the JAX package does.  Differentiable in float parameters."""
    if return_kv and cfg.family == "ssm":
        raise NotImplementedError("ssm has no attention KV; use decode-mode prefill")
    if return_kv and cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid prefill needs conv/ssm state; use decode-mode prefill")
    x = _inputs(cfg, params, tokens, embeddings)
    if cfg.pos_embedding != "m_rope":
        positions_thw = None
    elif positions_thw is None:
        B, S = x.shape[:2]
        positions_thw = torch.arange(S, device=x.device)[None, None, :].expand(B, 3, S)
    remat = cfg.remat and torch.is_grad_enabled() and not return_kv
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    if cfg.family in ("ssm", "hybrid"):
        x = _run_state_family(cfg, params, x, remat)
    else:
        for layer in L.unstack(params["layers"], cfg.num_layers):
            if remat:
                x, a = checkpoint(_block_out, cfg, x, layer, positions_thw,
                                  use_reentrant=False)
            else:
                x, (k, v), a = _attn_block(cfg, x, layer, positions_thw)
                if return_kv:
                    ks.append(k)
                    vs.append(v)
            if a is not None:
                aux = aux + a
    out = (_head(cfg, params, x),)
    if return_aux:
        out += (aux,)
    if return_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# Slot-layout decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32, *,
               device=None) -> Dict[str, torch.Tensor]:
    """Slot-layout cache.  Attention K/V: one ``max_len`` stripe per batch
    row, plus one trash position at index ``max_len`` that absorbs the
    writes the JAX package's scatter drops (a ``cur_len`` at or past
    ``max_len``); attention never reads it.  Leaves (L, batch, max_len + 1,
    Hkv, hd), the hybrid's one per attention group.  The ssm and hybrid
    families also hold each row's conv taps ``conv`` (L, batch, cw - 1, C)
    in ``dtype`` and its float32 scan state ``ssm``."""
    def kv(lead):
        shape = (lead, batch, max_len + 1, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    Lyr, cw, di, N = cfg.num_layers, cfg.conv_width, cfg.d_inner, cfg.ssm_state
    if cfg.family == "ssm":
        return {"conv": torch.zeros((Lyr, batch, cw - 1, di), dtype=dtype, device=device),
                "ssm": torch.zeros((Lyr, batch, di, N), dtype=torch.float32, device=device)}
    if cfg.family == "hybrid":
        nh = cfg.ssm_heads
        return {"conv": torch.zeros((Lyr, batch, cw - 1, di + 2 * N), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((Lyr, batch, nh, di // nh, N), dtype=torch.float32,
                                   device=device),
                **kv(_n_groups(cfg))}
    return kv(Lyr)


def cache_max_len(cfg: ModelConfig, cache: Dict[str, torch.Tensor]) -> int:
    """The positions an ``init_cache`` stripe holds (its trash position
    aside); unbounded for a cache of conv/ssm state only."""
    return cache["k"].shape[2] - 1 if "k" in cache else 1 << 20


def seed_cache(cfg: ModelConfig, cache: Dict[str, torch.Tensor], kvs) -> None:
    """Write fused-prefill K/V (from ``forward(..., return_kv=True)``, each
    (L, B, S0, Hkv, hd)) into positions [0, S0) of every layer IN PLACE."""
    k, v = kvs
    for i in range(cfg.num_layers):
        seed_kv_cache(cache["k"][i], cache["v"][i], k[i], v[i])


def _keep_rows(dst: torch.Tensor, new: torch.Tensor, write_rows) -> None:
    """``dst`` (rows first) takes ``new`` IN PLACE, only on ``write_rows``
    (all rows when it is None)."""
    new = new.to(dst.dtype)
    if write_rows is not None:
        new = torch.where(write_rows.reshape((-1,) + (1,) * (new.dim() - 1)), new, dst)
    dst.copy_(new)


def _slot_attention(cfg: ModelConfig, x, p, kc, vc, cur_len, write_rows):
    """``decode_attention`` on one layer's stripes; rows outside
    ``write_rows`` attend with their new K/V but keep the stripe as it was."""
    if write_rows is not None:
        rows = torch.arange(kc.shape[0], device=kc.device)
        pos = cur_len.long().clamp(max=kc.shape[1] - 1)
        old = kc[rows, pos], vc[rows, pos]
    h = decode_attention(x, p, kc, vc, cur_len, n_heads=cfg.num_heads,
                         n_kv=cfg.num_kv_heads, cfg=cfg.approx, rope_theta=cfg.rope_theta,
                         use_rope=_use_rope(cfg))
    if write_rows is not None:
        m = write_rows[:, None, None]
        kc[rows, pos] = torch.where(m, kc[rows, pos], old[0])
        vc[rows, pos] = torch.where(m, vc[rows, pos], old[1])
    return h


def decode_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: Optional[torch.Tensor],     # (B, 1)
    cur_len: torch.Tensor,              # (B,)
    *,
    write_rows: Optional[torch.Tensor] = None,   # (B,) bool
    embeddings: Optional[torch.Tensor] = None,   # (B, 1, d) in place of tokens
) -> torch.Tensor:
    """One-token decode against an ``init_cache`` cache: each row writes
    its new K/V at its ``cur_len`` and attends over positions ``[0,
    cur_len]``, and (ssm, hybrid) advances its conv taps and scan state.
    Writes the cache in place; returns logits (B, 1, Vp) float32.

    ``write_rows`` limits the writes to those rows: the others compute as
    usual from the cache but leave it as it was (the teacher-forced
    admission freezes each row past its prompt, as the JAX package does
    with ``where(take, new, old)`` over every leaf).  A model without token
    inputs takes ``embeddings`` (``tokens`` None); the audio family adds
    the sinusoid of ``cur_len``, and the vlm family rotates at ``cur_len``
    in all three rope streams."""
    x = _inputs(cfg, params, tokens, embeddings, cur_len)
    a = cfg.approx
    layers = L.unstack(params["layers"], cfg.num_layers)
    if cfg.family in ("ssm", "hybrid"):
        step = S.mamba1_decode_step if cfg.family == "ssm" else S.mamba2_decode_step
        shared = params.get("shared_attn")
        for i, layer in enumerate(layers):
            y, (conv, h) = step(L.rms_norm(x, layer["ln"]), layer["mamba"],
                                (cache["conv"][i], cache["ssm"][i]), cfg=a)
            _keep_rows(cache["conv"][i], conv, write_rows)
            _keep_rows(cache["ssm"][i], h, write_rows)
            x = x + y
            if shared is not None and (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x = x + _slot_attention(cfg, L.rms_norm(x, shared["ln1"]), shared["attn"],
                                        cache["k"][g], cache["v"][g], cur_len, write_rows)
                x = x + _ffn(L.rms_norm(x, shared["ln2"]), shared["ffn"], a, cfg.fuse_gate_up)
        return _head(cfg, params, x)
    for i, layer in enumerate(layers):
        h = _slot_attention(cfg, L.rms_norm(x, layer["ln1"]), layer["attn"],
                            cache["k"][i], cache["v"][i], cur_len, write_rows)
        x = _decode_mlp(cfg, x + h, layer, a)
    return _head(cfg, params, x)


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None) -> Dict[str, torch.Tensor]:
    """Paged KV pool: ``num_blocks`` fixed-size blocks per layer, plus one
    trash block at index ``num_blocks`` that absorbs the writes the JAX
    package's scatters drop (sentinel table entries, rows past their
    table).  Leaves are (L, num_blocks + 1, block_size, Hkv, hd); nothing
    ever reads the trash block.  Attention families only: ssm/hybrid state
    has no sequence axis to page."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.family} caches carry per-request conv/ssm state with no "
            "sequence axis; the paged layout applies to attention-family "
            "KV caches only"
        )
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_mlp(cfg: ModelConfig, x, layer, a: ApproxConfig):
    """The post-attention half of a decode-path dense or moe block; the moe
    FFN routes the step's B tokens together."""
    if cfg.family == "moe":
        B = x.shape[0]
        h2, _ = moe_ffn(L.rms_norm(x, layer["ln2"]).reshape(B, cfg.d_model), layer["moe"],
                        top_k=cfg.moe_top_k, cfg=a, capacity_factor=cfg.capacity_factor)
        return x + h2.reshape(B, 1, cfg.d_model)
    return x + _ffn(L.rms_norm(x, layer["ln2"]), layer["ffn"], a, cfg.fuse_gate_up)


def paged_decode_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: Optional[torch.Tensor],     # (B, 1)
    cur_len: torch.Tensor,              # (B,)
    block_tables: torch.Tensor,         # (B, W) int32
    *,
    block_size: int,
    attn_impl: str = "kernel",
    embeddings: Optional[torch.Tensor] = None,   # (B, 1, d) in place of tokens
) -> torch.Tensor:
    """One-token decode against an ``init_paged_cache`` pool: each row's
    K/V reads and the new token's write go through its block table (shared
    by every layer).  Writes the pool in place; returns logits (B, 1, Vp)
    float32.  Attention families (dense, moe, vlm, audio) only; inputs as
    in ``decode_step``."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError("paged decode applies to attention-family caches only")
    x = _inputs(cfg, params, tokens, embeddings, cur_len)
    a = cfg.approx
    for i, layer in enumerate(L.unstack(params["layers"], cfg.num_layers)):
        h = paged_decode_attention(
            L.rms_norm(x, layer["ln1"]), layer["attn"],
            cache["k"][i], cache["v"][i], block_tables, cur_len,
            block_size=block_size, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, cfg=a, rope_theta=cfg.rope_theta,
            use_rope=_use_rope(cfg), attn_impl=attn_impl,
        )
        x = _decode_mlp(cfg, x + h, layer, a)
    return _head(cfg, params, x)


# ---------------------------------------------------------------------------
# Multi-token paged pass: speculative verification and chunked prefill
# ---------------------------------------------------------------------------


def _norm_per_position(x, gamma):
    """``rms_norm`` of each position's (B, 1, d) slice.  A CUDA reduction
    picks its thread layout from the number of rows it reduces, so one norm
    over B*S rows would sum each row in another order than a decode step's
    norm over B rows; S norms of B rows keep the multi-token pass
    bit-identical to S decode steps."""
    return torch.cat([L.rms_norm(x[:, j:j + 1], gamma) for j in range(x.shape[1])], dim=1)


def paged_verify_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: Optional[torch.Tensor],     # (B, S)
    cur_len: torch.Tensor,              # (B,) position of the first token
    block_tables: torch.Tensor,         # (B, W) int32
    *,
    block_size: int,
    embeddings: Optional[torch.Tensor] = None,   # (B, S, d) in place of tokens
) -> torch.Tensor:
    """Score ``S`` consecutive tokens per row against the paged pool in one
    pass: row ``b``'s token ``j`` sits at position ``cur_len[b] + j``.
    Returns logits (B, S, Vp) float32: ``logits[:, j]`` is what a
    sequential ``paged_decode_step(attn_impl="gather")`` at ``cur_len + j``
    would give, bit for bit where the projections are (per-row activation
    scales, or float matmuls that do not depend on the row count), and the
    pool holds this pass's K/V at ``[cur_len, cur_len + S)``, written in
    place.  Projections run batched over the S positions; norms and
    attention run per position (``paged_verify_attention``).

    Dense family only: MoE routing is capacity-coupled across the token
    batch, so a (B*S)-token pass would route differently than B sequential
    single-token steps, and ssm/hybrid state has no paged layout."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError("paged verify applies to attention-family caches only")
    if cfg.family == "moe":
        raise NotImplementedError(
            "moe routing is capacity-coupled across the token batch — a "
            "batched verify pass routes differently than sequential decode, "
            "breaking the speculative acceptance contract"
        )
    x = _inputs(cfg, params, tokens, embeddings, cur_len)
    a = cfg.approx
    for i, layer in enumerate(L.unstack(params["layers"], cfg.num_layers)):
        h = paged_verify_attention(
            _norm_per_position(x, layer["ln1"]), layer["attn"],
            cache["k"][i], cache["v"][i], block_tables, cur_len,
            block_size=block_size, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, cfg=a, rope_theta=cfg.rope_theta,
            use_rope=_use_rope(cfg),
        )
        x = x + h
        x = x + _ffn(_norm_per_position(x, layer["ln2"]), layer["ffn"], a, cfg.fuse_gate_up)
    return _head(cfg, params, x, norm=_norm_per_position)


def paged_chunk_prefill_step(
    cfg: ModelConfig,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,               # (B, C) one chunk of each prompt
    prefill_pos: torch.Tensor,          # (B,) tokens already prefilled
    block_tables: torch.Tensor,         # (B, W) int32, sentinel-tailed
    *,
    block_size: int,
) -> torch.Tensor:
    """Teacher-force one (B, C) chunk of each row's prompt into the pool at
    positions ``[prefill_pos, prefill_pos + C)``, reading the prefix
    already written through the block table.  This IS ``paged_verify_step``:
    table entries covering ``[0, prefill_pos + C)`` must name real blocks,
    tail entries may still be the sentinel (their writes land in the trash
    block and no horizon reaches them), so N chunks write the pool and
    give the logits of one pass over the whole prompt, bit for bit.  The
    same family gates as the verify pass."""
    return paged_verify_step(cfg, params, cache, tokens, prefill_pos, block_tables,
                             block_size=block_size)


def _mask_pad(cfg: ModelConfig, logits):
    """-1e30 on padded vocab columns (additive, in the logits' dtype)."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    if Vp == V:
        return logits
    neg = torch.where(torch.arange(Vp, device=logits.device) < V, 0.0, -1e30)
    return logits + neg.to(logits.dtype)


def _head(cfg: ModelConfig, params, x, norm=L.rms_norm):
    """The logits (..., Vp) float32; a vocab-split head's columns are
    gathered from every rank, so each rank holds them all."""
    x = norm(x, params["final_norm"])
    head = params["lm_head"]
    return _mask_pad(cfg, L.gather_columns(L.dense(x, head, cfg.approx), head)).to(torch.float32)


def params_to(node, device):
    """The parameter tree (float tensors, QWeights and their Shards) on
    ``device``."""
    if isinstance(node, dict):
        return {k: params_to(v, device) for k, v in node.items()}
    if isinstance(node, Shard):
        return Shard(params_to(node.w, device), node.split, node.mesh)
    if isinstance(node, QWeight):
        return QWeight(*(t.to(device) for t in node))
    return None if node is None else node.to(device)
