"""State-space sequence layers: the Mamba-1 selective scan (falcon-mamba)
and the Mamba-2 SSD (zamba2), the JAX package's ``models/ssm.py``.

Both process time in chunks so the (B, S, d_inner, N) discretized state
of a whole sequence is built one chunk at a time:

* Mamba-1: a loop over chunks carrying the state, a prefix within each
  chunk (the JAX package's associative scan, summed in time order here);
* Mamba-2 (SSD): the intra-chunk quadratic form plus the inter-chunk
  scalar-decay recurrence (the minimal SSD algorithm of the Mamba-2 paper).

Projections go through the approximate-multiplier ``dense`` (K1 on frozen
weights); the convolution, the recurrences and the gating are elementwise
float work, as in the JAX package, which computes them outside any Pallas
kernel.  Parameters are dicts keyed by the JAX named tuples' fields.
Under data-parallel training (``parallel/fsdp.wrap``) every leaf is a
``DataPart``: the projections gather in ``dense``, and the convolution and
scan parameters, replicated, are read once per use through ``L.whole``,
whose backward sums their gradients over the ranks; shapes come from
``w_dim``.
``softplus`` is ``logaddexp(x, 0)``, the JAX package's ``jax.nn.softplus``
(``F.softplus`` switches to the identity past a threshold).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.approx import ApproxConfig, w_dim
from repro_torch.models import layers as L

__all__ = [
    "init_mamba1", "mamba1_forward", "mamba1_decode_step",
    "init_mamba2", "mamba2_forward", "mamba2_decode_step",
    "ssd_chunked", "softplus",
]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------


def init_mamba1(gen: Optional[torch.Generator], d_model: int, d_inner: int, n_state: int,
                dt_rank: int, conv_w: int = 4, *, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Mamba1Params`` as a dict, from ``gen`` (None:
    shapes only, on ``meta``)."""
    return {
        "in_proj": L.init_dense(d_model, 2 * d_inner, gen, device),
        "conv_w": 0.1 * torch.randn((conv_w, d_inner), generator=gen, device=device),
        "conv_b": torch.zeros((d_inner,), device=device),
        "x_proj": L.init_dense(d_inner, dt_rank + 2 * n_state, gen, device),
        "dt_proj": L.init_dense(dt_rank, d_inner, gen, device),
        "dt_bias": torch.full((d_inner,), -4.6, device=device),   # softplus^-1(0.01)
        "a_log": torch.log(torch.arange(1, n_state + 1, dtype=torch.float32, device=device)
                           ).expand(d_inner, n_state).clone(),
        "d_skip": torch.ones((d_inner,), device=device),
        "out_proj": L.init_dense(d_inner, d_model, gen, device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """x (B, S, C); w (cw, C).  Returns (y, new_state), the state (B, cw-1,
    C): the last cw-1 inputs.  Taps summed in order i = 0..cw-1."""
    cw = w.shape[0]
    wd = w.to(x.dtype)
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * wd[i] for i in range(cw)) + b.to(x.dtype)
    return y, xp[:, -(cw - 1):, :]


def _selective_scan_chunked(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor,
                            chunk: int):
    """The linear recurrence h_t = dA_t * h_{t-1} + dBx_t over axis 1.

    dA/dBx: (B, S, di, N); h0: (B, di, N).  Returns (h_all (B, S, di, N),
    h_last).  Chunked as in the JAX package: each chunk's cumulative
    (decay, input) pair, then ``h_blk = aa * h + bb`` from the carried
    state."""
    S = dA.shape[1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the scan chunk {chunk}")
    h, outs = h0, []
    for c in range(S // chunk):
        da, dbx = dA[:, c * chunk:(c + 1) * chunk], dBx[:, c * chunk:(c + 1) * chunk]
        aa, bb = [da[:, 0]], [dbx[:, 0]]
        for t in range(1, chunk):
            aa.append(aa[-1] * da[:, t])
            bb.append(da[:, t] * bb[-1] + dbx[:, t])
        h_blk = torch.stack(aa, dim=1) * h[:, None] + torch.stack(bb, dim=1)
        h = h_blk[:, -1]
        outs.append(h_blk)
    return torch.cat(outs, dim=1), h


def _mamba1_core(xz, p: Dict[str, Any], cfg: ApproxConfig, conv_state, h0, chunk: int):
    """Shared by the forward and the decode step; xz (B, S, 2*di)."""
    S = xz.shape[1]
    N = w_dim(p["a_log"], 1)
    dt_rank = w_dim(p["dt_proj"], 0)
    x, z = xz.chunk(2, dim=-1)
    x, conv_state = _causal_depthwise_conv(x, L.whole(p["conv_w"]), L.whole(p["conv_b"]),
                                           conv_state)
    x = F.silu(x)
    proj = L.dense(x, p["x_proj"], cfg)
    dt, Bc, Cc = proj[..., :dt_rank], proj[..., dt_rank:dt_rank + N], proj[..., dt_rank + N:]
    dt = softplus(L.dense(dt, p["dt_proj"], cfg) + L.whole(p["dt_bias"]).to(x.dtype))  # (B,S,di)
    A = -torch.exp(L.whole(p["a_log"]).to(torch.float32))                        # (di, N)
    dA = torch.exp(dt.to(torch.float32)[..., None] * A)                          # (B,S,di,N)
    dBx = (dt * x).to(torch.float32)[..., None] * Bc.to(torch.float32)[..., None, :]
    if S == 1:
        h = dA[:, 0] * h0 + dBx[:, 0]
        h_all, h_last = h[:, None], h
    else:
        h_all, h_last = _selective_scan_chunked(dA, dBx, h0, min(chunk, S))
    y = torch.einsum("bsdn,bsn->bsd", h_all, Cc.to(torch.float32)).to(x.dtype)
    y = y + L.whole(p["d_skip"]).to(x.dtype) * x
    y = y * F.silu(z)
    return L.dense(y, p["out_proj"], cfg), conv_state, h_last


def mamba1_forward(x: torch.Tensor, p: Dict[str, Any], *, cfg: ApproxConfig,
                   chunk: int = 256):
    """x (B, S, d) -> (y, (conv_state, ssm_state)) from a zero state."""
    B = x.shape[0]
    di = w_dim(p["out_proj"], 0)
    N = w_dim(p["a_log"], 1)
    xz = L.dense(x, p["in_proj"], cfg)
    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    y, conv_state, h_last = _mamba1_core(xz, p, cfg, None, h0, chunk)
    return y, (conv_state, h_last)


def mamba1_decode_step(x: torch.Tensor, p: Dict[str, Any], state, *, cfg: ApproxConfig):
    """x (B, 1, d); state = (conv_state (B, cw-1, di), h (B, di, N)).
    Returns (y, (conv_state, h)), new tensors."""
    conv_state, h = state
    xz = L.dense(x, p["in_proj"], cfg)
    y, conv_state, h = _mamba1_core(xz, p, cfg, conv_state, h, 1)
    return y, (conv_state, h)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def init_mamba2(gen: Optional[torch.Generator], d_model: int, d_inner: int, n_state: int,
                n_heads: int, conv_w: int = 4, *, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``Mamba2Params`` as a dict, from ``gen`` (None:
    shapes only, on ``meta``)."""
    conv_dim = d_inner + 2 * n_state
    return {
        "in_proj": L.init_dense(d_model, 2 * d_inner + 2 * n_state + n_heads, gen, device),
        "conv_w": 0.1 * torch.randn((conv_w, conv_dim), generator=gen, device=device),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "dt_bias": torch.zeros((n_heads,), device=device),
        "a_log": torch.zeros((n_heads,), device=device),
        "d_skip": torch.ones((n_heads,), device=device),
        "norm_g": torch.ones((d_inner,), device=device),
        "out_proj": L.init_dense(d_inner, d_model, gen, device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., c) log-decays -> (..., c, c) lower-triangular cumulative sums
    (-inf above the diagonal)."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.full_like(seg, -torch.inf))


def ssd_chunked(X, a_log_dt, Bm, Cm, h0, chunk: int):
    """Minimal SSD (Mamba-2) over chunks.

    X: (B, S, nh, hd); a_log_dt: (B, S, nh) per-step log decay (negative);
    Bm/Cm: (B, S, N); h0: (B, nh, hd, N).  Returns (Y, h_last)."""
    Bsz, S, nh, hd = X.shape
    N = Bm.shape[-1]
    nc = S // chunk
    Xc = X.reshape(Bsz, nc, chunk, nh, hd)
    Ac = a_log_dt.reshape(Bsz, nc, chunk, nh)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    Acs = torch.cumsum(Ac, dim=2)                                    # (B,nc,c,nh)
    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(Ac.transpose(2, 3)))                    # (B,nc,nh,c,c)
    scores = torch.einsum("bzin,bzjn->bzij", Cc, Bc)                 # (B,nc,c,c)
    Y_intra = torch.einsum("bzhij,bzij,bzjhd->bzihd", Lmat, scores, Xc)
    # chunk-end states
    decay_to_end = torch.exp(Acs[:, :, -1:, :] - Acs)                # (B,nc,c,nh)
    states = torch.einsum("bzch,bzcn,bzchd->bzhdn", decay_to_end, Bc, Xc)
    # inter-chunk recurrence: each chunk starts from the state before it
    chunk_decay = torch.exp(Acs[:, :, -1, :])                        # (B,nc,nh)
    h, h_prevs = h0, []
    for z in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                            # (B,nc,nh,hd,N)
    in_decay = torch.exp(Acs)                                        # decay from chunk start
    Y_inter = torch.einsum("bzch,bzcn,bzhdn->bzchd", in_decay, Cc, h_prevs)
    Y = (Y_intra + Y_inter).reshape(Bsz, S, nh, hd)
    return Y, h


def _mamba2_split(p: Dict[str, Any], proj):
    di = w_dim(p["out_proj"], 0)
    N = (w_dim(p["conv_w"], 1) - di) // 2
    nh = w_dim(p["a_log"], 0)
    z, xBC, dt = proj[..., :di], proj[..., di:2 * di + 2 * N], proj[..., 2 * di + 2 * N:]
    return z, xBC, dt, di, N, nh


def mamba2_forward(x: torch.Tensor, p: Dict[str, Any], *, cfg: ApproxConfig,
                   chunk: int = 256):
    """x (B, S, d) -> (y, (conv_state, ssm_state)) from a zero state."""
    B, S, _ = x.shape
    proj = L.dense(x, p["in_proj"], cfg)
    z, xBC, dt, di, N, nh = _mamba2_split(p, proj)
    hd = di // nh
    xBC, conv_state = _causal_depthwise_conv(xBC, L.whole(p["conv_w"]), L.whole(p["conv_b"]),
                                             None)
    xBC = F.silu(xBC)
    xs, Bm, Cm = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    dt = softplus(dt.to(torch.float32) + L.whole(p["dt_bias"]))      # (B,S,nh)
    a = -torch.exp(L.whole(p["a_log"]).to(torch.float32))             # (nh,)
    Xh = xs.reshape(B, S, nh, hd).to(torch.float32) * dt[..., None]
    h0 = torch.zeros((B, nh, hd, N), dtype=torch.float32, device=x.device)
    ck = min(chunk, S)
    if S % ck != 0 or S == 1:
        ck = 1 if S == 1 else S
    Y, h_last = ssd_chunked(Xh, dt * a, Bm.to(torch.float32), Cm.to(torch.float32), h0, ck)
    Y = Y + L.whole(p["d_skip"]).to(torch.float32)[None, None, :, None] * \
        xs.reshape(B, S, nh, hd).to(torch.float32)
    y = Y.reshape(B, S, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), L.whole(p["norm_g"]))
    return L.dense(y, p["out_proj"], cfg), (conv_state, h_last)


def mamba2_decode_step(x: torch.Tensor, p: Dict[str, Any], state, *, cfg: ApproxConfig):
    """x (B, 1, d); state = (conv_state, h (B, nh, hd, N)).  Returns (y,
    (conv_state, h)), new tensors."""
    conv_state, h = state
    B = x.shape[0]
    proj = L.dense(x, p["in_proj"], cfg)
    z, xBC, dt, di, N, nh = _mamba2_split(p, proj)
    hd = di // nh
    xBC, conv_state = _causal_depthwise_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs, Bm, Cm = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])[:, 0]         # (B,nh)
    a = -torch.exp(p["a_log"].to(torch.float32))
    dA = torch.exp(dt * a)                                            # (B,nh)
    Xh = xs[:, 0].reshape(B, nh, hd).to(torch.float32) * dt[..., None]
    h = h * dA[..., None, None] + torch.einsum("bhd,bn->bhdn", Xh, Bm[:, 0].to(torch.float32))
    Y = torch.einsum("bhdn,bn->bhd", h, Cm[:, 0].to(torch.float32))
    Y = Y + p["d_skip"].to(torch.float32)[None, :, None] * \
        xs[:, 0].reshape(B, nh, hd).to(torch.float32)
    y = Y.reshape(B, 1, di).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm_g"])
    return L.dense(y, p["out_proj"], cfg), (conv_state, h)
