"""Mamba2 (SSD) block: chunked scan for prefill, O(1)-state recurrent step
for decode (twin of ``repro/models/mamba2.py``).
[arXiv:2405.21060 as used by zamba2, arXiv:2411.15242]

State: h ∈ (B, H, P, N) with P = head dim, N = ssm state size.
    h_t = exp(a_h Δ_t) h_{t-1} + Δ_t B_t ⊗ x_t
    y_t = C_t · h_t + D x_t
B_t, C_t shared across heads (ngroups = 1), a_h scalar per head.

A block's params are a flat ``{name: tensor}`` dict (``in_proj``,
``conv_w``, ``out_proj``, ``a_log``, ``d_skip``, ``dt_bias``).
:func:`mamba_block_apply` runs the SSD through ``kernels/mamba2_scan/ops.ssd``
(the CUDA kernel on the card) when ``cfg.use_pallas_kernels`` is set, else
through :func:`ssd_chunked`, the reference's own route, which also serves
training.  The two round differently in bf16: ``ssd_chunked`` rounds C·Bᵀ
to the model's dtype, as the reference's does, and the kernel route does
not (ROADMAP queue 3).  :func:`mamba_block_decode` updates the cache's
state and conv buffer in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan.ops import ssd

Params = Dict[str, torch.Tensor]


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim


def block_shapes(cfg: ModelConfig, dtype: torch.dtype
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one block's params."""
    d, n = cfg.d_model, cfg.ssm_state_size
    d_in, nheads = mamba_dims(cfg)
    f32 = torch.float32
    return {"in_proj": ((d, 2 * d_in + 2 * n + nheads), dtype),
            "conv_w": ((cfg.ssm_conv_width, d_in + 2 * n), dtype),
            "out_proj": ((d_in, d), dtype),
            "a_log": ((nheads,), f32), "d_skip": ((nheads,), f32), "dt_bias": ((nheads,), f32)}


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, nheads = mamba_dims(cfg)
    n = cfg.ssm_state_size
    return torch.split(zxbcdt, [d_in, d_in + 2 * n, nheads], dim=-1)


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, xbc (B, S, C), conv_w (W, C): the W
    shifted products summed in the model's dtype in the reference's order."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = pad[:, 0:s] * conv_w[0]
    for i in range(1, w):
        out = out + pad[:, i:i + s] * conv_w[i]
    return F.silu(out)


def ssd_chunked(x, dt, a, b, c, d_skip, *, chunk: int, h0=None):
    """The reference's chunked SSD scan.  x (B, S, H, P); dt (B, S, H); a
    (H,) negative; b, c (B, S, N).  The chunk shrinks until it divides S.
    C·Bᵀ is formed in the model's dtype, as the reference's einsum of two
    bf16 operands gives bf16.  Returns y (B, S, H, P) in x's dtype and the
    final state (B, H, P, N) float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    nc = s // chunk
    adt = a[None, None, :] * dt                                          # (B, S, H) <= 0
    xr = (x * dt[..., None]).reshape(bsz, nc, chunk, h, p)               # Δ-weighted, float32
    ar = adt.reshape(bsz, nc, chunk, h)
    br = b.reshape(bsz, nc, chunk, n)
    cr = c.reshape(bsz, nc, chunk, n)
    hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xr[:, i], ar[:, i], br[:, i], cr[:, i]
        cs = torch.cumsum(ac, dim=1)                                     # (B, c, H)
        cb = torch.einsum("btn,bsn->bts", cc, bc)                        # model dtype
        decay = cs[:, :, None, :] - cs[:, None, :, :]                    # (B, t, s, H)
        m = torch.where(mask[None, :, :, None], torch.exp(decay), 0.0) * cb[..., None].float()
        y_intra = torch.einsum("btsh,bshp->bthp", m, xc)
        y_inter = torch.einsum("btn,bhpn->bthp", cc.float(), hprev) * torch.exp(cs)[..., None]
        end = cs[:, -1:, :]                                              # (B, 1, H)
        w = torch.exp(end - cs)                                          # (B, c, H)
        hprev = hprev * torch.exp(end)[:, 0, :, None, None] + torch.einsum(
            "bsh,bsn,bshp->bhpn", w, bc.float(), xc)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype), hprev


def ssd_reference(x, dt, a, b, c, d_skip, h0=None):
    """Token-by-token oracle (float32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(s):
        xt, dtt, bt, ct = x[:, t].float(), dt[:, t], b[:, t].float(), c[:, t].float()
        decay = torch.exp(a[None] * dtt)                                 # (B, H)
        hprev = hprev * decay[..., None, None] + torch.einsum("bhp,bn,bh->bhpn", xt, bt, dtt)
        ys.append(torch.einsum("bn,bhpn->bhp", ct, hprev))
    y = torch.stack(ys, dim=1) + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype), hprev


def _ssm_inputs(lp: Params, cfg: ModelConfig, x: torch.Tensor):
    """The projections: z, the conv's input xbc, and Δ in float32."""
    zxbcdt = torch.einsum("bsd,de->bse", x, lp["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    return z, xbc, F.softplus(dt.float() + lp["dt_bias"])


def mamba_block_state(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 256):
    """The block over a full sequence, x (B, S, d) -> (B, S, d), and the
    SSD's final state (B, H, P, N) float32, which :func:`mamba_block_apply`
    drops as the reference does."""
    d_in, nheads = mamba_dims(cfg)
    n = cfg.ssm_state_size
    z, xbc, dt = _ssm_inputs(lp, cfg, x)
    xin, b, c = torch.split(_causal_conv(xbc, lp["conv_w"]), [d_in, n, n], dim=-1)
    a = -torch.exp(lp["a_log"])
    xh = xin.reshape(*xin.shape[:2], nheads, cfg.ssm_head_dim)
    if cfg.use_pallas_kernels:
        y, state = ssd(xh, dt, a, b, c, lp["d_skip"])
    else:
        y, state = ssd_chunked(xh, dt, a, b, c, lp["d_skip"], chunk=chunk)
    y = y.reshape(*x.shape[:2], d_in) * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, lp["out_proj"]), state


def mamba_block_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 256):
    return mamba_block_state(lp, cfg, x, chunk=chunk)[0]


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    d_in, nheads = mamba_dims(cfg)
    n = cfg.ssm_state_size
    return {"h": torch.zeros((batch, nheads, cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * n), dtype=dtype,
                                device=device)}


def mamba_block_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
                       conv: torch.Tensor) -> torch.Tensor:
    """One-token step, x (B, 1, d) -> (B, 1, d).  The state ``h``
    (B, H, P, N) float32 and the conv buffer ``conv`` (B, W - 1, C), the
    last W - 1 inputs of the conv, are updated in place."""
    d_in, nheads = mamba_dims(cfg)
    n = cfg.ssm_state_size
    bsz = x.shape[0]
    z, xbc, dt = _ssm_inputs(lp, cfg, x)
    hist = torch.cat([conv, xbc.to(conv.dtype)], dim=1)                  # (B, W, C)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, lp["conv_w"])[:, None])
    xin, b, c = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = dt[:, 0]                                                        # (B, H)
    a = -torch.exp(lp["a_log"])
    xh = xin[:, 0].reshape(bsz, nheads, cfg.ssm_head_dim).float()
    h.mul_(torch.exp(a[None] * dt)[..., None, None]).add_(
        torch.einsum("bhp,bn,bh->bhpn", xh, b[:, 0].float(), dt))
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), h)
    y = y + xh * lp["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_in).to(x.dtype) * F.silu(z)
    conv.copy_(hist[:, 1:])
    return torch.einsum("bse,ed->bsd", y, lp["out_proj"])
