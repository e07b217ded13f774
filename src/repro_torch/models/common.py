"""Shared dense building blocks (twin of ``repro/models/common.py``).

Plain functions on tensors, in the reference's layouts: activations are
(B, S, ...) and attention heads sit in the second-to-last axis.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# -- initialisation ----------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device, *, fan_shape: Optional[Sequence[int]] = None,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init.  ``fan_shape`` is the per-layer shape
    the fan-in is read from when ``shape`` carries a leading layer axis
    (the reference inits each layer, then stacks)."""
    fs = tuple(fan_shape or shape)
    fan_in = fs[-2] if len(fs) >= 2 else fs[-1]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=device)
    return (x * 0.02).to(dtype)


# -- norms -------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.float()).to(dt)


# -- RoPE --------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once: a
    copy from host memory waits for the device's queue, and a decode step
    applies RoPE twice a layer."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)           # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    angles = angles[..., None, :]                                # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@lru_cache(maxsize=16)
def _section_ids_on(sections: tuple, device: torch.device) -> torch.Tensor:
    """The M-RoPE stream (0, 1, 2) of each of the hd/2 frequencies, on
    ``device``, copied there once (as :func:`_rope_freqs_on`)."""
    ids = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x (B, S, H, hd); positions (3, B, S), the
    (temporal, height, width) ids.  ``sections`` splits the hd/2 rotary
    frequencies into (t, h, w) groups, each rotated by its own position
    stream.  [arXiv:2409.12191]"""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to hd/2 = {hd // 2}")
    freqs = _rope_freqs_on(hd, float(theta), x.device)           # (hd/2,)
    pos_sel = positions[_section_ids_on(tuple(sections), x.device)]  # (hd/2, B, S)
    angles = torch.movedim(pos_sel, 0, -1).float() * freqs       # (B, S, hd/2)
    angles = angles[..., None, :]                                # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- FFN ---------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


# -- losses ------------------------------------------------------------------
def chunked_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    """Mean masked cross-entropy, with the logits built in sequence chunks
    of ``chunk`` positions (B, chunk, V) in float32.  The reference also
    rematerializes each chunk in the backward pass; at the sequence lengths
    this slice runs (128) there is one chunk, so the port does not."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    w = unembed.float()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        hc = h[:, s0:s0 + chunk].float()
        logits = torch.einsum("bsd,dv->bsv", hc, w)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, s0:s0 + chunk, None])[..., 0]
        total = total + torch.sum((logz - gold) * mask[:, s0:s0 + chunk])
    denom = torch.clamp(torch.sum(mask.float()), min=1.0)
    return total / denom
