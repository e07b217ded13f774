"""QSGD wire compression (twin of ``repro/core/compression.py``).

Bucketed stochastic quantization (Alistarh et al. [2]): one float32 L2 norm
per ``bucket_size`` elements plus a sign+magnitude code per element, with
exact bits-on-wire accounting.  Where the reference takes a PRNG key, the
port takes the uniform draws themselves (``u``, one per padded element,
shaped (nb, bucket_size)) — the swarm round draws them from its key
schedule or is handed them (``random.RoundDraws``).

Given the same bucket norms and uniforms, the codes equal the reference's
exactly: every expression up to the code integers is the reference's, op
for op, in float32.  The norms themselves are float reductions whose order
differs from XLA's.  Top-k and PowerSGD wait for their slice (ROADMAP
queue 1, item 6).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

WIRE_CODECS = (None, "qsgd")


@dataclass(frozen=True)
class Compressed:
    kind: str
    payload: Dict[str, Any]
    bits: int          # exact bits on the wire
    orig_shape: tuple
    orig_bits: int


def _nbits(x: torch.Tensor) -> int:
    return int(x.numel() * x.element_size() * 8)


def bits_per_element(levels: int) -> int:
    return math.ceil(math.log2(levels + 1)) + 1


def pad_buckets(x: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Flatten to float32, zero-pad to a bucket multiple -> (nb, bucket)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % bucket_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, bucket_size)


def bucket_norms(padded: torch.Tensor) -> torch.Tensor:
    """(nb, B) -> (nb, 1) L2 norms."""
    return torch.linalg.vector_norm(padded, dim=1, keepdim=True)


def quantize(padded: torch.Tensor, norms: torch.Tensor, u: torch.Tensor,
             levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic rounding of |x| / norm * levels -> (q int32 in
    [0, levels], sign bool), exactly the reference's float32 expressions."""
    scaled = torch.abs(padded) / torch.clamp(norms, min=1e-30) * levels
    lower = torch.floor(scaled)
    p = scaled - lower
    q = (lower + (u.reshape(padded.shape) < p).float()).to(torch.int32)
    return q, torch.signbit(padded)


def qsgd_compress(x: torch.Tensor, u: torch.Tensor, *, levels: int = 16,
                  bucket_size: int = 1024) -> Compressed:
    padded = pad_buckets(x, bucket_size)
    norms = bucket_norms(padded)
    q, sign = quantize(padded, norms, u, levels)
    size = x.numel()
    return Compressed(
        kind="qsgd",
        payload={"q": q, "sign": sign, "norms": norms, "levels": levels,
                 "size": size},
        bits=32 * norms.numel() + size * bits_per_element(levels),
        orig_shape=tuple(x.shape),
        orig_bits=_nbits(x),
    )


def qsgd_decompress(c: Compressed) -> torch.Tensor:
    p = c.payload
    mag = p["q"].float() / p["levels"] * p["norms"]
    out = torch.where(p["sign"], -mag, mag).reshape(-1)[:p["size"]]
    return out.reshape(c.orig_shape)


def roundtrip(kind: Optional[str], u: Optional[torch.Tensor], x: torch.Tensor,
              **kwargs) -> torch.Tensor:
    """What the receiver reconstructs from ``x``: identity for ``None``,
    decode(encode(x)) for ``"qsgd"`` with the uniforms ``u``."""
    if kind is None:
        return x
    if kind == "qsgd":
        return qsgd_decompress(qsgd_compress(x, u, **kwargs))
    if kind in ("topk", "powersgd"):
        raise NotImplementedError(f"the {kind!r} wire waits for its slice "
                                  "(ROADMAP queue 1, item 6)")
    raise ValueError(f"unknown wire codec: {kind!r} "
                     f"(roundtrip carries: {WIRE_CODECS})")


def compression_ratio(c: Compressed) -> float:
    return c.orig_bits / c.bits
