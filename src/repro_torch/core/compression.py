"""Gradient compression for the wire (twin of ``repro/core/compression.py``,
paper §3.1).

- QSGD bucketed stochastic quantization (Alistarh et al. [2]): one float32
  L2 norm per ``bucket_size`` elements plus a sign+magnitude code per
  element;
- top-k sparsification, with error feedback;
- PowerSGD-style rank-r compression of a matrix (a flat vector is laid on
  its squarest grid by :func:`roundtrip`).

Each compressor returns a :class:`Compressed` payload with its exact bits
on the wire.  Where the reference takes a PRNG key, the port takes the
draws themselves: QSGD's uniforms ``u``, one per padded element, shaped
(nb, bucket_size), and PowerSGD's normal subspace init, (cols, rank).
:func:`wire_draw` says which draw a flat vector's wire consumes; the swarm
round draws it from its key schedule or is handed it
(``random.RoundDraws``).

Given the same bucket norms and uniforms, QSGD's codes equal the
reference's exactly: every expression up to the code integers is the
reference's, op for op, in float32.  The norms themselves are float
reductions whose order differs from XLA's.  Top-k's values are the
reference's; where |x| ties at the k-th value the two sides may keep
different indices (ROADMAP queue 3).  PowerSGD's QR may choose other column
signs than XLA's; the reconstruction p·qᵀ does not depend on them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

WIRE_CODECS = (None, "qsgd", "topk", "powersgd")


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


def inverse(count: int, device) -> torch.Tensor:
    """A float32 1/count, rounded once.  Under ``jit`` XLA folds a division
    by a constant into a multiply by this value, and every reference round
    runs compiled: the dense means multiply their sum by it, as the
    reference's compiled ``jnp.mean`` does, and the QSGD decode multiplies
    each norm by it (:func:`dequantize`).  The masked means divide, as
    theirs do (a traced count)."""
    return (torch.ones((), dtype=torch.float32, device=device)
            / torch.full((), float(count), dtype=torch.float32, device=device))


def dequantize(q: torch.Tensor, norms: torch.Tensor, levels: int) -> torch.Tensor:
    """QSGD codes (int) times their norms (broadcast) over ``levels``, as the
    compiled reference computes ``q / levels * norm``: XLA rewrites it into
    q · (norm · r), r = :func:`inverse` (levels), one multiply a norm and
    one a code.  Equal bit for bit to the reference under ``jax.jit`` at
    every ``levels``; the eager reference, which divides, differs by an ulp
    where ``levels`` is not a power of two."""
    return q.float() * (norms * inverse(levels, norms.device))


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
    mag = dequantize(p["q"], p["norms"], p["levels"])
    out = torch.where(p["sign"], -mag, mag).reshape(-1)[:p["size"]]
    return out.reshape(c.orig_shape)


# -- top-k with error feedback ---------------------------------------------------
def topk_compress(x: torch.Tensor, *, k_frac: float = 0.01) -> Compressed:
    flat = x.reshape(-1).float()
    k = max(1, int(flat.numel() * k_frac))
    idx = torch.topk(torch.abs(flat), k).indices
    return Compressed(
        kind="topk",
        payload={"vals": flat[idx], "idx": idx, "size": flat.numel()},
        bits=k * (32 + 32),
        orig_shape=tuple(x.shape),
        orig_bits=_nbits(x),
    )


def topk_decompress(c: Compressed) -> torch.Tensor:
    p = c.payload
    out = torch.zeros(p["size"], dtype=torch.float32, device=p["vals"].device)
    out[p["idx"]] = p["vals"]
    return out.reshape(c.orig_shape)


def topk_with_error_feedback(x: torch.Tensor, error: torch.Tensor, *,
                             k_frac: float = 0.01) -> Tuple[Compressed, torch.Tensor]:
    """Returns (compressed, new_error): the error accumulates what was not
    sent."""
    corrected = x + error
    c = topk_compress(corrected, k_frac=k_frac)
    return c, corrected - topk_decompress(c)


# -- PowerSGD (rank r) ------------------------------------------------------------
def powersgd_compress(x: torch.Tensor, q0: torch.Tensor, *, rank: int = 4,
                      iters: int = 1) -> Compressed:
    """Rank-``rank`` subspace-iteration approximation of a matrix (m, n),
    from the normal draw ``q0`` (n, rank)."""
    if x.dim() != 2:
        raise ValueError(f"powersgd applies to matrices, got shape {tuple(x.shape)}")
    if iters < 1:
        raise ValueError(f"powersgd needs iters >= 1, got {iters}")
    m, n = x.shape
    if tuple(q0.shape) != (n, rank):
        raise ValueError(f"powersgd needs a ({n}, {rank}) normal draw, got "
                         f"{tuple(q0.shape)}")
    xf = x.float()
    q = q0.float()
    for _ in range(iters):
        p = torch.linalg.qr(xf @ q).Q                    # (m, r)
        q = xf.T @ p                                     # (n, r)
    return Compressed(
        kind="powersgd",
        payload={"p": p, "q": q},
        bits=(m + n) * rank * 32,
        orig_shape=tuple(x.shape),
        orig_bits=_nbits(x),
    )


def powersgd_decompress(c: Compressed) -> torch.Tensor:
    return (c.payload["p"] @ c.payload["q"].T).reshape(c.orig_shape)


def squarest_grid(size: int) -> Tuple[int, int]:
    """(rows, cols) of the squarest grid holding ``size`` values, as the
    reference lays a flat vector out for PowerSGD."""
    cols = int(math.ceil(math.sqrt(size)))
    return int(math.ceil(size / cols)), cols


def wire_draw(kind: Optional[str], size: int,
              **kwargs) -> Optional[Tuple[str, Tuple[int, ...]]]:
    """The draw one node's wire consumes for a flat vector of ``size``
    values: ``("uniform", (nb, bucket_size))`` for qsgd, ``("normal",
    (cols, rank))`` for powersgd, None for the other codecs."""
    if kind == "qsgd":
        bucket = kwargs.get("bucket_size", 1024)
        return "uniform", (-(-size // bucket), bucket)
    if kind == "powersgd":
        return "normal", (squarest_grid(size)[1], kwargs.get("rank", 4))
    return None


def roundtrip(kind: Optional[str], u: Optional[torch.Tensor], x: torch.Tensor,
              **kwargs) -> torch.Tensor:
    """What the receiver reconstructs from ``x``: identity for ``None``,
    decode(encode(x)) otherwise, with the codec's draw ``u`` (QSGD's
    uniforms, PowerSGD's normals; top-k takes none).  PowerSGD lays a
    non-matrix ``x`` on its squarest grid, zero-padded, and slices the
    reconstruction back."""
    if kind is None:
        return x
    if kind == "qsgd":
        return qsgd_decompress(qsgd_compress(x, u, **kwargs))
    if kind == "topk":
        return topk_decompress(topk_compress(x, **kwargs))
    if kind == "powersgd":
        if x.dim() == 2:
            return powersgd_decompress(powersgd_compress(x, u, **kwargs))
        flat = x.reshape(-1).float()
        d = flat.numel()
        rows, cols = squarest_grid(d)
        grid = torch.cat([flat, flat.new_zeros(rows * cols - d)]).reshape(rows, cols)
        out = powersgd_decompress(powersgd_compress(grid, u, **kwargs))
        return out.reshape(-1)[:d].reshape(x.shape)
    raise ValueError(f"unknown wire codec: {kind!r} "
                     f"(roundtrip carries: {WIRE_CODECS})")


DECOMPRESSORS = {
    "qsgd": qsgd_decompress,
    "topk": topk_decompress,
    "powersgd": powersgd_decompress,
}


def decompress(c: Compressed) -> torch.Tensor:
    return DECOMPRESSORS[c.kind](c)


def compression_ratio(c: Compressed) -> float:
    return c.orig_bits / c.bits
