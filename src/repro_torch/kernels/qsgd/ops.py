"""QSGD encode: the wire's stochastic quantization to int8 codes (twin of
``repro/kernels/qsgd/ops.py``, paper §3.1 [2]).

One kernel, ``csrc/qsgd_encode.cu``, takes one norm per bucket, so it
serves two surfaces:

- the reference kernel's global-norm surface — :func:`qsgd_encode` against
  one L2 norm of the whole tensor, viewed as (R, 128) lanes (one bucket of
  R·128), with :func:`qsgd_decode`, :func:`qsgd_roundtrip`,
  :func:`wire_bits` and :func:`single_bucket_regime`;
- the fused swarm round's bucketed wire, through
  ``kernels.qsgd_decode.ops.wire_encode``.

Where the reference takes a PRNG key, the port takes the uniform draws
themselves, one per padded element.  :func:`qsgd_encode_buckets` launches
the kernel on CUDA tensors (:func:`qsgd_encode_kernel`) and runs the plain
version, :func:`qsgd_encode_plain`, on CPU tensors.  Given the same norms
and uniforms the codes are equal, on either device, to the reference's.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.compression import dequantize
from repro_torch.kernels import build

LANE = 128

#: launches of the encode kernel (one per wrapper call on CUDA)
LAUNCHES = {"qsgd_encode": 0}


def qsgd_encode_plain(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor, *,
                      levels: int, bucket_size: int) -> torch.Tensor:
    """Plain version of the kernel: the expressions of the reference's
    ``qsgd/kernel.py:_kernel`` with ``norms[i // bucket_size]``.  ``x`` is
    zero-padded to the length of ``u``; the codes come back in ``u``'s
    shape, int8."""
    flat = x.reshape(-1).float()
    pad = u.numel() - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    xb = flat.reshape(-1, bucket_size)
    scaled = torch.abs(xb) / torch.clamp(norms.reshape(-1, 1), min=1e-30) * levels
    lower = torch.floor(scaled)
    p = scaled - lower
    q = lower + (u.reshape(xb.shape) < p).float()
    q = torch.where(torch.signbit(xb), -q, q)
    return q.to(torch.int8).reshape(u.shape)


def _check(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor, levels: int,
           bucket_size: int) -> None:
    if not (x.dtype == u.dtype == norms.dtype == torch.float32):
        raise TypeError("qsgd_encode needs float32 x, uniforms and norms")
    if not 1 <= levels <= 127:
        raise ValueError(f"int8 codes need 1 <= levels <= 127, got {levels}")
    padded = u.numel()
    if bucket_size < 1 or padded % bucket_size or x.numel() > padded:
        raise ValueError(f"qsgd_encode needs whole buckets of uniforms covering x: "
                         f"{x.numel()} values, {padded} uniforms, bucket {bucket_size}")
    if norms.numel() != padded // bucket_size:
        raise ValueError(f"qsgd_encode needs one norm a bucket: {norms.numel()} norms "
                         f"for {padded // bucket_size} buckets")
    if not (x.device == u.device == norms.device):
        raise ValueError("qsgd_encode inputs must share one device")


def qsgd_encode_kernel(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor, *,
                       levels: int, bucket_size: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only): x read unpadded, codes
    in ``u``'s shape."""
    _check(x, u, norms, levels, bucket_size)
    if not x.is_cuda:
        raise ValueError("qsgd_encode_kernel needs CUDA tensors")
    xf = x.reshape(-1).contiguous()
    uf, nf = u.contiguous(), norms.contiguous()
    out = torch.empty(u.shape, dtype=torch.int8, device=x.device)
    fn = build.function("qsgd_encode", "qsgd_encode_i8",
                        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                        + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(xf.data_ptr(), uf.data_ptr(), nf.data_ptr(), out.data_ptr(),
                   xf.numel(), uf.numel(), bucket_size, float(levels), stream),
                "qsgd_encode")
    LAUNCHES["qsgd_encode"] += 1
    return out


def qsgd_encode_buckets(x: torch.Tensor, u: torch.Tensor, norms: torch.Tensor, *,
                        levels: int, bucket_size: int) -> torch.Tensor:
    """int8 codes of ``x`` against one norm per ``bucket_size`` elements,
    with the uniforms ``u`` (one per padded element; the codes take its
    shape).  The kernel on CUDA tensors, its plain version on CPU ones."""
    if x.is_cuda:
        return qsgd_encode_kernel(x, u, norms, levels=levels, bucket_size=bucket_size)
    _check(x, u, norms, levels, bucket_size)
    return qsgd_encode_plain(x, u, norms, levels=levels, bucket_size=bucket_size)


# ------------------------- the global-norm surface ----------------------------
def _to_lanes(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Flatten to float32 and zero-pad to whole 128-lane rows -> (R, 128), pad."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % LANE
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, LANE), pad


def qsgd_encode(x: torch.Tensor, u: torch.Tensor, *,
                levels: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes int8 (R, 128) and the global norm (float32 scalar) of ``x``,
    with the (R, 128) uniforms ``u``.  Unbiased."""
    x2d, _ = _to_lanes(x)
    norm = torch.linalg.vector_norm(x2d)
    codes = qsgd_encode_buckets(x.reshape(-1).float(), u.reshape(x2d.shape),
                                norm.reshape(1), levels=levels,
                                bucket_size=x2d.numel())
    return codes, norm


def qsgd_decode(q: torch.Tensor, norm: torch.Tensor, *, levels: int,
                shape: tuple) -> torch.Tensor:
    size = 1
    for d in shape:
        size *= d
    mag = dequantize(q, norm, levels)
    return mag.reshape(-1)[:size].reshape(shape)


def qsgd_roundtrip(x: torch.Tensor, u: torch.Tensor, *, levels: int = 64) -> torch.Tensor:
    q, norm = qsgd_encode(x, u, levels=levels)
    return qsgd_decode(q, norm, levels=levels, shape=tuple(x.shape))


def wire_bits(x: torch.Tensor) -> int:
    """int8 code per element + fp32 norm."""
    return x.numel() * 8 + 32


def single_bucket_regime(size: int, *, bucket_size: int = 1024) -> bool:
    """True iff this surface (one global norm, LANE-padded draws) and the
    bucketed wire ``compression.qsgd_compress`` quantize identically: the
    wire makes one bucket whose padded width is the LANE padding,
    ``size <= bucket_size`` and ``ceil(size / LANE) * LANE == bucket_size``
    (zero padding never changes a norm, and the draws are the same numbers
    in another shape)."""
    rows = -(-size // LANE)
    return size <= bucket_size and rows * LANE == bucket_size
