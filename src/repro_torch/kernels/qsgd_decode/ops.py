"""Wire-format QSGD payloads and the fused decode-accumulate (twin of
``repro/kernels/qsgd_decode/ops.py``).

``wire_encode`` is bit-compatible with ``core.compression.qsgd_compress`` —
same bucketing, same norms, same stochastic-rounding draws — but stores the
code as one **signed int8** per element (sign folded into the magnitude)
instead of the reference's int32 + bool pair, so the payload a fused round
keeps live between compress and aggregate is ~4.5 bytes/element smaller.
Its codes come from ``kernels.qsgd.ops.qsgd_encode_buckets``: the encode
kernel on a CUDA tensor (reading x unpadded), its plain version on a CPU
one.
``wire_decode(wire_encode(x, u))`` equals ``compression.roundtrip("qsgd",
u, x)`` except that true-sign zero codes decode to +0.0 rather than −0.0
(numerically equal; every arithmetic consumer is unaffected).

The decode is the compiled reference's, q · (norm · r) with r the float32
1/levels (``compression.dequantize``): every reference round runs under
``jit``, where XLA rewrites ``q / levels * norm`` into that form, so
``wire_decode`` equals ``jax.jit`` of the reference's bit for bit at every
``levels``.

``decode_accumulate`` is Σᵢ wᵢ · decode(payloadᵢ) without a decoded
stack: on a CUDA tensor it launches the kernel of
``csrc/qsgd_decode.cu``; on a CPU tensor it runs the plain version,
:func:`decode_accumulate_plain`, which performs the kernel's arithmetic in
the same order.  Each node's term is ``wire_decode(payloadᵢ) * wᵢ`` bit
for bit, summed in node order.  The reference has no exact compiled
target for the sum (XLA sums the node axis in an order of its own), so the
accumulator agrees with it within a bound, not bit for bit.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core.compression import (bits_per_element, bucket_norms, dequantize,
                                          inverse, pad_buckets)
from repro_torch.kernels import build
from repro_torch.kernels.qsgd import ops as qsgd_ops

#: launches of the decode-accumulate kernel (one per wrapper call on CUDA)
LAUNCHES = {"qsgd_decode_accumulate": 0}


@dataclass
class QsgdPayload:
    """codes (…, nb, B) int8 signed magnitudes, norms (…, nb, 1) float32
    bucket L2 norms; ``levels``, ``size`` and ``bucket_size`` describe the
    encoding.  A node-batched payload has a leading N axis."""
    codes: torch.Tensor
    norms: torch.Tensor
    levels: int
    size: int
    bucket_size: int

    def wire_bits(self) -> int:
        """Bits on the wire of ONE node's payload — the same accounting as
        ``compression.qsgd_compress``."""
        nb = -(-self.size // self.bucket_size)
        return 32 * nb + self.size * bits_per_element(self.levels)


def wire_encode(x: torch.Tensor, u: torch.Tensor, *, levels: int = 16,
                bucket_size: int = 1024) -> QsgdPayload:
    """QSGD-quantize ``x`` (any shape) into a signed-int8 wire payload with
    the uniform draws ``u`` (one per padded element).  ``levels`` must fit
    a signed byte."""
    if levels > 127:
        raise ValueError(f"int8 wire codes need levels <= 127, got {levels}")
    norms = bucket_norms(pad_buckets(x, bucket_size))
    codes = qsgd_ops.qsgd_encode_buckets(x.reshape(-1).float(), u.reshape(-1, bucket_size),
                                         norms, levels=levels, bucket_size=bucket_size)
    return QsgdPayload(codes, norms, levels=levels, size=x.numel(),
                       bucket_size=bucket_size)


def _decode_rows(codes: torch.Tensor, norms: torch.Tensor, levels: int,
                 size: int) -> torch.Tensor:
    return dequantize(codes, norms, levels).reshape(-1)[:size]


def wire_decode(payload: QsgdPayload) -> torch.Tensor:
    """Dequantize a payload back to flat float32 values: (size,) for one
    node, (N, size) for a node-batched payload (decoded row by row, so no
    (N, D) intermediate beyond the output)."""
    c, nrm = payload.codes, payload.norms
    if c.dim() == 2:
        return _decode_rows(c, nrm, payload.levels, payload.size)
    out = torch.empty((c.shape[0], payload.size), dtype=torch.float32,
                      device=c.device)
    for i in range(c.shape[0]):
        out[i] = _decode_rows(c[i], nrm[i], payload.levels, payload.size)
    return out


def decode_accumulate_plain(codes: torch.Tensor, norms: torch.Tensor,
                            weights: torch.Tensor, *, levels: int,
                            bucket_size: int) -> torch.Tensor:
    """Plain version of the kernel: (N, L) int8 codes, (N, L/bucket) norms,
    (N,) weights -> (L,) float32.  Node i adds (q · sᵢ) · wᵢ, sᵢ = normᵢ ·
    (1/levels) a bucket, so its term is ``wire_decode``'s value times wᵢ;
    nodes summed in node order."""
    n, length = codes.shape
    acc = torch.zeros(length, dtype=torch.float32, device=codes.device)
    for i in range(n):
        dec = dequantize(codes[i].reshape(-1, bucket_size), norms[i].reshape(-1, 1), levels)
        acc = acc + dec.reshape(-1) * weights[i]
    return acc


def _check_inputs(codes, norms, weights, bucket_size):
    n, length = codes.shape
    if codes.dtype != torch.int8 or norms.dtype != torch.float32 \
            or weights.dtype != torch.float32:
        raise TypeError("decode_accumulate needs int8 codes and float32 "
                        "norms and weights")
    if bucket_size % 16 or length % bucket_size:
        raise ValueError(f"decode_accumulate needs whole buckets of a multiple "
                         f"of 16 codes: bucket_size={bucket_size}, L={length}")
    if tuple(norms.shape) != (n, length // bucket_size) \
            or tuple(weights.shape) != (n,):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, norms "
                         f"{tuple(norms.shape)}, weights {tuple(weights.shape)}")
    if not (codes.device == norms.device == weights.device):
        raise ValueError("decode_accumulate inputs must share one device")


def decode_accumulate_kernel(codes: torch.Tensor, norms: torch.Tensor,
                             weights: torch.Tensor, *, levels: int,
                             bucket_size: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check_inputs(codes, norms, weights, bucket_size)
    if not codes.is_cuda:
        raise ValueError("decode_accumulate_kernel needs CUDA tensors")
    codes, norms, weights = (t.contiguous() for t in (codes, norms, weights))
    n, length = codes.shape
    out = torch.empty(length, dtype=torch.float32, device=codes.device)
    if codes.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("decode_accumulate needs 16-byte aligned codes")
    fn = build.function("qsgd_decode", "qsgd_decode_accumulate_f32",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                                 ctypes.c_int, ctypes.c_float,
                                                 ctypes.c_void_p])
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    # the kernel multiplies by the plain version's float32 1/levels
    r = float(inverse(levels, "cpu"))
    build.check(fn(codes.data_ptr(), norms.data_ptr(), weights.data_ptr(),
                   out.data_ptr(), n, length, bucket_size, r, stream),
                "qsgd_decode_accumulate")
    LAUNCHES["qsgd_decode_accumulate"] += 1
    return out


def decode_accumulate(payload: QsgdPayload, weights: torch.Tensor) -> torch.Tensor:
    """Σᵢ wᵢ · decode(payloadᵢ) for a node-batched payload (codes
    (N, nb, B)) -> the (size,) float32 accumulator.  The kernel on a CUDA
    payload, its plain version on a CPU one."""
    n, nb, b = payload.codes.shape
    codes = payload.codes.reshape(n, nb * b)
    norms = payload.norms.reshape(n, nb)
    w = weights.float()
    if codes.is_cuda:
        acc = decode_accumulate_kernel(codes, norms, w, levels=payload.levels,
                                       bucket_size=b)
    else:
        _check_inputs(codes, norms, w, b)
        acc = decode_accumulate_plain(codes, norms, w, levels=payload.levels,
                                      bucket_size=b)
    return acc[:payload.size]
