"""Unmasked CenteredClip [40] (twin of ``repro/kernels/centered_clip/ops.py``,
paper §3.3): the sequential engine's aggregator.

:func:`cc_iter` is one iteration, v + mean_i clip(x_i − v, τ), clipped by
each row's full L2 norm ‖x_i − v‖: on CUDA tensors it launches the kernel
of ``csrc/centered_clip.cu``, on CPU tensors it runs the plain version,
:func:`cc_iter_plain`, which repeats ``core.aggregation.centered_clip``'s
body (reference ``aggregation.py:131-136``) expression for expression.
τ is fixed, or adaptive (``clip_tau=None``): the median of the k row
norms, computed on the device.  The mean multiplies the row sum by a
float32 1/k, fused with the add of v into one rounding as XLA compiles the
reference's body, so this is not ``masked_cc_iter`` with an all-true mask
(which divides by k).

:func:`centered_clip` warm-starts from the dense coordinate median
(``aggregation.coordinate_median``: the ``masked_median`` kernel with an
all-true mask on CUDA) unless ``v0`` is given, then runs ``iters``
iterations.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import aggregation    # which imports this module back
from repro_torch.kernels import build

#: launches of the CenteredClip iteration (one per wrapper call on CUDA)
LAUNCHES = {"cc_iter": 0}

MAX_NODES = 64
_THREADS = 256
_BLOCKS = 2048             # partial-norm blocks of the first launch


def _median(values: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the midpoint of its two middle ranks."""
    s = torch.sort(values).values
    k = s.numel()
    return (s[(k - 1) // 2] + s[k // 2]) * 0.5


def cc_iter_plain(x: torch.Tensor, v: torch.Tensor,
                  clip_tau: Optional[float] = None) -> torch.Tensor:
    diff = x - v[None]
    norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
    tau = (_median(norm.reshape(-1)) if clip_tau is None
           else torch.full((), float(clip_tau), device=x.device))
    scale = torch.minimum(torch.ones((), device=x.device),
                          tau / torch.maximum(norm, torch.full((), 1e-12,
                                                               device=x.device)))
    total = torch.sum(diff * scale, dim=0)
    inv = aggregation.inverse(x.shape[0], x.device)
    # v + total * (1/k) rounded once, as the reference's compiled body fuses
    # it into a multiply-add: the product is exact in float64, and the sum
    # rounds twice only where its float64 value falls on a float32 midpoint
    return (v.double() + total.double() * inv.double()).float()


def _check(x: torch.Tensor, v: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"cc_iter needs a (k, D) float32 stack, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= x.shape[0] <= MAX_NODES:
        raise ValueError(f"cc_iter takes 1..{MAX_NODES} rows, got {x.shape[0]}")
    if tuple(v.shape) != (x.shape[1],) or v.dtype != torch.float32 \
            or v.device != x.device:
        raise ValueError(f"cc_iter: v must be ({x.shape[1]},) float32 on {x.device}")


def cc_iter(x: torch.Tensor, v: torch.Tensor, *,
            clip_tau: Optional[float] = None) -> torch.Tensor:
    """One CenteredClip iteration over the (k, D) float32 rows ``x`` from
    ``v`` -> (D,)."""
    _check(x, v)
    if not x.is_cuda:
        return cc_iter_plain(x, v, clip_tau)
    x, v = x.contiguous(), v.contiguous()
    n, d = x.shape
    nblk = max(1, min(_BLOCKS, -(-d // _THREADS)))
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty((n, nblk), dtype=torch.float32, device=x.device)
    scales = torch.empty(n, dtype=torch.float32, device=x.device)
    p = ctypes.c_void_p
    fn = build.function("centered_clip", "cc_iter_f32",
                        [p, p, p, p, ctypes.c_int, p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float, ctypes.c_int, p])
    tau = 0.0 if clip_tau is None else float(clip_tau)
    build.check(fn(x.data_ptr(), v.data_ptr(), out.data_ptr(), partial.data_ptr(), nblk,
                   scales.data_ptr(), n, d, tau, int(clip_tau is None),
                   torch.cuda.current_stream(x.device).cuda_stream), "cc_iter")
    LAUNCHES["cc_iter"] += 1
    return out


def centered_clip(updates: torch.Tensor, *, clip_tau: Optional[float] = 1.0,
                  iters: int = 3, v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(k, D) -> (D,) robust aggregate: the dense median (or ``v0``), then
    ``iters`` iterations of :func:`cc_iter`."""
    x = updates.float()
    v = aggregation.coordinate_median(x) if v0 is None else v0.float()
    for _ in range(iters):
        v = cc_iter(x, v, clip_tau=clip_tau)
    return v
