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

:func:`cc_chain` runs ``iters`` iterations in one call: on CUDA tensors
1 + 2·iters launches that read the stack iters + 1 times (the next
iteration's norms come from the pass that forms v); on CPU tensors a loop
of :func:`cc_iter_plain`.  :func:`cc_iter` is the chain of one.  The
column layout is ``kernels/cc_chain.py``'s, shared with ``masked_agg``'s
chain.

:func:`centered_clip` warm-starts from the dense coordinate median
(``aggregation.coordinate_median``: the ``masked_median`` kernel with an
all-true mask on CUDA) unless ``v0`` is given, then runs the chain of
``iters`` iterations.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import aggregation    # which imports this module back
from repro_torch.kernels import build
from repro_torch.kernels.cc_chain import aligned_copy, check_iters, plan_for

#: CenteredClip iterations launched on CUDA (+iters a cc_chain, 1 a cc_iter)
LAUNCHES = {"cc_iter": 0}

MAX_NODES = 64


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


def _check(x: torch.Tensor, v: torch.Tensor, what: str = "cc_iter") -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"{what} needs a (k, D) float32 stack, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= x.shape[0] <= MAX_NODES:
        raise ValueError(f"{what} takes 1..{MAX_NODES} rows, got {x.shape[0]}")
    if tuple(v.shape) != (x.shape[1],) or v.dtype != torch.float32 \
            or v.device != x.device:
        raise ValueError(f"{what}: v must be ({x.shape[1]},) float32 on {x.device}")


_P = ctypes.c_void_p


def cc_iter(x: torch.Tensor, v: torch.Tensor, *,
            clip_tau: Optional[float] = None) -> torch.Tensor:
    """One CenteredClip iteration over the (k, D) float32 rows ``x`` from
    ``v`` -> (D,): the chain of one (three launches on CUDA)."""
    return _chain(x, v, 1, clip_tau, "cc_iter")


def cc_chain(x: torch.Tensor, v0: torch.Tensor, *, iters: int,
             clip_tau: Optional[float] = None) -> torch.Tensor:
    """``iters`` CenteredClip iterations over the (k, D) float32 rows ``x``
    from ``v0`` -> (D,), bit-equal to ``iters`` calls of :func:`cc_iter`.
    ``iters = 0`` returns ``v0``."""
    check_iters(iters, "cc_chain")
    return _chain(x, v0, iters, clip_tau, "cc_chain")


def _chain(x: torch.Tensor, v0: torch.Tensor, iters: int, clip_tau: Optional[float],
           what: str) -> torch.Tensor:
    _check(x, v0, what)
    if iters == 0:
        return v0
    if not x.is_cuda:
        v = v0
        for _ in range(iters):
            v = cc_iter_plain(x, v, clip_tau)
        return v
    x, v0 = x.contiguous(), aligned_copy(v0)
    n, d = x.shape
    plan = plan_for(x)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty((n, plan.nblk), dtype=torch.float32, device=x.device)
    scales = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = build.function("centered_clip", "cc_chain_f32",
                        [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                         ctypes.c_int, _P])
    tau = 0.0 if clip_tau is None else float(clip_tau)
    build.check(fn(x.data_ptr(), v0.data_ptr(), out.data_ptr(), partial.data_ptr(), plan.nblk,
                   plan.chunk, plan.vec, scales.data_ptr(), n, d, iters, tau,
                   int(clip_tau is None), torch.cuda.current_stream(x.device).cuda_stream),
                what)
    LAUNCHES["cc_iter"] += iters
    return out


def centered_clip(updates: torch.Tensor, *, clip_tau: Optional[float] = 1.0,
                  iters: int = 3, v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(k, D) -> (D,) robust aggregate: the dense median (or ``v0``), then
    the chain of ``iters`` iterations."""
    x = updates.float()
    v = aggregation.coordinate_median(x) if v0 is None else v0.float()
    return cc_chain(x, v, iters=iters, clip_tau=clip_tau)
