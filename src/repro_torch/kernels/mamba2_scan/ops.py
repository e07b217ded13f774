"""Mamba2 SSD chunked scan, forward only (twin of
``repro/kernels/mamba2_scan/ops.py``).

Per (batch, head), with the state h (P, N), a_h < 0 and B, C shared across
heads (ngroups = 1):

    h_t = exp(a_h Δ_t) h_{t-1} + (Δ_t x_t) B_tᵀ
    y_t = h_t C_t + D_h x_t

``ssd`` takes the surface of the reference's ``ssd_chunked_pallas``: x
(B, S, H, P) in the model's dtype, dt (B, S, H) float32, a (H,), b and c
(B, S, N) in the model's dtype, d_skip (H,) and an optional h0 (B, H, P, N)
float32.  It returns y in x's dtype and the final state (B, H, P, N) in
float32.  On CUDA tensors it launches the kernel of ``csrc/mamba2_ssd.cu``,
which also does the reference wrapper's prologue and epilogue (x·Δ, a·Δ,
the casts, the D-skip), so the float32 Δ-weighted x and y are never
written out; on CPU tensors it runs the plain version, :func:`ssd_plain`.
Neither has a backward, as in the reference: the wrapper raises on an
input that requires grad, and training takes ``models.mamba2.ssd_chunked``.

Both compute in float32, in chunks of ``CHUNK`` tokens: with cs the
inclusive cumulative sum of a·Δ over the chunk, the band
(C_t·B_s) exp(cs_t − cs_s) for s <= t (selected to 0 above the diagonal
before any product, so strong decay gives no inf·0), the state's share
exp(cs_t) h C_t, and the state carried as exp(cs_end) h +
Σ_s exp(cs_end − cs_s) Δ_s x_s B_sᵀ.  B and C are cast to float32 before
C·Bᵀ, as in the reference's kernel route (its ``ssd_chunked`` rounds C·Bᵀ to
the model's dtype: ROADMAP queue 3).  The ragged end is padded with zero x,
B, C and Δ, which adds nothing to y or h, where the reference shrinks its
chunk until it divides S.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: launches of the kernel (one per wrapper call on CUDA)
LAUNCHES = {"ssd_scan": 0}
CHUNK = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 inside: the same
    chunks, padding and factors."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    nc = (s + pad) // chunk

    def chunks(t):
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad, *t.shape[2:]))], dim=1)
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xf, dtf = x.float(), dt.float()
    xr = chunks(xf * dtf[..., None])                                    # Δ-weighted x
    ar = chunks(a.float()[None, None] * dtf)                            # a·Δ <= 0
    br, cr = chunks(b.float()), chunks(c.float())
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    above = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xr[:, i], ar[:, i], br[:, i], cr[:, i]
        cs = torch.cumsum(ac, dim=1)                                    # (B, c, H) inclusive
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        decay = (cs[:, :, None] - cs[:, None]).masked_fill(above[None, :, :, None],
                                                           float("-inf"))
        m = torch.exp(decay) * cb[..., None]                            # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", m, xc)
        y = y + torch.exp(cs)[..., None] * torch.einsum("btn,bhpn->bthp", cc, state)
        end = cs[:, -1]                                                 # (B, H)
        w = torch.exp(end[:, None] - cs)                                # (B, c, H)
        state = state * torch.exp(end)[..., None, None] + torch.einsum(
            "bshp,bsn->bhpn", xc * w[..., None], bc)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] + xf * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def _check_inputs(x, dt, a, b, c, d_skip, h0):
    if x.dim() != 4:
        raise ValueError(f"ssd needs x (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    if tuple(b.shape) != (bsz, s, n) or tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"b and c must be (B, S, N) with (B, S) = {(bsz, s)}: got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if p % 16:
        raise ValueError(f"ssd needs a head dim P that is a multiple of 16, got {p}")
    if n % 16 or not 16 <= n <= 128:
        raise ValueError(f"ssd needs a state size N that is a multiple of 16 up to 128, got {n}")
    if tuple(dt.shape) != (bsz, s, h):
        raise ValueError(f"dt must be (B, S, H) = {(bsz, s, h)}, got {tuple(dt.shape)}")
    if tuple(a.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"a and d_skip must be (H,) = {(h,)}, got {tuple(a.shape)}, "
                         f"{tuple(d_skip.shape)}")
    if h0 is not None and tuple(h0.shape) != (bsz, h, p, n):
        raise ValueError(f"h0 must be (B, H, P, N) = {(bsz, h, p, n)}, got {tuple(h0.shape)}")
    if x.dtype not in _DTYPE_CODES or not x.dtype == b.dtype == c.dtype:
        raise TypeError(f"ssd needs x, b, c all float32 or all bfloat16: got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"ssd needs dt in float32, got {dt.dtype}")
    tensors = (x, dt, a, b, c, d_skip) + (() if h0 is None else (h0,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd inputs must share one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd has no backward (inference only, as in the reference); "
                           "train through models.mamba2.ssd_chunked (use_pallas_kernels=False)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check_inputs(x, dt, a, b, c, d_skip, h0)
    if not x.is_cuda:
        raise ValueError("ssd_kernel needs CUDA tensors")
    x, dt, b, c = (_aligned(t) for t in (x, dt, b, c))
    a, d_skip = _aligned(a.float()), _aligned(d_skip.float())
    h0 = None if h0 is None else _aligned(h0.float())
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    fn = build.function("mamba2_ssd", "ssd_scan_fwd",
                        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   d_skip.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                   hf.data_ptr(), bsz, s, h, p, n, _DTYPE_CODES[x.dtype], stream), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, hf


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, N), d_skip (H,)[,
    h0 (B, H, P, N)] -> y (B, S, H, P) in x's dtype and h_final (B, H, P, N)
    float32.  The kernel on CUDA tensors, its plain version on CPU tensors."""
    if x.is_cuda:
        return ssd_kernel(x, dt, a, b, c, d_skip, h0)
    _check_inputs(x, dt, a, b, c, d_skip, h0)
    return ssd_plain(x, dt, a, b, c, d_skip, h0)
