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

Both compute the kernel's chunk-parallel form in float32, in chunks of
``CHUNK`` tokens.  With cs the inclusive cumulative sum of a·Δ over the
chunk:

- the chunk's change of the state is Σ_s (x_s exp(cs_end − cs_s) Δ_s) B_sᵀ,
  and the state carried across chunks is h <- exp(cs_end) h + that change;
- y_t = exp(cs_t) (C_t · h_in) + Σ_{s <= t} M'[t][s] x_s + D x_t with the
  band M'[t][s] = ((C_t·B_s) exp(cs_t − cs_s)) Δ_s, selected to 0 above the
  diagonal before any product, so strong decay gives no inf·0.

B and C are cast to float32 before C·Bᵀ, as in the reference's kernel
route (its ``ssd_chunked`` rounds C·Bᵀ to the model's dtype: ROADMAP queue
3).  The ragged end is padded with zero x, B, C and Δ, which adds nothing
to y or h, where the reference shrinks its chunk until it divides S.

``ssd_plain(..., bf16_operands=True)`` rounds each float32 operand of the
kernel's tensor-core products (the weighted x and B of the state's change,
C and the state, M' and x) to bfloat16 first: the single-pass product, a
control that the card's checks must tell from the kernel, which splits
each such operand into a bf16 hi and lo term.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: launches of the kernel (one per wrapper call on CUDA)
LAUNCHES = {"ssd_scan": 0}
CHUNK = 64
#: the bf16 y bound of the card's checks (relative L2 against ssd_plain), set
#: between the kernel's reading and the bf16-operand control's, which exceeds it
BF16_REL = 1e-3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SLAB = 64      # chunks a step of ssd_plain's output pass (bounds its temporaries)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, d_skip: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              bf16_operands: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 inside: the same
    chunks, padding, factors and products."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % CHUNK
    nc = (s + pad) // CHUNK
    op = (lambda t: t.bfloat16().float()) if bf16_operands else (lambda t: t)

    def chunks(t):
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad, *t.shape[2:]))], dim=1)
        return t.reshape(bsz, nc, CHUNK, *t.shape[2:])

    xf, dtf = x.float(), dt.float()
    xr, dr = chunks(xf), chunks(dtf)                                    # (B, nc, L, H, P), (B, nc, L, H)
    br, cr = chunks(b.float()), chunks(c.float())                       # (B, nc, L, N)
    cs = torch.cumsum(a.float() * dr, dim=2)                            # inclusive, a·Δ <= 0
    end = cs[:, :, -1]                                                  # (B, nc, H)

    # 1. each chunk's change of the state and its decay
    wgt = torch.exp(end[:, :, None] - cs) * dr
    dh = torch.einsum("bcshp,bcsn->bchpn", op(xr * wgt[..., None]), op(br))
    decay = torch.exp(end)
    del wgt

    # 2. the state each chunk starts from
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_in = torch.empty_like(dh)
    for ci in range(nc):
        h_in[:, ci] = state
        state = decay[:, ci, :, None, None] * state + dh[:, ci]
    del dh

    # 3. y, a slab of chunks at a time
    above = ~torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, nc, _SLAB):
        sl = slice(c0, min(nc, c0 + _SLAB))
        cs_, dr_, cr_ = cs[:, sl], dr[:, sl], cr[:, sl]
        y = torch.exp(cs_)[..., None] * torch.einsum("bctn,bchpn->bcthp", op(cr_),
                                                     op(h_in[:, sl]))
        cb = torch.einsum("bctn,bcsn->bcts", op(cr_), op(br[:, sl]))
        gap = (cs_[:, :, :, None] - cs_[:, :, None]).masked_fill(above[None, None, :, :, None],
                                                                float("-inf"))
        m = (cb[..., None] * torch.exp(gap)) * dr_[:, :, None]          # (B, n, t, s, H)
        y = y + torch.einsum("bctsh,bcshp->bcthp", op(m), op(xr[:, sl]))
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(bsz, nc * CHUNK, h, p)[:, :s]
    y = y + xf * d_skip.float()[None, None, :, None]
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
    # the kernel's float32 scratch: each chunk's change of the state (then
    # the state it starts from), its decay, and its C·Bᵀ (one for all
    # heads); freed when this returns
    nc = -(-s // CHUNK)
    dh = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=x.device)
    decay = torch.empty((bsz, h, nc), dtype=torch.float32, device=x.device)
    cb = torch.empty((bsz, nc, CHUNK, CHUNK), dtype=torch.float32, device=x.device)
    fn = build.function("mamba2_ssd", "ssd_scan_fwd",
                        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   d_skip.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                   hf.data_ptr(), dh.data_ptr(), decay.data_ptr(), cb.data_ptr(),
                   bsz, s, h, p, n, _DTYPE_CODES[x.dtype], stream), "ssd_scan")
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
