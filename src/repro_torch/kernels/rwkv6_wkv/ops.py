"""RWKV6 WKV recurrence, forward only (twin of
``repro/kernels/rwkv6_wkv/ops.py``).

Per head (K = V = head dim), with the decay w_t in (0, 1)^K:

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

``wkv`` takes r, k, v, w (B, S, H, K) in the model's dtype (float32 or
bfloat16), u (H, K) and an optional s0 (B, H, K, K), and returns y in r's
dtype and the final state (B, H, K, K) in float32.  On CUDA tensors it
launches the kernel of ``csrc/rwkv6_wkv.cu``; on CPU tensors it runs the
plain version, :func:`wkv_plain`.  Neither has a backward, as in the
reference: the wrapper raises on an input that requires grad, and training
takes ``models.rwkv6.wkv_chunked``.

Both compute the chunked form in float32 with chunks of ``CHUNK`` tokens:
within a chunk the strictly causal part weighs k_s v_sᵀ into y_t by the
pairwise decay exp(excl_t - cs_s) <= 1 (cs the inclusive cumulative log
decay, excl = cs - log w), the diagonal carries the u bonus, and the state
enters as (r_t * exp(excl_t))ᵀ S and leaves as exp(cs_end) S +
Σ_s (k_s * exp(cs_end - cs_s)) v_sᵀ.  Every factor is at most 1, so strong
decays cannot overflow, where the reference's factorised form scales k by
exp(-cs).  log w is clamped at ``LOG_W_MIN`` (w below 1.8e-35 acts as
1.8e-35), so a zero decay gives no inf - inf.  The ragged end is padded
with zero r, k, v and log w = 0, which adds nothing to y or the state.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: launches of the kernel (one per wrapper call on CUDA)
LAUNCHES = {"wkv_scan": 0}
CHUNK = 16
LOG_W_MIN = -80.0
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: Optional[torch.Tensor] = None, *,
              chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 inside: the same
    chunks and the same decay form."""
    bsz, s, h, dk = r.shape
    pad = (-s) % chunk
    nc = (s + pad) // chunk

    def chunks(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad, h, dk))], dim=1)
        return t.reshape(bsz, nc, chunk, h, dk)

    logw = torch.log(w.float()).clamp(min=LOG_W_MIN)
    rr, kk, vv, ww = chunks(r), chunks(k), chunks(v), chunks(logw)
    uf = u.float()
    state = (torch.zeros((bsz, h, dk, dk), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    ys = []
    for i in range(nc):
        rc, kc, vc, lw = rr[:, i], kk[:, i], vv[:, i], ww[:, i]        # (B, c, H, K)
        cs = torch.cumsum(lw, dim=1)                                    # inclusive
        excl = cs - lw                                                  # exclusive
        # pairwise decay of k_s v_sᵀ into y_t: exp(excl_t - cs_s), s < t
        gap = (excl[:, :, None] - cs[:, None, :])                       # (B, t, s, H, K)
        gap = gap.masked_fill(~strict[None, :, :, None, None], float("-inf"))
        att = torch.einsum("bthk,bshk,btshk->bhts", rc, kc, torch.exp(gap))
        y = torch.einsum("bhts,bshv->bthv", att, vc)
        y = y + torch.sum(rc * uf[None, None] * kc, dim=-1, keepdim=True) * vc
        y = y + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(excl), state)
        end = cs[:, -1]                                                 # (B, H, K)
        state = state * torch.exp(end)[..., None] + torch.einsum(
            "bshk,bshv->bhkv", kc * torch.exp(end[:, None] - cs), vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s].to(r.dtype), state


def _check_inputs(r, k, v, w, u, s0):
    if r.dim() != 4 or not r.shape == k.shape == v.shape == w.shape:
        raise ValueError(f"wkv needs r, k, v, w all (B, S, H, K): got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    bsz, _, h, dk = r.shape
    if dk % 16 or not 16 <= dk <= 128:
        raise ValueError(f"wkv needs a head dim that is a multiple of 16 up to 128, got {dk}")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be (H, K) = {(h, dk)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (bsz, h, dk, dk):
        raise ValueError(f"s0 must be (B, H, K, K) = {(bsz, h, dk, dk)}, got {tuple(s0.shape)}")
    if r.dtype not in _DTYPE_CODES or not r.dtype == k.dtype == v.dtype == w.dtype:
        raise TypeError(f"wkv needs r, k, v, w all float32 or all bfloat16: got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    tensors = (r, k, v, w, u) + (() if s0 is None else (s0,))
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv inputs must share one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("wkv has no backward (inference only, as in the reference); "
                           "train through models.rwkv6.wkv_chunked (use_pallas_kernels=False)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check_inputs(r, k, v, w, u, s0)
    if not r.is_cuda:
        raise ValueError("wkv_kernel needs CUDA tensors")
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    u = _aligned(u.float())
    s0 = None if s0 is None else _aligned(s0.float())
    bsz, s, h, dk = r.shape
    y = torch.empty_like(r)
    sf = torch.empty((bsz, h, dk, dk), dtype=torch.float32, device=r.device)
    fn = build.function("rwkv6_wkv", "wkv_scan_fwd",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                   0 if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
                   bsz, s, h, dk, _DTYPE_CODES[r.dtype], stream), "wkv_scan")
    LAUNCHES["wkv_scan"] += 1
    return y, sf


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, K) x 4, (H, K)[, (B, H, K, K)] -> y (B, S, H, K) in r's
    dtype and s_final (B, H, K, K) float32.  The kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if r.is_cuda:
        return wkv_kernel(r, k, v, w, u, s0)
    _check_inputs(r, k, v, w, u, s0)
    return wkv_plain(r, k, v, w, u, s0)
