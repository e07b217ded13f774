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

Both compute the kernel's chunk-parallel form in float32: chunks of
``CHUNK`` tokens, each cut into sub-chunks of ``SUB``.  With cl the
inclusive cumulative log decay within a sub-chunk, el the same one token
earlier (0 at the sub-chunk's first token) and T_i the total of sub-chunk
i (sums of T left to right):

- the chunk's change of the state is Σ_s kd_s v_sᵀ with kd_s = k_s
  exp(T_i - cl_s) exp(Σ_{i' > i} T_i'), and the state carried across chunks
  is S <- exp(Σ_i T_i) S + that change;
- y_t (t in sub-chunk i) is the state's share (r_t exp(el_t) exp(Σ_{i' <
  i} T_i'))ᵀ S_in, plus A · V with the scores A[t][s] of a key sub-chunk
  j < i as (r_t exp(el_t) exp(Σ_{j < i' < i} T_i')) · (k_s exp(T_j - cl_s))
  (every factor at most 1: the reference token is j's end), inside sub-chunk i
  pairwise as Σ_c r_t k_s exp(el_t - cl_s) for s < t, and the u bonus
  (r_t k_t) · u on the diagonal.

Every factor is exp of a sum that is at most 0, so strong decays cannot
overflow (the reference's factorised form scales k by exp(-cs), which does:
ROADMAP queue 3), and no exponent is the difference of two long sums.
log w is clamped at ``LOG_W_MIN`` (w below 1.8e-35 acts as 1.8e-35), so a
zero decay gives no inf - inf.  The ragged end is padded with zero r, k, v
and log w = 0, which adds nothing to y or the state.

``wkv_plain(..., bf16_operands=True)`` rounds each float32 operand of the
kernel's tensor-core products (kd and v, the decayed r and the state, the
decayed r and k of the scores, A and v) to bfloat16 first: the single-pass
product, a control that the card's checks must tell from the kernel, which
splits each such operand into a bf16 hi and lo term.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: launches of the kernel (one per wrapper call on CUDA)
LAUNCHES = {"wkv_scan": 0}
CHUNK = 64
SUB = 16
LOG_W_MIN = -80.0
#: the bf16 y bound of the card's checks (relative L2 against wkv_plain), set
#: between the kernel's reading and the bf16-operand control's, which exceeds it
BF16_REL = 1e-3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SLAB = 64      # chunks a step of wkv_plain's output pass (bounds its temporaries)


def _left_sum(parts, lo: int, hi: int) -> torch.Tensor:
    """parts[lo] + ... + parts[hi - 1], left to right; zeros when empty."""
    out = torch.zeros_like(parts[0])
    for i in range(lo, hi):
        out = out + parts[i]
    return out


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: Optional[torch.Tensor] = None, *,
              bf16_operands: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 inside: the same
    chunks, sub-chunks, factors and products."""
    bsz, s, h, dk = r.shape
    nsub = CHUNK // SUB
    pad = (-s) % CHUNK
    nc = (s + pad) // CHUNK
    op = (lambda t: t.bfloat16().float()) if bf16_operands else (lambda t: t)

    def chunks(t):              # (B, S, H, K) -> (B, nc, nsub, SUB, H, K), float32, zero-padded
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad, h, dk))], dim=1)
        return t.reshape(bsz, nc, nsub, SUB, h, dk)

    rr, kk, vv = chunks(r), chunks(k), chunks(v)
    cl = torch.cumsum(chunks(torch.log(w.float()).clamp(min=LOG_W_MIN)), dim=3)
    el = torch.cat([torch.zeros_like(cl[:, :, :, :1]), cl[:, :, :, :-1]], dim=3)
    tot = [cl[:, :, i, -1] for i in range(nsub)]                       # T_i: (B, nc, H, K)

    # 1. each chunk's change of the state and its decay
    kd = torch.stack([kk[:, :, i] * torch.exp(tot[i][:, :, None] - cl[:, :, i])
                      * torch.exp(_left_sum(tot, i + 1, nsub))[:, :, None]
                      for i in range(nsub)], dim=2)
    ds = torch.einsum("bcthk,bcthv->bchkv", op(kd.flatten(2, 3)), op(vv.flatten(2, 3)))
    decay = torch.exp(_left_sum(tot, 0, nsub))                          # (B, nc, H, K)
    del kd

    # 2. the state each chunk starts from
    state = (torch.zeros((bsz, h, dk, dk), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    s_in = torch.empty_like(ds)
    for c in range(nc):
        s_in[:, c] = state
        state = decay[:, c, :, :, None] * state + ds[:, c]
    del ds

    # 3. y, a slab of chunks at a time
    uf = u.float()
    ys = []
    for c0 in range(0, nc, _SLAB):
        sl = slice(c0, min(nc, c0 + _SLAB))
        r_, k_, v_, cl_, el_ = rr[:, sl], kk[:, sl], vv[:, sl], cl[:, sl], el[:, sl]
        tt = [t[:, sl] for t in tot]
        n = r_.shape[1]
        rbar = r_ * torch.exp(el_)                                       # r exp(el)
        rhat = torch.stack([rbar[:, :, i] * torch.exp(_left_sum(tt, 0, i))[:, :, None]
                            for i in range(nsub)], dim=2).flatten(2, 3)
        y = torch.einsum("bcthk,bchkv->bcthv", op(rhat), op(s_in[:, sl]))
        del rhat
        att = r.new_zeros((bsz, n, h, CHUNK, CHUNK), dtype=torch.float32)
        for i in range(nsub):
            rows = slice(i * SUB, (i + 1) * SUB)
            for j in range(i):
                rt = rbar[:, :, i] * torch.exp(_left_sum(tt, j + 1, i))[:, :, None]
                kt = k_[:, :, j] * torch.exp(tt[j][:, :, None] - cl_[:, :, j])
                att[..., rows, j * SUB:(j + 1) * SUB] = torch.einsum(
                    "bcthk,bcshk->bchts", op(rt), op(kt))
            for t in range(SUB):        # inside the sub-chunk: pairwise, then the bonus
                rk = r_[:, :, i, t:t + 1] * k_[:, :, i, :t]                  # (B, n, t, H, K)
                e = torch.exp(el_[:, :, i, t:t + 1] - cl_[:, :, i, :t])
                att[..., i * SUB + t, i * SUB:i * SUB + t] = (rk * e).sum(-1).permute(0, 1, 3, 2)
                att[..., i * SUB + t, i * SUB + t] = (r_[:, :, i, t] * k_[:, :, i, t] * uf).sum(-1)
        y = y + torch.einsum("bchts,bcshv->bcthv", op(att), op(v_.flatten(2, 3)))
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(bsz, nc * CHUNK, h, dk)[:, :s]
    return y.to(r.dtype), state


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
    # the kernel's float32 scratch: each chunk's change of the state (then
    # the state it starts from) and its decay; freed when this returns
    nc = -(-s // CHUNK)
    ds = torch.empty((bsz, h, nc, dk, dk), dtype=torch.float32, device=r.device)
    decay = torch.empty((bsz, h, nc, dk), dtype=torch.float32, device=r.device)
    fn = build.function("rwkv6_wkv", "wkv_scan_fwd",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                   0 if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
                   ds.data_ptr(), decay.data_ptr(), bsz, s, h, dk, _DTYPE_CODES[r.dtype],
                   stream), "wkv_scan")
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
