"""Causal sliding-window GQA attention, forward only (twin of
``repro/kernels/swa_attention/ops.py``).

``swa_attention`` takes the model's layout, q (B, S, H, hd) and k, v
(B, S, Hkv, hd), and returns (B, S, H, hd) in q's dtype.  Query i sees key
j iff j <= i and i - j < window.  On CUDA tensors it launches the kernel of
``csrc/swa_attention.cu``; on CPU tensors it runs the plain version,
:func:`swa_attention_plain`.  Neither has a backward, as in the reference:
the wrapper raises on an input that requires grad, and training through a
window takes ``models.attention._swa``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the kernel (one per wrapper call on CUDA)
LAUNCHES = {"swa_attention": 0}
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels of ``csrc/swa_attention.cu``, by the code its dispatcher
#: (``swa_attention_path``) returns
PATHS = {0: "f32 (CUDA cores)", 1: "bf16 mma.sync (simple)", 2: "bf16 TMA ring + wgmma"}


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, block_q: int = 512) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 inside: each block of
    ``block_q`` queries against the keys of its band only, so a 32k-token
    sequence needs (block_q x (block_q + window)) scores at a time."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    scale = hd ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, block_q):
        q1 = min(s, q0 + block_q)
        k0 = max(0, q0 - window + 1)
        qg = q[:, q0:q1].reshape(b, q1 - q0, hkv, hq // hkv, hd).float()
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k[:, k0:q1].float()) * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        sc = sc.masked_fill((kpos > qpos) | (qpos - kpos >= window), NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k0:q1].float())
        out[:, q0:q1] = o.reshape(b, q1 - q0, hq, hd).to(q.dtype)
    return out


def _check_inputs(q, k, v, window):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"swa_attention needs q (B, S, H, hd) and k, v (B, S, Hkv, hd): "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd or hq % k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k/v {tuple(k.shape)}")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"swa_attention needs a head dim that is a multiple of 8 "
                         f"up to 128, got {hd}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"swa_attention needs q, k, v all float32 or all bfloat16: "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("swa_attention inputs must share one device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("swa_attention has no backward (inference only, as in the "
                           "reference); train through models.attention._swa "
                           "(use_pallas_kernels=False)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def swa_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only)."""
    _check_inputs(q, k, v, window)
    if not q.is_cuda:
        raise ValueError("swa_attention_kernel needs CUDA tensors")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, s, hq, hd = q.shape
    out = torch.empty_like(q)
    fn = build.function("swa_attention", "swa_attention_fwd",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
                   k.shape[2], hd, int(window), hd ** -0.5, _DTYPE_CODES[q.dtype], stream),
                "swa_attention")
    LAUNCHES["swa_attention"] += 1
    return out


def kernel_path(s: int, hd: int, dtype: torch.dtype) -> str:
    """The kernel that ``swa_attention_kernel`` launches at sequence length
    ``s``, head dim ``hd`` and ``dtype``, as the C dispatcher chooses it
    (one of ``PATHS``; builds the library, so a card's machine only)."""
    fn = build.function("swa_attention", "swa_attention_path", [ctypes.c_int] * 3)
    return PATHS[fn(int(s), int(hd), _DTYPE_CODES[dtype])]


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """(B, S, H, hd), (B, S, Hkv, hd) x 2 -> (B, S, H, hd).  The kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return swa_attention_kernel(q, k, v, window=window)
    _check_inputs(q, k, v, window)
    return swa_attention_plain(q, k, v, window=window)
