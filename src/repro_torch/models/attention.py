"""Full causal GQA attention (twin of ``repro/models/attention.py:32``).

The reference computes full attention as a blockwise online softmax in
float32 and calls no kernel on this path; the port computes the same
function as one plain einsum-softmax-einsum in float32 (at the sequence
lengths this slice runs there is a single block, where the two coincide).
Sliding-window attention and the ring-buffer decode wait for their slices.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)                                  # (b, k, g, q)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = pv / torch.clamp(l.permute(0, 3, 1, 2), min=1e-30)[..., None]
    return out.reshape(b, sq, hq, hd).to(q.dtype)
