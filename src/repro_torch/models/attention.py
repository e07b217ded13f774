"""GQA attention with an optional sliding window, and the KV-cache decode
with a ring buffer (twin of ``repro/models/attention.py``).

Layouts are the reference's: q (B, S, Hq, hd), k and v (B, S, Hkv, hd).

- Full attention (no window): with ``use_pallas``, ``causal`` and
  Sq == Skv, the kernel of ``kernels/swa_attention`` with window = Sq, the
  same function (zamba2's shared block in a served prefill).  Otherwise the
  reference's blockwise online softmax in float32, over q blocks of
  ``q_block`` and kv blocks of ``kv_block`` tokens (each halved until it
  divides its length), so no (Sq, Skv) score matrix is ever held: a
  32,768-token prompt holds one (1,024 x 1,024) block of scores per head
  at a time.  Causal kv blocks strictly above the diagonal are skipped.
  The blockwise route serves training, Sq != Skv and
  ``use_pallas_kernels=False``.  (The reference's hybrid never passes
  ``use_pallas`` to its attention, so it always takes the blockwise route.)
- Sliding window: with ``use_pallas`` and Sq == Skv, the kernel of
  ``kernels/swa_attention`` (CUDA on the card, its plain version on the
  CPU); otherwise :func:`_swa`, the reference's banded float32 twin, which
  also serves training.
- Decode: one new token against a cache of ``cache_length`` slots, a ring
  (slot pos % L) when the model has a window.  The cache is updated in
  place.  ``pos`` is a host int for the whole batch, or a (B,) tensor on
  the cache's device with each row at its own position (the serving
  engine's slots).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.swa_attention.ops import swa_attention

NEG_INF = -1e30


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, Hq, hd) -> (B, S, Hkv, G, hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, hkv, hq // hkv, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_block: int = 1024, kv_block: int = 1024,
              use_pallas: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q_block = min(q_block, sq)
    while sq % q_block:
        q_block //= 2
    if window is not None:
        if use_pallas and sq == skv:
            return swa_attention(q, k, v, window=window)
        return _swa(_grouped(q, hkv), k, v, window=window, q_block=q_block,
                    scale=hd ** -0.5)
    if use_pallas and causal and sq == skv:
        return swa_attention(q, k, v, window=sq)
    kv_block = min(kv_block, skv)
    while skv % kv_block:
        kv_block //= 2
    qg = _grouped(q, hkv)
    out = torch.empty(qg.shape, dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, q_block):
        qcur = qg[:, q0:q0 + q_block].float()
        qpos = q0 + torch.arange(q_block, device=q.device)
        m = l = acc = None
        for k0 in range(0, skv, kv_block):
            if causal and k0 > q0 + q_block - 1:
                # strictly above the diagonal: every score is masked, and the
                # reference's scan adds exp(-1e30 - m) == 0 exactly, so
                # skipping these blocks gives the same bits
                break
            s = torch.einsum("bqkgd,bskd->bkgqs", qcur,
                             k[:, k0:k0 + kv_block].float()) * hd ** -0.5
            if causal and k0 + kv_block - 1 > q0:     # a block wholly below keeps every score
                kpos = k0 + torch.arange(kv_block, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                torch.full((), NEG_INF, device=q.device))
            vcur = v[:, k0:k0 + kv_block].float()
            if m is None:
                # the first block: the reference's update from m = -1e30,
                # l = acc = 0, where exp(-1e30 - m) is exactly 0
                m = torch.amax(s, dim=-1)                          # (b, k, g, q)
                p = torch.exp(s - m[..., None])
                l = torch.sum(p, dim=-1)
                acc = torch.einsum("bkgqs,bskd->bqkgd", p, vcur)
                continue
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bkgqs,bskd->bqkgd", p, vcur)
            m = m_new
        out[:, q0:q0 + q_block] = acc / torch.clamp(l.permute(0, 3, 1, 2), min=1e-30)[..., None]
    return out.reshape(b, sq, hq, hd)


def _swa(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
         q_block: int, scale: float) -> torch.Tensor:
    """Banded causal attention: each q block sees the previous ``window``
    keys.  k and v are padded on the left by ``window`` so every block's
    slice of ``window + q_block`` keys starts at or after 0."""
    b, sq, hkv, g, hd = qg.shape
    span = window + q_block
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    out = torch.empty((b, sq, hkv, g, hd), dtype=k.dtype, device=k.device)
    for start in range(0, sq, q_block):       # start in padded coords == qpos - window
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, start:start + q_block].float(),
                         kp[:, start:start + span].float()) * scale
        qpos = start + torch.arange(q_block, device=k.device)
        kpos = start + torch.arange(span, device=k.device) - window
        mask = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window) & (kpos[None, :] >= 0))
        s = torch.where(mask, s, torch.full((), NEG_INF, device=k.device))
        p = torch.softmax(s, dim=-1)
        out[:, start:start + q_block] = torch.einsum(
            "bkgqs,bskd->bqkgd", p, vp[:, start:start + span].float())
    return out.reshape(b, sq, hkv * g, hd)


# -- decode ------------------------------------------------------------------
def cache_length(seq_len: int, window: Optional[int]) -> int:
    return seq_len if window is None else min(seq_len, window)


def row_positions(pos, batch: int, device: torch.device) -> torch.Tensor:
    """A decode position as a (B,) int64 tensor: a per-row tensor as it is,
    a host int repeated over the batch."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((batch,), pos, dtype=torch.long, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos, *, ring: bool) -> torch.Tensor:
    """q (B, 1, Hq, hd) against a cache (B, L, Hkv, hd) that already holds
    the new token; ``pos`` is the new token's absolute position, a host int
    or a (B,) tensor of per-row positions.  Slot j of row b is valid when
    ``j <= pos[b]``, and every slot of a full ring (``pos[b] + 1 >= L``)."""
    b, _, hq, hd = q.shape
    l, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = _grouped(q, hkv)[:, 0].float()                         # (B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * hd ** -0.5
    row_pos = row_positions(pos, b, q.device)[:, None, None, None]
    valid = torch.arange(l, device=q.device) <= row_pos
    if ring:
        valid = valid | (row_pos + 1 >= l)
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def cache_insert(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos, *, ring: bool):
    """Write one token's K/V in place: row b at slot ``pos[b] % L`` (ring)
    or ``min(pos[b], L - 1)`` (the reference's ``dynamic_update_slice``
    clamps), by a scatter on the device; ``pos`` a host int or a (B,)
    tensor."""
    l = k_cache.shape[1]
    pos = row_positions(pos, k_cache.shape[0], k_cache.device)
    slot = pos % l if ring else torch.clamp(pos, max=l - 1)
    idx = slot[:, None, None, None].expand(k_new.shape)
    k_cache.scatter_(1, idx, k_new.to(k_cache.dtype))
    v_cache.scatter_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Naive O(S^2) oracle, for the tests."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", _grouped(q, hkv).float(), k.float()) * hd ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)
