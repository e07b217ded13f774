"""Masked Byzantine-robust aggregation (twin of the ``masked_*`` half of
``repro/core/aggregation.py``, paper §3.3).

Each aggregator takes a fixed (N, D) float32 stack and a boolean keep-mask
(N,) and equals its dense counterpart on ``updates[mask]``, so the round
keeps one shape across membership churn.  Under total churn
(``mask.sum() == 0``) krum and centered_clip return zeros (a no-op step).
These are the unfused path's aggregators; the fused path runs the kernels
of ``kernels/masked_agg``.  At full width the stack holds ~1.6e9 values,
so the functions walk D in column chunks where a whole-stack temporary
would not fit (``_CHUNK`` elements at a time).

Ported so far: mean, krum, centered_clip.  Median, trimmed mean and
multi-krum wait for the campaign slice (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Union

import torch

_CHUNK = 1 << 24            # elements per chunk (torch.sort / quantile size)


def _col_chunks(n: int, d: int):
    step = max(1, _CHUNK // max(n, 1))
    for c0 in range(0, d, step):
        yield c0, min(d, c0 + step)


def _masked_median(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked coordinate median with nanmedian's interpolation —
    ``jnp.nanquantile(where(mask, x, nan), 0.5, method="midpoint")``: sort
    each column with masked rows at +inf, take the two middle ranks of the
    kept count k and return (lo + hi) * 0.5; NaN where k == 0.  (Written out
    rather than through ``torch.nanquantile``, which refuses more than 16M
    elements and interpolates by lerp.)"""
    n, d = updates.shape
    m = mask.bool()
    k = torch.sum(m.to(torch.int64))
    lo_idx = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), min=0)
    hi_idx = torch.div(k, 2, rounding_mode="floor")
    out = torch.empty(d, dtype=torch.float32, device=updates.device)
    inf = torch.full((), float("inf"), device=updates.device)
    for c0, c1 in _col_chunks(n, d):
        x = torch.where(m[:, None], updates[:, c0:c1].float(), inf)
        s = torch.sort(x, dim=0).values
        lo = s.index_select(0, lo_idx.reshape(1))[0]
        hi = s.index_select(0, hi_idx.reshape(1))[0]
        out[c0:c1] = (lo + hi) * 0.5
    return torch.where(k >= 1, out, torch.full((), float("nan"),
                                               device=updates.device))


def masked_mean(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    k = torch.clamp(torch.sum(mask.float()), min=1.0)
    return torch.sum(updates * mask[:, None].to(updates.dtype), dim=0) / k


def _krum_scores_from_d2(d2: torch.Tensor, mask: torch.Tensor,
                         f: Union[int, torch.Tensor]) -> torch.Tensor:
    """Krum's O(N²) selection phase given raw pairwise squared distances:
    the sum of each kept row's k_act − f − 2 (at least 1) nearest kept
    neighbours.  Masked-out rows score +inf; kept rows are capped at the
    float32 max so argmin never prefers a masked row."""
    n = d2.shape[0]
    m = mask.bool()
    k_act = torch.sum(m.to(torch.int64))
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    pair_ok = m[:, None] & m[None, :] & ~eye
    inf = torch.full((), float("inf"), device=d2.device)
    d2 = torch.where(pair_ok, d2, inf)
    k_near = torch.clamp(k_act - f - 2, min=1)
    s = torch.sort(d2, dim=-1).values
    ranks = torch.arange(n, device=d2.device)[None, :]
    nearest = torch.where(ranks < k_near, s, torch.zeros((), device=d2.device))
    scores = torch.sum(nearest, dim=-1)
    big = torch.full((), torch.finfo(torch.float32).max, device=d2.device)
    return torch.where(m, torch.minimum(scores, big), inf)


def _pairwise_d2(updates: torch.Tensor) -> torch.Tensor:
    """Broadcast pairwise squared distances, summed over column chunks."""
    n, d = updates.shape
    d2 = torch.zeros((n, n), dtype=torch.float32, device=updates.device)
    step = max(1, _CHUNK // max(n * n, 1))
    for c0 in range(0, d, step):
        x = updates[:, c0:c0 + step].float()
        d2 += torch.sum(torch.square(x[:, None, :] - x[None, :, :]), dim=-1)
    return d2


def masked_krum(updates: torch.Tensor, mask: torch.Tensor, *,
                f: Union[int, torch.Tensor] = 1) -> torch.Tensor:
    scores = _krum_scores_from_d2(_pairwise_d2(updates), mask, f)
    row = updates[torch.argmin(scores)]
    return torch.where(torch.any(mask), row, torch.zeros_like(row))


def masked_centered_clip(updates: torch.Tensor, mask: torch.Tensor, *,
                         clip_tau: Optional[float] = None, iters: int = 3,
                         v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CenteredClip [40] over the kept rows: v ← v + Σᵢ mᵢ·clip(xᵢ − v, τ)/k,
    ``iters`` times, from the masked coordinate median (or ``v0``).
    ``clip_tau=None`` adapts τ each iteration to the masked median of the
    node distances ‖xᵢ − v‖."""
    n, d = updates.shape
    mf = mask.float()
    k = torch.clamp(torch.sum(mf), min=1.0)
    v = _masked_median(updates, mask) if v0 is None else v0.float()
    for _ in range(iters):
        sq = torch.zeros(n, dtype=torch.float32, device=updates.device)
        for c0, c1 in _col_chunks(n, d):
            diff = updates[:, c0:c1].float() - v[None, c0:c1]
            sq += torch.sum(diff * diff, dim=1)
        norm = torch.sqrt(sq)
        tau = (_masked_median(norm[:, None], mask)[0] if clip_tau is None
               else clip_tau)
        scale = torch.minimum(torch.ones((), device=norm.device),
                              tau / torch.clamp(norm, min=1e-12))
        w = (scale * mf)[:, None]
        new = torch.empty_like(v)
        for c0, c1 in _col_chunks(n, d):
            diff = updates[:, c0:c1].float() - v[None, c0:c1]
            new[c0:c1] = v[c0:c1] + torch.sum(diff * w, dim=0) / k
        v = new
    return torch.where(torch.any(mask), v, torch.zeros_like(v))


MASKED_AGGREGATORS: Dict[str, Callable] = {
    "mean": masked_mean,
    "krum": masked_krum,
    "centered_clip": masked_centered_clip,
}


def get_masked_aggregator(name: str, **defaults) -> Callable:
    """``fn(updates, mask)`` for a ported masked aggregator (KeyError for
    the ones that wait for a later slice)."""
    fn = MASKED_AGGREGATORS[name]
    return functools.partial(fn, **defaults) if defaults else fn


def breakdown_point(name: str, n: int) -> float:
    """Max tolerated byzantine fraction (theory; validated empirically)."""
    return {
        "mean": 0.0,
        "median": 0.5,
        "trimmed_mean": 0.5,
        "krum": max(0.0, (n - 3) / (2 * n)),
        "multi_krum": max(0.0, (n - 3) / (2 * n)),
        "centered_clip": 0.5,
    }[name]
