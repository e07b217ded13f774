"""Byzantine-robust aggregation (twin of ``repro/core/aggregation.py``,
paper §3.3).

Two families over an (N, D) float32 stack of per-node updates:

- the dense aggregators of the sequential engine — ``mean``,
  ``coordinate_median``, ``trimmed_mean``, ``krum``, ``multi_krum`` and
  ``centered_clip`` — over the compacted survivors (``AGGREGATORS``);
- their ``masked_*`` twins, which take the fixed stack and a boolean
  keep-mask (N,) and equal the dense aggregator on ``updates[mask]``, so
  the batched round keeps one shape across membership churn.  Under total
  churn (``mask.sum() == 0``) krum, multi-krum and centered_clip return
  zeros (a no-op step).  These are the unfused round's aggregators; the
  fused round runs the kernels of ``kernels/masked_agg``.

On a CUDA stack the dense median is the ``masked_median`` kernel with an
all-true mask, and the dense CenteredClip iterates the kernel of
``kernels/centered_clip``.  At full width a stack holds ~1.6e9 values, so
the functions walk D in column chunks where a whole-stack temporary would
not fit (``_CHUNK`` elements at a time).  The reference's pytree adapter
(``_as_matrix``) waits for the distributed layer that needs it (ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.compression import inverse

# both kernel modules import this module back; each side reads the other's
# names only when called
from repro_torch.kernels.centered_clip import ops as cc_ops
from repro_torch.kernels.masked_agg import ops as masked_agg_ops

_CHUNK = 1 << 24            # elements per chunk (torch.sort / quantile size)


def _col_chunks(n: int, d: int):
    step = max(1, _CHUNK // max(n, 1))
    for c0 in range(0, d, step):
        yield c0, min(d, c0 + step)


# ------------------------------ dense aggregators ------------------------------
def mean(updates: torch.Tensor) -> torch.Tensor:
    x = updates.float()
    return torch.sum(x, dim=0) * inverse(x.shape[0], x.device)


def coordinate_median(updates: torch.Tensor) -> torch.Tensor:
    """``jnp.median(updates, axis=0)``: each column's midpoint of its two
    middle ranks.  On the CPU a stable sort, bit-equal to ``jnp.median``
    (whose sort is stable and ranks +0.0 and −0.0 as equal); on CUDA the
    ``masked_median`` kernel with an all-true mask — equal values, though a
    tie of +0.0 and −0.0 may give the other zero (ROADMAP queue 3)."""
    x = updates.float()
    n, d = x.shape
    if x.is_cuda:
        return masked_agg_ops.masked_median(
            x, torch.ones(n, dtype=torch.bool, device=x.device))
    out = torch.empty(d, dtype=torch.float32)
    for c0, c1 in _col_chunks(n, d):
        s = torch.sort(x[:, c0:c1], dim=0, stable=True).values
        out[c0:c1] = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return out


def trimmed_mean(updates: torch.Tensor, *, trim: int = 1) -> torch.Tensor:
    n, d = updates.shape
    trim = min(trim, (n - 1) // 2)
    inv = inverse(n - 2 * trim, updates.device)
    out = torch.empty(d, dtype=torch.float32, device=updates.device)
    for c0, c1 in _col_chunks(n, d):
        s = torch.sort(updates[:, c0:c1].float(), dim=0).values
        out[c0:c1] = torch.sum(s[trim:n - trim], dim=0) * inv
    return out


def _krum_scores(updates: torch.Tensor, f: int) -> torch.Tensor:
    """Each row's sum of squared distances to its n − f − 2 (at least 1)
    nearest other rows, nearest first."""
    n = updates.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=updates.device)
    d2 = torch.where(eye, torch.full((), float("inf"), device=updates.device),
                     _pairwise_d2(updates))
    k = max(n - int(f) - 2, 1)
    return torch.sum(torch.sort(d2, dim=-1).values[:, :k], dim=-1)


def krum(updates: torch.Tensor, *, f: int = 1) -> torch.Tensor:
    return updates[torch.argmin(_krum_scores(updates, f))].float()


def _rows_sum(updates: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Σ over ``rows`` (in that order) of the update rows."""
    n, d = updates.shape
    out = torch.empty(d, dtype=torch.float32, device=updates.device)
    for c0, c1 in _col_chunks(n, d):
        out[c0:c1] = torch.sum(updates[rows, c0:c1].float(), dim=0)
    return out


def multi_krum(updates: torch.Tensor, *, f: int = 1, m: int = 0) -> torch.Tensor:
    """The mean of the m best-scored rows; ``m`` clamped to the stack
    height, as the reference clamps it."""
    n = updates.shape[0]
    m = min(m or max(n - int(f) - 2, 1), n)
    best = torch.argsort(_krum_scores(updates, f), stable=True)[:m]
    return _rows_sum(updates, best) * inverse(m, updates.device)


def centered_clip(updates: torch.Tensor, *, clip_tau: Optional[float] = None,
                  iters: int = 3, v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CenteredClip [40]: v ← v + mean_i clip(x_i − v, τ), ``iters`` times,
    from the coordinate median (or ``v0``).  ``clip_tau=None`` adapts τ
    each iteration to the median node distance ‖x_i − v‖.  The iterations
    are ``kernels/centered_clip``'s (the kernel on CUDA)."""
    return cc_ops.centered_clip(updates, clip_tau=clip_tau, iters=iters, v0=v0)


# ------------------------------- masked twins ----------------------------------
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
    """Σᵢ mᵢ·xᵢ / k, the rows added one by one in node order, so rows that
    are masked out after the last kept one change no bit: a sweep's lane
    padded with never-joining nodes gives its single-run swarm's mean."""
    m = mask.to(updates.dtype)
    k = torch.clamp(torch.sum(mask.float()), min=1.0)
    acc = updates[0] * m[0]
    for i in range(1, updates.shape[0]):
        acc = torch.addcmul(acc, updates[i], m[i])
    return acc / k


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
        # a tensor τ: a Python float over a tensor is reciprocal-then-
        # multiply in torch, two roundings where the reference has one
        tau = (_masked_median(norm[:, None], mask)[0] if clip_tau is None
               else torch.full((), float(clip_tau), device=norm.device))
        scale = torch.minimum(torch.ones((), device=norm.device),
                              tau / torch.clamp(norm, min=1e-12))
        w = (scale * mf)[:, None]
        new = torch.empty_like(v)
        for c0, c1 in _col_chunks(n, d):
            diff = updates[:, c0:c1].float() - v[None, c0:c1]
            new[c0:c1] = v[c0:c1] + torch.sum(diff * w, dim=0) / k
        v = new
    return torch.where(torch.any(mask), v, torch.zeros_like(v))


def masked_coordinate_median(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_median(updates, mask)


def masked_trimmed_mean(updates: torch.Tensor, mask: torch.Tensor, *,
                        trim: int = 1) -> torch.Tensor:
    """The mean of each column's kept values of rank t..k−t−1, t =
    min(trim, (k − 1) // 2): masked rows sort last at +inf (all masked: t =
    −1 keeps rank 0, +inf, as the reference does)."""
    n, d = updates.shape
    m = mask.bool()
    k = int(torch.sum(m))
    t = min(int(trim), (k - 1) // 2)
    ranks = torch.arange(n, device=updates.device)[:, None]
    keep = (ranks >= t) & (ranks < k - t)
    div = torch.full((), float(max(k - 2 * t, 1)), device=updates.device)
    inf = torch.full((), float("inf"), device=updates.device)
    out = torch.empty(d, dtype=torch.float32, device=updates.device)
    for c0, c1 in _col_chunks(n, d):
        s = torch.sort(torch.where(m[:, None], updates[:, c0:c1].float(), inf),
                       dim=0).values
        out[c0:c1] = torch.sum(torch.where(keep, s, 0.0), dim=0) / div
    return out


def masked_multi_krum(updates: torch.Tensor, mask: torch.Tensor, *,
                      f: Union[int, torch.Tensor] = 1,
                      m: Union[int, torch.Tensor, None] = 0) -> torch.Tensor:
    """The mean of the m best-scored kept rows.  ``m`` 0 or None means
    max(k − f − 2, 1); any other m is clamped to [1, k], so masked rows
    (real corrupted or stale updates) are never averaged in."""
    k_act = int(torch.sum(mask.bool()))
    auto = m is None or (not isinstance(m, torch.Tensor) and m == 0)
    m_eff = max(k_act - int(f) - 2, 1) if auto else min(max(int(m), 1), k_act)
    scores = _krum_scores_from_d2(_pairwise_d2(updates), mask, f)
    best = torch.argsort(scores, stable=True)[:m_eff]
    out = _rows_sum(updates, best) / torch.full((), float(m_eff), device=updates.device)
    return torch.where(torch.any(mask), out, torch.zeros_like(out))


MASKED_AGGREGATORS: Dict[str, Callable] = {
    "mean": masked_mean,
    "median": masked_coordinate_median,
    "trimmed_mean": masked_trimmed_mean,
    "krum": masked_krum,
    "multi_krum": masked_multi_krum,
    "centered_clip": masked_centered_clip,
}


def get_masked_aggregator(name: str, **defaults) -> Callable:
    """Masked twin of :func:`get_aggregator`: ``fn(updates, mask)``."""
    fn = MASKED_AGGREGATORS[name]
    return functools.partial(fn, **defaults) if defaults else fn


AGGREGATORS: Dict[str, Callable] = {
    "mean": mean,
    "median": coordinate_median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
    "multi_krum": multi_krum,
    "centered_clip": centered_clip,
}


def get_aggregator(name: str, **defaults) -> Callable:
    """``fn(updates)`` over the (k, D) stack of the kept updates."""
    fn = AGGREGATORS[name]
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
