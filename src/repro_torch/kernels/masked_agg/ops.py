"""Fused masked aggregation: the round engine's fast path (twin of
``repro/kernels/masked_agg/ops.py``).

Three kernels, each a wrapper with a launch counter and a plain PyTorch
version beside it:

- :func:`masked_median` — the masked coordinate median (CenteredClip's warm
  start): a merge-exchange network over the K kept rows for K <= 16
  (:func:`median_pairs`), Batcher's padded odd-even network above;
- :func:`masked_cc_chain` — ``iters`` masked CenteredClip iterations,
  fixed or adaptive τ, in 1 + 2·iters launches that read the stack
  iters + 1 times; :func:`masked_cc_iter` is the chain of one;
- :func:`masked_krum_d2` — krum's (N, N) gram-form squared distances.

A wrapper launches its CUDA kernel (``csrc/masked_agg.cu``) on CUDA tensors
and runs the plain version only on CPU tensors; nothing falls back.  The
plain versions repeat the kernels' arithmetic: the median is bit-equal,
the CenteredClip iteration differs only in the order of the norm
reductions (~1e-6 relative), and d2 only in the order in which each
thread's column sums are added.  The median and d2 stream the stack on the
grid of :func:`stream_grid`.

The fused aggregators on top (``masked_*_fused``) share names and keyword
surface with ``core.aggregation``, and also accept a node-batched
:class:`QsgdPayload` in place of the float32 stack.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import aggregation
from repro_torch.kernels import build
from repro_torch.kernels.cc_chain import aligned_copy, check_iters, plan_for
from repro_torch.kernels.qsgd_decode import ops as qdec

#: On CPU tensors make_round_fn auto-selects the fused path once the float32
#: update stack (N·D·4 bytes) crosses this, as the reference does.  The
#: TPU's value; on the card the fused path takes no threshold (the H100's
#: crossover is not measured), so a fusable round always runs the kernels.
FUSED_MIN_BYTES = 4 << 20

#: launches per kernel: +1 each time a wrapper launches its CUDA kernel;
#: ``masked_cc_iter`` counts CenteredClip iterations (+iters a chain)
LAUNCHES = {"masked_median": 0, "masked_cc_iter": 0, "masked_krum_d2": 0}

MAX_NODES = 64
#: the median's exact networks and krum's register Gram take up to this
#: many rows (``kMaxExact`` of csrc/masked_agg.cu, held equal by a CPU test)
MAX_EXACT = 16
THREADS = 256              # a block of the streaming kernels (kThreads)
#: the streaming kernels' grid: STREAM_WAVES waves of STREAM_BLOCKS_PER_SM
#: resident blocks an SM (their launch bound at n <= 10) times the SM count.
#: tools/agg_stream_probe.py on an H100, (10, 162,417,408): krum_d2 2.055
#: ms at 1 or 2 waves, 2.078 at 4, 2.124 at 8; the median 2.413 at 2
#: waves, 2.409 at 4, 2.403 at 8 (2.361 with a block for every 1,024
#: columns); 2 waves give the pair's least sum
STREAM_WAVES = 2
STREAM_BLOCKS_PER_SM = 2
#: the SM count of an H100 SXM: the grid the plain d2 follows on a CPU tensor
H100_SMS = 132


def oddeven_merge_pairs(n: int) -> List[Tuple[int, int]]:
    """Compare-exchange pairs of Batcher's odd-even merge sort for ``n`` a
    power of two (the order the CUDA network applies them in)."""
    if n & (n - 1):
        raise ValueError(f"network size must be a power of two, got {n}")
    pairs: List[Tuple[int, int]] = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def merge_exchange_pairs(k: int) -> List[Tuple[int, int]]:
    """Compare-exchange pairs of Knuth's merge exchange (Batcher's; TAOCP
    vol. 3, §5.2.2, Algorithm M), which sorts exactly ``k`` inputs, in the
    order ``merge_exchange`` of csrc/masked_agg.cu applies them: for p =
    top, top/2, ..., 1 (top the largest power of two below k) a pass (d =
    p, r = 0), then one (d = q − p, r = p) for q = top, top/2, ... while
    q > p; a pass compares (i, i + d) for every i < k − d with i & p == r."""
    if k < 2:
        return []
    top = 1 << ((k - 1).bit_length() - 1)
    pairs: List[Tuple[int, int]] = []
    p = top
    while p > 0:
        q = 2 * top
        while q > p:
            d, r = (p, 0) if q == 2 * top else (q - p, p)
            pairs += [(i, i + d) for i in range(k - d) if i & p == r]
            q //= 2
        p //= 2
    return pairs


@functools.lru_cache(maxsize=None)
def median_pairs(k: int) -> Tuple[Tuple[int, int], ...]:
    """:func:`merge_exchange_pairs` of ``k`` less every pair that neither
    middle rank, (k − 1) // 2 nor k // 2, depends on: the comparators the
    kernel keeps once the compiler drops the selects nothing reads (29 of
    31 at k = 10)."""
    need = {(k - 1) // 2, k // 2}
    kept = []
    for i, j in reversed(merge_exchange_pairs(k)):
        if i in need or j in need:
            kept.append((i, j))
            need |= {i, j}
    return tuple(reversed(kept))


class StreamGrid(NamedTuple):
    """Thread t of block b takes ``vec`` neighbouring columns at (b·THREADS
    + t)·vec, then every ``nblk``·THREADS·vec columns."""
    nblk: int
    vec: int


def stream_grid(d: int, aligned: bool, sms: int) -> StreamGrid:
    """The median's and d2's grid for D = ``d`` on a card of ``sms`` SMs:
    STREAM_WAVES · STREAM_BLOCKS_PER_SM · sms blocks, fewer where D has
    less than a step of columns for each; 16-byte loads (``vec`` 4) where
    the stack's base is 16-byte ``aligned`` and d % 4 == 0, else 1."""
    vec = 4 if aligned and d % 4 == 0 else 1
    nblk = max(1, min(STREAM_WAVES * STREAM_BLOCKS_PER_SM * sms, -(-d // (THREADS * vec))))
    return StreamGrid(nblk, vec)


def grid_for(x: torch.Tensor) -> StreamGrid:
    """:func:`stream_grid` for a contiguous (n, d) stack on its card (an
    H100's SM count for a CPU tensor)."""
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.is_cuda else H100_SMS)
    return stream_grid(x.shape[1], x.data_ptr() % 16 == 0, sms)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# ------------------------------- plain versions --------------------------------
def _network_sort(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sort equal-shaped rows elementwise with the odd-even network (+inf
    rows pad to a power of two).  A compare-exchange swaps iff b < a, so the
    sort is a permutation, exactly as in the kernel."""
    n = len(rows)
    npad = _next_pow2(n)
    rows = rows + [torch.full_like(rows[0], float("inf"))] * (npad - n)
    for i, j in oddeven_merge_pairs(npad):
        a, b = rows[i], rows[j]
        swap = b < a
        rows[i], rows[j] = torch.where(swap, b, a), torch.where(swap, a, b)
    return rows[:n]


def _rank_mid(rows: List[torch.Tensor], k: torch.Tensor) -> torch.Tensor:
    """(lo + hi) * 0.5 of the ranks (k-1)//2 and k//2 of the sorted rows;
    NaN where k == 0 (no low rank is selected)."""
    lo_idx = torch.div(k - 1, 2, rounding_mode="floor")
    hi_idx = torch.div(k, 2, rounding_mode="floor")
    lo = torch.full_like(rows[0], float("nan"))
    hi = torch.full_like(rows[0], float("nan"))
    for r, row in enumerate(rows):
        lo = torch.where(lo_idx == r, row, lo)
        hi = torch.where(hi_idx == r, row, hi)
    return (lo + hi) * 0.5


def masked_median_plain(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's median: the K kept rows through :func:`median_pairs`
    for K <= MAX_EXACT, the padded odd-even network over all rows (masked
    ones +inf) above, NaN for K = 0.  Reads the mask on the host."""
    m = mask.float()
    kept = torch.nonzero(m > 0).flatten().tolist()
    k = len(kept)
    if k == 0:
        return torch.full((x.shape[1],), float("nan"), device=x.device)
    if k <= MAX_EXACT:
        rows = [x[i] for i in kept]
        for i, j in median_pairs(k):
            a, b = rows[i], rows[j]
            swap = b < a
            rows[i], rows[j] = torch.where(swap, b, a), torch.where(swap, a, b)
        return (rows[(k - 1) // 2] + rows[k // 2]) * 0.5
    inf = torch.full((), float("inf"), device=x.device)
    rows = [torch.where(m[i] > 0, x[i], inf) for i in range(x.shape[0])]
    return _rank_mid(_network_sort(rows), torch.tensor(k, device=x.device))


def masked_cc_iter_plain(x: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                         clip_tau: Optional[float] = None) -> torch.Tensor:
    n = x.shape[0]
    m = mask.float()
    sq = torch.stack([torch.sum(torch.square(x[i] - v)) for i in range(n)])
    norm = torch.sqrt(sq)
    if clip_tau is None:
        inf = torch.full((), float("inf"), device=x.device)
        rows = [torch.where(m[i] > 0, norm[i:i + 1], inf) for i in range(n)]
        tau = _rank_mid(_network_sort(rows), torch.sum((m > 0).to(torch.int64)))[0]
    else:
        tau = torch.full((), float(clip_tau), device=x.device)
    scale = torch.minimum(torch.ones((), device=x.device),
                          tau / torch.maximum(norm, torch.full((), 1e-12,
                                                               device=x.device)))
    w = scale * m
    acc = torch.zeros_like(v)
    for i in range(n):
        acc = acc + (x[i] - v) * w[i]
    return v + acc / torch.clamp(torch.sum(m), min=1.0)


def masked_krum_d2_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's decomposition on :func:`grid_for`'s grid: each thread's
    sums of x_i·x_j over its columns, summed over the block's threads, then
    over the blocks; the upper triangle mirrored; then the gram form.  (One
    float32 matrix product over all D = 1.6e8 columns at once rounds far
    more: it differed from the kernel by ~1e-4 of the squared norms.)"""
    n, d = x.shape
    nblk, vec = grid_for(x)
    stride = nblk * THREADS * vec
    steps = -(-d // stride)
    xp = torch.nn.functional.pad(x, (0, steps * stride - d))
    xp = xp.reshape(n, steps, nblk, THREADS, vec)
    per_thread = torch.einsum("isbtj,ksbtj->ikbt", xp, xp)       # (N, N, blocks, threads)
    g = torch.sum(torch.sum(per_thread, dim=3), dim=2)
    g = torch.triu(g) + torch.triu(g, 1).T
    sq = torch.diagonal(g)
    return sq[:, None] + sq[None, :] - 2.0 * g


# ---------------------------------- wrappers -----------------------------------
def _check_stack(x: torch.Tensor, mask: Optional[torch.Tensor], what: str) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"{what}: needs an (N, D) float32 stack, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n = x.shape[0]
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"{what}: the sorting network takes 1..{MAX_NODES} "
                         f"nodes, got {n}")
    if mask is not None and (tuple(mask.shape) != (n,) or mask.device != x.device):
        raise ValueError(f"{what}: mask must be ({n},) on {x.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_P = ctypes.c_void_p


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked coordinate median of an (N, D) float32 stack -> (D,); NaN
    where no row is kept.  Equal in value to ``aggregation._masked_median``
    (a tie of +0.0 and −0.0 may give the other zero).  On CUDA one launch
    that reads the kept rows once; the kept count stays on the device."""
    _check_stack(x, mask, "masked_median")
    if not x.is_cuda:
        return masked_median_plain(x, mask)
    x = x.contiguous()
    m = mask.float().contiguous()
    n, d = x.shape
    grid = grid_for(x)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    fn = build.function("masked_agg", "masked_median_f32",
                        [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, _P])
    build.check(fn(x.data_ptr(), m.data_ptr(), out.data_ptr(), grid.nblk, grid.vec, n, d,
                   _stream(x)), "masked_median")
    LAUNCHES["masked_median"] += 1
    return out


def masked_cc_iter(x: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, *,
                   clip_tau: Optional[float] = None) -> torch.Tensor:
    """One masked CenteredClip iteration v + Σᵢ mᵢ·clip(xᵢ − v, τ)/k ->
    (D,): the chain of one (three launches on CUDA).  ``clip_tau=None``
    takes the adaptive τ (masked median of ‖xᵢ − v‖), computed on the
    device."""
    return _cc_chain(x, v, mask, 1, clip_tau, "masked_cc_iter")


def masked_cc_chain(x: torch.Tensor, v0: torch.Tensor, mask: torch.Tensor, *,
                    iters: int, clip_tau: Optional[float] = None) -> torch.Tensor:
    """``iters`` masked CenteredClip iterations from ``v0`` -> (D,),
    bit-equal to ``iters`` calls of :func:`masked_cc_iter`; on CUDA
    tensors 1 + 2·iters launches that read the stack iters + 1 times.
    ``iters = 0`` returns ``v0``."""
    check_iters(iters, "masked_cc_chain")
    return _cc_chain(x, v0, mask, iters, clip_tau, "masked_cc_chain")


def _cc_chain(x: torch.Tensor, v0: torch.Tensor, mask: torch.Tensor, iters: int,
              clip_tau: Optional[float], what: str) -> torch.Tensor:
    _check_stack(x, mask, what)
    if tuple(v0.shape) != (x.shape[1],) or v0.dtype != torch.float32 \
            or v0.device != x.device:
        raise ValueError(f"{what}: v must be ({x.shape[1]},) float32 on {x.device}")
    if iters == 0:
        return v0
    if not x.is_cuda:
        v = v0
        for _ in range(iters):
            v = masked_cc_iter_plain(x, v, mask, clip_tau)
        return v
    x, v0 = x.contiguous(), aligned_copy(v0)
    m = mask.float().contiguous()
    n, d = x.shape
    plan = plan_for(x)
    out = torch.empty(d, dtype=torch.float32, device=x.device)
    partial = torch.empty((n, plan.nblk), dtype=torch.float32, device=x.device)
    w = torch.empty(n, dtype=torch.float32, device=x.device)
    kf = torch.empty(1, dtype=torch.float32, device=x.device)
    fn = build.function("masked_agg", "masked_cc_chain_f32",
                        [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float, ctypes.c_int, _P])
    tau = 0.0 if clip_tau is None else float(clip_tau)
    build.check(fn(x.data_ptr(), v0.data_ptr(), m.data_ptr(), out.data_ptr(),
                   partial.data_ptr(), plan.nblk, plan.chunk, plan.vec, w.data_ptr(),
                   kf.data_ptr(), n, d, iters, tau, int(clip_tau is None), _stream(x)), what)
    LAUNCHES["masked_cc_iter"] += iters
    return out


def masked_krum_d2(x: torch.Tensor) -> torch.Tensor:
    """(N, N) pairwise squared distances ‖xᵢ‖² + ‖xⱼ‖² − 2xᵢᵀxⱼ of an
    (N, D) float32 stack; on CUDA one pass over the stack and a one-block
    finalize."""
    _check_stack(x, None, "masked_krum_d2")
    if not x.is_cuda:
        return masked_krum_d2_plain(x)
    x = x.contiguous()
    n, d = x.shape
    grid = grid_for(x)
    partial = torch.empty((n * (n + 1) // 2, grid.nblk), dtype=torch.float32,
                          device=x.device)
    d2 = torch.empty((n, n), dtype=torch.float32, device=x.device)
    fn = build.function("masked_agg", "masked_krum_d2_f32",
                        [_P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                         ctypes.c_longlong, _P])
    build.check(fn(x.data_ptr(), partial.data_ptr(), grid.nblk, grid.vec, d2.data_ptr(), n,
                   d, _stream(x)), "masked_krum_d2")
    LAUNCHES["masked_krum_d2"] += 1
    return d2


# ------------------------------ fused aggregators ------------------------------
Updates = Union[torch.Tensor, qdec.QsgdPayload]


def _as_f32_stack(updates: Updates) -> torch.Tensor:
    """(N, D) float32 view of either a dense stack or a QsgdPayload batch."""
    if isinstance(updates, qdec.QsgdPayload):
        return qdec.wire_decode(updates)
    return updates.float()


def masked_median_net(updates: Updates, mask: torch.Tensor) -> torch.Tensor:
    return masked_median(_as_f32_stack(updates), mask)


def masked_centered_clip_fused(updates: Updates, mask: torch.Tensor, *,
                               clip_tau: Optional[float] = None, iters: int = 3,
                               v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = _as_f32_stack(updates)
    v = v0.float() if v0 is not None else masked_median(x, mask)
    v = masked_cc_chain(x, v, mask, iters=iters, clip_tau=clip_tau)
    return torch.where(torch.any(mask), v, torch.zeros_like(v))


def masked_krum_fused(updates: Updates, mask: torch.Tensor, *,
                      f: Union[int, torch.Tensor] = 1) -> torch.Tensor:
    x = _as_f32_stack(updates)
    scores = aggregation._krum_scores_from_d2(masked_krum_d2(x), mask, f)
    row = x[torch.argmin(scores)]
    return torch.where(torch.any(mask), row, torch.zeros_like(row))


def masked_mean_fused(updates: Updates, mask: torch.Tensor) -> torch.Tensor:
    if isinstance(updates, qdec.QsgdPayload):
        k = torch.clamp(torch.sum(mask.float()), min=1.0)
        return qdec.decode_accumulate(updates, mask.float()) / k
    return aggregation.masked_mean(updates, mask)


FUSED_MASKED_AGGREGATORS: Dict[str, Callable] = {
    "mean": masked_mean_fused,
    "krum": masked_krum_fused,
    "centered_clip": masked_centered_clip_fused,
}


def get_fused_aggregator(name: str, **defaults) -> Callable:
    """Fused twin of ``aggregation.get_masked_aggregator``; KeyError for an
    aggregator without a fused implementation."""
    fn = FUSED_MASKED_AGGREGATORS[name]
    return functools.partial(fn, **defaults) if defaults else fn
