"""Gossip averaging (paper §3.2; twin of ``repro/core/gossip.py``): the
communication-efficient replacement for the synchronous all-reduce.

The mixing step is ``x ← W x`` with a doubly-stochastic Metropolis matrix
(``core.topology``); per-round per-node traffic is O(degree · D) instead of
the all-reduce's ring O(D) with global synchronisation.  Convergence to the
exact mean is geometric with rate λ₂ of W.

The mixing itself is a plain (N, N) × (N, D) product, which the reference
computes outside any Pallas kernel; here it is ``torch.matmul`` (run it
with TF32 off on the card, as ``chip_smoke.py`` does, to keep float32
products).  The graph layer lives in ``core.topology`` and is re-exported
here, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.topology import (  # noqa: F401  (re-exports)
    clustered_adjacency,
    fully_connected_adjacency,
    metropolis_weights,
    mixing_matrix,
    random_regular_adjacency,
    ring_adjacency,
    spectral_gap,
    torus_adjacency,
)


# -- mixing -------------------------------------------------------------------
def gossip_round(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (N, ...) per-node values; one synchronous gossip mixing step."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    w = torch.as_tensor(w, device=flat.device).to(flat.dtype)
    return (w @ flat).reshape(x.shape)


def gossip_average(x: torch.Tensor, w: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` mixing steps."""
    for _ in range(rounds):
        x = gossip_round(x, w)
    return x


def consensus_error(x: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max node deviation from the true mean (convergence metric).  An (N,)
    bool ``active`` takes the mean and the max over the active nodes only
    (0 where none is).  The deviations are taken a row at a time, so no
    (N, D) temporary is made."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if active is None:
        keep = torch.ones(n, dtype=flat.dtype, device=flat.device)
        mean = torch.mean(flat, dim=0)
    else:
        keep = active.to(flat.dtype)
        mean = (keep @ flat) / torch.clamp(torch.sum(keep), min=1.0)
    dev = torch.stack([torch.linalg.vector_norm(flat[i] - mean) for i in range(n)])
    return torch.max(dev * keep)


def rounds_for_tolerance(w: np.ndarray, tol: float) -> int:
    """Analytic round count to shrink consensus error by ``tol``: error
    contracts by (1-gap) per round, so ``ceil(log tol / log(1-gap))``,
    clamped to >= 0 (``tol >= 1`` is met by round 0).  A zero spectral gap
    (a disconnected graph: gossip never reaches consensus) raises
    ``ValueError``."""
    if tol >= 1.0:
        return 0
    gap = spectral_gap(w)
    if gap <= 1e-9:
        raise ValueError(
            "mixing matrix has zero spectral gap (disconnected graph): "
            "gossip never reaches consensus — no finite round count exists")
    return max(0, int(np.ceil(np.log(tol) / np.log(max(1e-12, 1.0 - gap)))))


def gossip_traffic_bytes(adj: np.ndarray, d: int, dtype_bytes: int = 4) -> int:
    """Bytes moved per round (each edge carries D values each way)."""
    return int(adj.sum()) * d * dtype_bytes


def allreduce_traffic_bytes(n: int, d: int, dtype_bytes: int = 4) -> int:
    """Ring all-reduce: 2(N-1)/N · D per node · N nodes."""
    return int(2 * (n - 1) * d * dtype_bytes)
