"""Communication topologies for decentralized training (paper §3.2, §5.5;
a copy of ``repro/core/topology.py``, which is numpy only).

Adjacency builders, the Metropolis mixing matrix, spectral-gap utilities
and a registry of named topologies, consumed by the decentralized swarm
round (``core.swarm`` with ``SwarmConfig.topology`` / ``LaneParams.mixing``),
the scenario registry and the §5.5 topology-axis sweeps.  ``core.gossip``
keeps the mixing runtime (``gossip_round`` / ``gossip_average`` / traffic
accounting).

A topology produces an undirected boolean adjacency; :func:`metropolis_weights`
turns it into the doubly-stochastic mixing matrix ``W`` with
``W_ij = 1/(1+max(deg_i, deg_j))`` on edges and the leftover mass on the
diagonal.  Gossip converges to the exact mean geometrically at rate
``1 - spectral_gap(W)``.

Time-varying graphs: :func:`time_varying_mixing` stacks a fresh graph per
round (T, N, N) and :func:`churn_coupled_mixing` couples the mixing matrix
to a join/leave schedule (departed nodes become isolated self-loops, so
their replicas freeze).  The decentralized round indexes a 3-D stack by
``round % T`` (``"cycle"``) or ``min(round, T - 1)`` (``"clamp"``).  Every
matrix is bit-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

__all__ = [
    "Topology", "TOPOLOGIES", "register_topology", "get_topology",
    "list_topologies", "ring_adjacency", "torus_adjacency",
    "random_regular_adjacency", "fully_connected_adjacency",
    "clustered_adjacency", "is_connected", "metropolis_weights",
    "spectral_gap", "mixing_matrix", "time_varying_mixing",
    "churn_coupled_mixing",
]


# -- adjacency builders ---------------------------------------------------------
def ring_adjacency(n: int) -> np.ndarray:
    a = np.zeros((n, n), bool)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[idx, (idx - 1) % n] = True
    return a


def torus_adjacency(n: int) -> np.ndarray:
    """2-D wraparound grid on the most-square ``r x c = n`` factorization.

    Degree 4 away from degenerate shapes; a prime ``n`` factors as ``1 x n``
    and degenerates to the ring.  (Duplicate wrap edges on 1- or 2-wide
    grids collapse in the boolean adjacency — degree just drops.)
    """
    r = max(d for d in range(1, int(np.sqrt(n)) + 1) if n % d == 0)
    c = n // r
    a = np.zeros((n, n), bool)
    for i in range(r):
        for j in range(c):
            u = i * c + j
            for v in (i * c + (j + 1) % c, ((i + 1) % r) * c + j):
                if u != v:
                    a[u, v] = a[v, u] = True
    return a


def fully_connected_adjacency(n: int) -> np.ndarray:
    a = np.ones((n, n), bool)
    np.fill_diagonal(a, False)
    return a


def is_connected(adj: np.ndarray) -> bool:
    """BFS reachability from node 0 over an undirected adjacency."""
    n = adj.shape[0]
    if n == 0:
        return True
    seen = np.zeros(n, bool)
    seen[0] = True
    frontier = np.array([0])
    while frontier.size:
        nxt = adj[frontier].any(axis=0) & ~seen
        seen |= nxt
        frontier = np.flatnonzero(nxt)
    return bool(seen.all())


def random_regular_adjacency(n: int, degree: int = 4, seed: int = 0, *,
                             max_tries: int = 64) -> np.ndarray:
    """Random degree-regular-ish graph: the union of ``max(1, degree//2)``
    random ring permutations.

    Degree is a *ceiling*, not a guarantee — two permutations can land the
    same edge (or a ring perm of length 2 double-counts one), so individual
    nodes may come up short.  What IS guaranteed: the graph is symmetric,
    self-loop-free, every node has degree >= 2, and it is **connected** —
    a draw whose perm edges collide into a disconnected or under-degree
    graph is discarded and redrawn with fresh permutations (previously such
    draws were returned silently, poisoning every spectral-gap consumer
    downstream with a gap of ~0).
    """
    if n < 2:
        raise ValueError(f"random_regular_adjacency needs n >= 2, got {n}")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        a = np.zeros((n, n), bool)
        for _ in range(max(1, degree // 2)):
            perm = rng.permutation(n)
            a[perm, np.roll(perm, 1)] = True
            a[np.roll(perm, 1), perm] = True
        np.fill_diagonal(a, False)
        if is_connected(a) and int(a.sum(1).min()) >= min(2, n - 1):
            return a
    raise ValueError(
        f"no connected degree-{degree} graph on {n} nodes in {max_tries} "
        "draws (raise max_tries or the degree)")


def clustered_adjacency(n: int, clusters: int = 2) -> np.ndarray:
    """``clusters`` rings joined into a chain by single bridge edges
    (``clusters - 1`` bridges, no wraparound) — a connected graph with a
    near-zero spectral gap (the partitioned-swarm regime: consensus leaks
    across bridges one edge at a time)."""
    if clusters < 1 or n < 2 * clusters:
        raise ValueError(f"need n >= 2*clusters, got n={n} clusters={clusters}")
    bounds = np.linspace(0, n, clusters + 1).astype(int)
    a = np.zeros((n, n), bool)
    for k in range(clusters):
        lo, hi = bounds[k], bounds[k + 1]
        size = hi - lo
        for i in range(size):
            u, v = lo + i, lo + (i + 1) % size
            if u != v:
                a[u, v] = a[v, u] = True
    for k in range(clusters - 1):        # one bridge per adjacent cluster pair
        u, v = bounds[k + 1] - 1, bounds[k + 1]
        a[u, v] = a[v, u] = True
    return a


# -- mixing matrices & spectra --------------------------------------------------
def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Doubly-stochastic Metropolis mixing matrix from an undirected
    adjacency: ``W_ij = 1/(1+max(deg_i, deg_j))`` on edges, leftover mass on
    the diagonal."""
    adj = np.asarray(adj, bool)
    deg = adj.sum(1)
    w = np.where(adj, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])), 0.0)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


def spectral_gap(w: np.ndarray) -> float:
    """``1 - |λ₂|`` of a **symmetric** mixing matrix — the geometric
    consensus rate.  Uses ``eigvalsh`` (every Metropolis matrix is
    symmetric), so eigenvalues are exactly real and cannot pick up complex
    round-off the way the old general-eigvals path could.  ``eigvalsh``
    reads only one triangle, so a non-symmetric matrix (e.g. a push-sum /
    directed-gossip W) would silently get the gap of a *different* matrix
    — rejected loudly instead."""
    w = np.asarray(w, np.float64)
    if not np.allclose(w, w.T, atol=1e-8):
        raise ValueError("spectral_gap expects a symmetric mixing matrix "
                         "(directed/push-sum gossip needs its own analysis)")
    ev = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(1.0 - ev[1])


# -- the registry ---------------------------------------------------------------
@dataclass(frozen=True)
class Topology:
    """A named communication graph family.

    ``builder(n, seed=0, **kwargs)`` returns the boolean adjacency for an
    ``n``-node swarm; deterministic in ``(n, seed, kwargs)``.
    """
    name: str
    description: str
    builder: Callable[..., np.ndarray]


TOPOLOGIES: Dict[str, Topology] = {}


def register_topology(topology: Topology) -> Topology:
    TOPOLOGIES[topology.name] = topology
    return topology


def get_topology(name: str) -> Topology:
    try:
        return TOPOLOGIES[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; "
                       f"registered: {list_topologies()}") from None


def list_topologies() -> List[str]:
    return sorted(TOPOLOGIES)


register_topology(Topology(
    name="ring",
    description="Cycle graph: degree 2, gap ~ 1/n² — the slowest-mixing "
                "connected baseline.",
    builder=lambda n, seed=0: ring_adjacency(n),
))

register_topology(Topology(
    name="torus",
    description="2-D wraparound grid (most-square factorization): degree "
                "~4, gap ~ 1/n.",
    builder=lambda n, seed=0: torus_adjacency(n),
))

register_topology(Topology(
    name="random_regular",
    description="Union of random ring permutations (degree-d-ish expander): "
                "near-constant gap, the communication-efficient sweet spot.",
    builder=lambda n, seed=0, degree=4: random_regular_adjacency(
        n, degree, seed=seed),
))

register_topology(Topology(
    name="fully_connected",
    description="Complete graph: gap 1, one gossip round = exact mean — "
                "equivalent to the centralized aggregator.",
    builder=lambda n, seed=0: fully_connected_adjacency(n),
))

register_topology(Topology(
    name="clustered",
    description="Rings joined by single bridge edges: connected but "
                "near-zero gap — the partitioned-swarm stress case.",
    builder=lambda n, seed=0, clusters=2: clustered_adjacency(n, clusters),
))


def mixing_matrix(name: str, n: int, seed: int = 0, **kwargs) -> np.ndarray:
    """Metropolis mixing matrix of the named topology at size ``n``."""
    return metropolis_weights(get_topology(name).builder(n, seed=seed, **kwargs))


def time_varying_mixing(name: str, n: int, rounds: int, seed: int = 0,
                        **kwargs) -> np.ndarray:
    """A (rounds, N, N) stack of per-round mixing matrices — a fresh graph
    draw each round (deterministic in ``(seed, round)``).  Static topologies
    (ring/torus/fully_connected ignore their seed) stack to identical
    slices.  The decentralized swarm round indexes this by ``round % T``."""
    return np.stack([mixing_matrix(name, n, seed=seed + 7919 * t, **kwargs)
                     for t in range(rounds)])


def churn_coupled_mixing(w: np.ndarray, joins: np.ndarray, leaves: np.ndarray,
                         rounds: int) -> np.ndarray:
    """Couple a base mixing matrix to a membership schedule: a (T, N, N)
    stack where round ``t`` keeps only edges between nodes active at ``t``
    (``joins[i] <= t < leaves[i]``) and returns the lost mass to the
    diagonal.  Inactive nodes become isolated self-loops (rows ``e_i``), so
    their replicas freeze instead of mixing from beyond the grave; each
    slice stays symmetric and doubly stochastic, so consensus guarantees
    hold round by round on the active subgraph."""
    w = np.asarray(w, np.float64)
    n = w.shape[0]
    joins = np.asarray(joins)
    leaves = np.asarray(leaves)
    out = np.empty((rounds, n, n))
    for t in range(rounds):
        act = (joins <= t) & (t < leaves)
        off = w * (act[:, None] & act[None, :])
        np.fill_diagonal(off, 0.0)
        wt = off.copy()
        np.fill_diagonal(wt, 1.0 - off.sum(1))
        out[t] = wt
    return out
