"""Protocol Models and unextractability (paper §4.1): the custody layer the
Protocol Model server needs (twin of ``repro/core/unextractable.py``).

- the custody state is an ``(N, S)`` boolean **custody matrix**
  ``holds[n, s]`` (node n holds shard s), drawn by :func:`assign_matrix`
  (numpy, the reference's draw exactly) so that each shard has
  ``redundancy`` holders and no node holds more than ``max_fraction`` of
  the model.  The matrix is tiny and read at every call, so it stays on the
  host (a CPU bool tensor);
- coalition analysis is a set of tensor reductions over that matrix, with
  any number of leading batch axes on the coalition mask;
- :class:`ShardCustody` is the name-keyed view the server speaks;
- :func:`shard_params` / :func:`reconstruct_params` cut a param dict into
  flat float32 chunks in the reference's leaf order and reassemble it;
  missing shards come back as zeros;
- :func:`masked_reconstruct` zeroes the shards a coverage mask leaves out,
  in place of ``shard_params -> reconstruct_params``: the campaign's
  reconstruct-attack eval;
- :class:`CustodyConfig` and :func:`coalition_tail_mask`, the custody lane
  of a swarm run (``SwarmConfig.custody``);
- the economic comparison cost(acquire missing shards) vs cost(retrain).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.convert import Layout, flatten_into, layout_of, unflatten


# ============================ assignment =======================================
def assign_matrix(n_nodes: int, num_shards: int, redundancy: int = 2,
                  seed: int = 0, max_fraction: float = 0.5) -> np.ndarray:
    """Round-robin-with-shuffle custody draw honouring the custody bound.

    Returns the ``(n_nodes, num_shards)`` boolean custody matrix.  Each
    shard is handed to ``redundancy`` distinct nodes, candidates visited in
    a freshly shuffled order per shard, skipping nodes already at the
    ``ceil(max_fraction * num_shards)`` per-node cap.  Raises
    ``ValueError`` when the bound is too tight for the swarm size.  Pure in
    ``seed``: the reference's numpy draw, so both draw the same matrix.
    """
    if redundancy < 1:
        raise ValueError(f"redundancy must be >= 1, got {redundancy}")
    rng = np.random.default_rng(seed)
    per_node_cap = int(np.ceil(max_fraction * num_shards))
    holds = np.zeros((n_nodes, num_shards), bool)
    order = list(range(n_nodes))
    for s in range(num_shards):
        rng.shuffle(order)
        n_holders = 0
        for n in order:
            if holds[n].sum() < per_node_cap:
                holds[n, s] = True
                n_holders += 1
            if n_holders == redundancy:
                break
        if n_holders < redundancy:
            raise ValueError("custody bound too tight for this swarm size")
    return holds


# ===================== coalition analysis ======================================
# Each takes the (N, S) custody matrix and a boolean coalition / departure
# mask of shape (..., N), and reduces over the node axis.

def shards_covered(holds: torch.Tensor, coalition: torch.Tensor) -> torch.Tensor:
    """(..., N) coalition mask -> (..., S) bool: shards the coalition holds."""
    return torch.any(holds & coalition[..., :, None], dim=-2)


def coverage_frac(holds: torch.Tensor, coalition: torch.Tensor) -> torch.Tensor:
    """Fraction of the model's shards the coalition covers: (..., N) -> (...,).
    The float32 sum times float32 1/S, as the reference's compiled mean
    computes it, so the two agree to the bit."""
    recip = torch.tensor(1.0 / holds.shape[-1], dtype=torch.float32)
    return shards_covered(holds, coalition).float().sum(dim=-1) * recip


def can_extract_all(holds: torch.Tensor, coalition: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (...,) bool: the coalition covers every shard."""
    return torch.all(shards_covered(holds, coalition), dim=-1)


def tolerates_departures_all(holds: torch.Tensor, departed: torch.Tensor) -> torch.Tensor:
    """Elasticity: the swarm still holds every shard after the departures
    marked in the (..., N) mask — (...,) bool."""
    return torch.all(torch.any(holds & ~departed[..., :, None], dim=-2), dim=-1)


def missing_shards(holds: torch.Tensor, coalition: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (...,) int32: shards the coalition does NOT cover."""
    covered = shards_covered(holds, coalition).sum(dim=-1)
    return (holds.shape[-1] - covered).to(torch.int32)


# ============================ ShardCustody =====================================
@dataclass
class ShardCustody:
    """The ``(N, S)`` custody matrix (a CPU bool tensor) and the node ids
    that label its rows; ``assignment`` and ``node_shards`` are views."""
    num_shards: int
    redundancy: int
    node_ids: Tuple[str, ...]
    holds: torch.Tensor

    @staticmethod
    def assign(nodes: Sequence[str], num_shards: int, redundancy: int = 2,
               seed: int = 0, max_fraction: float = 0.5) -> "ShardCustody":
        holds = assign_matrix(len(nodes), num_shards, redundancy, seed, max_fraction)
        return ShardCustody(num_shards, redundancy, tuple(nodes), torch.from_numpy(holds))

    @property
    def assignment(self) -> Dict[int, List[str]]:
        """shard -> holder ids, in node order."""
        h = self.holds.numpy()
        return {s: [self.node_ids[n] for n in np.flatnonzero(h[:, s])]
                for s in range(self.num_shards)}

    @property
    def node_shards(self) -> Dict[str, Set[int]]:
        """node -> shards held."""
        h = self.holds.numpy()
        return {nid: set(np.flatnonzero(h[n]).tolist())
                for n, nid in enumerate(self.node_ids)}

    def coalition_mask(self, coalition: Sequence[str]) -> torch.Tensor:
        """Names -> (N,) boolean mask; unknown names are ignored."""
        members = set(coalition)
        return torch.tensor([nid in members for nid in self.node_ids], dtype=torch.bool)

    def coverage(self, coalition: Sequence[str]) -> float:
        return float(coverage_frac(self.holds, self.coalition_mask(coalition)))

    def can_extract(self, coalition: Sequence[str]) -> bool:
        return bool(can_extract_all(self.holds, self.coalition_mask(coalition)))

    def tolerates_departures(self, departed: Sequence[str]) -> bool:
        return bool(tolerates_departures_all(self.holds, self.coalition_mask(departed)))

    def missing_shards(self, coalition: Sequence[str]) -> List[int]:
        """The shard ids the coalition does NOT cover (the module-level
        :func:`missing_shards` returns their count)."""
        covered = shards_covered(self.holds, self.coalition_mask(coalition)).numpy()
        return [int(s) for s in np.flatnonzero(~covered)]

    def min_extraction_coalition(self, exact: bool = False) -> int:
        """Size of a coalition achieving full coverage; -1 if even the full
        swarm cannot cover.  Greedy set cover by default (an upper bound);
        ``exact=True`` tries subsets in increasing size up to that bound."""
        h = self.holds.numpy()
        greedy = _greedy_cover(h)
        if not exact or greedy < 0:
            return greedy
        nonempty = [int(n) for n in np.flatnonzero(h.any(axis=1))]
        for size in range(1, greedy):
            for combo in itertools.combinations(nonempty, size):
                if h[list(combo)].any(axis=0).all():
                    return size
        return greedy


def _greedy_cover(holds: np.ndarray) -> int:
    """Greedy set cover over the custody matrix (ties -> lowest node index)."""
    remaining = np.ones(holds.shape[1], bool)
    available = holds.copy()
    size = 0
    while remaining.any():
        gains = (available & remaining).sum(axis=1)
        best = int(np.argmax(gains))
        if gains[best] == 0:
            return -1
        remaining &= ~available[best]
        available[best] = False
        size += 1
    return size


# -- shard and reassemble real parameter dicts ----------------------------------
def shard_params(params: Mapping[str, torch.Tensor],
                 num_shards: int) -> Tuple[List[torch.Tensor], int]:
    """Cut a param dict into ``num_shards`` equal flat float32 chunks, in
    the reference's leaf order, zero-padded at the end.  The chunks are
    views of one flat vector.  Returns (chunks, unpadded size)."""
    size = sum(t.numel() for t in params.values())
    flat = torch.zeros(size + (-size) % num_shards, dtype=torch.float32,
                       device=next(iter(params.values())).device)
    flatten_into(flat[:size], params)
    return list(flat.reshape(num_shards, -1)), size


def reconstruct_params(shards: Mapping[int, torch.Tensor], layout: Layout,
                       num_shards: int, true_size: int,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reassemble a param dict from the held shards; missing shards are
    zero-filled (unusable).  ``layout`` is the params' ``convert.layout_of``
    (the reference takes the param tree; a layout holds no weights).  An
    empty ``shards`` gives the all-zero dict on ``device`` (default: the
    card).  Every leaf is a fresh tensor."""
    if shards:
        first = shards[next(iter(shards))]
        size = first.numel()
        flat = torch.zeros(num_shards * size, dtype=torch.float32, device=first.device)
        for i, s in shards.items():
            flat[i * size:(i + 1) * size] = s
    else:
        flat = torch.zeros(true_size, dtype=torch.float32, device=resolve_device(device))
    # clone the float32 leaves too, so no leaf holds on to the flat vector
    return {k: t.clone() if t.dtype == torch.float32 else t
            for k, t in unflatten(flat[:true_size], layout).items()}


def masked_reconstruct(params: Mapping[str, torch.Tensor],
                       covered: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero the shards that the (S,) bool mask ``covered`` leaves out of a
    param dict, keeping its names, shapes and dtypes: the chunking of
    :func:`shard_params` (the float32 concat in flat order, zero-padded to a
    multiple of S, shard s the s-th contiguous chunk), each chunk multiplied
    by its mask bit as the reference does (so a left-out -x reads -0.0),
    cast back leaf by leaf.  At full coverage it is the identity, bfloat16
    leaves included (bf16 -> f32 -> bf16 keeps the value).  One padded
    float32 vector of the whole model is alive while it runs; the float32
    leaves are views of it."""
    num_shards = covered.shape[-1]
    size = sum(t.numel() for t in params.values())
    flat = torch.zeros(size + (-size) % num_shards, dtype=torch.float32,
                       device=next(iter(params.values())).device)
    flatten_into(flat[:size], params)
    flat.view(num_shards, -1).mul_(covered.to(flat.device)[:, None])
    return unflatten(flat[:size], layout_of(params))


# ======================= swarm-lane custody config =============================
@dataclass(frozen=True)
class CustodyConfig:
    """The custody lane of a swarm run (``SwarmConfig.custody``).

    ``coalition_fraction`` marks the extraction coalition as the last
    ``ceil(fraction * N)`` roster slots, the tail where the scenario and
    sweep rosters put their attackers, so the Byzantine minority doubles
    as the extraction coalition.  ``seed`` draws the custody matrix and is
    apart from the run seed: run seeds vary noise and churn, never who
    holds what (the ``topology_seed`` convention)."""
    num_shards: int = 16
    redundancy: int = 2
    seed: int = 0
    max_fraction: float = 0.5
    coalition_fraction: float = 0.0


def coalition_tail_mask(n_nodes: int, fraction: float) -> np.ndarray:
    """(N,) bool marking the last ``ceil(fraction * n_nodes)`` roster slots."""
    k = min(n_nodes, int(math.ceil(fraction * n_nodes)))
    mask = np.zeros(n_nodes, bool)
    if k:
        mask[n_nodes - k:] = True
    return mask


# -- economics (the definition's inequality) ------------------------------------
def retrain_cost_flops(param_count: int, tokens: int) -> float:
    return 6.0 * param_count * tokens


def extraction_cost_flops(custody: ShardCustody, coalition: Sequence[str],
                          cost_per_shard_flops: float) -> float:
    """Cost to acquire the shards the coalition is missing, by doing enough
    verified work to be assigned custody of each (join-and-leech)."""
    missing = int(missing_shards(custody.holds, custody.coalition_mask(coalition)))
    return missing * cost_per_shard_flops


def is_protocol_model(custody: ShardCustody, coalition: Sequence[str],
                      param_count: int, tokens: int,
                      cost_per_shard_flops: float) -> bool:
    """Paper §4.1 property 2 for this coalition: extraction >= retraining."""
    if custody.can_extract(coalition):
        return False
    return (extraction_cost_flops(custody, coalition, cost_per_shard_flops)
            >= retrain_cost_flops(param_count, tokens))
