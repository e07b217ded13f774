"""Swarm simulator: the centralized synchronous round (twin of
``repro/core/swarm.py``).

N protocol participants train one model.  Each round, in order:

1. per-node gradients, written as flat float32 rows of one (N, D) stack in
   the reference's flat order (``models.convert``);
2. corruption of the Byzantine rows (``_corrupt_all``);
3. the wire: QSGD payloads (fused round) or the decoded round trip of
   ``compression.roundtrip`` (qsgd, top-k, PowerSGD);
4. stake/slash audits of a random subset (``verification.audit_flat``);
5. masked robust aggregation over ``keep = active & ~caught`` — the
   kernels of ``kernels/masked_agg`` and ``kernels/qsgd_decode`` when the
   round is fused, ``core.aggregation`` otherwise;
6. the optimizer update, slashing and speed-weighted minting.

The round is a function ``round_fn(lane, state, rnd, batches, draws=None)
-> (state, RoundRecord)`` built by :func:`make_round_fn`, as in the
reference; :class:`Swarm` steps it and keeps the ledger.
:class:`SequentialSwarm` is the readable per-node twin of the same round:
it loops over the active nodes, aggregates the compacted survivors with
the dense ``core.aggregation`` aggregators, and is held against
:class:`Swarm`.  Every draw comes from the ``(seed, purpose, round, node)``
schedule of ``repro_torch.random``, the same in both engines, or, when
``draws`` is given, from the caller (the tests pass the reference's draws
and compare rounds exactly).  The wire draw of a node is drawn once per use
from its node generator, so its payload and the auditor's recomputation
see the same numbers and honest nodes pass their audits.

The campaign engine composes the round: :func:`scan_rounds` steps one run
over its rounds with nothing read back by the loop, and :func:`run_campaign`
runs every lane of a :func:`stack_lanes` campaign (a Python loop over the
lanes, each a scanned run from the same initial params on the same
per-(node, round) batches), routing each lane to its own aggregator by
``agg_id`` when the round is built over an aggregator set.

**Decentralized mode** (paper §3.2 meets §5.5): a round built with
``decentralized=True`` (``SwarmConfig.topology`` on the engine,
``LaneParams.mixing`` on the functional core) has no central aggregator.
``SwarmState.params`` carries a leading node axis, one replica per node,
and each round every node (1) takes the gradient of its own replica, (2)
robust-aggregates the submissions of its neighbourhood (the nonzero
entries of its row of the mixing matrix, and kept), (3) applies that to
its replica with its own optimizer state, and (4) the replicas
gossip-mix, ``params ← W @ params`` in float32.
``RoundRecord.consensus_err`` is the largest deviation of an active
replica from the active replicas' mean after mixing.  ``mixing`` may be a
(T, N, N) stack (``core.topology``'s time-varying or churn-coupled
graphs), read at ``round % T`` (``"cycle"``) or ``min(round, T - 1)``
(``"clamp"``).  On the card each node's aggregation takes the fused
aggregator's kernels with that node's mask; the wire stays the decoded
round trip on both devices.

**Custody lane** (paper §4.1 meets §5.5): ``SwarmConfig.custody`` (a
``core.unextractable.CustodyConfig``; ``LaneParams.custody`` /
``coalition`` on the functional core) carries the (N, S) custody matrix
through the round as observability only: it never changes the training
math.  Each round records ``RoundRecord.coverage``, the fraction of shards
held by at least one active node (the live extraction frontier), computed
on the device.  A campaign with a custody lane also runs the
reconstruct-attack eval: the coalition's shards reassembled
(``masked_reconstruct``) and evaluated beside the honest params, so each
lane's final loss is an (honest, extracted) pair.

**Bounded-staleness async rounds** (paper §3, heterogeneous nodes): a round
built with ``staleness_bound=K > 0`` keeps ``SwarmState.ring``, the params
as of the start of each of the last K+1 rounds (slot ``round % (K+1)``).
Node i's realized delay is drawn on the host in [0, min(cap_i, round, K)]
and its gradient is taken at the snapshot that old; the audit recomputes
against the same snapshot, so staleness alone never slashes.  The round
never writes into a tensor it was given, so a slot holds its round's param
dict by reference, with no copy.

**Economy lane** (paper §4 meets §5.5): ``SwarmConfig.economy`` (a
``core.economy.EconomyConfig``; ``LaneParams.econ`` on the functional core)
carries the stakes, balances, reward escrow and slash pool through the
round (``SwarmState.econ``).  A node takes part only while alive and
bonded (stake-gated admission, on the device), the economy is updated
after the slashing, and ``RoundRecord.coalition_stake`` is the coalition's
share of the kept stake.  On an adaptive lane the coalition best-responds
each round: it scores ``economy.ADAPTIVE_SCALES`` against the aggregator
and submits the winner.

A ``MeshPlan`` placement (ROADMAP queue 1, item 13) raises
``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple, Union)

import numpy as np
import torch

from repro_torch.core import aggregation, compression, economy, gossip, topology
from repro_torch.core.economy import EconomyConfig, EconState
from repro_torch.core.ledger import Ledger
from repro_torch.core.unextractable import (
    CustodyConfig,
    assign_matrix,
    coalition_tail_mask,
    coverage_frac,
    masked_reconstruct,
    shards_covered,
)
from repro_torch.core.verification import VerificationConfig, audit_flat
from repro_torch.kernels.masked_agg import ops as masked_agg_ops
from repro_torch.kernels.qsgd_decode import ops as qsgd_decode_ops
from repro_torch.models.convert import flat_size, flatten_into, layout_of, unflatten
from repro_torch.random import RoundDraws, RoundRandom

#: Byzantine behaviours, indexed by the code of the corruption table.
BEHAVIOURS = ("honest", "sign_flip", "scale", "noise", "zero", "inner_product")
BEHAVIOUR_CODES: Dict[str, int] = {name: i for i, name in enumerate(BEHAVIOURS)}

_FAR = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class NodeSpec:
    node_id: str
    speed: float = 1.0
    byzantine: Optional[str] = None      # None|sign_flip|scale|noise|zero|inner_product
    byzantine_scale: float = 10.0
    join_round: int = 0
    leave_round: Optional[int] = None
    #: max gradient staleness (rounds) this node may run behind, read only
    #: when the config sets ``staleness_bound > 0`` and clamped to it; the
    #: realized delay of a round is drawn in [0, min(delay, bound, round)].
    #: None derives it from ``speed`` (:attr:`effective_delay`); an
    #: explicit value always wins.
    delay: Optional[int] = None

    @property
    def effective_delay(self) -> int:
        """The staleness cap async rounds read: ``delay`` when set, else
        ``ceil(1 / speed) - 1`` (a node at 1/s of the reference speed lags
        up to s - 1 rounds: speed >= 1 -> 0, 0.5 -> 1, 0.25 -> 3)."""
        if self.delay is not None:
            return self.delay
        return max(int(np.ceil(1.0 / max(self.speed, 1e-9))) - 1, 0)

    def active(self, rnd: int) -> bool:
        return self.join_round <= rnd and (self.leave_round is None or rnd < self.leave_round)

    @property
    def behaviour_code(self) -> int:
        kind = self.byzantine or "honest"
        if kind not in BEHAVIOUR_CODES:
            raise ValueError(f"unknown byzantine behaviour: {kind!r} "
                             f"(known: {BEHAVIOURS})")
        return BEHAVIOUR_CODES[kind]


@dataclass(frozen=True)
class SwarmConfig:
    aggregator: str = "centered_clip"
    agg_kwargs: Dict = field(default_factory=dict)
    verification: Optional[VerificationConfig] = None
    compression: Optional[str] = None    # None|"qsgd"|"topk"|"powersgd"
    compression_kwargs: Dict = field(default_factory=dict)
    seed: int = 0
    #: named communication topology (``core.topology`` registry): setting
    #: one switches the batched engine to the decentralized round (per-node
    #: replicas, neighbourhood aggregation, gossip mixing).  None =
    #: centralized.
    topology: Optional[str] = None
    topology_kwargs: Dict = field(default_factory=dict)
    #: seed of the graph draw (random_regular), apart from ``seed`` so that
    #: run seeds vary the noise and never the graph
    topology_seed: int = 0
    #: couple the mixing matrix to the roster's join/leave schedule
    #: (``topology.churn_coupled_mixing``): departed or not-yet-joined
    #: nodes become isolated self-loops and their replicas freeze.  False
    #: keeps the graph static: every replica mixes on every round.
    churn_coupled: bool = False
    #: Protocol-Model custody lane (``core.unextractable.CustodyConfig``):
    #: the (N, S) custody matrix over this roster, traced through the round
    #: (``RoundRecord.coverage``), and the extraction coalition of the
    #: reconstruct-attack eval.  None = no custody tracking.  It never
    #: changes the training math.
    custody: Optional[CustodyConfig] = None
    #: fused hot path (kernels.masked_agg + kernels.qsgd_decode): None =
    #: auto (see make_round_fn), True = force, False = never.
    fused: Optional[bool] = None
    #: bounded-staleness async rounds: K > 0 keeps the last K+1 param
    #: snapshots and lets each node take its gradient at a delayed one
    #: (``NodeSpec.delay``).  0 is the synchronous round, code path and all.
    staleness_bound: int = 0
    #: the economy lane (``core.economy.EconomyConfig``): stakes, balances,
    #: reward escrow and slash pool carried through the round, stake-gated
    #: admission and (``adaptive=True``) the coalition's best response.
    #: The coalition is the roster's byzantine slots.  None = no economy.
    economy: Optional[EconomyConfig] = None


def corrupt(kind: str, grad_flat: torch.Tensor, honest_mean: torch.Tensor,
            scale: float, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar (single-node) corruption table — the reference the row-wise
    ``_corrupt_all`` below must match branch for branch.  ``noise`` is the
    standard-normal draw of a ``noise`` attacker."""
    if kind == "sign_flip":
        return -scale * grad_flat
    if kind == "scale":
        return scale * grad_flat
    if kind == "noise":
        return grad_flat + scale * noise
    if kind == "zero":
        return torch.zeros_like(grad_flat)
    if kind == "inner_product":
        # [87]-style: oppose the honest consensus direction
        return -scale * honest_mean
    raise ValueError(kind)


def _corrupt_all(codes: Sequence[int], gf: torch.Tensor,
                 honest_mean: Optional[torch.Tensor], scales: torch.Tensor,
                 noise_row: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """The corruption table over the (N, D) stack, row by row by behaviour
    code (the reference selects per element among every branch; each
    branch here is the same float32 expression).  Honest rows are the
    gradient rows themselves: with no attacker the stack is returned as
    is, otherwise a copy with the attacker rows replaced."""
    if not any(codes):
        return gf
    out = gf.clone()
    for i, c in enumerate(codes):
        if c == 0:
            continue
        s = scales[i]
        kind = BEHAVIOURS[c]
        out[i] = corrupt(kind, gf[i], honest_mean, s,
                         noise_row(i) if kind == "noise" else None)
    return out


# ============================ functional core ==================================
class LaneParams(NamedTuple):
    """Per-run parameters of the round.

    A single run's lane: roster fields are (N,) tensors on the round's
    device; ``seed`` keys the draws; the audit fields are floats
    (``p_check == 0`` disables auditing); ``agg_kwargs`` are passed to the
    aggregator (in a routed round, each aggregator takes the entries it
    accepts); ``agg_id`` is a host int, this run's index into the round's
    aggregator set.

    A campaign (:func:`stack_lanes`): every tensor field gains a leading L
    axis, ``seed`` and the audit fields become per-lane host tuples, each
    ``agg_kwargs`` entry an (L,) tensor, ``agg_id`` an (L,) int32 tensor
    and ``agg_ids`` its host copy, which routing reads so that it never
    reads the device.  :meth:`lane` slices run k back out.

    ``mixing`` is the decentralized round's doubly-stochastic mixing
    matrix, an (N, N) or (T, N, N) float32 tensor ((L, ...) stacked);
    None means the round is centralized, and every lane of a campaign
    must agree.

    ``custody`` / ``coalition`` are the custody lane: the (N, S) bool
    custody matrix and the (N,) bool extraction coalition, on the round's
    device.  ``delays`` is the bounded-staleness lane: the (N,) int32
    per-node maximum delays, a CPU tensor (the delays are drawn on the
    host), read only by rounds built with ``staleness_bound > 0``.  None
    disables each; all lanes of a campaign agree, as for ``mixing``.
    ``econ`` is the economy lane, an ``economy.EconParams`` (its scalars
    (L,) tensors, its coalition (L, N) and ``adaptive`` a host tuple when
    stacked); None disables it, and all lanes agree."""
    codes: torch.Tensor       # (N,) int32 behaviour codes (BEHAVIOUR_CODES)
    scales: torch.Tensor      # (N,) f32 byzantine scales
    speeds: torch.Tensor      # (N,) f32 capacity -> minted shares per kept round
    joins: torch.Tensor       # (N,) int32 join round (inclusive)
    leaves: torch.Tensor      # (N,) int32 leave round (exclusive; _FAR = never)
    seed: Union[int, Tuple[int, ...]]             # the run seed of the key schedule
    p_check: Union[float, Tuple[float, ...]]      # audit probability (0 = never)
    tolerance: Union[float, Tuple[float, ...]]    # audit relative-mismatch tolerance
    numeric_noise: Union[float, Tuple[float, ...]]  # simulated cross-stack spread
    agg_kwargs: Dict[str, Any]
    agg_id: Union[int, torch.Tensor] = 0          # index into the aggregator set
    agg_ids: Optional[Tuple[int, ...]] = None     # stacked only: agg_id on the host
    mixing: Any = None
    custody: Any = None
    coalition: Any = None
    delays: Any = None
    econ: Any = None

    @property
    def n_lanes(self) -> Optional[int]:
        """L of a stacked campaign; None for a single run's lane."""
        return None if self.agg_ids is None else len(self.agg_ids)

    def lane(self, k: int) -> "LaneParams":
        """Run ``k`` of a stacked campaign as a single run's lane."""
        if self.agg_ids is None:
            raise ValueError("lane(k) slices a stacked campaign (stack_lanes)")
        return LaneParams(
            codes=self.codes[k], scales=self.scales[k], speeds=self.speeds[k],
            joins=self.joins[k], leaves=self.leaves[k], seed=self.seed[k],
            p_check=self.p_check[k], tolerance=self.tolerance[k],
            numeric_noise=self.numeric_noise[k],
            agg_kwargs={name: v[k] for name, v in self.agg_kwargs.items()},
            agg_id=self.agg_ids[k],
            econ=None if self.econ is None else economy.EconParams(*(x[k] for x in self.econ)),
            **{f: None if getattr(self, f) is None else getattr(self, f)[k]
               for f in ("mixing", "custody", "coalition", "delays")})


class SwarmState(NamedTuple):
    """Everything that evolves across rounds.  In a decentralized round
    every leaf of ``params`` and ``opt_state`` has a leading node axis:
    one replica, and one optimizer state, per node."""
    params: Dict[str, torch.Tensor]
    opt_state: Any
    slashed: torch.Tensor     # (N,) bool — caught by an audit in a prior round
    contrib: torch.Tensor     # (N,) f32 — speed-weighted kept rounds
    ring: Any = None          # async rounds: a tuple of K+1 param dicts, slot
                              # r % (K+1) the params as of the start of round r
                              # (held by reference); None in synchronous rounds
    econ: Optional[EconState] = None   # economy lanes: the stakes, balances,
                              # escrow and pools; None without an economy lane


class RoundRecord(NamedTuple):
    """Per-round outputs (0-d tensors, or (N,) masks)."""
    n_active: torch.Tensor
    n_byzantine: torch.Tensor
    caught: torch.Tensor      # (N,) bool — slashed in *this* round
    keep: torch.Tensor        # (N,) bool — active & not caught (minted this round)
    agg_norm: torch.Tensor        # decentralized: the mean of the per-node norms
    consensus_err: torch.Tensor   # 0 in centralized rounds
    coverage: torch.Tensor        # 1.0 without a custody lane
    staleness: torch.Tensor       # 0 in synchronous rounds
    coalition_stake: Optional[torch.Tensor] = None  # economy lanes: the
                              # coalition's share of the kept nodes' stake
                              # after the round; None without an economy lane


def lane_for_nodes(nodes: Sequence[NodeSpec], cfg: SwarmConfig,
                   device: torch.device, *,
                   agg_kwargs: Optional[Dict] = None) -> LaneParams:
    """The single-run :class:`LaneParams` of a roster and config.
    ``cfg.topology`` resolves to the named Metropolis mixing matrix at this
    roster size, drawn with ``cfg.topology_seed`` (not the run seed: reruns
    across seeds keep the graph).  ``cfg.churn_coupled`` expands it to the
    (T, N, N) schedule-coupled stack, T spanning the last membership event
    (read with ``mixing_schedule="clamp"``, which :class:`Swarm` wires).
    ``cfg.custody`` draws the (N, S) custody matrix with ``custody.seed``
    (run seeds never reshuffle who holds what) and marks the coalition as
    the last ``ceil(coalition_fraction * N)`` roster slots.
    ``cfg.staleness_bound > 0`` fills ``delays`` with each node's
    ``effective_delay`` clamped to the bound.  ``cfg.economy`` fills
    ``econ``, the roster's byzantine slots the coalition."""
    v = cfg.verification

    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    mixing = None
    if cfg.topology is not None:
        w = topology.mixing_matrix(cfg.topology, len(nodes), seed=cfg.topology_seed,
                                   **cfg.topology_kwargs)
        if cfg.churn_coupled:
            joins = np.asarray([n.join_round for n in nodes])
            leaves = np.asarray([_FAR if n.leave_round is None else n.leave_round
                                 for n in nodes])
            events = [int(x) for x in (*joins, *leaves) if 0 < x < _FAR]
            w = topology.churn_coupled_mixing(
                w, joins, leaves, rounds=(max(events) + 1) if events else 1)
        mixing = torch.from_numpy(w.astype(np.float32)).to(device)
    custody = coalition = delays = None
    if cfg.custody is not None:
        cc = cfg.custody
        custody = torch.from_numpy(assign_matrix(
            len(nodes), cc.num_shards, cc.redundancy, cc.seed, cc.max_fraction)).to(device)
        coalition = torch.from_numpy(
            coalition_tail_mask(len(nodes), cc.coalition_fraction)).to(device)
    if cfg.staleness_bound > 0:
        delays = torch.tensor([min(n.effective_delay, cfg.staleness_bound)
                               for n in nodes], dtype=torch.int32)
    return LaneParams(
        codes=t([n.behaviour_code for n in nodes], torch.int32),
        scales=t([n.byzantine_scale for n in nodes], torch.float32),
        speeds=t([n.speed for n in nodes], torch.float32),
        joins=t([n.join_round for n in nodes], torch.int32),
        leaves=t([_FAR if n.leave_round is None else n.leave_round
                  for n in nodes], torch.int32),
        seed=cfg.seed,
        p_check=float(v.p_check) if v else 0.0,
        tolerance=float(v.tolerance) if v else 1.0,
        numeric_noise=float(v.numeric_noise) if v else 0.0,
        agg_kwargs=dict(agg_kwargs or {}),
        mixing=mixing,
        custody=custody,
        coalition=coalition,
        delays=delays,
        econ=(None if cfg.economy is None else cfg.economy.params_for(
            [n.byzantine is not None for n in nodes], device)),
    )


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of like-shaped trees (dicts, named and
    plain tuples, lists; None stays None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_trees(trees: Sequence[Any]):
    """Like-shaped trees -> one tree whose leaves gain a leading axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def lane_slice(tree, k: int):
    """Lane ``k`` of a campaign output, or node ``k``'s replica (or
    optimizer state) of a decentralized state: every leaf indexed by ``k``
    (views, no copy)."""
    return tree_map(lambda x: x[k], tree)


def stack_lanes(lanes: Sequence[LaneParams],
                device: Optional[torch.device] = None) -> LaneParams:
    """Stack single-run lanes into a campaign: every tensor field (and any
    host array, as ``derailment.build_sweep_lanes`` builds) gains a leading
    L axis on ``device`` (default: the first lane's), ``seed`` and the audit
    fields become per-lane host tuples, each ``agg_kwargs`` entry an (L,)
    tensor, and ``agg_id`` an (L,) int32 tensor beside its host copy
    ``agg_ids``.  All lanes must share N and the ``agg_kwargs`` keys, and
    agree on ``mixing``: all None (centralized) or all same-shaped
    matrices (decentralized), and likewise on ``custody`` / ``coalition``
    (moved to ``device``), on ``delays`` (stacked on the CPU) and on
    ``econ`` (its tensors stacked on ``device``, ``adaptive`` a host
    tuple)."""
    lanes = list(lanes)
    if not lanes:
        raise ValueError("stack_lanes needs at least one lane")
    for lane in lanes:
        if lane.agg_ids is not None:
            raise ValueError("stack_lanes stacks single-run lanes, not campaigns")
    keys = set(lanes[0].agg_kwargs)
    if any(set(lane.agg_kwargs) != keys for lane in lanes):
        raise ValueError("every lane of a campaign needs the same agg_kwargs keys")
    for f in ("mixing", "custody", "coalition", "delays", "econ"):
        if any((getattr(lane, f) is None) != (getattr(lanes[0], f) is None)
               for lane in lanes):
            raise ValueError(f"every lane of a campaign must agree on {f} "
                             "(all None, or all of one shape)")
    decentralized = lanes[0].mixing is not None
    first = lanes[0].codes
    dev = torch.device(device) if device is not None else (
        first.device if isinstance(first, torch.Tensor) else torch.device("cpu"))

    def stacked(values):
        return torch.stack([torch.as_tensor(x) for x in values]).to(dev)

    agg_ids = tuple(int(lane.agg_id) for lane in lanes)
    return LaneParams(
        codes=stacked(lane.codes for lane in lanes),
        scales=stacked(lane.scales for lane in lanes),
        speeds=stacked(lane.speeds for lane in lanes),
        joins=stacked(lane.joins for lane in lanes),
        leaves=stacked(lane.leaves for lane in lanes),
        seed=tuple(int(lane.seed) for lane in lanes),
        p_check=tuple(float(lane.p_check) for lane in lanes),
        tolerance=tuple(float(lane.tolerance) for lane in lanes),
        numeric_noise=tuple(float(lane.numeric_noise) for lane in lanes),
        agg_kwargs={k: stacked(lane.agg_kwargs[k] for lane in lanes)
                    for k in sorted(keys)},
        agg_id=torch.tensor(agg_ids, dtype=torch.int32, device=dev),
        agg_ids=agg_ids,
        mixing=(stacked(lane.mixing for lane in lanes).float() if decentralized
                else None),
        custody=(None if lanes[0].custody is None
                 else stacked(lane.custody for lane in lanes).bool()),
        coalition=(None if lanes[0].coalition is None
                   else stacked(lane.coalition for lane in lanes).bool()),
        delays=(None if lanes[0].delays is None else torch.stack(
            [torch.as_tensor(lane.delays, dtype=torch.int32).cpu() for lane in lanes])),
        econ=(None if lanes[0].econ is None else economy.EconParams(**{
            f: (tuple(int(lane.econ.adaptive) for lane in lanes) if f == "adaptive"
                else stacked(getattr(lane.econ, f) for lane in lanes))
            for f in economy.EconParams._fields})))


def init_ring(params, staleness_bound: int):
    """The bounded-staleness snapshot ring: K+1 slots, each ``params`` by
    reference (every slot starts at the initial params, the snapshot any
    early delay resolves to).  None when ``staleness_bound`` is 0.  The
    reference repeats the params K+1 times into one array; the port's
    round makes new tensors and writes into none it was given, so a slot
    needs no copy."""
    if staleness_bound <= 0:
        return None
    return (params,) * (staleness_bound + 1)


def init_state(params, optimizer, n_nodes: int, *, staleness_bound: int = 0,
               econ: Optional[EconState] = None) -> SwarmState:
    """The centralized round's initial state: the params, a fresh optimizer
    state, no node slashed, nothing minted, with ``staleness_bound`` the
    async ring, and ``econ`` (``economy.init_econ_state``) the economy."""
    dev = next(iter(params.values())).device
    return SwarmState(params=params, opt_state=optimizer.init(params),
                      slashed=torch.zeros(n_nodes, dtype=torch.bool, device=dev),
                      contrib=torch.zeros(n_nodes, dtype=torch.float32, device=dev),
                      ring=init_ring(params, staleness_bound), econ=econ)


def init_decentralized_state(params, optimizer, n_nodes: int, *,
                             staleness_bound: int = 0) -> SwarmState:
    """Per-node replica state: every node starts from the same ``params``
    with its own optimizer state, each leaf repeated along a new leading
    node axis (the replicas are equal, so each node's ``optimizer.init`` is
    the first node's).  With ``staleness_bound`` the ring's slots hold the
    replicas."""

    def repeat(x):
        return x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.dim())

    dev = next(iter(params.values())).device
    replicas = {k: repeat(v) for k, v in params.items()}
    return SwarmState(
        params=replicas,
        opt_state=tree_map(repeat, optimizer.init(params)),
        slashed=torch.zeros(n_nodes, dtype=torch.bool, device=dev),
        contrib=torch.zeros(n_nodes, dtype=torch.float32, device=dev),
        ring=init_ring(replicas, staleness_bound))


def consensus_params(params):
    """Collapse per-node replicas to the swarm-mean (consensus) params: the
    float32 mean over the node axis, cast back to each leaf's dtype."""
    return {k: torch.mean(v.float(), dim=0).to(v.dtype) for k, v in params.items()}


def _accepted_kwargs(name: str) -> frozenset:
    """Keyword names a masked aggregator understands (for routing the shared
    ``lane.agg_kwargs`` dict in multi-aggregator rounds), read from the
    signatures of ``aggregation.MASKED_AGGREGATORS``, which the fused twins
    share."""
    sig = inspect.signature(aggregation.MASKED_AGGREGATORS[name])
    return frozenset(p.name for p in sig.parameters.values()
                     if p.kind is inspect.Parameter.KEYWORD_ONLY)


def _wire_draw(rr: RoundRandom, draw: Optional[tuple], node: int) -> Optional[torch.Tensor]:
    """Node ``node``'s wire draw for ``compression.wire_draw``'s ``draw``:
    uniforms, normals, or None for a wire that takes none."""
    if draw is None:
        return None
    kind, shape = draw
    return rr.wire(node, shape) if kind == "uniform" else rr.wire_normal(node, shape)


def _node_gradient(loss_fn: Callable, params: Dict[str, torch.Tensor], batch):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves.keys(), grads))


def fused_choice(names: Sequence[str], compression_kind: Optional[str],
                 levels: int = 16, *, on_card: bool, stack_bytes: int,
                 fused: Optional[bool] = None) -> Tuple[bool, ...]:
    """Which aggregators of a round's set run their fused twins: one bool
    per name.  The fused path needs an uncompressed or int8-codeable qsgd
    wire and the aggregator's twin in ``FUSED_MASKED_AGGREGATORS``.

    ``fused=None`` on the card gives every aggregator with a twin its
    kernels, whatever the rest of the set holds and with no size
    threshold: a lane runs its own aggregator only (:func:`make_round_fn`),
    so a mixed set never sends a CenteredClip lane to plain PyTorch.  On
    the CPU (where the fused path runs the kernels' plain versions) it
    follows the reference: all or none, fused when every aggregator of the
    set has a twin and the (N, D) float32 stack reaches
    ``FUSED_MIN_BYTES``.  ``True`` fuses every one and raises where one
    cannot be; ``False`` fuses none."""
    wire_ok = (compression_kind is None
               or (compression_kind == "qsgd" and levels <= 127))
    has_twin = [wire_ok and name in masked_agg_ops.FUSED_MASKED_AGGREGATORS
                for name in names]
    if fused is None:
        if on_card:
            return tuple(has_twin)
        return (all(has_twin)
                and stack_bytes >= masked_agg_ops.FUSED_MIN_BYTES,) * len(names)
    if fused and not all(has_twin):
        raise ValueError(
            "fused=True unsupported here: needs aggregators within "
            f"{sorted(masked_agg_ops.FUSED_MASKED_AGGREGATORS)} (got "
            f"{list(names)}) and an uncompressed or int8-codeable qsgd wire "
            f"(got {compression_kind!r}, levels={levels})")
    return (bool(fused),) * len(names)


def make_round_fn(loss_fn: Callable, optimizer, params_template, n_nodes: int, *,
                  aggregator, agg_kwargs: Optional[Dict] = None,
                  compression_kind: Optional[str] = None,
                  compression_kwargs: Optional[Dict] = None,
                  verify: bool = False, decentralized: bool = False,
                  mixing_schedule: str = "cycle",
                  fused: Optional[bool] = None,
                  staleness_bound: int = 0) -> Callable:
    """Build the round: ``round_fn(lane, state, rnd, batches, draws=None)
    -> (state, RoundRecord)``, ``batches`` one batch per node.

    ``aggregator`` is one name (``agg_kwargs`` are its static kwargs;
    ``lane.agg_kwargs`` pass through verbatim) or a sequence of ``(name,
    static_kwargs)`` pairs, and then ``agg_kwargs`` must be empty.  A
    routed round runs lane ``k`` through aggregator ``lane.agg_id``, which
    receives only the ``lane.agg_kwargs`` entries its signature accepts,
    less its static kwargs (static kwargs win).  The reference, under
    ``vmap``, evaluates every aggregator of the set and selects one by
    ``agg_id``; the port evaluates only the lane's own (``agg_id`` is a host
    int), the same value without the set's work done L times over.

    ``decentralized=True`` builds the round without a central aggregator
    (the module docstring): ``state.params`` / ``opt_state`` carry a leading
    node axis (:func:`init_decentralized_state`) and ``lane.mixing`` is the
    graph.  Activity gates contribution (keep) only: inactive or slashed
    replicas go on updating from their neighbourhood and mixing, as in the
    reference, so a fully-connected graph reproduces the centralized round
    even under churn; a churn-coupled stack freezes leavers instead.
    ``mixing_schedule`` reads a (T, N, N) stack at ``round % T``
    (``"cycle"``) or ``min(round, T - 1)`` (``"clamp"``).

    ``fused`` selects the hot path: aggregators run their fused twins
    (``kernels.masked_agg``) and a qsgd wire keeps the int8 payload live
    into aggregation instead of a decoded float32 stack.  ``None`` resolves
    it per aggregator with :func:`fused_choice`; ``True`` forces it
    (raising on unsupported combinations); ``False`` forces the reference
    path.  A decentralized round keeps the decoded wire on both devices;
    on the CPU it is never fused, as in the reference (``fused=True``
    raises its ``ValueError``), and on the card each node's neighbourhood
    takes the fused twin where the aggregator has one.  The choice is
    exposed as ``round_fn.fused_by_agg`` (one bool per aggregator of the
    set) and ``round_fn.fused`` (every one fused).

    ``staleness_bound=K > 0`` builds the bounded-staleness async round:
    ``state.ring`` holds K+1 snapshots (:func:`init_ring`); each round puts
    the params as of its start in slot ``round % (K+1)``, draws node i's
    realized delay in [0, min(``lane.delays[i]``, round, K)] on the host
    (``RoundRandom.delay``) and takes node i's gradient at slot
    ``(round - delay) % (K+1)`` (a decentralized node at its own replica
    there).  Everything downstream consumes that gradient stack unchanged,
    the audit's recomputation included: the validator recomputes against
    the snapshot the node claims, so staleness alone never slashes.
    ``RoundRecord.staleness`` is the mean realized delay over the active
    nodes.  Each node's gradient is taken alone in both rounds, so a
    zero-delay lane equals the synchronous round bit for bit (in the
    reference, whose async round batches the gradients differently, it is
    only close).  ``K = 0`` is the synchronous round's own code path.

    A lane with ``econ`` (an economy lane; ``state.econ`` its
    ``economy.EconState``) gates admission on the device
    (``economy.admitted_mask``: alive and bonded), and after the slashing
    runs ``economy.econ_round_update`` and records the coalition's share of
    the kept stake.  On an adaptive lane (``econ.adaptive``, a host int)
    the coalition's active slots submit ``-best · honest_mean``, ``best``
    the ``economy.best_response_scale`` over the raw gradients, scored
    every round with no host read.  The reference scores on every lane and
    selects the result away on fixed lanes; the port skips it there.  The
    scorer is the attacker's model of the defense: on the CPU the
    reference's unfused masked aggregators, even in a fused round; on the
    card the lane's own aggregator by the round's own route
    (``fused_by_agg``), so that a CenteredClip lane scores through the
    median and chain kernels.  An economy lane needs a centralized round.
    """
    if isinstance(aggregator, str):
        agg_specs = [(aggregator, dict(agg_kwargs or {}))]
        route_kwargs = False
    else:
        if agg_kwargs:
            raise ValueError("pass per-aggregator static kwargs inside the "
                             "(name, kwargs) pairs, not via agg_kwargs")
        agg_specs = [(name, dict(kw)) for name, kw in aggregator]
        route_kwargs = True
    if compression_kind not in compression.WIRE_CODECS:
        raise ValueError(f"unknown wire codec: {compression_kind!r} "
                         f"(known: {compression.WIRE_CODECS})")
    if mixing_schedule not in ("cycle", "clamp"):
        raise ValueError(f"unknown mixing_schedule: {mixing_schedule!r} "
                         "(known: 'cycle', 'clamp')")
    ckw = dict(compression_kwargs or {})
    layout = layout_of(params_template)
    d_total = flat_size(layout)
    stack_bytes = n_nodes * d_total * 4
    names = [name for name, _ in agg_specs]
    on_card = next(iter(params_template.values())).is_cuda
    if decentralized and not on_card:
        if fused:
            raise ValueError(
                "fused=True unsupported here: needs a centralized round, "
                f"aggregators within {sorted(masked_agg_ops.FUSED_MASKED_AGGREGATORS)} "
                f"(got {names}), and an uncompressed or int8-codeable qsgd wire "
                f"(got {compression_kind!r}, levels={ckw.get('levels', 16)})")
        fused_by_agg = (False,) * len(names)
    else:
        # a decentralized round aggregates the decoded stack: its wire never
        # limits the fused twins
        fused_by_agg = fused_choice(
            names, None if decentralized else compression_kind, ckw.get("levels", 16),
            on_card=on_card, stack_bytes=stack_bytes, fused=fused)
    agg_fns = [((masked_agg_ops.get_fused_aggregator if f
                 else aggregation.get_masked_aggregator)(name, **kw),
                _accepted_kwargs(name) - set(kw), f)
               for (name, kw), f in zip(agg_specs, fused_by_agg)]
    # the adaptive coalition's model of the defense (economy lanes)
    score_fns = agg_fns if on_card else [
        (aggregation.get_masked_aggregator(name, **kw), _accepted_kwargs(name) - set(kw), False)
        for name, kw in agg_specs]

    def aggregate(lane: LaneParams, stack, mask, fns=agg_fns):
        if not route_kwargs:
            return fns[0][0](stack, mask, **lane.agg_kwargs)
        fn, accepted, _ = fns[int(lane.agg_id)]
        return fn(stack, mask, **{k: v for k, v in sorted(lane.agg_kwargs.items())
                                  if k in accepted})

    draw = compression.wire_draw(compression_kind, d_total, **ckw)

    def mixing_at(lane: LaneParams, rnd: int) -> torch.Tensor:
        if lane.mixing is None:
            raise ValueError("a decentralized round needs LaneParams.mixing "
                             "(SwarmConfig.topology, or a mixing matrix on the lane)")
        w = lane.mixing.float()
        if w.dim() == 3:                 # time-varying / churn-coupled stack
            t_max = w.shape[0]
            w = w[min(rnd, t_max - 1) if mixing_schedule == "clamp" else rnd % t_max]
        return w

    def update_nodes(lane, state, w, submitted, keep):
        """5 + 6 of a decentralized round, node by node: node i aggregates
        the kept submissions of its neighbourhood (the Metropolis W has
        self-loops, so its own is among them) and updates its replica with
        its own optimizer state.  One node's aggregate is alive at a time;
        the new replicas are written as the rows of the float32 stack that
        the gossip mix reads.  Returns ``(stack, opt_state, agg_norm)``."""
        per_keep = (w > 0) & keep[None, :]                  # (N, N)
        node_any = torch.any(per_keep, dim=1).tolist()
        dev = keep.device
        flat = torch.empty((n_nodes, d_total), dtype=torch.float32, device=dev)
        new_opt = tree_map(torch.empty_like, state.opt_state)
        norms = torch.zeros(n_nodes, dtype=torch.float32, device=dev)
        for i in range(n_nodes):
            p_i, o_i = lane_slice(state.params, i), lane_slice(state.opt_state, i)
            if node_any[i]:
                agg = aggregate(lane, submitted, per_keep[i])
                norms[i] = torch.linalg.vector_norm(agg)
                p_i, o_i = optimizer.update(unflatten(agg, layout), o_i, p_i)
                del agg
            flatten_into(flat[i], p_i)
            tree_map(lambda o, x: o[i].copy_(x), new_opt, o_i)
        return flat, new_opt, torch.mean(norms)

    def round_fn(lane: LaneParams, state: SwarmState, rnd: int, batches,
                 draws: Optional[RoundDraws] = None):
        dev = state.slashed.device
        n = n_nodes
        active = (lane.joins <= rnd) & (rnd < lane.leaves) & ~state.slashed
        econ = lane.econ
        if econ is not None:
            if decentralized:
                raise ValueError("economy lanes need a centralized round "
                                 "(stake-gated admission and the fee market "
                                 "assume one aggregate)")
            if state.econ is None:
                raise ValueError("economy lane without SwarmState.econ — "
                                 "init the state with "
                                 "economy.init_econ_state(lane.econ, n)")
            # stake-gated admission from the live stakes: a node not admitted
            # drops out of audits, aggregation and minting alike
            active = active & economy.admitted_mask(econ, state.econ)
        maskf = active.float()
        nact = torch.sum(maskf)
        rr = RoundRandom(lane.seed, rnd, dev, draws)
        codes = lane.codes.tolist()
        fused_qsgd = (compression_kind == "qsgd" and not decentralized
                      and agg_fns[int(lane.agg_id)][2])

        # 0. async rounds: this round's snapshot, then each node's realized
        # delay and the snapshot it reads
        ring, snapshot = state.ring, [state.params] * n
        staleness = torch.zeros((), dtype=torch.float32, device=dev)
        if staleness_bound > 0:
            if lane.delays is None:
                raise ValueError("staleness_bound > 0 needs a LaneParams.delays lane "
                                 "(lane_for_nodes with SwarmConfig.staleness_bound set)")
            ring_len = staleness_bound + 1
            if state.ring is None or len(state.ring) != ring_len:
                raise ValueError(f"staleness_bound={staleness_bound} needs a SwarmState.ring "
                                 f"of {ring_len} slots (init_state(..., staleness_bound=))")
            ring = tuple(state.params if j == rnd % ring_len else slot
                         for j, slot in enumerate(state.ring))
            caps = [min(d, rnd, staleness_bound) for d in lane.delays.tolist()]
            delay = [rr.delay(i, caps[i]) for i in range(n)]
            snapshot = [ring[(rnd - d) % ring_len] for d in delay]
            delay_t = torch.tensor(delay, dtype=torch.float32, device=dev)
            staleness = torch.sum(delay_t * maskf) / torch.clamp(nact, min=1.0)

        # 1. per-node gradients -> rows of one (N, D) float32 stack; each
        # node of a decentralized round at its own replica
        gf = torch.empty((n, d_total), dtype=torch.float32, device=dev)
        for i in range(n):
            params_i = lane_slice(snapshot[i], i) if decentralized else snapshot[i]
            flatten_into(gf[i], _node_gradient(loss_fn, params_i, batches[i]))
        del snapshot

        # 2. corruption (an economy lane's best response needs the honest
        # mean whatever the codes)
        honest_mean = None
        if econ is not None or BEHAVIOUR_CODES["inner_product"] in codes:
            acc = torch.zeros(d_total, dtype=torch.float32, device=dev)
            for i in range(n):
                acc = acc + gf[i] * maskf[i]
            honest_mean = acc / torch.clamp(nact, min=1.0)
        corrupted = _corrupt_all(codes, gf, honest_mean, lane.scales,
                                 lambda i: rr.corrupt(i, d_total))
        if econ is not None and econ.adaptive:
            # the adaptive coalition's best response: one (N, D) buffer for
            # the scored stacks, then its submissions
            coal_act = econ.coalition & active
            buf = torch.empty_like(gf)
            best = economy.best_response_scale(
                lambda x, m: aggregate(lane, x, m, score_fns), gf, honest_mean,
                coal_act, active, buf=buf)
            corrupted = torch.where(coal_act[:, None], -best * honest_mean[None, :],
                                    corrupted, out=buf)

        # 3 + 4. the wire, and the audits of the selected nodes: node i's
        # uniforms feed its payload and the auditor's recomputation alike
        audited = torch.zeros(n, dtype=torch.bool, device=dev)
        if verify:
            vcfg = VerificationConfig(p_check=lane.p_check,
                                      tolerance=lane.tolerance,
                                      numeric_noise=lane.numeric_noise)
            sel = torch.stack([rr.audit_sel(i) for i in range(n)])
            audited = active & (sel < lane.p_check)
        audited_host = audited.tolist()
        passes = torch.ones(n, dtype=torch.bool, device=dev)
        if fused_qsgd:
            wire_shape = draw[1]
            pay_codes = torch.empty((n, *wire_shape), dtype=torch.int8, device=dev)
            pay_norms = torch.empty((n, wire_shape[0], 1), dtype=torch.float32,
                                    device=dev)
        elif compression_kind is not None:
            submitted = torch.empty((n, d_total), dtype=torch.float32, device=dev)
        else:
            submitted = corrupted
        for i in range(n):
            u = _wire_draw(rr, draw, i)
            if fused_qsgd:
                pay = qsgd_decode_ops.wire_encode(corrupted[i], u, **ckw)
                pay_codes[i], pay_norms[i] = pay.codes, pay.norms
                claimed = qsgd_decode_ops.wire_decode(pay) if audited_host[i] else None
            else:
                if compression_kind is not None:
                    submitted[i] = compression.roundtrip(compression_kind, u,
                                                         corrupted[i], **ckw)
                claimed = submitted[i]
            if audited_host[i]:
                recomputed = compression.roundtrip(compression_kind, u, gf[i], **ckw)
                ok, _ = audit_flat(claimed, recomputed,
                                   rr.audit_noise(i, d_total), vcfg)
                passes[i] = ok
        if fused_qsgd:
            submitted = qsgd_decode_ops.QsgdPayload(
                pay_codes, pay_norms, levels=ckw.get("levels", 16),
                size=d_total, bucket_size=wire_shape[1])
        del gf, corrupted
        caught = audited & ~passes
        keep = active & ~caught

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if decentralized:
            # 5 + 6 node by node, then the gossip mix of the replicas in
            # float32 (momentum stays local, as in DSGD)
            w = mixing_at(lane, rnd)
            flat, new_opt, agg_norm = update_nodes(lane, state, w, submitted, keep)
            del submitted
            mixed = gossip.gossip_round(flat, w)
            del flat
            # consensus over the active replicas only: a churn-coupled
            # leaver's replica freezes (its row e_i) and would otherwise
            # dominate the max
            consensus_err = gossip.consensus_error(mixed, active)
            # the replicas in their dtypes, copied out of the stack so that
            # it can be freed
            new_params = {k: v.contiguous() for k, v in unflatten(mixed, layout).items()}
            del mixed
        else:
            # 5. masked robust aggregation
            agg = aggregate(lane, submitted, keep)
            del submitted
            any_keep = torch.any(keep)
            agg = torch.where(any_keep, agg, torch.zeros_like(agg))

            # 6. the optimizer update
            if bool(any_keep):
                new_params, new_opt = optimizer.update(unflatten(agg, layout),
                                                       state.opt_state, state.params)
            else:
                new_params, new_opt = state.params, state.opt_state
            agg_norm, consensus_err = torch.linalg.vector_norm(agg), zero

        # custody: the live extraction frontier, a shard available while one
        # of its holders is active (departed or slashed holders drop out)
        coverage = (zero + 1.0 if lane.custody is None
                    else coverage_frac(lane.custody, active))

        # the economy, after the slashing
        new_econ, coalition_stake = state.econ, None
        if econ is not None:
            new_econ = economy.econ_round_update(econ, state.econ, active=active, keep=keep,
                                                 caught=caught, speeds=lane.speeds)
            kept_stake = new_econ.stake * keep.float()
            act_stake = torch.sum(kept_stake)
            coal_stake = torch.sum(kept_stake * econ.coalition.float())
            coalition_stake = torch.where(act_stake > 0.0,
                                          coal_stake / torch.clamp(act_stake, min=1e-9), zero)
        new_state = SwarmState(
            params=new_params, opt_state=new_opt,
            slashed=state.slashed | caught,
            contrib=state.contrib + lane.speeds * keep.float(), ring=ring, econ=new_econ)
        rec = RoundRecord(
            n_active=torch.sum(active).to(torch.int32),
            n_byzantine=torch.sum(active & (lane.codes > 0)).to(torch.int32),
            caught=caught, keep=keep, agg_norm=agg_norm,
            consensus_err=consensus_err, coverage=coverage, staleness=staleness,
            coalition_stake=coalition_stake)
        return new_state, rec

    round_fn.fused_by_agg = fused_by_agg      # resolved choice, inspectable
    round_fn.fused = all(fused_by_agg)
    round_fn.stack_bytes = stack_bytes
    round_fn.staleness_bound = staleness_bound
    return round_fn


def scan_rounds(round_fn: Callable, lane: LaneParams, state: SwarmState,
                rounds: int, batch_fn: Callable, eval_fn: Optional[Callable] = None,
                *, draws_fn: Optional[Callable[[int], RoundDraws]] = None):
    """Step the round over rounds 0..rounds-1: the twin of the reference's
    ``lax.scan``, as a Python loop.  ``batch_fn(rnd)`` gives the round's
    per-node batches, ``draws_fn(rnd)`` (the tests) its draws.  The loop
    itself reads nothing back from the device (the records stay there,
    stacked); the round reads what ``Swarm.step``'s does (ROADMAP queue
    1, item 3b).
    Returns ``(state, RoundRecord, final_loss)``: every record leaf stacked
    (T, ...), ``final_loss`` a float32 tensor of ``eval_fn(params)`` on the
    final params (0-d for a single loss; a campaign's custody eval gives an
    (honest, extracted) pair), computed under ``torch.no_grad()`` (0
    without an ``eval_fn``)."""
    if rounds < 1:
        raise ValueError(f"scan_rounds needs rounds >= 1, got {rounds}")
    recs = []
    for rnd in range(rounds):
        draws = None if draws_fn is None else draws_fn(rnd)
        state, rec = round_fn(lane, state, rnd, batch_fn(rnd), draws)
        recs.append(rec)
    dev = state.slashed.device
    if eval_fn is None:
        final = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        with torch.no_grad():
            final = torch.as_tensor(eval_fn(state.params), dtype=torch.float32,
                                    device=dev)
        if final.numel() == 1:
            final = final.reshape(())
    return state, stack_trees(recs), final


def make_scan_program(round_fn: Callable, batch_fn: Callable, rounds: int,
                      eval_fn: Optional[Callable] = None) -> Callable:
    """The scanned run as a function: ``run(lane, params, opt_state,
    slashed, contrib, ring=None, econ=None) -> (SwarmState, RoundRecord,
    final_loss)``, ``ring`` the async round's (:func:`init_ring`).  The
    reference donates the carries to XLA; here nothing is donated or needs
    to be: the round is functional, so the engine never writes into the
    caller's ``params``, ``opt_state``, ``ring`` or ``econ`` (the economy
    lane's ``EconState``) and makes its own new carries each round."""
    def run(lane: LaneParams, params, opt_state, slashed, contrib, ring=None, econ=None):
        state = SwarmState(params=params, opt_state=opt_state, slashed=slashed,
                           contrib=contrib, ring=ring, econ=econ)
        return scan_rounds(round_fn, lane, state, rounds, batch_fn, eval_fn)
    return run


def run_campaign(loss_fn: Callable, params0, optimizer, data_fn: Callable,
                 lanes: LaneParams, *, rounds: int, aggregator,
                 agg_kwargs: Optional[Dict] = None,
                 compression_kind: Optional[str] = None,
                 compression_kwargs: Optional[Dict] = None,
                 verify: bool = False, eval_fn: Optional[Callable] = None,
                 batched_data_fn: Optional[Callable] = None,
                 fast_compile: bool = False,
                 fused: Optional[bool] = None, plan=None,
                 draws_fn: Optional[Callable[[int, int], RoundDraws]] = None,
                 keep_params: bool = True):
    """Run a whole campaign: every lane of ``lanes`` (:func:`stack_lanes`)
    through the scanned round.

    All lanes share the aggregator set (and its static kwargs), the wire
    codec, the initial params and the data: each per-(node, round) batch
    is made once, by ``data_fn(node, rnd)`` or ``batched_data_fn(rnd)`` (a
    sequence of N batches), and every lane sees it.  They differ in what
    :class:`LaneParams` carries: roster, seed, audit rate and tolerance,
    ``agg_id`` and ``agg_kwargs``, and in a decentralized campaign the
    mixing matrix (so topology is a lane axis).  Decentralized mode is read
    from ``lanes.mixing``: each lane then starts from
    :func:`init_decentralized_state`, a 3-D stack is read at ``round % T``
    (a time-varying schedule; a churn-coupled stack is :class:`Swarm`'s,
    which reads it clamped), and ``eval_fn`` sees the lane's consensus
    (node-mean) params.  Async mode is read from ``lanes.delays``: the
    ring is sized by the largest cap over the lanes (a campaign of
    all-zero caps runs the synchronous round), each lane's own caps
    bounding its delays.  Custody mode is read from ``lanes.custody``:
    every round records the live coverage, and the eval also runs the
    reconstruct-attack, so each lane's final loss is the pair (honest,
    extracted), the loss of the model reassembled from exactly the shards
    the lane's coalition holds (final losses (L, 2)).  Economy mode is read
    from ``lanes.econ``: each lane starts from its own
    ``economy.init_econ_state`` and its final ``EconState`` is returned in
    the state's ``econ``, each field (L, ...).  This
    first cut loops over the lanes on the host, each lane
    :func:`scan_rounds` from a fresh initial state; lane k equals the
    single-run :class:`Swarm` of the same roster and config bit for bit.  ``draws_fn(k, rnd)`` hands lane k
    its round's draws (the tests pass the reference's).

    ``fast_compile`` is the reference's XLA option and a no-op here: there
    is nothing to compile.  ``plan`` (a ``MeshPlan``) waits for the
    distributed layer (item 13).

    Returns ``(SwarmState, RoundRecord, final losses)`` with a leading L
    axis on every leaf: records (L, T, ...), final losses (L,) or (L, 2).
    ``keep_params=False`` drops each lane's params, optimizer state and
    ring as the lane ends (the returned state holds None for them): a
    sweep reads only ``slashed``, ``contrib``, the records and the final
    losses, and then holds one lane's model state at a time.
    """
    program = make_campaign_program(
        loss_fn, params0, optimizer, data_fn, lanes, rounds=rounds,
        aggregator=aggregator, agg_kwargs=agg_kwargs,
        compression_kind=compression_kind, compression_kwargs=compression_kwargs,
        verify=verify, eval_fn=eval_fn, batched_data_fn=batched_data_fn,
        fused=fused, plan=plan, draws_fn=draws_fn, keep_params=keep_params)
    return program(lanes)


def make_campaign_program(loss_fn: Callable, params0, optimizer,
                          data_fn: Callable, lanes: LaneParams, *,
                          rounds: int, aggregator,
                          agg_kwargs: Optional[Dict] = None,
                          compression_kind: Optional[str] = None,
                          compression_kwargs: Optional[Dict] = None,
                          verify: bool = False,
                          eval_fn: Optional[Callable] = None,
                          batched_data_fn: Optional[Callable] = None,
                          fused: Optional[bool] = None, plan=None,
                          draws_fn: Optional[Callable[[int, int], RoundDraws]] = None,
                          keep_params: bool = True) -> Callable:
    """Build (without running) the campaign that :func:`run_campaign`
    runs: ``fn(lanes) -> (SwarmState, RoundRecord, final losses)``.
    ``lanes`` is read for its structure only (N, decentralized or not,
    custody or not, the ring's size).  The
    resolved fused choice is ``fn.fused`` and ``fn.fused_by_agg``.

    Each lane's outputs are copied into preallocated (L, ...) tensors as
    the lane ends and its own state is dropped, so the campaign holds L
    final states plus the one in flight, never two copies of them all."""
    if plan is not None:
        raise NotImplementedError("a MeshPlan placement is not ported yet "
                                  "(ROADMAP queue 1, item 13)")
    if lanes.n_lanes is None:
        raise ValueError("run_campaign takes a stacked campaign (stack_lanes)")
    n = int(lanes.codes.shape[-1])
    decentralized = lanes.mixing is not None
    has_custody = lanes.custody is not None
    staleness_bound = int(lanes.delays.max()) if lanes.delays is not None else 0
    round_fn = make_round_fn(
        loss_fn, optimizer, params0, n, aggregator=aggregator,
        agg_kwargs=agg_kwargs, compression_kind=compression_kind,
        compression_kwargs=compression_kwargs, verify=verify,
        decentralized=decentralized, fused=fused, staleness_bound=staleness_bound)
    init = init_decentralized_state if decentralized else init_state

    def lane_eval(lane: LaneParams, params):
        # decentralized lanes evaluate the consensus (mean) replica
        pe = consensus_params(params) if decentralized else params
        if not has_custody:
            return eval_fn(pe)
        # the reconstruct-attack eval: exactly the shards the coalition
        # holds, the rest zero-filled
        covered = shards_covered(lane.custody, lane.coalition)
        return torch.stack([torch.as_tensor(eval_fn(p), dtype=torch.float32).reshape(())
                            for p in (pe, masked_reconstruct(pe, covered))])

    def program(lanes: LaneParams):
        batches: Dict[int, list] = {}

        def batch_fn(rnd: int):
            if rnd not in batches:
                batches[rnd] = (list(batched_data_fn(rnd)) if batched_data_fn is not None
                                else [data_fn(i, rnd) for i in range(n)])
            return batches[rnd]

        out = None
        for k in range(lanes.n_lanes):
            lane = lanes.lane(k)
            state0 = init(params0, optimizer, n, staleness_bound=staleness_bound)
            if lane.econ is not None:
                state0 = state0._replace(econ=economy.init_econ_state(lane.econ, n))
            run = scan_rounds(round_fn, lane, state0, rounds, batch_fn,
                              None if eval_fn is None else functools.partial(lane_eval, lane),
                              draws_fn=None if draws_fn is None
                              else functools.partial(draws_fn, k))
            if not keep_params:
                run = (run[0]._replace(params=None, opt_state=None, ring=None), *run[1:])
            if out is None:
                out = tree_map(lambda x: x.new_empty((lanes.n_lanes, *x.shape)), run)
            tree_map(lambda o, x: o[k].copy_(x), out, run)
            del run
        return out

    program.fused = round_fn.fused
    program.fused_by_agg = round_fn.fused_by_agg
    return program


def history_from_records(recs: Union[RoundRecord, Sequence[RoundRecord]],
                         node_ids: Sequence[str], *, start_round: int = 0) -> List[dict]:
    """Rebuild the per-round host history from one run's records: a
    RoundRecord stacked (T, ...) (:func:`scan_rounds`, or one lane of a
    campaign), or a list of per-round records (:class:`Swarm`), each read
    as it is."""
    if not isinstance(recs, RoundRecord):
        return [history_from_records(tree_map(lambda x: x[None], r), node_ids,
                                     start_round=start_round + t)[0]
                for t, r in enumerate(recs)]
    host = tree_map(lambda x: x.cpu().numpy(), recs)
    out = [{
        "round": start_round + t,
        "n_active": int(host.n_active[t]),
        "n_byzantine": int(host.n_byzantine[t]),
        "caught": [node_ids[int(i)] for i in np.flatnonzero(host.caught[t])],
        "agg_norm": float(host.agg_norm[t]),
        "consensus_error": float(host.consensus_err[t]),
        "coverage": float(host.coverage[t]),
        "staleness": float(host.staleness[t]),
    } for t in range(host.agg_norm.shape[0])]
    if host.coalition_stake is not None:
        for t, row in enumerate(out):
            row["coalition_stake"] = float(host.coalition_stake[t])
    return out


def ledger_from_run(state: SwarmState, node_ids: Sequence[str],
                    verification: Optional[VerificationConfig] = None,
                    validator: str = "validator") -> Ledger:
    """Reconstruct the ownership :class:`Ledger` of one run from its device
    counters, as :class:`Swarm`'s per-round bookkeeping builds it: a node's
    balance is its speed-weighted kept rounds; a slashed node's pre-catch
    mints are forfeited (its counter froze at the catch round) and its
    stake burns, paying the validator jackpot."""
    led = Ledger()
    if verification is not None:
        for nid in node_ids:
            led.stake(nid, verification.stake)
    contrib = state.contrib.cpu().numpy()
    slashed = state.slashed.cpu().numpy()
    for nid, c in zip(node_ids, contrib):
        if c > 0:
            led.record_contribution(nid, float(c))
    for i in np.flatnonzero(slashed):
        led.slash(node_ids[int(i)])
        if verification is not None:
            led.pay_jackpot(validator, verification.jackpot)
    return led


# ================================ engines ======================================
class _SwarmBase:
    """State, ledger plumbing and the run() loop shared by both engines.

    ``loss_fn(params, batch) -> scalar``; ``data_fn(node_idx, rnd) ->
    batch``.  A round runs on the device of ``params``.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        self.loss_fn = loss_fn
        self.params = params
        self.optimizer = optimizer
        self.opt_state = optimizer.init(params)
        self.nodes = list(nodes)
        self.cfg = cfg
        self.data_fn = data_fn
        self.ledger = Ledger()
        self.slashed: Set[str] = set()
        self.history: List[dict] = []
        self.device = next(iter(params.values())).device
        #: the host copy of the custody matrix (None without a custody
        #: lane): who holds what, for callers to inspect after a run
        self.custody_matrix: Optional[np.ndarray] = (
            assign_matrix(len(self.nodes), cfg.custody.num_shards,
                          cfg.custody.redundancy, cfg.custody.seed,
                          cfg.custody.max_fraction)
            if cfg.custody is not None else None)
        if cfg.verification:
            for node in self.nodes:
                self.ledger.stake(node.node_id, cfg.verification.stake)

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        raise NotImplementedError

    def _coverage_of(self, active_idxs: Sequence[int]) -> float:
        """The live shard coverage of the given active node indices, in
        float64 on the host (1.0 without a custody lane)."""
        if self.custody_matrix is None:
            return 1.0
        if not len(active_idxs):
            return 0.0
        return float(self.custody_matrix[list(active_idxs)].any(0).mean())

    def _slash(self, node: NodeSpec) -> None:
        self.ledger.slash(node.node_id)
        self.ledger.pay_jackpot("validator", self.cfg.verification.jackpot)
        self.slashed.add(node.node_id)

    def eval_params(self):
        """The params an ``eval_fn`` should see: the decentralized engine
        returns the consensus (node-mean) replica."""
        return self.params

    def run(self, rounds: int, eval_fn: Optional[Callable] = None,
            eval_every: int = 10) -> List[float]:
        """Step rounds 0..rounds-1; ``eval_fn(params)`` every ``eval_every``
        rounds and after the last.  (The reference's ``Swarm.run`` scans
        when no ``eval_fn`` is given; the port always steps, and its scanned
        run is :func:`scan_rounds`.)"""
        losses = []
        for r in range(rounds):
            rec = self.step(r)
            if eval_fn and (r % eval_every == 0 or r == rounds - 1):
                rec["eval_loss"] = float(eval_fn(self.eval_params()))
                losses.append(rec["eval_loss"])
        return losses


class Swarm(_SwarmBase):
    """The batched engine: a thin wrapper that steps the round of
    :func:`make_round_fn` and keeps the host ledger.  Inactive nodes still
    occupy a row of the stack (their gradient is computed and then masked),
    as in the reference.  It also carries the device mint counter
    (``contrib``) across steps, as a lane of :func:`run_campaign` does.

    ``cfg.topology`` switches it to the decentralized round: ``params`` and
    ``opt_state`` become per-node replicas and optimizer states (leading N
    axis), history rows carry a nonzero ``consensus_error``, and
    :meth:`eval_params` returns the consensus (node-mean) replica.
    ``cfg.staleness_bound`` runs the async round, the engine carrying its
    snapshot ring from step to step (rounds then step from 0 in order);
    ``cfg.custody`` records the coverage each round; ``cfg.economy``
    carries the ``EconState`` (``_econ_state``) from step to step, and the
    history rows, whose ``n_active`` is the device record's (admission is
    gated by stakes), gain ``coalition_stake``.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        super().__init__(loss_fn, params, optimizer, nodes, cfg, data_fn)
        n = len(self.nodes)
        self._lane = lane_for_nodes(self.nodes, cfg, self.device)
        self._joins_np = np.asarray([s.join_round for s in self.nodes], np.int64)
        self._leaves_np = np.asarray(
            [_FAR if s.leave_round is None else s.leave_round for s in self.nodes],
            np.int64)
        self._slashed_np = np.zeros(n, bool)
        #: the device mint counter, carried across steps as a scanned run
        #: carries it (speed-weighted kept rounds; frozen once slashed)
        self.contrib = torch.zeros(n, dtype=torch.float32, device=self.device)
        self._decentralized = cfg.topology is not None
        self._core = make_round_fn(
            loss_fn, optimizer, self.params, n,
            aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs,
            compression_kind=cfg.compression,
            compression_kwargs=cfg.compression_kwargs,
            verify=cfg.verification is not None,
            decentralized=self._decentralized,
            mixing_schedule="clamp" if cfg.churn_coupled else "cycle",
            fused=cfg.fused, staleness_bound=cfg.staleness_bound)
        if self._decentralized:
            # per-node replicas and optimizer states from round 0
            init = init_decentralized_state(self.params, optimizer, n)
            self.params, self.opt_state = init.params, init.opt_state
        #: the async round's snapshot ring (None when synchronous), engine
        #: state like params and opt_state, advanced by every round
        self._ring = init_ring(self.params, cfg.staleness_bound)
        #: the economy state (None without an economy lane), likewise
        self._econ_state = (economy.init_econ_state(self._lane.econ, n)
                            if self._lane.econ is not None else None)

    @property
    def fused(self) -> bool:
        return self._core.fused

    def _state(self) -> SwarmState:
        return SwarmState(
            params=self.params, opt_state=self.opt_state,
            slashed=torch.as_tensor(self._slashed_np, device=self.device),
            contrib=self.contrib, ring=self._ring, econ=self._econ_state)

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        active_np = ((self._joins_np <= rnd) & (rnd < self._leaves_np)
                     & ~self._slashed_np)
        if not active_np.any():
            raise RuntimeError(f"round {rnd}: no active nodes")
        batches = [self.data_fn(i, rnd) for i in range(len(self.nodes))]
        state, rec = self._core(self._lane, self._state(), rnd, batches, draws)
        self.params, self.opt_state = state.params, state.opt_state
        self.contrib, self._ring, self._econ_state = state.contrib, state.ring, state.econ
        row = history_from_records([rec], [n.node_id for n in self.nodes],
                                   start_round=rnd)[0]
        for i in np.flatnonzero(rec.caught.cpu().numpy()):
            self._slash(self.nodes[int(i)])
            self._slashed_np[int(i)] = True
        for i in np.flatnonzero(rec.keep.cpu().numpy()):
            node = self.nodes[int(i)]
            self.ledger.record_contribution(node.node_id, node.speed)
        self.history.append(row)
        return row

    def eval_params(self):
        return consensus_params(self.params) if self._decentralized else self.params


class SequentialSwarm(_SwarmBase):
    """The per-node engine: the readable twin of the reference's
    ``SequentialSwarm``, held against :class:`Swarm`.

    Each round loops over the active nodes only: a flat float32 gradient
    each (the reference's flat order), corruption with the honest mean of
    the active nodes, the wire (``compression.roundtrip``, decoded), audits
    that recompute the gradient and re-encode it with the submitter's wire
    draw, then the dense aggregator of ``core.aggregation`` over the
    compacted (k, D) stack of the survivors.  The draws are the batched
    engine's: the same ``(seed, purpose, round, node)`` generators, or the
    caller's ``draws``.  Bounded staleness (``cfg.staleness_bound > 0``)
    keeps a dict of the last K+1 param snapshots, each node's delay drawn
    on the host from the same schedule as the batched engine's (rounds
    then step from 0 in order; ``run`` does), and the audit recomputes at
    the node's snapshot.  A custody lane's coverage is the float64 mean of
    the host custody matrix, as in the reference.  It is centralized-only,
    as the reference's: a topology raises ``ValueError``.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        if cfg.topology is not None:
            raise ValueError("the sequential reference engine is "
                             "centralized-only; decentralized topologies "
                             "need engine='batched'")
        super().__init__(loss_fn, params, optimizer, nodes, cfg, data_fn)
        if cfg.compression not in compression.WIRE_CODECS:
            raise ValueError(f"unknown wire codec: {cfg.compression!r} "
                             f"(known: {compression.WIRE_CODECS})")
        self._layout = layout_of(params)
        self._d = flat_size(self._layout)
        self._draw = compression.wire_draw(cfg.compression, self._d,
                                           **cfg.compression_kwargs)
        self._aggregate = aggregation.get_aggregator(cfg.aggregator, **cfg.agg_kwargs)
        self._snapshots: Dict[int, Any] = {}     # round -> params (async only)

    def _gradient(self, params, batch) -> torch.Tensor:
        g = torch.empty(self._d, dtype=torch.float32, device=self.device)
        flatten_into(g, _node_gradient(self.loss_fn, params, batch))
        return g

    def _wire(self, g: torch.Tensor, rr: RoundRandom, node: int) -> torch.Tensor:
        return compression.roundtrip(self.cfg.compression, _wire_draw(rr, self._draw, node),
                                     g, **self.cfg.compression_kwargs)

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        cfg, dev = self.cfg, self.device
        active = [(i, n) for i, n in enumerate(self.nodes)
                  if n.active(rnd) and n.node_id not in self.slashed]
        if not active:
            raise RuntimeError(f"round {rnd}: no active nodes")
        rr = RoundRandom(cfg.seed, rnd, dev, draws)
        K = cfg.staleness_bound
        delays = [0] * len(active)
        snapshots = [self.params] * len(active)
        if K > 0:
            # the ring's readable twin: this round's params, and the last K
            # rounds'; a node drawing delay d reads round rnd - d's
            self._snapshots[rnd] = self.params
            for old in [r for r in self._snapshots if r < rnd - K]:
                del self._snapshots[old]
            delays = [rr.delay(i, min(node.effective_delay, K, rnd)) for i, node in active]
            snapshots = [self._snapshots[rnd - d] for d in delays]
        batches = [self.data_fn(i, rnd) for i, _ in active]
        grads = [self._gradient(p, b) for p, b in zip(snapshots, batches)]

        # corruption and the wire; the honest mean is the batched engine's
        # masked sum, added in node order, over the active count
        honest_mean = None
        if any(n.byzantine == "inner_product" for _, n in active):
            acc = torch.zeros(self._d, dtype=torch.float32, device=dev)
            for g in grads:
                acc = acc + g
            honest_mean = acc / torch.full((), float(len(active)), device=dev)
        submitted = []
        for (i, node), g in zip(active, grads):
            if node.byzantine:
                scale = torch.tensor(node.byzantine_scale, dtype=torch.float32, device=dev)
                noise = rr.corrupt(i, self._d) if node.byzantine == "noise" else None
                g = corrupt(node.byzantine, g, honest_mean, scale, noise)
            submitted.append(self._wire(g, rr, i))
        del grads, honest_mean

        # stake/slash audits (§4.2): recompute, re-encode with the
        # submitter's wire draw, compare with audit_flat
        caught, keep = [], [True] * len(active)
        if cfg.verification:
            v = cfg.verification
            for j, (i, node) in enumerate(active):
                if not bool(rr.audit_sel(i) < v.p_check):
                    continue
                # at the node's own (possibly stale) snapshot: the delay is
                # part of its claim, so staleness alone never slashes
                recomputed = self._wire(self._gradient(snapshots[j], batches[j]), rr, i)
                ok, _ = audit_flat(submitted[j], recomputed, rr.audit_noise(i, self._d), v)
                if not bool(ok):
                    self._slash(node)
                    caught.append(node.node_id)
                    keep[j] = False

        # aggregation of the compacted survivors, the optimizer update
        kept = [x for x, k in zip(submitted, keep) if k]
        del submitted
        if kept:
            survivors = torch.stack(kept)
            del kept
            agg = self._aggregate(survivors)
            del survivors
            self.params, self.opt_state = self.optimizer.update(
                unflatten(agg, self._layout), self.opt_state, self.params)
        else:
            agg = torch.zeros(self._d, dtype=torch.float32, device=dev)

        # mint shares in proportion to verified work (speed-weighted) (§4)
        for (_, node), k in zip(active, keep):
            if k:
                self.ledger.record_contribution(node.node_id, node.speed)
        rec = {
            "round": rnd,
            "n_active": len(active),
            "n_byzantine": sum(1 for _, n in active if n.byzantine),
            "caught": caught,
            "agg_norm": float(torch.linalg.vector_norm(agg)),
            "consensus_error": 0.0,
            "coverage": self._coverage_of([i for i, _ in active]),
            # a float32 division, as the batched engine's record
            "staleness": float(np.float32(sum(delays)) / np.float32(max(len(active), 1))),
        }
        self.history.append(rec)
        return rec


ENGINES = {"batched": Swarm, "sequential": SequentialSwarm}


def make_swarm(loss_fn, params, optimizer, nodes: List[NodeSpec], cfg: SwarmConfig,
               data_fn, *, engine: str = "batched") -> _SwarmBase:
    """Build a swarm with the requested engine (``ENGINES``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine: {engine!r} (known: {sorted(ENGINES)})")
    return ENGINES[engine](loss_fn, params, optimizer, nodes, cfg, data_fn)
