"""Scenario registry: named, reproducible swarm configurations (twin of
``repro/core/scenarios.py``).

A :class:`Scenario` is a factory: it scales to any node count and builds
the ``(nodes, SwarmConfig)`` pair or a ready-to-run swarm on either engine.
Every scenario of the reference is registered here: the eight of the
centralized synchronous round, the three of the decentralized round, the
two custody scenarios, the three async ones and the two economy ones.
:func:`scenario_campaign` runs one scenario across seeds as one campaign
(``swarm.run_campaign``).

:class:`SweepGrid` names the §5.5 derailment phase-diagram grids that
``core.derailment.sweep`` consumes: every grid of the reference, the
economy grids included.  :class:`ServingGrid` names the serving grids
that ``core.serving.sweep`` consumes: every serving grid of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.economy import EconomyConfig
from repro_torch.core.swarm import (
    NodeSpec,
    SwarmConfig,
    lane_for_nodes,
    make_swarm,
    run_campaign,
    stack_lanes,
)
from repro_torch.core.unextractable import CustodyConfig
from repro_torch.core.verification import VerificationConfig


@dataclass(frozen=True)
class Scenario:
    """A named, size-scalable swarm regime.

    ``make_nodes(n)`` returns the node roster for an ``n``-node swarm;
    ``make_config(seed)`` the matching :class:`SwarmConfig`.  Both are pure,
    so the same (name, n, seed) triple always reproduces the same run.
    """
    name: str
    description: str
    make_nodes: Callable[[int], List[NodeSpec]]
    make_config: Callable[[int], SwarmConfig]
    default_nodes: int = 16

    def build(self, n_nodes: Optional[int] = None, seed: int = 0
              ) -> Tuple[List[NodeSpec], SwarmConfig]:
        n = self.default_nodes if n_nodes is None else n_nodes
        if n < 2:
            raise ValueError(f"scenario {self.name!r} needs >= 2 nodes, got {n}")
        return self.make_nodes(n), self.make_config(seed)

    def build_swarm(self, loss_fn, params, optimizer, data_fn, *,
                    n_nodes: Optional[int] = None, seed: int = 0,
                    engine: str = "batched"):
        """Instantiate a swarm for this scenario on the requested engine."""
        nodes, cfg = self.build(n_nodes, seed)
        return make_swarm(loss_fn, params, optimizer, nodes, cfg, data_fn,
                          engine=engine)


SCENARIOS: Dict[str, Scenario] = {}

#: the reference's scenarios that need a later axis of the round -> the
#: ROADMAP queue 1 item each waits for (none: every axis is ported)
WAITING_SCENARIOS: Dict[str, int] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (overwrites an existing name)."""
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    if name in SCENARIOS:
        return SCENARIOS[name]
    if name in WAITING_SCENARIOS:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet "
            f"(ROADMAP queue 1, item {WAITING_SCENARIOS[name]})")
    raise KeyError(f"unknown scenario {name!r}; registered: {list_scenarios()}")


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def batched_data_fn_for(data_fn: Callable[[int, int], dict], n_nodes: int,
                        ) -> Callable[[int], list]:
    """Lift a per-node ``data_fn(node_idx, rnd)`` into one ``fn(rnd)`` that
    gives the round's N batches (the round takes a sequence of per-node
    batches, so this is the list of N calls)."""
    def fn(rnd: int) -> list:
        return [data_fn(i, rnd) for i in range(n_nodes)]
    return fn


# -- helpers -------------------------------------------------------------------
def _mixed_nodes(n: int, n_byz: int, attack: str, scale: float,
                 speeds: Tuple[float, ...] = (1.0,),
                 delays: Tuple[int, ...] = (0,),
                 byz_delay: int = 0) -> List[NodeSpec]:
    """n - n_byz honest nodes (speeds/delays cycling) then n_byz attackers."""
    nodes = [NodeSpec(f"h{i}", speed=speeds[i % len(speeds)],
                      delay=delays[i % len(delays)])
             for i in range(n - n_byz)]
    nodes += [NodeSpec(f"adv{i}", byzantine=attack, byzantine_scale=scale,
                       delay=byz_delay)
              for i in range(n_byz)]
    return nodes


# -- the registry --------------------------------------------------------------
register_scenario(Scenario(
    name="honest_baseline",
    description=("All nodes honest, equal speed, mean aggregation, no "
                 "verification or compression.  The control every other "
                 "scenario is read against."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0),
    make_config=lambda seed: SwarmConfig(aggregator="mean", seed=seed),
))

register_scenario(Scenario(
    name="sign_flip_minority",
    description=("A 25% minority submits sign-flipped, 10x-amplified "
                 "gradients (§3.3).  CenteredClip aggregation holds within "
                 "its breakdown point."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "sign_flip", 10.0),
    make_config=lambda seed: SwarmConfig(aggregator="centered_clip", seed=seed),
))

register_scenario(Scenario(
    name="inner_product_collusion",
    description=("A 25% coalition colludes on the [87]-style inner-product "
                 "attack: every attacker submits -scale x the honest mean, "
                 "the strongest directed attack in the corruption table.  "
                 "CenteredClip aggregation."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "inner_product", 20.0),
    make_config=lambda seed: SwarmConfig(aggregator="centered_clip", seed=seed),
))

def _churn_nodes(n: int) -> List[NodeSpec]:
    core = max(2, n // 3)
    nodes = [NodeSpec(f"core{i}") for i in range(core)]
    for i in range(n - core):
        join = 1 + (i % 6)
        nodes.append(NodeSpec(f"churn{i}", join_round=join,
                              leave_round=join + 8 + (i % 5)))
    return nodes

register_scenario(Scenario(
    name="high_churn_elastic",
    description=("Elastic membership stress (§3 property 3): a third of the "
                 "swarm is always on; the rest join and leave on staggered "
                 "1-6 round offsets with 8-12 round lifetimes.  The batched "
                 "engine must absorb this churn without recompiling."),
    make_nodes=_churn_nodes,
    make_config=lambda seed: SwarmConfig(aggregator="mean", seed=seed),
))

register_scenario(Scenario(
    name="heterogeneous_speed",
    description=("Heterogeneous capacity (§3 property 5): node speeds cycle "
                 "0.5x/1x/2x/4x and minted ownership shares must stay "
                 "proportional to speed-weighted verified work (§4)."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0,
                                      speeds=(0.5, 1.0, 2.0, 4.0)),
    make_config=lambda seed: SwarmConfig(aggregator="mean", seed=seed),
))

register_scenario(Scenario(
    name="compressed_wire",
    description=("Communication efficiency (§3.1): every gradient is "
                 "round-tripped through 64-level bucketed QSGD before "
                 "aggregation.  Honest swarm; measures what lossy wires cost "
                 "in convergence."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="mean", compression="qsgd",
        compression_kwargs={"levels": 64, "bucket_size": 512}, seed=seed),
))

register_scenario(Scenario(
    name="audit_heavy",
    description=("Verification economics (§4.2): a 25% freeloader minority "
                 "submits zero gradients; validators audit half of all "
                 "updates per round (p_check=0.5), slashing stake and paying "
                 "jackpots until the freeloaders are excluded."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "zero", 0.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="mean",
        verification=VerificationConfig(p_check=0.5, stake=5.0,
                                        tolerance=1e-3, jackpot=5.0),
        seed=seed),
))

register_scenario(Scenario(
    name="derailment_stress",
    description=("The No-Off stress case (§5.5): a 40% inner-product "
                 "coalition at 50x scale tries to derail the run against "
                 "CenteredClip aggregation plus stake/slash audits at "
                 "p_check=0.25 — the regime where the paper argues only "
                 "physical intervention remains."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, (2 * n) // 5),
                                      "inner_product", 50.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="centered_clip",
        verification=VerificationConfig(p_check=0.25, stake=10.0,
                                        tolerance=1e-3, jackpot=5.0),
        seed=seed),
))

register_scenario(Scenario(
    name="gossip_ring_honest",
    description=("Fully decentralized honest swarm (§3.2): per-node model "
                 "replicas on a ring, each node mean-aggregates its "
                 "neighborhood and replicas gossip-mix once per round.  "
                 "Convergence and consensus_error are gated by the ring's "
                 "O(1/n²) spectral gap — the no-central-aggregator control."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0),
    make_config=lambda seed: SwarmConfig(aggregator="mean", topology="ring",
                                         seed=seed),
))

register_scenario(Scenario(
    name="byzantine_neighborhood",
    description=("Decentralized robustness (§3.3 x §3.2): a 25% sign-flip "
                 "minority attacks a degree-4 random-regular gossip graph; "
                 "every node CenteredClips its *own* neighborhood, so an "
                 "attacker can exceed the breakdown point locally even "
                 "while globally below it."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "sign_flip", 10.0),
    make_config=lambda seed: SwarmConfig(aggregator="centered_clip",
                                         topology="random_regular",
                                         seed=seed),
))

register_scenario(Scenario(
    name="custody_leech",
    description=("Unextractability under attack (§4.1): a 25% leech "
                 "minority submits zero gradients while doubling as the "
                 "extraction coalition.  Redundancy-2 custody with a 0.4 "
                 "per-node bound keeps the coalition below full shard "
                 "coverage, so the reconstruct-attack eval prices their "
                 "reassembled model as garbage; the live coverage trace "
                 "stays at 1.0 (leeches keep relaying custody).  The leech "
                 "count is ceil(n/4) so it coincides with the coalition "
                 "tail mask (ceil(0.25 * n)) at every roster size."),
    make_nodes=lambda n: _mixed_nodes(n, -(-n // 4), "zero", 0.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="mean", seed=seed,
        custody=CustodyConfig(num_shards=16, redundancy=2,
                              max_fraction=0.4, coalition_fraction=0.25)),
))


def _collapse_nodes(n: int) -> List[NodeSpec]:
    core = max(2, n // 3)
    nodes = [NodeSpec(f"core{i}") for i in range(core)]
    for i in range(n - core):
        nodes.append(NodeSpec(f"leaver{i}", leave_round=3 + 2 * (i % 4)))
    return nodes


register_scenario(Scenario(
    name="custody_churn_collapse",
    description=("Custody-coupled churn (§4.1 x §3 property 3): two thirds "
                 "of the swarm departs on staggered rounds and never "
                 "returns, against redundancy-2 custody.  Once every holder "
                 "of some shard has left, the live coverage "
                 "(RoundRecord.coverage) collapses below 1.0 — the model "
                 "is no longer fully held by anyone; the swarm 'degraded' "
                 "regime of the extractability phase table."),
    make_nodes=_collapse_nodes,
    make_config=lambda seed: SwarmConfig(
        aggregator="mean", seed=seed,
        custody=CustodyConfig(num_shards=16, redundancy=2, max_fraction=0.5)),
))

register_scenario(Scenario(
    name="straggler_majority",
    description=("Bounded-staleness asynchrony (§3 property 5): two thirds "
                 "of an honest swarm are stragglers gradienting against "
                 "parameter snapshots up to 3 rounds old (delay cycles "
                 "0/3/3, speeds 1x/0.5x/0.5x) under staleness_bound=3, "
                 "mean aggregation.  The convergence price of *not* "
                 "waiting for the slow majority — the DOWNPOUR regime."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0, speeds=(1.0, 0.5, 0.5),
                                      delays=(0, 3, 3)),
    make_config=lambda seed: SwarmConfig(aggregator="mean", staleness_bound=3,
                                         seed=seed),
))

register_scenario(Scenario(
    name="stale_poisoning",
    description=("Stale Byzantine updates (§3.3 x asynchrony): a 25% "
                 "sign-flip minority submits maximally stale poisoned "
                 "gradients (delay=3) while honest nodes run fresh — does "
                 "CenteredClip's breakdown point survive when the attack "
                 "rides the staleness the protocol must tolerate?  Audits "
                 "recompute against the claimed stale snapshot (the delay "
                 "is part of the claim), so staleness alone never "
                 "slashes — only corruption does."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "sign_flip", 10.0,
                                      byz_delay=3),
    make_config=lambda seed: SwarmConfig(
        aggregator="centered_clip",
        verification=VerificationConfig(p_check=0.25, stake=10.0,
                                        tolerance=1e-3, jackpot=5.0),
        staleness_bound=3, seed=seed),
))


def _async_churn_nodes(n: int) -> List[NodeSpec]:
    core = max(2, n // 3)
    nodes = [NodeSpec(f"core{i}", delay=i % 3) for i in range(core)]
    for i in range(n - core):
        join = 1 + (i % 6)
        nodes.append(NodeSpec(f"churn{i}", join_round=join,
                              leave_round=join + 8 + (i % 5), delay=1 + (i % 2)))
    return nodes


register_scenario(Scenario(
    name="async_churn",
    description=("Asynchrony x elastic membership (§3 properties 3+5): the "
                 "high_churn_elastic roster with per-node staleness (core "
                 "delays cycle 0/1/2, transients 1/2) under "
                 "staleness_bound=2 — late joiners gradient against "
                 "snapshots taken before they were active, the hardest "
                 "bookkeeping case for the snapshot ring."),
    make_nodes=_async_churn_nodes,
    make_config=lambda seed: SwarmConfig(aggregator="mean", staleness_bound=2,
                                         seed=seed),
))

register_scenario(Scenario(
    name="economy_rational",
    description=("The §4 incentive control: a 25% inner-product coalition "
                 "buys identities from one capital budget (identity cost "
                 "1.0, bond 5.0) against CenteredClip + p_check=0.5 audits, "
                 "while fees and rewards pay honest stakes — the schedule "
                 "the paper argues sustains rational participation.  "
                 "Admission is stake-gated on the device; slashed or "
                 "insolvent nodes drop out of aggregation for good."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 4), "inner_product", 20.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="centered_clip",
        verification=VerificationConfig(p_check=0.5, stake=5.0,
                                        tolerance=1e-3, jackpot=5.0),
        economy=EconomyConfig(),
        seed=seed),
))

register_scenario(Scenario(
    name="economy_sybil_adaptive",
    description=("Sybil pressure meets an adaptive adversary (§4 x §5.5): "
                 "identities are cheap (cost 0.1), so the coalition's "
                 "budget buys a count majority, and instead of a fixed "
                 "behaviour it best-responds each round — scoring a menu "
                 "of attack scales against the known aggregator and "
                 "submitting the one that pushes the aggregate hardest "
                 "against honest descent.  Sparse audits (p_check=0.1) "
                 "price what adaptivity buys that fixed attacks don't."),
    make_nodes=lambda n: _mixed_nodes(n, max(1, n // 2), "inner_product", 20.0),
    make_config=lambda seed: SwarmConfig(
        aggregator="centered_clip",
        verification=VerificationConfig(p_check=0.1, stake=5.0,
                                        tolerance=1e-3, jackpot=5.0),
        economy=EconomyConfig(identity_cost=0.1, adaptive=True),
        seed=seed),
))

register_scenario(Scenario(
    name="partitioned_swarm",
    description=("Near-partition stress (§5.5): two ring clusters joined "
                 "by a single bridge edge (near-zero spectral gap).  "
                 "Honest swarm; consensus leaks across the bridge one edge "
                 "per round, so consensus_error decays at the bridge rate, "
                 "not the cluster rate."),
    make_nodes=lambda n: _mixed_nodes(n, 0, "zero", 0.0),
    make_config=lambda seed: SwarmConfig(aggregator="mean",
                                         topology="clustered", seed=seed),
))


# -- campaigns over scenarios ----------------------------------------------------
def scenario_campaign(name: str, loss_fn, params, optimizer, data_fn, *,
                      n_nodes: Optional[int] = None, seeds: Tuple[int, ...] = (0,),
                      rounds: int, eval_fn: Optional[Callable] = None):
    """Run one scenario across many seeds as one campaign (lane *k* is
    ``seeds[k]``).

    Returns ``(state, records, final_losses, node_ids, cfg)``: every output
    leaf carries a leading seed axis, and lane *k* reproduces the single-run
    ``Swarm`` of the same (scenario, seed) bit for bit — see
    ``swarm.history_from_records`` / ``swarm.ledger_from_run`` for turning
    a lane back into host-side history and ledger.
    """
    scn = get_scenario(name)
    nodes, cfg = scn.build(n_nodes, seeds[0])
    dev = next(iter(params.values())).device
    lanes = stack_lanes([lane_for_nodes(nodes, scn.make_config(s), dev)
                         for s in seeds])
    state, recs, final = run_campaign(
        loss_fn, params, optimizer, data_fn, lanes, rounds=rounds,
        aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs,
        compression_kind=cfg.compression,
        compression_kwargs=cfg.compression_kwargs,
        verify=cfg.verification is not None, eval_fn=eval_fn)
    return state, recs, final, [n.node_id for n in nodes], cfg


# -- derailment sweep grids (§5.5 phase diagrams) --------------------------------
@dataclass(frozen=True)
class Regime:
    """One (aggregator, verification) column of the §5.5 phase diagram.

    ``agg_kwargs`` are *static* aggregator kwargs (the round's aggregator
    set holds one entry per distinct (aggregator, static kwargs));
    per-run kwargs (krum's ``f`` tracking the attacker count) are added
    to the lanes by ``derailment.sweep`` itself.
    """
    name: str
    aggregator: str
    agg_kwargs: Dict = field(default_factory=dict)
    verification: Optional[VerificationConfig] = None


@dataclass(frozen=True)
class SweepGrid:
    """A named derailment sweep: the cartesian grid (attacker counts ×
    scales × seeds) per regime that ``derailment.sweep`` runs as the lanes
    of one campaign, with an honest baseline lane per seed.

    A non-empty ``topologies`` adds the decentralized axis: every cell is
    crossed with each named ``core.topology`` entry and runs the
    decentralized round (per-node replicas, neighbourhood aggregation,
    gossip mixing; the mixing matrix rides on the lane), with honest
    baselines per (topology, seed).  Empty means centralized.

    Non-empty ``redundancies`` / ``coalition_fractions`` add the custody
    axis (§4.1): every cell is crossed with each (redundancy, coalition
    fraction) pair, the (N, ``num_shards``) custody matrix (per-node bound
    ``custody_max_fraction``) and the coalition mask ride on the lane, the
    round records the live coverage and the eval the reconstruct-attack
    loss beside the honest one (``SweepResult.extractability_table``).
    ``custody_leave_fraction > 0`` staggers that fraction of the honest
    roster out of the run (drawn per seed), what drives redundancy-starved
    cells into the "degraded" regime.

    A non-empty ``staleness_bounds`` adds the asynchrony axis: every cell
    is crossed with each bound K, its nodes taking their gradients at
    snapshots up to K rounds old.  The per-node caps ride on the lane and
    the ring is sized by the largest bound, so every bound, 0 included,
    runs in one campaign; honest baselines are per (topology, staleness
    bound, seed).

    Every field of the reference's grid is here, so every grid registers
    as data.  ``identity_costs`` / ``fees`` / ``reward_schedules`` /
    ``adaptive`` with the ``econ_*`` knobs are the economy axes: a grid
    that sets one gives every lane an economy, the attacker slots its
    coalition, funded from the grid's one budget."""
    name: str
    description: str
    regimes: Tuple[Regime, ...]
    n_honest: int = 10
    attacker_counts: Tuple[int, ...] = (1, 3, 6, 12)
    seeds: Tuple[int, ...] = (0, 1, 2)
    scales: Tuple[float, ...] = (50.0,)
    attack: str = "inner_product"
    rounds: int = 25
    topologies: Tuple[str, ...] = ()
    redundancies: Tuple[int, ...] = ()
    coalition_fractions: Tuple[float, ...] = ()
    num_shards: int = 16
    custody_max_fraction: float = 0.5
    custody_leave_fraction: float = 0.0
    staleness_bounds: Tuple[int, ...] = ()
    # -- economy axes (§4): empty on all four = no economy lane --------------
    identity_costs: Tuple[float, ...] = ()
    fees: Tuple[float, ...] = ()
    reward_schedules: Tuple[Tuple[float, float], ...] = ()  # (rate, jackpot)
    adaptive: Tuple[bool, ...] = ()
    econ_budget: float = 50.0        # the coalition's total capital
    econ_min_stake: float = 5.0      # admission bond
    econ_op_cost: float = 0.05       # per-round operating cost per unit speed
    econ_reserve: float = 1.0        # honest starting balance

    @property
    def has_custody(self) -> bool:
        return bool(self.redundancies) or bool(self.coalition_fractions)

    @property
    def has_economy(self) -> bool:
        return bool(self.identity_costs) or bool(self.fees) \
            or bool(self.reward_schedules) or bool(self.adaptive)

    @property
    def n_points(self) -> int:
        return (len(self.regimes) * len(self.attacker_counts)
                * len(self.scales) * len(self.seeds)
                * max(1, len(self.topologies))
                * max(1, len(self.staleness_bounds))
                * max(1, len(self.redundancies))
                * max(1, len(self.coalition_fractions))
                * max(1, len(self.identity_costs))
                * max(1, len(self.fees))
                * max(1, len(self.reward_schedules))
                * max(1, len(self.adaptive)))

    @property
    def n_lanes(self) -> int:
        """Total campaign lanes ``derailment.sweep`` builds for this grid:
        every measured point plus the shared honest-baseline lanes (one per
        (topology, staleness bound, seed)), as the reference counts
        them."""
        return self.n_points + (max(1, len(self.topologies))
                                * max(1, len(self.staleness_bounds))
                                * len(self.seeds))


SWEEP_GRIDS: Dict[str, SweepGrid] = {}


def register_sweep_grid(grid: SweepGrid) -> SweepGrid:
    SWEEP_GRIDS[grid.name] = grid
    return grid


def get_sweep_grid(name: str) -> SweepGrid:
    try:
        return SWEEP_GRIDS[name]
    except KeyError:
        raise KeyError(f"unknown sweep grid {name!r}; "
                       f"registered: {list_sweep_grids()}") from None


def list_sweep_grids() -> List[str]:
    return sorted(SWEEP_GRIDS)


_AUDIT = VerificationConfig(p_check=0.25, stake=10.0, tolerance=1e-3,
                            jackpot=5.0)
_PERFECT_AUDIT = VerificationConfig(p_check=1.0, stake=5.0, tolerance=1e-3,
                                    jackpot=5.0)

register_sweep_grid(SweepGrid(
    name="no_off_quick",
    description=("The benchmark grid: 4 attacker fractions x 3 seeds x "
                 "2 regimes (mean / CenteredClip+audits) = 24 runs in one "
                 "fused compiled program."),
    regimes=(Regime("mean", "mean"),
             Regime("centered_clip+audit", "centered_clip",
                    verification=_AUDIT)),
))

register_sweep_grid(SweepGrid(
    name="no_off_phase",
    description=("The paper's full §5.5 table: mean (off-switch works), "
                 "CenteredClip (breakdown point), and mean under "
                 "near-perfect verification (derailment slashed away).  "
                 "All three regimes fuse into one program — p_check is a "
                 "traced lane, the aggregator a per-lane id."),
    regimes=(Regime("mean", "mean"),
             Regime("centered_clip", "centered_clip"),
             Regime("mean+verified", "mean", verification=_PERFECT_AUDIT)),
))

register_sweep_grid(SweepGrid(
    name="no_off_smoke",
    description="CI smoke: 2 counts x 1 seed x 2 regimes = 4 tiny runs.",
    regimes=(Regime("mean", "mean"),
             Regime("centered_clip", "centered_clip")),
    n_honest=6,
    attacker_counts=(2, 6),
    seeds=(0,),
    rounds=8,
))

register_sweep_grid(SweepGrid(
    name="no_off_topology",
    description=("The decentralized §5.5 diagram: at what spectral gap "
                 "does local robust aggregation stop resisting "
                 "derailment?  2 regimes x 4 topologies x 3 fractions x "
                 "2 seeds, all lanes (and per-topology baselines) in one "
                 "compiled program — the mixing matrix is a traced lane."),
    regimes=(Regime("mean", "mean"),
             Regime("centered_clip", "centered_clip")),
    topologies=("ring", "random_regular", "clustered", "fully_connected"),
    n_honest=10,
    attacker_counts=(1, 3, 6),
    seeds=(0, 1),
    rounds=20,
))

register_sweep_grid(SweepGrid(
    name="no_off_async",
    description=("The asynchrony frontier (§5.5 x §3): does CenteredClip's "
                 "breakdown point survive *stale* Byzantine updates?  2 "
                 "regimes x 3 staleness bounds x 3 attacker counts x 2 "
                 "seeds — every bound shares one compiled program (per-node "
                 "delay caps are a traced lane over the max bound's ring), "
                 "so staleness x attacker-fraction renders like any other "
                 "phase diagram."),
    regimes=(Regime("mean", "mean"),
             Regime("centered_clip", "centered_clip")),
    staleness_bounds=(0, 2, 4),
    n_honest=10,
    attacker_counts=(1, 3, 6),
    seeds=(0, 1),
    rounds=20,
))

register_sweep_grid(SweepGrid(
    name="no_off_async_smoke",
    description=("CI smoke for the asynchrony axis: 1 regime x 2 staleness "
                 "bounds x 2 counts x 1 seed = 4 tiny runs."),
    regimes=(Regime("centered_clip", "centered_clip"),),
    staleness_bounds=(0, 2),
    n_honest=6,
    attacker_counts=(2, 6),
    seeds=(0,),
    rounds=8,
))

register_sweep_grid(SweepGrid(
    name="custody_frontier",
    description=("The §4.1 extractability frontier: at what redundancy and "
                 "coalition fraction does a swarm stop being a Protocol "
                 "Model?  (redundancy x coalition fraction x churn seed) "
                 "cells, each with the reconstruct-attack eval, in one "
                 "compiled program; a third of the honest roster churns "
                 "out mid-run, so low-redundancy cells degrade."),
    regimes=(Regime("mean", "mean"),),
    n_honest=10,
    attacker_counts=(0,),
    seeds=(0, 1, 2),
    rounds=20,
    redundancies=(1, 2, 3),
    coalition_fractions=(0.2, 0.4, 0.6, 0.8, 1.0),
    num_shards=12,
    custody_max_fraction=0.4,
    custody_leave_fraction=0.3,
))

register_sweep_grid(SweepGrid(
    name="custody_smoke",
    description=("CI smoke for the custody axis: 2 redundancies x 2 "
                 "coalition fractions x 1 seed = 4 tiny runs with the "
                 "reconstruct-attack eval."),
    regimes=(Regime("mean", "mean"),),
    n_honest=6,
    attacker_counts=(0,),
    seeds=(0,),
    rounds=8,
    redundancies=(1, 2),
    coalition_fractions=(0.5, 1.0),
    num_shards=8,
    custody_max_fraction=0.5,
    custody_leave_fraction=0.34,
))

register_sweep_grid(SweepGrid(
    name="no_off_economy",
    description=("The §4 incentive phase diagram: at what identity cost "
                 "and fee schedule does rational participation survive a "
                 "strategic coalition?  2 regimes x 3 identity costs x 3 "
                 "fees x 2 reward schedules x fixed-vs-adaptive x 2 seeds "
                 "= 144 lanes (+ baselines) in ONE compiled program — "
                 "every economy knob is a traced lane, the adaptive "
                 "best-response an in-program inner step.  Each lane is "
                 "classified sustained / death_spiral / captured; the "
                 "fixed-vs-adaptive gap is the paper's open question "
                 "rendered as a phase-diagram delta.  The fixed attack "
                 "runs at a moderate scale (2.0); the adaptive coalition "
                 "recalibrates per round, so the gap concentrates in the "
                 "weakly-defended (mean) regime and robust aggregation "
                 "closes it."),
    regimes=(Regime("mean+audit", "mean", verification=_AUDIT),
             Regime("centered_clip+audit", "centered_clip",
                    verification=_AUDIT)),
    n_honest=8,
    attacker_counts=(4,),
    seeds=(0, 1),
    scales=(2.0,),
    rounds=20,
    identity_costs=(0.25, 2.0, 8.0),
    fees=(0.25, 1.0, 4.0),
    reward_schedules=((0.05, 2.0), (0.2, 8.0)),
    adaptive=(False, True),
))

register_sweep_grid(SweepGrid(
    name="no_off_economy_smoke",
    description=("CI smoke for the economy axes: 2 regimes x 2 identity "
                 "costs x 2 fees x 1 schedule x fixed-vs-adaptive x 1 seed "
                 "= 16 tiny lanes (+ 1 baseline) with the full economy "
                 "round (Sybil funding, stake-gated admission, escrowed "
                 "rewards, pool-funded jackpots, best-response lanes) — "
                 "small enough for CI, large enough that the mean-regime "
                 "adaptive lanes show the loss gap."),
    regimes=(Regime("mean+audit", "mean", verification=_AUDIT),
             Regime("centered_clip+audit", "centered_clip",
                    verification=_AUDIT)),
    n_honest=6,
    attacker_counts=(3,),
    seeds=(0,),
    scales=(2.0,),
    rounds=8,
    identity_costs=(0.5, 4.0),
    fees=(0.5, 2.0),
    reward_schedules=((0.1, 5.0),),
    adaptive=(False, True),
))


# -- serving grids (no-off at inference) -----------------------------------------
@dataclass(frozen=True)
class ServingGrid:
    """A named serving sweep: the cartesian (load × churn rate × custody
    redundancy × coalition fraction × seed) grid that ``core.serving.sweep``
    runs, every lane through one step function — the inference twin of
    :class:`SweepGrid`.

    ``loads`` are request arrivals per serve step; ``churn_rates`` make
    that fraction of non-coalition custody nodes transient (half leave on
    staggered mid-horizon steps, half join late — elastic relief, the
    source of coverage gaps that *heal* and hence of the "degraded"
    regime); ``coalition_fractions`` mark roster-tail coalitions that
    defect together at ``defect_step`` (the inference no-off attack: who
    can refuse serving by leaving); ``redundancies`` draw one custody
    matrix each (seed 0 — serving seeds vary churn, never who holds
    what).  Engine shape: ``slots`` decode slots serve ``n_requests``
    requests of ``prompt_len`` (max) prompt tokens and ``max_new``
    generated tokens over a ``steps`` horizon; admission costs ``fee``
    credentials from one of ``n_holders`` balances."""
    name: str
    description: str
    loads: Tuple[float, ...] = (0.25, 0.5, 1.0)
    churn_rates: Tuple[float, ...] = (0.0, 0.3, 0.6)
    redundancies: Tuple[int, ...] = (1, 2)
    coalition_fractions: Tuple[float, ...] = (0.0,)
    seeds: Tuple[int, ...] = (0, 1)
    n_nodes: int = 8
    num_shards: int = 12
    max_fraction: float = 0.5
    n_requests: int = 12
    n_holders: int = 4
    slots: int = 4
    prompt_len: int = 8
    max_new: int = 8
    steps: int = 96
    defect_step: int = 32
    fee: float = 1.0

    @property
    def n_points(self) -> int:
        return (len(self.loads) * len(self.churn_rates)
                * len(self.redundancies) * len(self.coalition_fractions)
                * len(self.seeds))

    @property
    def n_lanes(self) -> int:
        """Serving sweeps have no baseline lanes: lanes == points (named as
        :class:`SweepGrid`'s)."""
        return self.n_points


SERVING_GRIDS: Dict[str, ServingGrid] = {}


def register_serving_grid(grid: ServingGrid) -> ServingGrid:
    SERVING_GRIDS[grid.name] = grid
    return grid


def get_serving_grid(name: str) -> ServingGrid:
    try:
        return SERVING_GRIDS[name]
    except KeyError:
        raise KeyError(f"unknown serving grid {name!r}; "
                       f"registered: {list_serving_grids()}") from None


def list_serving_grids() -> List[str]:
    return sorted(SERVING_GRIDS)


register_serving_grid(ServingGrid(
    name="serving_frontier",
    description=("The inference no-off frontier: at what load, churn rate "
                 "and custody redundancy does continuous-batching serving "
                 "stay available?  (3 loads x 3 churn rates x 2 "
                 "redundancies x 2 seeds) = 36 lanes in one compiled "
                 "program, classified served / degraded / halted."),
))

register_serving_grid(ServingGrid(
    name="serving_coalition",
    description=("Who can refuse serving?  A roster-tail coalition defects "
                 "at defect_step against increasing custody redundancy: "
                 "the serving twin of the §5.5 off-switch question — at "
                 "redundancy 1 every holder holds a veto; redundancy r "
                 "needs a coalition covering some shard's every holder."),
    loads=(0.5,),
    churn_rates=(0.0,),
    redundancies=(1, 2, 3),
    coalition_fractions=(0.25, 0.5, 0.75, 1.0),
    seeds=(0, 1, 2),
))

register_serving_grid(ServingGrid(
    name="serving_smoke",
    description=("CI smoke: 2 loads x 2 churn rates x 2 redundancies x 1 "
                 "seed = 8 tiny serving lanes with the full load/churn/"
                 "redundancy axis set."),
    loads=(0.5, 1.5),
    churn_rates=(0.0, 0.6),
    redundancies=(1, 2),
    seeds=(0,),
    n_requests=8,
    num_shards=8,
    slots=3,
    prompt_len=6,
    max_new=6,
    steps=48,
    defect_step=16,
))


register_sweep_grid(SweepGrid(
    name="no_off_topology_smoke",
    description=("CI smoke for the decentralized axis: 1 regime x 2 "
                 "topologies x 2 counts x 1 seed = 4 tiny runs."),
    regimes=(Regime("centered_clip", "centered_clip"),),
    topologies=("ring", "fully_connected"),
    n_honest=6,
    attacker_counts=(2, 6),
    seeds=(0,),
    rounds=8,
))
