"""The No-Off Problem & model-derailment attacks (paper §5.5; twin of
``repro/core/derailment.py``).

A decentralized model cannot be unilaterally halted.  The one *digital*
emergency brake is a derailment attack — joining the swarm and submitting
destructive gradients.  Its effectiveness depends on the aggregation rule
and the verification regime:

- mean aggregation + no verification  → tiny attacker fractions derail
  (the off-switch works, but so does any vandal);
- robust aggregation                  → derailment needs ≥ breakdown-point
  fraction of the swarm;
- near-perfect cheap verification     → derailment is slashed away faster
  than it damages; the paper concludes only physical intervention remains.

``simulate_derailment`` measures one point on a real training run;
``sweep`` measures the whole **phase diagram** — every (topology,
staleness bound, redundancy, coalition fraction, attacker count, scale,
seed) cell of every (aggregator, verification) regime of a
``scenarios.SweepGrid``, plus an honest baseline per (topology, staleness
bound, seed) — as the lanes of one ``swarm.run_campaign``: the regimes
routed by each lane's aggregator id and audit rate, the topologies by its
mixing matrix (the decentralized round), the staleness bounds by its
per-node delay caps (the async round) and the custody cells by its custody
matrix and coalition mask (the live coverage and the reconstruct-attack
eval, read by ``SweepResult.extractability_table``) and the economy cells
by its ``economy.EconParams`` (identity cost, fee, reward schedule, the
adaptive flag; one ``economy.EconomyResult`` per cell, read by
``SweepResult.economy_phase_table`` and ``economy_adaptive_gap``).
``attack_cost`` prices the attack (compute + slashed stakes);
``no_off_report`` renders the table row by row.

A ``MeshPlan`` placement (ROADMAP queue 1, item 13) raises
``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import functools
import time
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import economy
from repro_torch.core import topology as topo_mod
from repro_torch.core import unextractable
from repro_torch.core.economy import EconomyConfig, EconomyResult, EconParams
from repro_torch.core.scenarios import Regime, SweepGrid
from repro_torch.core.swarm import (
    BEHAVIOUR_CODES,
    LaneParams,
    NodeSpec,
    SwarmConfig,
    make_swarm,
    run_campaign,
    stack_lanes,
)
from repro_torch.core.verification import VerificationConfig
from repro_torch.random import RoundDraws

_FAR = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class DerailmentResult:
    attacker_fraction: float
    aggregator: str
    verified: bool
    final_loss: float
    baseline_loss: float
    attackers_slashed: int
    n_attackers: int
    init_loss: Optional[float] = None
    seed: int = 0
    regime: str = ""
    topology: str = ""      # "" = centralized; else a core.topology name
    staleness_bound: int = 0   # 0 = synchronous round; K = async, ring of K+1
    # -- custody axis (redundancy == 0 means the sweep had no custody lane)
    redundancy: int = 0
    coalition_fraction: float = 0.0
    coalition_coverage: float = 1.0   # shard fraction the coalition holds
    final_coverage: float = 1.0       # live swarm coverage at the last round
    extracted_loss: float = float("nan")  # reconstruct-attack eval loss

    @property
    def extractability(self) -> str:
        """The §4.1 regime of this cell ("" when no custody axis):

        - ``extractable``: the coalition covers every shard — custody
          failed, the reassembled model IS the model;
        - ``degraded``: the coalition cannot extract, but churn/slashing
          drained some shard's last live holder — nobody (including the
          swarm itself) holds the full model any more;
        - ``protocol_model``: the coalition is below full coverage and the
          swarm retains every shard — the §4.1 custody property holds.
        """
        if self.redundancy == 0:
            return ""
        if self.coalition_coverage >= 1.0 - 1e-9:
            return "extractable"
        if self.final_coverage < 1.0 - 1e-9:
            return "degraded"
        return "protocol_model"

    @property
    def derailed(self) -> bool:
        """Derailed = the run recovered less than half the honest learning
        progress (catches both divergence AND saturation-stall attacks,
        where the loss freezes near init while gradients vanish)."""
        if not np.isfinite(self.final_loss):
            return True
        if self.init_loss is not None and np.isfinite(self.init_loss) \
                and self.init_loss > self.baseline_loss:
            half = self.baseline_loss + 0.5 * (self.init_loss - self.baseline_loss)
            return bool(self.final_loss > half)
        return bool(self.final_loss > 1.5 * self.baseline_loss + 0.5)


def make_swarm_nodes(n_honest: int, n_attack: int, attack: str = "inner_product",
                     scale: float = 50.0, delay: int = 0):
    nodes = [NodeSpec(f"h{i}", delay=delay) for i in range(n_honest)]
    nodes += [NodeSpec(f"adv{i}", byzantine=attack, byzantine_scale=scale,
                       delay=delay)
              for i in range(n_attack)]
    return nodes


def _eval(eval_fn: Callable, params) -> float:
    with torch.no_grad():
        return float(eval_fn(params))


def simulate_derailment(loss_fn, init_params, optimizer, data_fn, eval_fn, *,
                        n_honest: int, n_attack: int, rounds: int,
                        aggregator: str = "mean",
                        verification: Optional[VerificationConfig] = None,
                        attack: str = "inner_product", scale: float = 50.0,
                        baseline_loss: Optional[float] = None,
                        topology: Optional[str] = None,
                        staleness_bound: int = 0,
                        seed: int = 0, engine: str = "batched",
                        return_swarm: bool = False):
    """Measure a single derailment point.

    Pass ``baseline_loss`` when sweeping many points against one honest
    baseline — otherwise *each call* re-trains the honest swarm from
    scratch.  ``engine`` is ``"batched"`` or ``"sequential"``.
    ``topology`` (a ``core.topology`` name) runs the point in the
    decentralized round; the baseline is then trained on the same
    topology, over a graph the size of the attacked swarm's (the attacker
    slots ride as never-joining relays), so the ratio isolates the attack
    and not the graph.  ``staleness_bound=K > 0`` runs the point in the
    async round, every node's cap K; the baseline then runs at the same
    bound, so the ratio isolates the attack, not the asynchrony.
    ``return_swarm=True`` returns ``(result, swarm)``,
    the attacked swarm after its run.  For whole phase diagrams use
    :func:`sweep`, which shares the baseline and runs every point of every
    regime as one campaign.
    """
    init_loss = _eval(eval_fn, init_params)
    nodes = make_swarm_nodes(n_honest, n_attack, attack, scale,
                             delay=staleness_bound)
    cfg = SwarmConfig(aggregator=aggregator, verification=verification, seed=seed,
                      topology=topology, staleness_bound=staleness_bound,
                      agg_kwargs={"f": max(1, n_attack)} if "krum" in aggregator else {})
    swarm = make_swarm(loss_fn, init_params, optimizer, nodes, cfg, data_fn,
                       engine=engine)
    losses = swarm.run(rounds, eval_fn=eval_fn, eval_every=max(1, rounds // 5))

    if baseline_loss is None:
        base_nodes = [NodeSpec(f"h{i}", delay=staleness_bound)
                      for i in range(n_honest)]
        if topology is not None:
            # the mixing graph the size of the attacked swarm's, as the
            # sweep's count = 0 baseline lanes have it
            base_nodes += [NodeSpec(f"adv{i}", join_round=_FAR)
                           for i in range(n_attack)]
        base = make_swarm(loss_fn, init_params, optimizer, base_nodes,
                          SwarmConfig(aggregator="mean", seed=seed,
                                      topology=topology,
                                      staleness_bound=staleness_bound),
                          data_fn, engine=engine)
        baseline_loss = base.run(rounds, eval_fn=eval_fn, eval_every=rounds)[-1]

    result = DerailmentResult(
        attacker_fraction=n_attack / (n_honest + n_attack),
        aggregator=aggregator,
        verified=verification is not None,
        final_loss=losses[-1],
        baseline_loss=baseline_loss,
        attackers_slashed=sum(1 for s in swarm.slashed if s.startswith("adv")),
        n_attackers=n_attack,
        init_loss=init_loss,
        seed=seed,
        regime=aggregator + ("+verified" if verification else ""),
        topology=topology or "",
        staleness_bound=staleness_bound,
    )
    return (result, swarm) if return_swarm else result


# -- the phase-diagram sweep -----------------------------------------------------
@dataclass
class SweepResult:
    """Every cell of a :class:`~repro_torch.core.scenarios.SweepGrid`, plus
    how it ran (``n_programs`` campaigns for ``n_runs`` runs — baseline
    lanes included) and how long the whole sweep took.  An economy grid
    also gives one ``EconomyResult`` a cell, in ``results`` order."""
    grid: SweepGrid
    results: List[DerailmentResult]
    n_programs: int
    n_runs: int
    wall_s: float
    econ_results: List[EconomyResult] = field(default_factory=list)

    @property
    def runs_per_s(self) -> float:
        return self.n_runs / max(self.wall_s, 1e-9)

    def economy_phase_table(self, regime: str, *, adaptive: bool = False) -> str:
        """The §4 incentive phase table of one regime (identity-cost rows,
        fee columns, S/D/C cells): :func:`economy.phase_table`."""
        return economy.phase_table(self.econ_results, regime=regime, adaptive=adaptive)

    def economy_adaptive_gap(self) -> Dict[str, float]:
        """The fixed-against-adaptive gap over matched economy cells:
        :func:`economy.adaptive_gap`."""
        return economy.adaptive_gap(self.econ_results)

    def phase_table(self) -> str:
        """The §5.5 phase diagram: derailed-seed counts per (regime [,
        topology][, staleness bound], attacker fraction) cell,
        attackers-slashed appended when any.  Topology-axis sweeps get one
        row per (regime, topology), labelled ``regime@topology``;
        staleness-axis sweeps one row per bound, labelled ``... s=K``."""
        fracs = sorted({r.attacker_fraction for r in self.results})
        sbounds: Tuple = self.grid.staleness_bounds or (None,)
        rows: List[Tuple[str, str, Optional[int]]] = []
        for reg in self.grid.regimes:
            for topo in (self.grid.topologies or ("",)):
                for sb in sbounds:
                    if any(r.regime == reg.name and r.topology == topo
                           and (sb is None or r.staleness_bound == sb)
                           for r in self.results):
                        rows.append((reg.name, topo, sb))
        labels = [reg + (f"@{topo}" if topo else "")
                  + (f" s={sb}" if sb is not None else "")
                  for reg, topo, sb in rows]
        width = max([22] + [len(l) + 2 for l in labels])
        head = "regime".ljust(width) + "".join(f"frac={f:.2f}".rjust(12)
                                               for f in fracs)
        lines = [head]
        for (reg, topo, sb), label in zip(rows, labels):
            cells = []
            for f in fracs:
                cell = [r for r in self.results
                        if r.regime == reg and r.topology == topo
                        and (sb is None or r.staleness_bound == sb)
                        and abs(r.attacker_fraction - f) < 1e-9]
                if not cell:
                    cells.append("-".rjust(12))
                    continue
                der = sum(r.derailed for r in cell)
                txt = f"{der}/{len(cell)}"
                slashed = sum(r.attackers_slashed for r in cell)
                if slashed:
                    txt += f" s{slashed}"
                cells.append(txt.rjust(12))
            lines.append(label.ljust(width) + "".join(cells))
        return "\n".join(lines)

    def extractability_table(self) -> str:
        """The §4.1 extractability phase table: one row per (regime [,
        topology], redundancy), one column per coalition fraction; each
        cell shows the regime letter of each of its (seed x count x scale)
        cells — P = protocol_model, X = extractable, D = degraded — and the
        mean coalition shard coverage."""
        cust = [r for r in self.results if r.redundancy > 0]
        if not cust:
            return "(no custody axis in this sweep)"
        fracs = sorted({r.coalition_fraction for r in cust})
        rows = sorted({(r.regime, r.topology, r.redundancy) for r in cust})
        labels = [reg + (f"@{topo}" if topo else "") + f" r={red}"
                  for reg, topo, red in rows]
        width = max([24] + [len(l) + 2 for l in labels])
        head = "custody".ljust(width) + "".join(f"coal={f:.2f}".rjust(16) for f in fracs)
        code = {"protocol_model": "P", "extractable": "X", "degraded": "D"}
        lines = [head]
        for (reg, topo, red), label in zip(rows, labels):
            cells = []
            for f in fracs:
                cell = [r for r in cust
                        if r.regime == reg and r.topology == topo
                        and r.redundancy == red
                        and abs(r.coalition_fraction - f) < 1e-9]
                if not cell:
                    cells.append("-".rjust(16))
                    continue
                marks = "".join(code[r.extractability] for r in cell)
                cov = sum(r.coalition_coverage for r in cell) / len(cell)
                cells.append(f"{marks} cov={cov:.2f}".rjust(16))
            lines.append(label.ljust(width) + "".join(cells))
        lines.append("(P=protocol_model  X=extractable  D=degraded, one "
                     "letter per cell; cov = coalition shard coverage)")
        return "\n".join(lines)


def _sweep_lane(n_total: int, n_honest: int, count: int, code: int,
                scale: float, seed: int,
                v: Optional[VerificationConfig],
                agg_id: int, agg_kwargs: Dict,
                mixing: Optional[np.ndarray] = None,
                leaves: Optional[np.ndarray] = None,
                custody: Optional[np.ndarray] = None,
                coalition: Optional[np.ndarray] = None,
                delays: Optional[np.ndarray] = None,
                econ: Optional[EconParams] = None) -> LaneParams:
    """One run lane: honest nodes first, ``count`` attackers, then padding
    that never joins (all regimes share a fixed N so they run as one
    campaign).  Node indices — and therefore the ``(seed, purpose, round,
    node)`` draws — match the single-run ``Swarm`` built by
    ``simulate_derailment`` exactly.  Roster fields are host (numpy)
    arrays: ``stack_lanes`` moves each stacked field to the device once.
    ``mixing`` (decentralized sweeps) is this lane's topology matrix over
    all ``n_total`` slots: padding slots sit in the graph as silent relays
    (they mix and update, never contribute), which holds the graph fixed
    across attacker counts, so a decentralized cell equals its
    ``simulate_derailment(topology=...)`` twin, whose graph spans its own
    roster, only at ``count == max(attacker_counts)``.  ``leaves``
    (custody-churn sweeps) replaces the never-leave schedule; ``custody`` /
    ``coalition`` are the lane's (n_total, S) custody matrix and (n_total,)
    coalition mask (padding rows hold nothing); ``delays`` (async sweeps)
    the (n_total,) per-node staleness caps, so that every bound of the
    axis shares the campaign; ``econ`` (economy sweeps) the lane's
    :class:`~repro_torch.core.economy.EconParams` on the CPU."""
    codes = np.zeros(n_total, np.int32)
    codes[n_honest:n_honest + count] = code
    scales = np.full(n_total, 10.0, np.float32)     # NodeSpec default
    scales[n_honest:n_honest + count] = scale
    joins = np.zeros(n_total, np.int32)
    joins[n_honest + count:] = _FAR                  # padding: never active
    return LaneParams(
        codes=codes,
        scales=scales,
        speeds=np.ones(n_total, np.float32),
        joins=joins,
        leaves=np.full(n_total, _FAR, np.int32) if leaves is None else leaves,
        seed=int(seed),
        p_check=float(v.p_check) if v else 0.0,
        tolerance=float(v.tolerance) if v else 1.0,
        numeric_noise=float(v.numeric_noise) if v else 0.0,
        agg_kwargs={k: np.asarray(x) for k, x in agg_kwargs.items()},
        agg_id=int(agg_id),
        mixing=mixing,
        custody=custody,
        coalition=coalition,
        delays=delays,
        econ=econ,
    )


@dataclass
class SweepProgramSpec:
    """Everything :func:`sweep` feeds the campaign engine, built without
    running anything: the lane list (host arrays — ``swarm.stack_lanes``
    moves them to the device once), per-lane metadata, the shared
    aggregator set, and ``coalition_coverage(redundancy, fraction,
    count)``, the shard fraction a custody cell's coalition holds."""
    lanes: List[LaneParams]
    metas: List[tuple]
    agg_specs: List[Tuple[str, Dict]]
    verify: bool
    has_custody: bool
    n_honest: int
    n_total: int
    coalition_coverage: Callable[[int, float, int], float]

    @property
    def aggregator(self):
        """The ``aggregator`` argument for ``run_campaign`` — the full
        (name, kwargs) set when several regimes share the campaign."""
        return (self.agg_specs if len(self.agg_specs) > 1
                else self.agg_specs[0][0])

    @property
    def agg_kwargs(self) -> Optional[Dict]:
        return self.agg_specs[0][1] if len(self.agg_specs) == 1 else None


def build_sweep_lanes(grid: SweepGrid, *, rounds: Optional[int] = None) -> SweepProgramSpec:
    """Build every lane of a :class:`~repro_torch.core.scenarios.SweepGrid`'s
    phase diagram — the grid cells, plus the shared honest baselines —
    without running anything.  See :class:`SweepProgramSpec`.  The lanes,
    their order and their metadata are the reference's.  ``rounds``
    (default ``grid.rounds``) places the custody churn's leave rounds."""
    rounds = grid.rounds if rounds is None else rounds
    n_honest = grid.n_honest
    n_total = n_honest + max(grid.attacker_counts)
    code = BEHAVIOUR_CODES[grid.attack]

    # the aggregator set shared by the campaign; the honest baseline is a
    # mean-aggregated run, so make sure plain mean is in the set
    agg_specs: List[Tuple[str, Dict]] = []
    agg_index: Dict[Tuple, int] = {}
    for reg in list(grid.regimes) + [Regime("baseline", "mean")]:
        key = (reg.aggregator, tuple(sorted(reg.agg_kwargs.items())))
        if key not in agg_index:
            agg_index[key] = len(agg_specs)
            agg_specs.append((reg.aggregator, dict(reg.agg_kwargs)))
    # krum aggregators read a per-run f (tracking the attacker count, as
    # simulate_derailment does); the lane kwargs must then be present on
    # every lane, and routing hands f only to the aggregators that take it
    need_f = any("krum" in name and "f" not in kw for name, kw in agg_specs)

    def lane_kw(count):
        return {"f": max(1, count)} if need_f else {}

    # the decentralized axis: one Metropolis matrix per named topology over
    # all n_total slots, drawn at seed 0 (padding slots are silent relays)
    topos = grid.topologies or ("",)
    mixings = {t: (topo_mod.mixing_matrix(t, n_total, seed=0).astype(np.float32)
                   if t else None) for t in topos}

    # the custody axis: one custody matrix per (redundancy, count), over the
    # slots that join (padding rows hold nothing), drawn at seed 0 as the
    # topology axis is (run seeds vary noise and churn, never who holds
    # what), and one coalition mask per (fraction, count): the last
    # ceil(fraction * roster) joined slots, attackers first
    has_custody = grid.has_custody
    reds = (grid.redundancies or (2,)) if has_custody else (0,)
    cfracs = (grid.coalition_fractions or (0.0,)) if has_custody else (0.0,)

    # the asynchrony axis: per-node staleness caps on the lane; the campaign
    # sizes its ring by the largest, so every bound, 0 included, shares it
    has_async = bool(grid.staleness_bounds)
    sbounds = grid.staleness_bounds if has_async else (0,)

    @functools.lru_cache(maxsize=None)
    def delays_for(bound: int, count: int) -> Optional[np.ndarray]:
        if not has_async:
            return None
        d = np.zeros(n_total, np.int32)
        d[:n_honest + count] = bound
        return d

    @functools.lru_cache(maxsize=None)
    def custody_for(red: int, count: int) -> Optional[np.ndarray]:
        if not has_custody:
            return None
        full = np.zeros((n_total, grid.num_shards), bool)
        full[:n_honest + count] = unextractable.assign_matrix(
            n_honest + count, grid.num_shards, red, seed=0,
            max_fraction=grid.custody_max_fraction)
        return full

    @functools.lru_cache(maxsize=None)
    def coalition_for(frac: float, count: int) -> Optional[np.ndarray]:
        if not has_custody:
            return None
        mask = np.zeros(n_total, bool)
        mask[:n_honest + count] = unextractable.coalition_tail_mask(n_honest + count, frac)
        return mask

    @functools.lru_cache(maxsize=None)
    def leaves_for(seed: int) -> Optional[np.ndarray]:
        """The custody churn: ``custody_leave_fraction`` of the honest
        roster leaves on staggered rounds in the back two thirds of the
        run, drawn per seed (only with the custody axis, whose coverage
        columns show what it does)."""
        if grid.custody_leave_fraction <= 0 or not has_custody:
            return None
        lv = np.full(n_total, _FAR, np.int32)
        k = min(n_honest - 1, int(grid.custody_leave_fraction * n_honest))
        rng = np.random.default_rng(10_000 + seed)
        start = max(1, rounds // 3)
        for j, i in enumerate(sorted(rng.choice(n_honest, k, replace=False))):
            lv[int(i)] = start + j % max(1, rounds - start)
        return lv

    # the economy axes (§4): identity cost, fee inflow, reward schedule and
    # the adaptive flag ride on the lane's EconParams.  The lane's attacker
    # slots are the coalition, funded from the grid's one budget; baseline
    # lanes carry the first combination with an empty coalition (fees and
    # rewards never touch the gradients, so one baseline a (topology,
    # staleness bound, seed) serves every economy cell)
    has_econ = grid.has_economy
    icosts = (grid.identity_costs or (1.0,)) if has_econ else (None,)
    efees = (grid.fees or (1.0,)) if has_econ else (None,)
    scheds = (grid.reward_schedules or ((0.1, 5.0),)) if has_econ else (None,)
    adapts = (grid.adaptive or (False,)) if has_econ else (None,)

    @functools.lru_cache(maxsize=None)
    def econ_for(icost, fee, sched, adp, count) -> Optional[EconParams]:
        if not has_econ:
            return None
        coal = np.zeros(n_total, bool)
        coal[n_honest:n_honest + count] = True
        return EconomyConfig(
            identity_cost=icost, budget=grid.econ_budget, min_stake=grid.econ_min_stake,
            fee_income=fee, reward_rate=sched[0], op_cost=grid.econ_op_cost,
            jackpot=sched[1], honest_reserve=grid.econ_reserve,
            adaptive=adp).params_for(coal)

    lanes, metas = [], []
    econ_combos = list(itertools.product(icosts, efees, scheds, adapts))
    for reg in grid.regimes:
        aid = agg_index[(reg.aggregator, tuple(sorted(reg.agg_kwargs.items())))]
        for topo, sbound, red, cfrac, (icost, fee, sched, adp), count, scale, seed in \
                itertools.product(topos, sbounds, reds, cfracs, econ_combos,
                                  grid.attacker_counts, grid.scales, grid.seeds):
            lanes.append(_sweep_lane(
                n_total, n_honest, count, code, scale, seed, reg.verification, aid,
                lane_kw(count), mixing=mixings[topo], leaves=leaves_for(seed),
                custody=custody_for(red, count), coalition=coalition_for(cfrac, count),
                delays=delays_for(sbound, count),
                econ=econ_for(icost, fee, sched, adp, count)))
            metas.append((reg, topo, sbound, red, cfrac, count, scale, seed,
                          icost, fee, sched, adp))
    for topo in topos:                   # baseline lanes (count = 0), one a
        for sbound in sbounds:           # (topology, staleness bound, seed):
            for seed in grid.seeds:      # async baselines run at the bound
                lanes.append(_sweep_lane(
                    n_total, n_honest, 0, code, 0.0, seed, None,
                    agg_index[("mean", ())], lane_kw(0), mixing=mixings[topo],
                    leaves=leaves_for(seed), custody=custody_for(reds[0], 0),
                    coalition=coalition_for(0.0, 0), delays=delays_for(sbound, 0),
                    econ=econ_for(icosts[0], efees[0], scheds[0], False, 0)))
                metas.append((None, topo, sbound, reds[0], 0.0, 0, 0.0, seed,
                              icosts[0], efees[0], scheds[0], False))

    def coalition_coverage(red: int, cfrac: float, count: int) -> float:
        cov = custody_for(red, count) & coalition_for(cfrac, count)[:, None]
        return float(cov.any(axis=0).mean())

    return SweepProgramSpec(
        lanes=lanes, metas=metas, agg_specs=agg_specs,
        verify=any(reg.verification is not None for reg in grid.regimes),
        has_custody=has_custody, n_honest=n_honest, n_total=n_total,
        coalition_coverage=coalition_coverage)


def sweep(loss_fn, init_params, optimizer, data_fn, eval_fn,
          grid: SweepGrid, *, rounds: Optional[int] = None,
          fast_compile: Optional[bool] = None, plan=None,
          return_campaign: bool = False,
          draws_fn: Optional[Callable[[int, int], RoundDraws]] = None):
    """Measure a whole §5.5 phase diagram as **one** campaign.

    Every (regime × topology × staleness bound × redundancy × coalition
    fraction × economy × attacker count × scale × seed) cell is a lane: verification
    differences ride in the lanes' ``p_check`` / ``tolerance`` (``p_check =
    0`` disables audits), aggregator differences in their ``agg_id`` over
    the round's aggregator set, topology differences in their mixing
    matrix (``grid.topologies`` non-empty: every lane then runs the
    decentralized round), staleness bounds in their delay caps
    (``grid.staleness_bounds``: the async round), custody cells in their
    custody matrix and coalition (``grid.redundancies`` /
    ``coalition_fractions``: each lane records its coverage and evaluates
    the reconstruct attack, feeding :meth:`SweepResult.extractability_table`),
    economy cells in their ``EconParams`` (identity cost × fee × reward
    schedule × adaptive, the attackers the coalition: each lane carries its
    economy, feeding :meth:`SweepResult.economy_phase_table`),
    and the honest baseline rides along as extra ``count = 0`` lanes, one per
    (topology, staleness bound, seed).  Lane building lives in
    :func:`build_sweep_lanes`.  Each result lane reproduces the
    single-point :func:`simulate_derailment` run for the same parameters.

    ``fast_compile`` is the reference's XLA option, accepted and unused
    (the port compiles nothing).  ``plan`` (a ``MeshPlan``) waits for the
    distributed layer (item 13).  An economy grid also fills
    ``econ_results`` (:func:`economy_results`).
    ``return_campaign=True`` returns ``(result, (state, records, final
    losses))``, the campaign's own outputs, lane j the j-th of
    :func:`build_sweep_lanes` (the cells in ``results`` order, then the
    baselines); without it the campaign keeps no lane's params or
    optimizer state past the lane's end (``keep_params=False``).
    ``draws_fn(j, rnd)`` hands lane j its round's draws
    (``swarm.run_campaign``'s), so that two sweeps on different devices, or
    against the reference, consume the same numbers.
    """
    if plan is not None:
        raise NotImplementedError("a MeshPlan placement is not ported yet "
                                  "(ROADMAP queue 1, item 13)")
    rounds = grid.rounds if rounds is None else rounds
    t0 = time.perf_counter()
    spec = build_sweep_lanes(grid, rounds=rounds)
    init_loss = _eval(eval_fn, init_params)
    device = next(iter(init_params.values())).device

    state, recs, final = run_campaign(
        loss_fn, init_params, optimizer, data_fn,
        stack_lanes(spec.lanes, device=device), rounds=rounds,
        aggregator=spec.aggregator, agg_kwargs=spec.agg_kwargs,
        verify=spec.verify, eval_fn=eval_fn, fast_compile=bool(fast_compile),
        keep_params=return_campaign, draws_fn=draws_fn)
    campaign = (state, recs, final) if return_campaign else None
    slashed = state.slashed.cpu().numpy()
    last_coverage = recs.coverage[:, -1].cpu().numpy()
    final = final.cpu().numpy()
    econ_results = (economy_results(spec, final, recs, state.econ) if grid.has_economy
                    else [])
    del state, recs
    results = sweep_results(spec, final, slashed, init_loss, last_coverage)
    result = SweepResult(grid=grid, results=results, n_programs=1,
                         n_runs=len(spec.lanes), wall_s=time.perf_counter() - t0,
                         econ_results=econ_results)
    return (result, campaign) if return_campaign else result


def economy_results(spec: SweepProgramSpec, final: np.ndarray, recs,
                    econ) -> List[EconomyResult]:
    """One ``EconomyResult`` per cell of an economy sweep, in ``results``
    order, from the campaign's (L, T, ...) records and its final (L, ...)
    ``EconState``: the outcome from the honest nodes kept in the first and
    last rounds, the coalition's last share of the kept stake and the mean
    honest payoff."""
    n_honest = spec.n_honest
    honest = final[:, 0] if spec.has_custody else final
    keep = recs.keep.cpu().numpy()                          # (L, T, N)
    n_act = recs.n_active.cpu().numpy()                     # (L, T)
    coal_tr = recs.coalition_stake.cpu().numpy()            # (L, T)
    pay = economy.payoff(econ).cpu().numpy()                # (L, N)
    out = []
    for j, (reg, *_, count, _, seed, icost, fee, sched, adp) in enumerate(spec.metas):
        if reg is None:
            continue
        hp = float(pay[j, :n_honest].mean())
        cp = float(pay[j, n_honest:n_honest + count].mean()) if count else 0.0
        out.append(EconomyResult(
            regime=reg.name, identity_cost=icost, fee=fee, reward_rate=sched[0],
            jackpot=sched[1], adaptive=adp, coalition_size=count, seed=seed,
            outcome=economy.classify_outcome(
                honest_active_first=int(keep[j, 0, :n_honest].sum()),
                honest_active_last=int(keep[j, -1, :n_honest].sum()),
                coalition_stake_last=float(coal_tr[j, -1]),
                honest_payoff_mean=hp),
            honest_payoff=hp, coalition_payoff=cp,
            coalition_stake_share=float(coal_tr[j, -1]),
            n_admitted_first=int(n_act[j, 0]), n_admitted_last=int(n_act[j, -1]),
            final_loss=float(honest[j])))
    return out


def sweep_results(spec: SweepProgramSpec, final: np.ndarray, slashed: np.ndarray,
                  init_loss: float, last_coverage: Optional[np.ndarray] = None
                  ) -> List[DerailmentResult]:
    """The cells of a sweep from its lanes' outcomes, lane j the j-th of
    ``spec``: ``final`` the (L,) final losses ((L, 2) with custody: honest,
    extracted), ``slashed`` the (L, N) slashed masks and ``last_coverage``
    the (L,) coverage of each lane's last round (read with custody only);
    each cell against its (topology, staleness bound, seed)'s baseline
    lane."""
    n_honest, has_custody = spec.n_honest, spec.has_custody
    honest = final[:, 0] if has_custody else final
    baselines: Dict[Tuple[str, int, int], float] = {}
    cells = []
    for j, (reg, topo, sb, red, cfrac, count, scale, seed, *_) in enumerate(spec.metas):
        if reg is None:
            baselines[topo, sb, seed] = float(honest[j])
        else:
            cells.append((j, reg, topo, sb, red, cfrac, count, seed))
    return [DerailmentResult(
        attacker_fraction=count / (n_honest + count) if count else 0.0,
        aggregator=reg.aggregator,
        verified=reg.verification is not None,
        final_loss=float(honest[j]),
        baseline_loss=baselines[topo, sb, seed],
        attackers_slashed=int(slashed[j, n_honest:n_honest + count].sum()),
        n_attackers=count,
        init_loss=init_loss,
        seed=seed,
        regime=reg.name,
        topology=topo,
        staleness_bound=sb,
        redundancy=red if has_custody else 0,
        coalition_fraction=cfrac,
        coalition_coverage=(spec.coalition_coverage(red, cfrac, count)
                            if has_custody else 1.0),
        final_coverage=float(last_coverage[j]) if has_custody else 1.0,
        extracted_loss=float(final[j, 1]) if has_custody else float("nan"),
    ) for j, reg, topo, sb, red, cfrac, count, seed in cells]


# -- economics -------------------------------------------------------------------
def attack_cost(n_attackers: int, rounds: int, *, compute_cost_per_round: float,
                verification: Optional[VerificationConfig]) -> float:
    """Price of running the derailment: compute + expected slashed stakes.

    With stake/slash verification each attacker's stake is destroyed with
    prob p_check each round; expected rounds to slash = 1/p_check, so the
    attacker re-stakes ~ rounds·p_check times.
    """
    compute = n_attackers * rounds * compute_cost_per_round
    if verification is None:
        return compute
    expected_slashes = n_attackers * min(rounds * verification.p_check, rounds)
    return compute + expected_slashes * verification.stake


def no_off_report(results) -> str:
    """Render the §5.5 analysis from a list of DerailmentResult (a topology
    column appears when any result is decentralized; custody columns when
    any result carries the custody axis, as in the reference)."""
    topo = any(r.topology for r in results)
    cust = any(r.redundancy for r in results)
    head = "attacker_frac  aggregator      "
    head += "topology          " if topo else ""
    head += "verified  derailed  slashed  final/baseline"
    head += "  r  coal_cov  extractability  extracted/honest" if cust else ""
    lines = [head]
    for r in results:
        t = f"{r.topology or 'centralized':16s}  " if topo else ""
        line = (
            f"{r.attacker_fraction:12.2f}  {r.aggregator:14s}  {t}"
            f"{str(r.verified):8s}"
            f"  {str(r.derailed):8s}  {r.attackers_slashed}/{r.n_attackers:<6d}"
            f"  {r.final_loss / max(r.baseline_loss, 1e-9):6.2f}")
        if cust:
            line += (f"  {r.redundancy}  {r.coalition_coverage:8.2f}"
                     f"  {r.extractability:14s}"
                     f"  {r.extracted_loss / max(r.final_loss, 1e-9):8.1f}")
        lines.append(line)
    return "\n".join(lines)
