"""Economy engine (paper §4): stake markets, Sybil pressure and adaptive
adversaries as campaign axes (twin of ``repro/core/economy.py``).

Whether a fee/reward schedule keeps honest capital in the swarm depends on
admission, slashing and attacker strategy interacting over rounds, so the
economy is a device-resident state carried through the round as
``contrib`` and ``slashed`` are (``core.swarm``).  Three coupled pieces:

1. **Stake-gated admission with Sybil pressure.**  Every identity costs
   ``identity_cost`` (sunk) plus a ``min_stake`` bond.  The adversary holds
   one ``budget``: how many identities it buys is derived on the device
   (:func:`init_econ_state`), and each round's admission mask from the live
   stakes (:func:`admitted_mask`): a node drained or slashed below the bond
   drops out of aggregation, audits and minting.

2. **Fee and reward schedules.**  Each round mints ``reward_rate × speed``
   into a one-round escrow (forfeited if the earner is caught), splits a
   fixed fee inflow pro rata by stake over the kept nodes, slashes caught
   stakes into a pool, pays validator jackpots from that pool (capped by
   it, never minted), and drains operating costs from balance, then stake.
   A node that cannot cover its cost exits for good.  The flow satisfies
   one conservation identity (:func:`conservation_gap`).

3. **Adaptive adversaries.**  On a lane with ``adaptive = 1`` the
   coalition best-responds each round: it scores a static menu of attack
   scales (``ADAPTIVE_SCALES``) against the known aggregator on the
   anticipated active mask and submits the scale that pushes the aggregate
   hardest against the honest descent direction
   (:func:`best_response_scale`).

The top half is the device arithmetic the round calls, in float32 tensors;
below it, the host-side spec (:class:`EconomyConfig`), the outcome
classification, the phase table and the readable per-node oracle
:class:`SequentialEconomy`, which imports ``core.swarm`` (which imports
this module) when it runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import aggregation, compression
from repro_torch.core.ledger import Ledger
from repro_torch.core.verification import audit_flat
from repro_torch.models.convert import flat_size, flatten_into, layout_of, unflatten
from repro_torch.random import RoundRandom

_EPS = 1e-9

#: The adaptive coalition's static strategy menu: the inner-product attack
#: scales it scores each round, from "hide inside the clipping radius" (0.5)
#: to "overwhelm a mean" (32).
ADAPTIVE_SCALES: Tuple[float, ...] = (0.5, 2.0, 8.0, 32.0)

#: Lane outcomes, in classification priority order (capture trumps collapse).
OUTCOMES = ("captured", "death_spiral", "sustained")


class EconParams(NamedTuple):
    """A lane's economy knobs (``LaneParams.econ``): 0-d float32 tensors on
    the lane's device, ``coalition`` the (N,) bool mask of the strategic
    (adversary) slots, and ``adaptive`` a host int (1: the coalition
    best-responds each round), so that the round branches on it without
    reading the device.  Stacked into a campaign (``swarm.stack_lanes``)
    the scalars become (L,) tensors, the coalition an (L, N) tensor and
    ``adaptive`` a per-lane host tuple."""
    identity_cost: torch.Tensor   # sunk capital per admitted identity
    budget: torch.Tensor          # the adversary's total capital (buys identities)
    min_stake: torch.Tensor       # admission bond
    fee_income: torch.Tensor      # inference-fee inflow per round (total)
    reward_rate: torch.Tensor     # shares minted per unit speed per kept round
    op_cost: torch.Tensor         # operating cost per unit speed per round
    jackpot: torch.Tensor         # validator payout per catch (capped by the pool)
    honest_reserve: torch.Tensor  # starting balance of an honest node
    adaptive: Union[int, Tuple[int, ...]]
    coalition: torch.Tensor       # (N,) bool strategic identities


class EconState(NamedTuple):
    """The device economy carried by ``SwarmState.econ``.  Conservation::

        capital_in.sum() + minted + fees_in
          == stake.sum() + balance.sum() + pending.sum()
             + slash_pool + validator_income + burned
    """
    stake: torch.Tensor             # (N,) f32 admission bonds at risk
    balance: torch.Tensor           # (N,) f32 spendable shares and capital
    pending: torch.Tensor           # (N,) f32 reward escrow (vests next round)
    capital_in: torch.Tensor        # (N,) f32 external capital each node brought
    alive: torch.Tensor             # (N,) bool funded at entry, solvent since
    minted: torch.Tensor            # f32 cumulative reward issuance
    fees_in: torch.Tensor           # f32 cumulative fee inflow
    burned: torch.Tensor            # f32 sunk identity and op costs, forfeits
    slash_pool: torch.Tensor        # f32 slashed stake not yet paid as jackpots
    validator_income: torch.Tensor  # f32 jackpots paid (from the pool)


def init_econ_state(econ: EconParams, n_nodes: int) -> EconState:
    """The initial economy, the Sybil knob resolved on the device.  Honest
    slots post the bond, sink the identity cost and hold
    ``honest_reserve``.  The coalition shares one ``budget``: its first
    ``k = min(floor(budget / max(identity_cost + min_stake, eps)),
    |coalition|)`` slots (by cumsum rank) are funded, the leftover budget
    tops their stakes up equally, and unfunded slots are born dead.
    Capital that buys nothing stays off the books (``capital_in`` counts
    only what entered), so the identity holds from round 0."""
    coal = econ.coalition
    fcoal = coal.float()
    n_coal = torch.sum(fcoal)
    per_identity = econ.identity_cost + econ.min_stake
    n_afford = torch.floor(econ.budget / torch.clamp(per_identity, min=_EPS))
    k = torch.minimum(n_afford, n_coal)
    rank = torch.cumsum(fcoal, 0) - 1.0     # each slot's index within the coalition
    funded = coal & (rank < k)
    leftover = torch.clamp(econ.budget - k * per_identity, min=0.0)
    top_up = leftover / torch.clamp(k, min=1.0)
    ffunded = funded.float()
    stake = torch.where(coal, ffunded * (econ.min_stake + top_up), econ.min_stake)
    sunk = torch.where(coal, ffunded * econ.identity_cost, econ.identity_cost)
    balance = torch.where(coal, torch.zeros_like(stake), econ.honest_reserve)
    zero = torch.zeros((), dtype=torch.float32, device=coal.device)
    return EconState(
        stake=stake, balance=balance, pending=torch.zeros_like(stake),
        capital_in=stake + sunk + balance, alive=funded | ~coal,
        minted=zero, fees_in=zero, burned=torch.sum(sunk),
        slash_pool=zero, validator_income=zero)


def admitted_mask(econ: EconParams, state: EconState) -> torch.Tensor:
    """(N,) bool: who takes part this round, alive (funded at entry, never
    insolvent) and still posting the full bond."""
    return state.alive & (state.stake >= econ.min_stake)


def econ_round_update(econ: EconParams, state: EconState, *, active: torch.Tensor,
                      keep: torch.Tensor, caught: torch.Tensor,
                      speeds: torch.Tensor) -> EconState:
    """One round of the economy, after the audit verdicts, in the
    reference's order: (1) caught nodes forfeit their escrow (burned), the
    rest vest it; (2) this round's rewards are minted into escrow for the
    kept nodes; (3) the fee inflow is split pro rata by stake over the kept
    nodes (none when nobody kept); (4) caught stakes are slashed into the
    pool; (5) jackpots are paid from the pool, capped by it; (6) operating
    costs drain balance first, then stake, and a node that cannot cover
    its cost exits for good."""
    kept, lost, act = keep.float(), caught.float(), active.float()

    # (1) escrow: forfeit or vest
    forfeited = torch.sum(state.pending * lost)
    balance = state.balance + state.pending * (1.0 - lost)
    # (2) mint this round's rewards into escrow
    pending = econ.reward_rate * speeds * kept
    minted = state.minted + torch.sum(pending)
    # (3) the fee market: a stake-weighted split over the kept nodes
    kept_stake = state.stake * kept
    tot_stake = torch.sum(kept_stake)
    any_kept = tot_stake > 0.0
    balance = balance + torch.where(
        any_kept, econ.fee_income * kept_stake / torch.clamp(tot_stake, min=_EPS),
        torch.zeros_like(kept_stake))
    fees_in = state.fees_in + torch.where(any_kept, econ.fee_income,
                                          torch.zeros_like(econ.fee_income))
    # (4) slash caught stakes into the pool
    slash_pool = state.slash_pool + torch.sum(state.stake * lost)
    stake = state.stake * (1.0 - lost)
    # (5) jackpots, funded from (and capped by) the pool
    jackpot_due = econ.jackpot * torch.sum(lost)
    jackpot_paid = torch.minimum(jackpot_due, slash_pool)
    slash_pool = slash_pool - jackpot_paid
    validator_income = state.validator_income + jackpot_paid
    # (6) operating costs: balance first, then stake; insolvency is final
    cost = econ.op_cost * speeds * act
    afford = balance + stake
    paid = torch.minimum(cost, afford)
    from_balance = torch.minimum(cost, balance)
    balance = balance - from_balance
    stake = stake - (paid - from_balance)
    alive = state.alive & ~(active & (cost > afford + 1e-6))
    burned = state.burned + forfeited + torch.sum(paid)
    return EconState(
        stake=stake, balance=balance, pending=pending, capital_in=state.capital_in,
        alive=alive, minted=minted, fees_in=fees_in, burned=burned,
        slash_pool=slash_pool, validator_income=validator_income)


def conservation_gap(state: EconState) -> torch.Tensor:
    """|inflows − holdings| of the identity in :class:`EconState`, a 0-d
    float32 tensor; ~1e-4 relative is float32 reduction noise."""
    inflow = torch.sum(state.capital_in) + state.minted + state.fees_in
    held = (torch.sum(state.stake) + torch.sum(state.balance) + torch.sum(state.pending)
            + state.slash_pool + state.validator_income + state.burned)
    return torch.abs(inflow - held)


def payoff(state: EconState) -> torch.Tensor:
    """(N,) float32: each node's return to date, what it could walk away
    with (balance + stake + escrow) less what it brought in."""
    return state.balance + state.stake + state.pending - state.capital_in


def best_response_scores(run_agg: Callable, gf: torch.Tensor, honest_mean: torch.Tensor,
                         coalition_active: torch.Tensor, anticipated_mask: torch.Tensor,
                         scales: Sequence[float] = ADAPTIVE_SCALES, *,
                         buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (S,) float32 scores of the candidate scales: candidate s puts
    ``-s · honest_mean`` in every active coalition row of ``gf`` and scores
    how hard ``run_agg(stack, anticipated_mask)`` then opposes the honest
    descent direction, ``-⟨agg, honest_mean⟩``.  The candidate stacks are
    written one after another into ``buf`` (an (N, D) float32 tensor,
    allocated when None), never four stacks at once."""
    buf = torch.empty_like(gf) if buf is None else buf
    rows = coalition_active[:, None]
    scores = []
    for s in scales:
        torch.where(rows, -s * honest_mean[None, :], gf, out=buf)
        scores.append(-torch.dot(run_agg(buf, anticipated_mask), honest_mean))
    return torch.stack(scores)


def best_response_scale(run_agg: Callable, gf: torch.Tensor, honest_mean: torch.Tensor,
                        coalition_active: torch.Tensor, anticipated_mask: torch.Tensor,
                        scales: Sequence[float] = ADAPTIVE_SCALES, *,
                        buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adaptive coalition's inner step: the scale of the best
    :func:`best_response_scores` (the first of equal maxima), a 0-d float32
    tensor on the stack's device, read by nothing on the host.
    ``run_agg(stack, mask)`` is the attacker's model of the defense, the
    masked aggregator the round applies."""
    scores = best_response_scores(run_agg, gf, honest_mean, coalition_active,
                                  anticipated_mask, scales, buf=buf)
    return torch.tensor(scales, dtype=torch.float32, device=gf.device)[torch.argmax(scores)]


# ----------------------------- host-side spec ----------------------------------
@dataclass(frozen=True)
class EconomyConfig:
    """The economy of a run (``SwarmConfig.economy``) in plain floats,
    turned into a lane's :class:`EconParams` by :meth:`params_for`.  The
    swarm's coalition is its roster's byzantine slots."""
    identity_cost: float = 1.0
    budget: float = 50.0
    min_stake: float = 5.0
    fee_income: float = 1.0
    reward_rate: float = 0.1
    op_cost: float = 0.05
    jackpot: float = 5.0
    honest_reserve: float = 1.0
    adaptive: bool = False

    def params_for(self, coalition, device=None) -> EconParams:
        """The lane knobs over the (N,) bool ``coalition``, on ``device``
        (default the CPU)."""
        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return EconParams(
            identity_cost=f(self.identity_cost), budget=f(self.budget),
            min_stake=f(self.min_stake), fee_income=f(self.fee_income),
            reward_rate=f(self.reward_rate), op_cost=f(self.op_cost),
            jackpot=f(self.jackpot), honest_reserve=f(self.honest_reserve),
            adaptive=1 if self.adaptive else 0,
            coalition=torch.as_tensor(np.asarray(coalition, bool), device=device))


def classify_outcome(*, honest_active_first: int, honest_active_last: int,
                     coalition_stake_last: float, honest_payoff_mean: float,
                     capture_threshold: float = 0.5) -> str:
    """One lane's outcome, in :data:`OUTCOMES` priority order:

    - ``captured``: the coalition ends holding at least
      ``capture_threshold`` of the active stake;
    - ``death_spiral``: honest participation fell below half its start, or
      honest capital ends under water;
    - ``sustained``: neither."""
    if coalition_stake_last >= capture_threshold:
        return "captured"
    if (honest_active_last < 0.5 * honest_active_first
            or honest_payoff_mean < 0.0):
        return "death_spiral"
    return "sustained"


@dataclass(frozen=True)
class EconomyResult:
    """One lane of an incentive phase diagram (``derailment.sweep``): the
    economy axes, the outcome and the payoffs behind it."""
    regime: str
    identity_cost: float
    fee: float
    reward_rate: float
    jackpot: float
    adaptive: bool
    coalition_size: int
    seed: int
    outcome: str                  # captured | death_spiral | sustained
    honest_payoff: float          # mean over the honest slots
    coalition_payoff: float       # mean over the coalition slots (0 if none)
    coalition_stake_share: float  # final share of the active stake
    n_admitted_first: int
    n_admitted_last: int
    final_loss: float


def phase_table(results: Sequence[EconomyResult], *, regime: str,
                adaptive: bool = False) -> str:
    """The sustained / death-spiral / captured table over (identity cost
    rows × fee columns) of one regime, a majority vote over seeds and
    reward schedules (S, D, C; lowercase: a split vote)."""
    rs = [r for r in results if r.regime == regime and r.adaptive == adaptive
          and r.coalition_size > 0]
    costs = sorted({r.identity_cost for r in rs})
    fees = sorted({r.fee for r in rs})
    lines = ["cost\\fee  " + "  ".join(f"{f:>7g}" for f in fees)]
    for c in costs:
        cells = []
        for f in fees:
            outs = [r.outcome for r in rs if r.identity_cost == c and r.fee == f]
            if not outs:
                cells.append("      .")
                continue
            top = max(set(outs), key=outs.count)
            ch = top[0].upper()
            cells.append(f"{ch if outs.count(top) == len(outs) else ch.lower():>7}")
        lines.append(f"{c:<9g}" + "  ".join(cells))
    return "\n".join(lines)


def adaptive_gap(results: Sequence[EconomyResult]) -> Dict[str, float]:
    """The fixed-against-adaptive gap over the (regime, cost, fee,
    schedule, coalition, seed) cells present in both halves: the shift in
    the non-sustained share, the mean honest payoff drop, and
    ``loss_ratio``, the median per-cell adaptive/fixed final-loss ratio."""
    def key(r):
        return (r.regime, r.identity_cost, r.fee, r.reward_rate, r.jackpot,
                r.coalition_size, r.seed)
    fixed = {key(r): r for r in results if not r.adaptive and r.coalition_size > 0}
    adapt = {key(r): r for r in results if r.adaptive and r.coalition_size > 0}
    common = sorted(set(fixed) & set(adapt))
    if not common:
        return {"cells": 0, "bad_frac_fixed": 0.0, "bad_frac_adaptive": 0.0,
                "gap": 0.0, "honest_payoff_drop": 0.0, "loss_ratio": 1.0}

    def bad(r):
        return r.outcome != "sustained"

    bf = sum(bad(fixed[k]) for k in common) / len(common)
    ba = sum(bad(adapt[k]) for k in common) / len(common)
    drop = sum(fixed[k].honest_payoff - adapt[k].honest_payoff for k in common) / len(common)
    ratios = sorted(adapt[k].final_loss / max(fixed[k].final_loss, 1e-9) for k in common)
    return {"cells": len(common), "bad_frac_fixed": bf, "bad_frac_adaptive": ba,
            "gap": ba - bf, "honest_payoff_drop": drop,
            "loss_ratio": ratios[len(ratios) // 2]}


# ========================== host-side drivers ==================================
class SequentialEconomy:
    """The readable per-node host oracle of the economy round, the
    reference the batched round is held against.

    A plain Python loop over the nodes with explicit bookkeeping in host
    float32 (admission, escrow, the fee split, pool-funded jackpots, cost
    drains), gradients through ``swarm._node_gradient``, the unfused masked
    aggregator of ``core.aggregation``, and every draw from the batched
    round's ``(seed, purpose, round, node)`` schedule, or from the caller's
    ``draws`` (:meth:`step`).  Centralized synchronous rounds only."""

    def __init__(self, loss_fn, params, optimizer, nodes, cfg, data_fn):
        if cfg.topology is not None or cfg.staleness_bound:
            raise ValueError("the economy oracle is centralized+synchronous")
        if cfg.economy is None:
            raise ValueError("SequentialEconomy needs SwarmConfig.economy")
        self.loss_fn, self.params = loss_fn, params
        self.optimizer, self.opt_state = optimizer, optimizer.init(params)
        self.nodes, self.cfg, self.data_fn = list(nodes), cfg, data_fn
        self.device = next(iter(params.values())).device
        self._layout = layout_of(params)
        self._d = flat_size(self._layout)
        self._draw = compression.wire_draw(cfg.compression, self._d, **cfg.compression_kwargs)
        self.slashed = np.zeros(len(self.nodes), bool)
        self.history: List[dict] = []
        coalition = np.asarray([n.byzantine is not None for n in self.nodes])
        self.econ_params = cfg.economy.params_for(coalition, self.device)
        self.econ = EconState(*(x.cpu().numpy()
                                for x in init_econ_state(self.econ_params, len(self.nodes))))
        self._agg = aggregation.get_masked_aggregator(cfg.aggregator, **cfg.agg_kwargs)

    def _gradient(self, i: int, rnd: int) -> torch.Tensor:
        from repro_torch.core.swarm import _node_gradient
        g = torch.empty(self._d, dtype=torch.float32, device=self.device)
        flatten_into(g, _node_gradient(self.loss_fn, self.params, self.data_fn(i, rnd)))
        return g

    def step(self, rnd: int, draws=None) -> dict:
        from repro_torch.core import swarm as sw
        cfg, ep, dev = self.cfg, self.econ_params, self.device
        n = len(self.nodes)
        econ = self.econ
        rr = RoundRandom(cfg.seed, rnd, dev, draws)

        # -- admission: roster-active, not slashed, alive and bonded ---------
        min_stake = float(ep.min_stake)
        active = np.zeros(n, bool)
        for i, node in enumerate(self.nodes):
            active[i] = (node.active(rnd) and not self.slashed[i]
                         and bool(econ.alive[i]) and econ.stake[i] >= min_stake)

        # -- gradients (each node, its own batch) ------------------------------
        gfs = [None] * n
        for i in np.flatnonzero(active):
            gfs[i] = self._gradient(int(i), rnd)
        acts = [gfs[i] for i in np.flatnonzero(active)]
        honest_mean = (torch.mean(torch.stack(acts), dim=0) if acts
                       else torch.zeros(self._d, dtype=torch.float32, device=dev))

        # -- corruption: fixed behaviours, or the best response ----------------
        coalition = ep.coalition.cpu().numpy()
        submitted, wire_u = {}, {}
        adaptive = ep.adaptive > 0
        chosen_scale = None
        if adaptive and acts:
            coal_act = torch.as_tensor(coalition & active, device=dev)
            stack = torch.stack([gfs[i] if active[i] else torch.zeros_like(honest_mean)
                                 for i in range(n)])
            chosen_scale = float(best_response_scale(
                self._agg, stack, honest_mean, coal_act, torch.as_tensor(active, device=dev)))
        for i in np.flatnonzero(active):
            i = int(i)
            node, gf = self.nodes[i], gfs[i]
            if coalition[i]:
                if adaptive:
                    gf = -chosen_scale * honest_mean
                elif node.byzantine:
                    scale = torch.tensor(node.byzantine_scale, dtype=torch.float32, device=dev)
                    noise = rr.corrupt(i, self._d) if node.byzantine == "noise" else None
                    gf = sw.corrupt(node.byzantine, gf, honest_mean, scale, noise)
            wire_u[i] = sw._wire_draw(rr, self._draw, i)
            submitted[i] = compression.roundtrip(cfg.compression, wire_u[i], gf,
                                                 **cfg.compression_kwargs)

        # -- audits (§4.2) ------------------------------------------------------
        caught = np.zeros(n, bool)
        if cfg.verification:
            v = cfg.verification
            for i in np.flatnonzero(active):
                i = int(i)
                if float(rr.audit_sel(i)) >= v.p_check:
                    continue
                recomputed = compression.roundtrip(cfg.compression, wire_u[i], gfs[i],
                                                   **cfg.compression_kwargs)
                ok, _ = audit_flat(submitted[i], recomputed, rr.audit_noise(i, self._d), v)
                if not bool(ok):
                    caught[i] = True
                    self.slashed[i] = True
        keep = active & ~caught

        # -- aggregate and update (the batched round's masked aggregator) -----
        if keep.any():
            stack = torch.stack([submitted.get(i, torch.zeros_like(honest_mean))
                                 for i in range(n)])
            agg = self._agg(stack, torch.as_tensor(keep, device=dev))
            self.params, self.opt_state = self.optimizer.update(
                unflatten(agg, self._layout), self.opt_state, self.params)
        else:
            agg = torch.zeros_like(honest_mean)

        # -- the economy round, in explicit host arithmetic --------------------
        f32 = np.float32
        stake = np.asarray(econ.stake, f32).copy()
        balance = np.asarray(econ.balance, f32).copy()
        pending = np.asarray(econ.pending, f32).copy()
        alive = np.asarray(econ.alive, bool).copy()
        minted, fees_in = f32(econ.minted), f32(econ.fees_in)
        burned, pool = f32(econ.burned), f32(econ.slash_pool)
        validator = f32(econ.validator_income)
        speeds = np.asarray([nd.speed for nd in self.nodes], f32)
        reward_rate, fee_income = f32(float(ep.reward_rate)), f32(float(ep.fee_income))
        jackpot, op_cost = f32(float(ep.jackpot)), f32(float(ep.op_cost))
        # (1) escrow: forfeit if caught, vest otherwise
        for i in range(n):
            if caught[i]:
                burned = f32(burned + pending[i])
            else:
                balance[i] = f32(balance[i] + pending[i])
            pending[i] = f32(0.0)
        # (2) mint this round's rewards into escrow
        for i in np.flatnonzero(keep):
            pending[i] = f32(reward_rate * speeds[i])
            minted = f32(minted + pending[i])
        # (3) the fee split, pro rata by stake over the kept nodes
        tot_stake = f32(sum(stake[i] for i in np.flatnonzero(keep)))
        if tot_stake > 0:
            for i in np.flatnonzero(keep):
                balance[i] = f32(balance[i] + fee_income * f32(stake[i] / tot_stake))
            fees_in = f32(fees_in + fee_income)
        # (4) slash caught stakes into the pool
        for i in np.flatnonzero(caught):
            pool = f32(pool + stake[i])
            stake[i] = f32(0.0)
        # (5) jackpots from the pool, capped by it
        due = f32(jackpot * caught.sum())
        paid_jackpot = min(due, pool)
        pool = f32(pool - paid_jackpot)
        validator = f32(validator + paid_jackpot)
        # (6) operating costs: balance, then stake; insolvency is final
        for i in np.flatnonzero(active):
            cost = f32(op_cost * speeds[i])
            afford = f32(balance[i] + stake[i])
            if cost > afford + 1e-6:
                alive[i] = False
            paid = min(cost, afford)
            from_bal = min(cost, balance[i])
            balance[i] = f32(balance[i] - from_bal)
            stake[i] = f32(stake[i] - f32(paid - from_bal))
            burned = f32(burned + paid)
        self.econ = EconState(
            stake=stake, balance=balance, pending=pending,
            capital_in=np.asarray(econ.capital_in, f32), alive=alive,
            minted=minted, fees_in=fees_in, burned=burned, slash_pool=pool,
            validator_income=validator)

        act_stake = float((stake * keep).sum())
        coal_stake = float((stake * (keep & coalition)).sum())
        rec = {
            "round": rnd, "n_active": int(active.sum()),
            "n_byzantine": int((active & coalition).sum()),
            "caught": [self.nodes[int(i)].node_id for i in np.flatnonzero(caught)],
            "keep": keep.copy(), "admitted": active.copy(),
            "agg_norm": float(torch.linalg.vector_norm(agg)),
            "coalition_stake": coal_stake / act_stake if act_stake > 0 else 0.0,
            "chosen_scale": chosen_scale,
        }
        self.history.append(rec)
        return rec

    def run(self, rounds: int) -> List[dict]:
        return [self.step(r) for r in range(rounds)]


def ledger_view(econ: EconState, node_ids: Sequence[str], validator: str = "validator"):
    """Project a final :class:`EconState` (tensors or host arrays) onto the
    host :class:`~repro_torch.core.ledger.Ledger` vocabulary (balances with
    escrow, stakes, pools), so that ledger invariants such as conservation
    can be asserted against the engine's output."""
    def host(x):
        return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)

    led = Ledger()
    stake, balance = host(econ.stake), host(econ.balance)
    pending, capital = host(econ.pending), host(econ.capital_in)
    for i, nid in enumerate(node_ids):
        if capital[i] > 0:
            led.stake(nid, float(capital[i]))
            # capital beyond the live stake has been spent or re-classed:
            # the stake bucket holds only the live stake
            led.stakes[nid] = float(stake[i])
        if balance[i] + pending[i] > 0:
            led.balances[nid] = float(balance[i] + pending[i])
    led.balances[validator] = float(host(econ.validator_income))
    led.slash_pool = float(host(econ.slash_pool))
    led.fee_pool = 0.0
    led.burned = float(host(econ.burned))
    # the inflow side of check_conservation: rewards and fees entered the
    # economy as issuance, not staked capital
    led.history.append(("mint", "rewards", float(host(econ.minted))))
    led.history.append(("mint", "fees", float(host(econ.fees_in))))
    return led
