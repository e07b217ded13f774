"""Fractional-ownership ledger (paper §4): contribution-proportional shares.

A copy of ``repro.core.ledger`` (pure Python; the port imports nothing of
the JAX package, whose ``core/__init__`` imports every JAX module).

The incentive core of Protocol Learning: each verified unit of useful work
mints shares; inference access requires credentials backed by shares; a
slashed node loses its stake (verification.py) and forfeits pending shares.

Invariants (property-tested):
- conservation: every unit of value entering the ledger (mint events,
  staked external capital) is still accounted for — as balances, stakes,
  the slash pool, the fee pool, or burned shares.  Jackpots do NOT mint:
  they are funded from the slash pool (capped by it), so a validator can
  never be paid more than cheaters actually forfeited.
- monotonicity: honest work never decreases a node's balance
- proportionality: balances / total == contributed work / total work
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Ledger:
    balances: Dict[str, float] = field(default_factory=dict)
    stakes: Dict[str, float] = field(default_factory=dict)
    burned: float = 0.0          # forfeited shares
    burned_stake: float = 0.0    # cumulative slashed stake (monotone counter)
    slash_pool: float = 0.0      # slashed stake not yet paid out as jackpots
    fee_pool: float = 0.0        # inference fees awaiting distribution
    history: List[Tuple[str, str, float]] = field(default_factory=list)

    # -- shares ---------------------------------------------------------------
    @property
    def total_shares(self) -> float:
        return sum(self.balances.values())

    def record_contribution(self, node: str, work_units: float) -> None:
        if work_units < 0:
            raise ValueError("work must be non-negative")
        self.balances[node] = self.balances.get(node, 0.0) + work_units
        self.history.append(("mint", node, work_units))

    def ownership_fraction(self, node: str) -> float:
        t = self.total_shares
        return self.balances.get(node, 0.0) / t if t > 0 else 0.0

    def transfer(self, src: str, dst: str, amount: float) -> None:
        """Credentials are transferable (paper §4.1)."""
        if amount < 0 or self.balances.get(src, 0.0) < amount:
            raise ValueError("insufficient balance")
        self.balances[src] -= amount
        self.balances[dst] = self.balances.get(dst, 0.0) + amount
        self.history.append(("transfer", f"{src}->{dst}", amount))

    # -- staking / slashing -----------------------------------------------------
    def stake(self, node: str, amount: float) -> None:
        """Lock external capital behind ``node``.  The inflow is recorded in
        the history so ``check_conservation`` can balance it against the
        stakes / slash-pool / jackpot side of the books."""
        if amount < 0:
            raise ValueError("stake must be non-negative")
        self.stakes[node] = self.stakes.get(node, 0.0) + amount
        self.history.append(("stake", node, amount))

    def slash(self, node: str) -> float:
        """Destroy the node's stake + forfeit its shares (caught cheating).

        Slashing a node the ledger has never seen (no stake, no balance) is
        a **no-op recording nothing**: there is no capital to destroy, and a
        phantom ``("slash", node, 0.0)`` event would put a participant that
        never staked or contributed into the audit trail."""
        if node not in self.stakes and node not in self.balances:
            return 0.0
        stake_lost = self.stakes.pop(node, 0.0)
        shares_lost = self.balances.pop(node, 0.0)
        self.burned += shares_lost
        self.burned_stake += stake_lost
        self.slash_pool += stake_lost
        self.history.append(("slash", node, stake_lost + shares_lost))
        return stake_lost + shares_lost

    def pay_jackpot(self, validator: str, amount: float) -> float:
        """Validator reward for catching bad work [41, 66].

        Jackpots are funded from the slash pool, never minted: the payout
        is capped at what slashed cheaters actually forfeited, and the
        history records the amount actually paid.  Returns that amount."""
        if amount < 0:
            raise ValueError("jackpot must be non-negative")
        paid = min(amount, self.slash_pool)
        self.slash_pool -= paid
        self.balances[validator] = self.balances.get(validator, 0.0) + paid
        self.history.append(("jackpot", validator, paid))
        return paid

    # -- fees (§4.1 inference markets) ------------------------------------------
    def charge_fee(self, holder: str, amount: float) -> None:
        """Move ``amount`` shares from ``holder`` into the fee pool (an
        inference request's fee).  Insufficient balance is an error — the
        device-side gate in ``core.serving`` refuses the request instead."""
        if amount < 0 or self.balances.get(holder, 0.0) < amount:
            raise ValueError("insufficient balance for fee")
        self.balances[holder] -= amount
        self.fee_pool += amount
        self.history.append(("fee", holder, amount))

    def distribute_fees(self) -> Dict[str, float]:
        """Pay the accumulated fee pool out to stakers pro-rata by stake
        (stake-weighted fee market: serving income flows to the capital
        that keeps the model held).  No stakers → the pool carries over."""
        total_stake = sum(self.stakes.values())
        if total_stake <= 0.0 or self.fee_pool <= 0.0:
            return {}
        pool, payouts = self.fee_pool, {}
        for node, s in self.stakes.items():
            share = pool * (s / total_stake)
            self.balances[node] = self.balances.get(node, 0.0) + share
            self.fee_pool -= share
            payouts[node] = share
            self.history.append(("fee_payout", node, share))
        return payouts

    # -- inference credentials (§4.1) -----------------------------------------
    def can_infer(self, holder: str, min_shares: float = 0.0) -> bool:
        """Inference access requires *strictly more* than ``min_shares``
        (the boundary is exclusive): at the default ``min_shares=0`` a
        holder with a zero balance — including one who just transferred
        their entire balance away — is refused, so credentials cannot be
        spent and kept at the same time.  ``core.serving`` applies the
        same strict ``balance - fee > min_shares`` gate on device."""
        return self.balances.get(holder, 0.0) > min_shares

    def balance_vector(self, holders: List[str]) -> List[float]:
        """Vectorized ledger view for the device-side serving engine: the
        balances of ``holders`` in order (0.0 for unknown names), ready to
        become ``ServeLane.balances``."""
        return [self.balances.get(h, 0.0) for h in holders]

    def check_conservation(self) -> bool:
        """Every unit of value that entered the ledger (mints + staked
        capital) is still held somewhere: balances, stakes, the slash pool,
        the fee pool, or burned shares.  Transfers, fees, slashes, and
        pool-funded jackpots only move value between those buckets."""
        inflow = sum(a for op, _, a in self.history if op in ("mint", "stake"))
        held = (self.total_shares + sum(self.stakes.values())
                + self.burned + self.slash_pool + self.fee_pool)
        return abs(held - inflow) < 1e-6 * max(1.0, inflow)
