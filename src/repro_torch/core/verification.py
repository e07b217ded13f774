"""Compute verification (twin of ``repro/core/verification.py``, paper §4.2).

Contributors stake capital; validators recompute a random subset of claimed
gradients and slash on a mismatch beyond a tolerance; jackpots pay for
validation.  The real-world cross-stack numerical spread is simulated as
noise added to the recomputation (``numeric_noise``).  Where the reference
takes a PRNG key, the port takes the standard-normal draws themselves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class VerificationConfig:
    """Audit-game parameters.  ``stake`` / ``jackpot`` / ``reward_per_step``
    are host-side economics consumed by the ledger.  Jackpots are funded
    from the slashed-stake pool, never minted (``Ledger.pay_jackpot`` caps
    the payout by the pool)."""
    p_check: float = 0.1             # probability a given update is audited
    stake: float = 10.0              # capital locked per contributor
    reward_per_step: float = 1.0     # shares minted per verified step
    tolerance: float = 1e-3          # relative mismatch tolerated
    jackpot: float = 5.0             # validator reward for a catch
    numeric_noise: float = 1e-5      # simulated cross-stack nondeterminism


def audit_flat(claimed: torch.Tensor, recomputed: torch.Tensor,
               noise: torch.Tensor, cfg: VerificationConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The §4.2 audit over flat float32 update vectors: perturb the
    recomputation by ``numeric_noise`` · noise · ‖recomputed‖ / √D and
    compare.  Returns ``(passes, mismatch)`` as 0-d tensors."""
    d = claimed.shape[-1]
    noisy = recomputed + (cfg.numeric_noise * noise
                          * torch.linalg.vector_norm(recomputed)
                          / math.sqrt(max(1, d)))
    mm = torch.linalg.vector_norm(claimed - noisy) / torch.clamp(
        torch.linalg.vector_norm(noisy), min=1e-30)
    return mm <= cfg.tolerance, mm


def audit_batch(claimed: torch.Tensor, recomputed: torch.Tensor,
                noise: torch.Tensor, cfg: VerificationConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`audit_flat` row by row over (N, D) stacks -> ((N,) passes,
    (N,) mismatch)."""
    out = [audit_flat(c, r, z, cfg) for c, r, z in zip(claimed, recomputed, noise)]
    return (torch.stack([p for p, _ in out]), torch.stack([m for _, m in out]))


# -- economics (paper §4.2 / §5.5) ---------------------------------------------
def expected_cheat_value(gain_per_step: float, cfg: VerificationConfig) -> float:
    """E[value of submitting fake work for one step]."""
    return gain_per_step - cfg.p_check * cfg.stake


def honest_value(cost_per_step: float, cfg: VerificationConfig) -> float:
    return cfg.reward_per_step - cost_per_step


def cheating_irrational(gain_per_step: float, cfg: VerificationConfig) -> bool:
    """Cheating has non-positive EV (the boundary counts as irrational:
    faking work has an effort cost the EV formula does not price)."""
    return expected_cheat_value(gain_per_step, cfg) <= 0


def min_p_check(gain_per_step: float, stake: float) -> float:
    """Smallest audit rate p with p·stake >= gain (capped at 1), in floating
    point.  Unlike the reference, a quotient that underflows to 0.0 is
    nudged up too, so the contract holds for every positive gain."""
    if gain_per_step <= 0.0:
        return 0.0
    p = gain_per_step / max(stake, 1e-12)
    while p < 1.0 and p * stake < gain_per_step:
        p = math.nextafter(p, 1.0)
    return min(1.0, p)


def validator_ev(cost_of_audit: float, p_cheater: float,
                 cfg: VerificationConfig) -> float:
    """Validators audit iff jackpot × catch-rate exceeds audit cost."""
    return p_cheater * cfg.jackpot - cost_of_audit
