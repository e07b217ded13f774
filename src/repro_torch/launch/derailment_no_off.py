"""The No-Off Problem (§5.5), measured: can a derailment attack, the one
digital emergency brake, halt a protocol-learning run?  The port's twin of
``examples/derailment_no_off.py``.

    python -m repro_torch.launch.derailment_no_off                   # on the card
    python -m repro_torch.launch.derailment_no_off --device cpu --rounds 2

One ``derailment.sweep`` runs the whole phase diagram (attacker fraction
× seed for each of three regimes: mean, CenteredClip, and mean under
audits at p_check 0.5; honest baselines included) as the lanes of one
campaign on the small LM (``launch/problems.py:small_lm_problem``), then
prints the paper's table, the per-cell detail and the attack's price.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.derailment import attack_cost, no_off_report, sweep
from repro_torch.core.scenarios import Regime, SweepGrid
from repro_torch.core.verification import VerificationConfig
from repro_torch.launch.problems import small_lm_problem

#: the verified regime's audits
VERIFIED = VerificationConfig(p_check=0.5, stake=10.0, tolerance=1e-3)


def no_off_lm_grid(rounds: int = 30, seeds: int = 1) -> SweepGrid:
    """The example's grid: 8 honest nodes against 1, 4 and 10 inner-product
    attackers at scale 20 (lanes of N = 18), three regimes."""
    return SweepGrid(
        name="no_off_lm",
        description="§5.5 table on a real (small) LM",
        regimes=(Regime("mean", "mean"),
                 Regime("centered_clip", "centered_clip"),
                 Regime("mean+verified", "mean", verification=VERIFIED)),
        n_honest=8,
        attacker_counts=(1, 4, 10),
        seeds=tuple(range(seeds)),
        scales=(20.0,),
        rounds=rounds,
    )


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per phase-diagram cell")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    args = ap.parse_args(argv)

    loss_fn, params, data_fn, eval_fn, opt = small_lm_problem(args.device)
    grid = no_off_lm_grid(args.rounds, args.seeds)
    print(f"running the {grid.n_points}-point derailment phase diagram as one "
          f"campaign (this trains a small LM {grid.n_lanes} times)...")
    res = sweep(loss_fn, params, opt, data_fn, eval_fn, grid)
    print(f"  {res.n_runs} runs (incl {len(grid.seeds)} shared honest "
          f"baselines) in {res.n_programs} campaign, {res.wall_s:.1f}s "
          f"-> {res.runs_per_s:.2f} runs/s")

    print("\n== §5.5 phase diagram (derailed seeds / total, s = attackers "
          "slashed) ==")
    print(res.phase_table())

    print("\n== per-cell detail ==")
    print(no_off_report(sorted(res.results,
                               key=lambda r: (r.regime, r.attacker_fraction))))

    print("\n== attack economics ==")
    for n_attack in (4, 10):
        c_unv = attack_cost(n_attack, args.rounds, compute_cost_per_round=1.0,
                            verification=None)
        c_ver = attack_cost(n_attack, args.rounds, compute_cost_per_round=1.0,
                            verification=VERIFIED)
        print(f"  {n_attack:2d} attackers x {args.rounds} rounds: "
              f"unverified={c_unv:.0f} units, verified={c_ver:.0f} units "
              f"(stakes burned)")

    print("\nReading: under mean aggregation the off-switch works (and so "
          "does any vandal); robust aggregation raises the bar to the "
          "breakdown point; near-perfect verification neutralizes it — "
          "the paper's conclusion that only physical intervention remains.")
    return res


if __name__ == "__main__":
    main()
