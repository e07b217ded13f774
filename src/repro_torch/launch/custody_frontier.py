"""The extractability frontier (§4.1 × §5.5): at what redundancy and
coalition fraction does a swarm stop being a Protocol Model?  The port's
twin of ``examples/custody_frontier.py``.

    python -m repro_torch.launch.custody_frontier                 # small LM, on the card
    python -m repro_torch.launch.custody_frontier --tiny          # the quadratic
    python -m repro_torch.launch.custody_frontier --device cpu --tiny --rounds 4

One ``derailment.sweep`` runs the whole custody phase diagram
((redundancy × coalition fraction × churn seed), each lane recording the
live coverage and running the reconstruct-attack eval) as the lanes of one
campaign: the (N, S) custody matrix and the coalition mask ride on each
lane.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import unextractable as unext
from repro_torch.core.derailment import no_off_report, sweep
from repro_torch.core.scenarios import Regime, SweepGrid
from repro_torch.launch.problems import small_lm_problem, tiny_quadratic_problem


def custody_grid(rounds: int = 20, seeds: int = 3) -> SweepGrid:
    """The example's grid: 10 honest nodes, 12 shards with no node over
    40% of them, redundancy 1-3 against coalitions of 20-100% of the
    roster, 30% of the roster churning out mid-run."""
    return SweepGrid(
        name="custody_frontier_example",
        description="§4.1 extractability frontier",
        regimes=(Regime("mean", "mean"),),
        n_honest=10,
        attacker_counts=(0,),
        seeds=tuple(range(seeds)),
        rounds=rounds,
        redundancies=(1, 2, 3),
        coalition_fractions=(0.2, 0.4, 0.6, 0.8, 1.0),
        num_shards=12,
        custody_max_fraction=0.4,
        custody_leave_fraction=0.3,
    )


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seeds", type=int, default=3,
                    help="churn seeds per phase-diagram cell")
    ap.add_argument("--tiny", action="store_true",
                    help="convex toy problem instead of the small LM")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    args = ap.parse_args(argv)

    loss_fn, params, data_fn, eval_fn, opt = (
        tiny_quadratic_problem(device=args.device) if args.tiny
        else small_lm_problem(args.device))
    grid = custody_grid(args.rounds, args.seeds)

    print(f"custody: {grid.num_shards} shards over {grid.n_honest} nodes, per-node "
          f"bound {grid.custody_max_fraction}; "
          f"{grid.custody_leave_fraction:.0%} of the roster churns out mid-run")
    for red in grid.redundancies:
        c = unext.ShardCustody.assign(
            [f"h{i}" for i in range(grid.n_honest)], grid.num_shards, redundancy=red,
            max_fraction=grid.custody_max_fraction)
        print(f"  redundancy {red}: min extraction coalition "
              f"{c.min_extraction_coalition(exact=True)} nodes (exact; "
              f"greedy upper bound {c.min_extraction_coalition()})")

    print(f"\nrunning the {grid.n_points}-point custody phase diagram as one "
          "campaign (coverage trace + reconstruct-attack eval in every lane)...")
    res = sweep(loss_fn, params, opt, data_fn, eval_fn, grid)
    print(f"  {res.n_runs} runs in {res.n_programs} campaign, "
          f"{res.wall_s:.1f}s -> {res.runs_per_s:.2f} runs/s")

    print("\n== §4.1 extractability phase table ==")
    print(res.extractability_table())

    print("\n== per-cell detail (extracted/honest prices the attack) ==")
    print(no_off_report(sorted(
        res.results, key=lambda r: (r.redundancy, r.coalition_fraction, r.seed))))

    print("\nReading: the custody bound draws the frontier.  Below full "
          "coverage the reconstruct-attack eval shows the coalition "
          "reassembles garbage (extracted loss far above honest); the moment "
          "the coalition covers every shard the extracted model IS the model "
          "(extracted/honest = 1.0).  Redundancy trades the two risks: r=1 "
          "keeps coalitions small but lets churn collapse the live frontier "
          "('degraded': nobody holds the full model any more), higher r "
          "survives churn but hands bigger coalitions full coverage.")
    return res


if __name__ == "__main__":
    main()
