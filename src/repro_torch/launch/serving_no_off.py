"""The no-off problem at inference time (§4.1 × §5): who can refuse or halt
*serving* when custody holders churn or defect?  The port's twin of
``examples/serving_no_off.py``.

    python -m repro_torch.launch.serving_no_off                # both grids, on the card
    python -m repro_torch.launch.serving_no_off --smoke        # the 8-lane serving_smoke grid
    python -m repro_torch.launch.serving_no_off --smoke --device cpu

One ``serving.sweep`` call runs the whole serving phase diagram ((load ×
churn rate × custody redundancy × coalition fraction × seed), every lane a
full continuous-batching run with admission queues, per-slot decode
caches, credential fees and coverage-gated availability) through one step
function, on the reference's reduced protocol-125m (1 layer, width 32).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core import serving
from repro_torch.core.scenarios import get_serving_grid
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model

#: the reference example's model
MODEL = dict(num_layers=1, d_model=32, num_heads=2, head_dim=16, d_ff=64, vocab_size=64)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the 8-lane serving_smoke grid only")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    ap.add_argument("--seed", type=int, default=0, help="weight-init seed")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(get_config("protocol-125m").reduced(**MODEL))
    params = model.init(args.seed, dev)

    grids = ["serving_smoke"] if args.smoke else ["serving_frontier", "serving_coalition"]
    results = {}
    for name in grids:
        grid = get_serving_grid(name)
        print(f"\n== {name}: {grid.n_points} serving lanes through one step function ==")
        print(f"   ({grid.slots} slots, {grid.n_requests} requests/lane, "
              f"{grid.num_shards} shards over {grid.n_nodes} nodes, "
              f"horizon {grid.steps} steps) on {dev}")
        res = serving.sweep(model, params, grid, device=dev)
        print(f"   {res.n_runs} lanes in {res.n_programs} program, "
              f"{res.wall_s:.1f}s -> {res.runs_per_s:.1f} lanes/s, "
              f"{res.tok_per_s:.0f} tok/s aggregate")
        print(res.availability_table())
        results[name] = res

    print(
        "\nReading: a Protocol Model's inference inherits an off-switch "
        "nobody designed.  Serving halts exactly when custody coverage "
        "drops below 1, so whoever holds a shard's last live copy holds a "
        "serving veto.  At redundancy 1 every holder is such a veto; "
        "redundancy buys availability under churn (gaps heal -> "
        "'degraded', not 'halted') but widens the coalition needed to "
        "refuse serving.  Load only backlogs: overload delays requests, it "
        "cannot halt the swarm.")
    return results


if __name__ == "__main__":
    main()
