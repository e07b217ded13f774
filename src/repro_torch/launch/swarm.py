"""Train protocol-125m across a simulated incentivized swarm: the port's
twin of ``examples/swarm_byzantine_training.py``.

    python -m repro_torch.launch.swarm                 # reduced width, on the card
    python -m repro_torch.launch.swarm --full          # 162,417,408 params
    python -m repro_torch.launch.swarm --device cpu --rounds 3
    python -m repro_torch.launch.swarm --full --engine sequential   # per-node engine
    python -m repro_torch.launch.swarm --full --scenario byzantine_neighborhood \
        --nodes 10 --rounds 2                          # any registered scenario
    python -m repro_torch.launch.swarm --full --scenario stale_poisoning \
        --rounds 4                                     # the async round
    python -m repro_torch.launch.swarm --full --scenario economy_sybil_adaptive \
        --rounds 3                                     # the economy lane

The "showcase" roster exercises the five §3 properties and the §4
incentives at once: 10 heterogeneous nodes (speeds 0.5-3x, two join late,
one leaves), two Byzantine nodes (inner-product and sign-flip attacks),
a QSGD wire (127 levels, buckets of 512), CenteredClip aggregation
(τ = 2.0, 3 iterations) and stake/slash audits (p = 0.25), trained with
AdamW at lr 5e-3 on sequences of 128 tokens, a global batch of 2N.  It
prints the reference's columns and ledger report.  ``--engine`` picks the
batched round (``Swarm``, the default) or the per-node ``SequentialSwarm``,
as the reference example's ``--engine`` does.  ``--scenario`` runs any
registered scenario instead (``core.scenarios``) at ``--nodes`` nodes,
the decentralized ones (``gossip_ring_honest``, ``byzantine_neighborhood``,
``partitioned_swarm``) on per-node replicas, whose consensus (node-mean)
replica is what the loss column evaluates; the async ones
(``straggler_majority``, ``stale_poisoning``, ``async_churn``) on the
bounded-staleness round, the custody ones (``custody_leech``,
``custody_churn_collapse``) with their coverage trace, the economy ones
(``economy_rational``, ``economy_sybil_adaptive``) with stake-gated
admission and, in the second, the coalition's best response.  As the reference,
it ends with a custody-sharded checkpoint of the trained params (the
consensus replica of a decentralized run) in ``--ckpt``: 16 shards,
redundancy 2, no holder over 40% of the model, over the nodes not
slashed; then a restore by two holders, which the custody refuses.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.scenarios import get_scenario, list_scenarios
from repro_torch.core.swarm import ENGINES, NodeSpec, SwarmConfig, make_swarm
from repro_torch.core.unextractable import ShardCustody
from repro_torch.core.verification import VerificationConfig
from repro_torch.data.pipeline import DataConfig, data_fn_for_swarm, model_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import AdamW


def showcase_roster(rounds: int):
    """The all-properties-at-once roster of the reference example."""
    nodes = [
        NodeSpec("h0", speed=3.0),
        NodeSpec("h1", speed=1.0),
        NodeSpec("h2", speed=1.0),
        NodeSpec("h3", speed=0.5),
        NodeSpec("h4", speed=1.0, leave_round=rounds // 2),
        NodeSpec("h5", speed=1.0),
        NodeSpec("late0", speed=2.0, join_round=rounds // 4),
        NodeSpec("late1", speed=1.0, join_round=rounds // 4),
        NodeSpec("adv0", byzantine="inner_product", byzantine_scale=20.0),
        NodeSpec("adv1", byzantine="sign_flip", byzantine_scale=10.0),
    ]
    cfg = SwarmConfig(
        aggregator="centered_clip",
        agg_kwargs={"clip_tau": 2.0, "iters": 3},
        verification=VerificationConfig(p_check=0.25, stake=10.0,
                                        tolerance=1e-3, jackpot=5.0),
        compression="qsgd",
        compression_kwargs={"levels": 127, "bucket_size": 512},
    )
    return nodes, cfg


def model_config(full: bool) -> ModelConfig:
    cfg = get_config("protocol-125m")
    if full:
        return cfg
    return cfg.reduced(num_layers=4, d_model=256, num_heads=4, head_dim=64,
                       d_ff=1024, vocab_size=2048)


@dataclass
class Problem:
    """One model, its random params and the pieces a swarm needs."""
    cfg: ModelConfig
    params: Dict[str, torch.Tensor]
    loss_fn: Callable
    device: torch.device
    seq_len: int = 128

    def data_cfg(self, n_nodes: int) -> DataConfig:
        return DataConfig(vocab_size=self.cfg.vocab_size, seq_len=self.seq_len,
                          global_batch=2 * n_nodes)

    def data_fn(self, n_nodes: int):
        return data_fn_for_swarm(self.cfg, self.data_cfg(n_nodes), n_nodes,
                                 device=self.device)

    def eval_loss(self, params, n_nodes: int) -> float:
        batch = model_batch(self.cfg, self.data_cfg(n_nodes), 10**6,
                            device=self.device)
        with torch.no_grad():
            return float(self.loss_fn(params, batch))


def build_problem(full: bool, device: DeviceLike = None, seed: int = 0) -> Problem:
    dev = resolve_device(device)
    cfg = model_config(full)
    model = build_model(cfg)
    params = model.init(seed, dev)
    return Problem(cfg=cfg, params=params, loss_fn=lambda p, b: model.loss(p, b)[0],
                   device=dev)


def make_showcase_swarm(problem: Problem, nodes: Sequence[NodeSpec],
                        cfg: SwarmConfig, lr: float = 5e-3, engine: str = "batched"):
    params = {k: v.clone() for k, v in problem.params.items()}
    return make_swarm(problem.loss_fn, params, AdamW(lr=lr), list(nodes), cfg,
                      problem.data_fn(len(nodes)), engine=engine)


def train(swarm, problem: Problem, rounds: int, *, print_every: int = 20,
          out: Callable[[str], None] = print) -> List[float]:
    """Step ``rounds`` rounds, printing the reference's columns; returns the
    eval losses printed."""
    n = len(swarm.nodes)
    losses = []
    out(f"{'round':>6} {'active':>6} {'byz':>4} {'loss':>8}  slashed")
    for r in range(rounds):
        rec = swarm.step(r)
        if r % print_every == 0 or r == rounds - 1:
            loss = problem.eval_loss(swarm.eval_params(), n)
            losses.append(loss)
            out(f"{r:6d} {rec['n_active']:6d} {rec['n_byzantine']:4d} "
                f"{loss:8.4f}  {sorted(swarm.slashed)}")
    return losses


def report_ledger(swarm, out: Callable[[str], None] = print) -> None:
    out("\nfractional ownership (ledger):")
    for node, bal in sorted(swarm.ledger.balances.items(), key=lambda kv: -kv[1]):
        out(f"  {node:10s} {bal:8.1f} shares "
            f"({swarm.ledger.ownership_fraction(node) * 100:5.1f}%)")
    out(f"  burned stake: {swarm.ledger.burned_stake:g} "
        f"(slashed: {sorted(swarm.slashed)})")
    if not swarm.ledger.check_conservation():
        raise RuntimeError("ledger does not conserve value")


def custody_checkpoint(swarm, path: str, out: Callable[[str], None] = print) -> ShardCustody:
    """§4.1: write the trained params as a custody-sharded checkpoint that
    no single node holds all of (16 shards, redundancy 2, no node over 40%
    of the model, over the nodes not slashed), then show that two holders
    cannot restore it.  Returns the custody."""
    holders = [n.node_id for n in swarm.nodes if n.node_id not in swarm.slashed]
    custody = ShardCustody.assign(holders, num_shards=16, redundancy=2, max_fraction=0.4)
    ckpt.save_custody(path, swarm.eval_params(), custody)
    out(f"\ncustody checkpoint -> {path}")
    out(f"  min extraction coalition: {custody.min_extraction_coalition()} "
        f"of {len(holders)} nodes")
    try:
        ckpt.restore_custody(path, swarm.eval_params(), holders=holders[:2])
    except PermissionError as e:
        out(f"  partial-coalition restore correctly refused: {e}")
    else:
        raise RuntimeError("a partial coalition restored the checkpoint")
    return custody


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="true 125M params (162,417,408)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    ap.add_argument("--seed", type=int, default=0, help="weight-init seed")
    ap.add_argument("--engine", default="batched", choices=sorted(ENGINES),
                    help="batched round (default) or the per-node sequential engine")
    ap.add_argument("--scenario", default="showcase",
                    choices=["showcase"] + list_scenarios())
    ap.add_argument("--nodes", type=int, default=None,
                    help="swarm size of a registered --scenario (default 10); "
                         "the showcase's roster is fixed")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_swarm_custody_ckpt"),
                    help="directory of the custody-sharded checkpoint")
    args = ap.parse_args(argv)
    if args.scenario == "showcase" and args.nodes is not None:
        ap.error("--nodes sizes a registered --scenario; the showcase runs its "
                 "own 10-node roster")

    problem = build_problem(args.full, args.device, args.seed)
    print(f"model: {problem.cfg.name} N={problem.cfg.param_count():,} "
          f"({'full' if args.full else 'reduced'}) on {problem.device}")
    if args.scenario == "showcase":
        nodes, cfg = showcase_roster(args.rounds)
    else:
        nodes, cfg = get_scenario(args.scenario).build(
            n_nodes=10 if args.nodes is None else args.nodes)
    print(f"scenario: {args.scenario} ({len(nodes)} nodes, engine={args.engine})")
    swarm = make_showcase_swarm(problem, nodes, cfg, engine=args.engine)
    t0 = time.time()
    losses = train(swarm, problem, args.rounds)
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    dt = time.time() - t0
    fused = f", fused={swarm.fused}" if args.engine == "batched" else ""
    print(f"\ntrained {args.rounds} rounds in {dt:.0f}s "
          f"({args.rounds / max(dt, 1e-9):.2f} rounds/s{fused})")
    report_ledger(swarm)
    t0 = time.time()
    custody = custody_checkpoint(swarm, args.ckpt)
    ckpt_s = time.time() - t0
    return {"swarm": swarm, "problem": problem, "losses": losses,
            "seconds": dt, "rounds": args.rounds, "nodes": nodes,
            "ckpt": args.ckpt, "custody": custody, "ckpt_seconds": ckpt_s}


if __name__ == "__main__":
    main()
