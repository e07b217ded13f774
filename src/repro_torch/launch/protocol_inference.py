"""Protocol Model serving (§4.1): credential-gated, custody-sharded
inference where the weights never leave the protocol.  The port's twin of
``examples/protocol_inference.py``.

    python -m repro_torch.launch.protocol_inference              # reduced protocol-125m, on the card
    python -m repro_torch.launch.protocol_inference --device cpu
    python -m repro_torch.launch.protocol_inference --arch h2o-danube-1.8b --full \\
        --seq 32768 --batch 1                                    # 1,831,201,280 params
    python -m repro_torch.launch.protocol_inference --arch rwkv6-1.6b --full \\
        --seq 32768 --batch 1                                    # 1,590,235,136 params
    python -m repro_torch.launch.protocol_inference --arch zamba2-1.2b --full \\
        --seq 32768 --batch 1                                    # 1,170,157,696 params
    python -m repro_torch.launch.protocol_inference --arch mixtral-8x7b --full \\
        --layers 3 --seq 32768 --batch 1                         # 4,615,958,528 params

Shows (1) credential gating and transferable credentials, (2) that serving
needs the live swarm (it survives one departure at redundancy 2, and a
collapse to 2 nodes names the missing shard ids), (3) that a partial
coalition reassembles only garbage, and (4) the extraction-vs-retrain
economics that define a Protocol Model.  8 nodes, 16 custody shards,
redundancy 2, at most 35% of the model on one node.  The config is built
with ``use_pallas_kernels`` set, so on the card each prefill of a
sliding-window model runs the attention kernel, each prefill of rwkv6 the
WKV kernel, and each prefill of zamba2 the SSD scan kernel once per mamba
layer (38 at full width).  At the reduced width (``ModelConfig.reduced``)
rwkv6 has 8 WKV heads of 32, and zamba2 4 groups of 1 mamba layer with 16
SSD heads of 32 and state 16.  The parameter count, printed and used in the
economics, is that of the params built.  ``--layers N`` cuts the depth
of the arch to N layers, its width kept: mixtral-8x7b's 46.7B params do
not fit one card's server (its float32 custody shards, the launcher's
params and two reassembled sets: about 12 bytes a parameter), 3 of its
32 layers do.  A VLM's request carries its media stubs and M-RoPE
positions (``Model.concrete_batch``).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.core.ledger import Ledger
from repro_torch.core.protocol import CredentialError, ExtractionError, ProtocolModelServer
from repro_torch.core.serving import device_clock
from repro_torch.core.unextractable import (extraction_cost_flops, is_protocol_model,
                                            retrain_cost_flops)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import count_params, describe, serving_config
from repro_torch.models.model import build_model

#: the example's reduced width
REDUCED = dict(num_layers=4, d_model=256, num_heads=4, head_dim=64, d_ff=1024,
               vocab_size=2048)
NODES = [f"node{i}" for i in range(8)]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="protocol-125m")
    ap.add_argument("--full", action="store_true", help="the arch at full width")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the arch's)")
    ap.add_argument("--seq", type=int, default=16, help="tokens per prompt")
    ap.add_argument("--batch", type=int, default=4, help="prompts per request")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    ap.add_argument("--seed", type=int, default=0, help="weight-init seed")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serving_config(args.arch, args.full, args.layers, **REDUCED)
    model = build_model(cfg)
    params = model.init(args.seed, dev)
    n_params = count_params(params)
    print(describe(cfg, args.full, args.layers, n_params, dev))

    ledger = Ledger()
    for i, n in enumerate(NODES):
        ledger.record_contribution(n, float(1 + i % 3))    # training shares
    srv = ProtocolModelServer.create(model, params, NODES, ledger, num_shards=16,
                                     redundancy=2, max_fraction=0.35)
    print(f"model sharded into {srv.custody.num_shards} custody shards over "
          f"{len(NODES)} nodes (redundancy {srv.custody.redundancy}, max fraction 0.35)")
    batch = model.concrete_batch(args.seed + 1, args.batch, args.seq, dev)
    del batch["labels"]

    # 1. credential gating and transfer
    refused = None
    try:
        srv.serve("customer", batch)
    except CredentialError as e:
        refused = e
        print(f"no credentials -> refused: {e}")
    ledger.transfer("node0", "customer", 0.5)
    logits = srv.serve("customer", batch)
    print(f"after credential transfer: served batch of {args.batch} x {args.seq} tokens, "
          f"logits {tuple(logits.shape)}, top tok {int(torch.argmax(logits[0]))}")

    # 2. elasticity: serving survives a departure (redundancy 2) ...
    online = [n for n in NODES if n != "node3"]
    logits_online = srv.serve("customer", batch, online_nodes=online)
    print(f"node3 offline: still served ({srv.custody.tolerates_departures(['node3'])})")
    # ... but not a collapsed swarm, and the failure names the missing shards
    collapsed = None
    try:
        srv.serve("customer", batch, online_nodes=NODES[:2])
    except ExtractionError as e:
        collapsed = e
        print(f"swarm collapsed to 2 nodes -> {e}")
        print(f"  (missing shard ids: {srv.custody.missing_shards(NODES[:2])})")

    # 3. a coalition below full coverage extracts garbage
    coalition = NODES[:3]
    cov = srv.custody.coverage(coalition)
    broken = srv.attempt_extraction(coalition)
    with torch.inference_mode():
        t0 = device_clock(dev)
        ref = model.prefill(params, batch)
        prefill_s = device_clock(dev) - t0
        got = model.prefill(broken, batch)
    del broken
    extract_err = float((got - ref).abs().max())
    extract_rel = float((got - ref).norm() / ref.norm())
    print(f"coalition of 3 covers {cov * 100:.0f}% of shards; extracted-model logit "
          f"error: {extract_err:.2f} (relative L2 {extract_rel:.2f}: unusable)")
    print(f"prefill of {args.batch} x {args.seq} tokens: {prefill_s:.3f} s")

    # 4. the defining inequality: acquire-missing-shards vs retrain
    tokens = 20 * n_params                                 # chinchilla-ish
    cost_per_shard = retrain_cost_flops(n_params, tokens) / 4
    extract = extraction_cost_flops(srv.custody, coalition, cost_per_shard)
    retrain = retrain_cost_flops(n_params, tokens)
    protocol = is_protocol_model(srv.custody, coalition, n_params, tokens, cost_per_shard)
    print(f"extraction cost {extract:.2e} FLOPs vs retrain {retrain:.2e} "
          f"-> protocol model: {protocol}")
    print(f"min coalition for full coverage: "
          f"{srv.custody.min_extraction_coalition()} of {len(NODES)} nodes")
    return {"server": srv, "model": model, "params": params, "batch": batch,
            "logits": logits, "logits_online": logits_online, "ref": ref,
            "refused": refused, "collapsed": collapsed, "extract_err": extract_err,
            "extract_rel": extract_rel,
            "protocol_model": protocol, "prefill_s": prefill_s, "n_params": n_params}


if __name__ == "__main__":
    main()
