"""Greedy serving driver over the Model API (twin of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve                    # reduced protocol-125m, on the card
    python -m repro_torch.launch.serve --arch h2o-danube-1.8b --full
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full   # 1,170,157,696 params
    python -m repro_torch.launch.serve --device cpu --driver loop
    python -m repro_torch.launch.serve --arch mixtral-8x7b --full --layers 3
    python -m repro_torch.launch.serve --driver engine --arch h2o-danube-1.8b --full \
        --batch 16 --slots 8 --prompt-len 64 --max-new 16

- ``--driver scan`` (default) and ``--driver loop``: ``core.serving.
  greedy_decode``.  The reference's two drivers are one eager loop here,
  so ``loop`` is another name for ``scan``;
- ``--driver engine``: the continuous-batching engine
  (``core.serving.ServingEngine``): ``--batch`` requests of ``--prompt-len``
  tokens, one arriving each step, through ``--slots`` decode slots, each
  decoding ``--max-new`` tokens; run twice, as the reference does (its
  first run compiles), and the second timed.

The config is built with ``use_pallas_kernels`` set, as the serving path
takes the kernels; decoding steps through ``decode_step`` and runs none.
The parameter count printed is that of the params built.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.serving import ServingConfig, ServingEngine, build_lane, greedy_decode
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model


def serving_config(arch: str, full: bool, layers: Optional[int] = None,
                   **reduced) -> ModelConfig:
    """``arch`` at full width, or ``.reduced(**reduced)``, with the kernel
    flag set and, where ``layers`` is given, its depth cut to that many
    layers (a run-size option: the width stays).  A reduced head dim keeps
    the proportions of the arch's M-RoPE split."""
    full_cfg = get_config(arch)
    cfg = full_cfg if full else full_cfg.reduced(**reduced)
    sec = full_cfg.mrope_sections
    if sec is not None and sum(cfg.mrope_sections) != cfg.resolved_head_dim // 2:
        scale = cfg.resolved_head_dim // 2 / sum(sec)
        cfg = dataclasses.replace(cfg, mrope_sections=tuple(int(s * scale) for s in sec))
    if layers is not None:
        if not 0 < layers <= full_cfg.num_layers:
            raise ValueError(f"--layers {layers}: {arch} has {full_cfg.num_layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, use_pallas_kernels=True)


def describe(cfg: ModelConfig, full: bool, layers: Optional[int], n_params: int,
             device) -> str:
    """The launchers' ``model:`` line: arch, params built, width, and the
    depth where ``--layers`` cut it."""
    cut = (f", depth cut to {layers} of {get_config(cfg.name).num_layers} layers"
           if layers is not None else "")
    return (f"model: {cfg.name} N={n_params:,} ({'full' if full else 'reduced'}{cut}) "
            f"on {device}, use_pallas_kernels={cfg.use_pallas_kernels}")


def count_params(params) -> int:
    """The number of parameters built (``ModelConfig.param_count`` is an
    analytic formula, which for rwkv6 counts ``cm_r`` as d x d_ff and for
    zamba2 omits ``dt_bias``)."""
    return sum(t.numel() for t in params.values())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="protocol-125m")
    ap.add_argument("--driver", default="scan", choices=("scan", "loop", "engine"))
    ap.add_argument("--batch", type=int, default=4,
                    help="batch (scan/loop) or request count (engine)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4, help="engine: decode slot-pool size")
    ap.add_argument("--full", action="store_true", help="the arch at full width")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the arch's)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    ap.add_argument("--seed", type=int, default=0, help="weight-init seed")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serving_config(args.arch, args.full, args.layers)
    model = build_model(cfg)
    params = model.init(args.seed, dev)
    print(describe(cfg, args.full, args.layers, count_params(params), dev))
    g = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g).to(dev)
    if args.driver == "engine":
        return run_engine(args, model, params, prompts)
    gen, stats = greedy_decode(model, params, prompts, args.max_new)
    print(f"arch={cfg.name} driver={args.driver} batch={stats.batch} "
          f"prefill={stats.prefill_s:.2f}s decode={stats.decode_s:.2f}s "
          f"({stats.tok_per_s:.1f} tok/s)")
    print("sample:", gen[0, :16].tolist())
    return {"tokens": gen, "stats": stats, "cfg": cfg}


def run_engine(args, model, params, prompts) -> dict:
    """The reference's engine branch: a horizon long enough for every wave
    of requests, 8 custody-free nodes, 4 holders funding every request."""
    plen, new, n = args.prompt_len, args.max_new, args.batch
    scfg = ServingConfig(slots=args.slots, max_new=new,
                         steps=plen + new + (plen + new) * ((n + args.slots - 1) // args.slots))
    lane = build_lane(n_requests=n, prompt_lens=np.full(n, plen, np.int32), max_new=new,
                      steps=scfg.steps, n_nodes=8, balances=[float(n)] * 4, fee=1.0,
                      load=1.0, device=prompts.device)
    engine = ServingEngine(model, scfg, prompts, device=prompts.device)
    engine.run(params, lane)                     # the first run, as the reference's warm-up
    res = engine.run(params, lane)
    cfg = model.cfg
    print(f"arch={cfg.name} engine slots={scfg.slots} requests={n} "
          f"served={int(res.done.sum())} tokens={res.tokens_served} "
          f"({res.tok_per_s:.1f} tok/s, {1e3 * res.wall_s / scfg.steps:.2f} ms a step, "
          f"availability {res.availability:.2f})")
    print("sample:", res.tokens[0, :16].tolist())
    return {"result": res, "engine": engine, "lane": lane, "model": model,
            "params": params, "prompts": prompts, "cfg": cfg}


if __name__ == "__main__":
    main()
