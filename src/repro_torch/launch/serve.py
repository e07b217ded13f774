"""Greedy serving driver over the Model API (twin of
``repro/launch/serve.py``).

    python -m repro_torch.launch.serve                    # reduced protocol-125m, on the card
    python -m repro_torch.launch.serve --arch h2o-danube-1.8b --full
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full   # 1,170,157,696 params
    python -m repro_torch.launch.serve --device cpu --driver loop

- ``--driver scan`` (default) and ``--driver loop``: ``core.serving.
  greedy_decode``.  The reference's two drivers are one eager loop here,
  so ``loop`` is another name for ``scan``;
- ``--driver engine``: the continuous-batching engine, not ported yet
  (ROADMAP queue 1, item 12).

The config is built with ``use_pallas_kernels`` set, as the serving path
takes the kernels; decoding steps through ``decode_step`` and runs none.
The parameter count printed is that of the params built.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.serving import ENGINE_ITEM, greedy_decode
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model


def serving_config(arch: str, full: bool, **reduced) -> ModelConfig:
    """``arch`` at full width, or ``.reduced(**reduced)``, with the kernel
    flag set."""
    cfg = get_config(arch)
    cfg = cfg if full else cfg.reduced(**reduced)
    return dataclasses.replace(cfg, use_pallas_kernels=True)


def count_params(params) -> int:
    """The number of parameters built (``ModelConfig.param_count`` is an
    analytic formula, which for rwkv6 counts ``cm_r`` as d x d_ff and for
    zamba2 omits ``dt_bias``)."""
    return sum(t.numel() for t in params.values())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="protocol-125m")
    ap.add_argument("--driver", default="scan", choices=("scan", "loop", "engine"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true", help="the arch at full width")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises when CUDA is missing)")
    ap.add_argument("--seed", type=int, default=0, help="weight-init seed")
    args = ap.parse_args(argv)
    if args.driver == "engine":
        raise NotImplementedError(f"--driver engine is not ported yet ({ENGINE_ITEM})")

    dev = resolve_device(args.device)
    cfg = serving_config(args.arch, args.full)
    model = build_model(cfg)
    params = model.init(args.seed, dev)
    print(f"model: {cfg.name} N={count_params(params):,} "
          f"({'full' if args.full else 'reduced'}) on {dev}, "
          f"use_pallas_kernels={cfg.use_pallas_kernels}")
    g = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g).to(dev)
    gen, stats = greedy_decode(model, params, prompts, args.max_new)
    print(f"arch={cfg.name} driver={args.driver} batch={stats.batch} "
          f"prefill={stats.prefill_s:.2f}s decode={stats.decode_s:.2f}s "
          f"({stats.tok_per_s:.1f} tok/s)")
    print("sample:", gen[0, :16].tolist())
    return {"tokens": gen, "stats": stats, "cfg": cfg}


if __name__ == "__main__":
    main()
