"""Deterministic synthetic LM data (twin of ``repro/data/pipeline.py``).

Token streams from a small mixture of Markov chains, so a model reduces its
loss on them.  ``(seed, step, shard)`` fully determines a batch, which the
§4.2 audit path depends on: a validator can recompute any contributor's
batch.  The Markov table is the reference's numpy table exactly; the start
states and branch choices come from the port's key schedule
(``random.generator``), so tokens differ from JAX's.  They are drawn on the
CPU and then moved, so a batch is the same on every device.

The LM batch serves the dense, MoE, SSM (rwkv6) and hybrid (zamba2)
families, as in the reference.  ``model_batch`` gives a VLM batch its
media stubs (normals from the port's key schedule) and M-RoPE position
streams; the audio branch waits for its model family (ROADMAP queue 1,
item 11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import AUDIO, VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import vlm_inputs
from repro_torch.random import _DATA, generator


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_states: int = 32          # markov states; structure the model can learn
    branch: int = 4               # out-degree per state


def _transition_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    table = rng.integers(0, cfg.vocab_size, size=(cfg.num_states, cfg.branch))
    return table.astype(np.int32)


def sample_tokens(cfg: DataConfig, step: int, *, shard: int = 0,
                  num_shards: int = 1, device: DeviceLike = None) -> torch.Tensor:
    """(local_batch, seq_len+1) int64 tokens — deterministic in (seed, step,
    shard)."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {num_shards} shards")
    dev = resolve_device(device)
    local = cfg.global_batch // num_shards
    g = generator(cfg.seed, _DATA, step, shard, device=torch.device("cpu"))
    table = torch.from_numpy(_transition_table(cfg)).long()
    state = torch.randint(0, cfg.num_states, (local,), generator=g)
    choices = torch.randint(0, cfg.branch, (local, cfg.seq_len + 1), generator=g)
    toks = torch.empty((local, cfg.seq_len + 1), dtype=torch.long)
    for t in range(cfg.seq_len + 1):
        tok = table[state, choices[:, t]]
        toks[:, t] = tok
        state = tok % cfg.num_states
    return toks.to(dev)


def lm_batch(cfg: DataConfig, step: int, *, shard: int = 0,
             num_shards: int = 1, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    toks = sample_tokens(cfg, step, shard=shard, num_shards=num_shards,
                         device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def model_batch(mcfg: ModelConfig, cfg: DataConfig, step: int, *, shard: int = 0,
                num_shards: int = 1, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Family-aware batch.  A VLM's holds the first seq - M tokens, the
    media stubs (B, M, d) drawn from ``(seed, _DATA, step, shard + 10,000)``
    (the reference's key for them) and the position streams (pos, pos // 4,
    pos % 4)."""
    if mcfg.family == AUDIO:
        raise NotImplementedError(
            f"model_batch for the {mcfg.family!r} family waits for its model "
            "slice (ROADMAP queue 1, item 11)")
    base = lm_batch(cfg, step, shard=shard, num_shards=num_shards, device=device)
    if mcfg.family == VLM:
        b, s = base["tokens"].shape[0], cfg.seq_len
        base["tokens"] = base["tokens"][:, :s - mcfg.num_media_tokens]
        g = generator(cfg.seed, _DATA, step, shard + 10_000, device=torch.device("cpu"))
        dev = base["tokens"].device
        base.update({k: t.to(dev) for k, t in vlm_inputs(mcfg, b, s, g).items()})
    return base


def data_fn_for_swarm(mcfg: ModelConfig, cfg: DataConfig, num_nodes: int,
                      device: DeviceLike = None):
    """Adapter for core.swarm: node i reads shard (i mod num_nodes)."""
    if cfg.global_batch % num_nodes:
        raise ValueError("global batch must split across nodes")
    dev = resolve_device(device)

    def fn(node_idx: int, rnd: int):
        return model_batch(mcfg, cfg, rnd, shard=node_idx % num_nodes,
                           num_shards=num_nodes, device=dev)
    return fn
