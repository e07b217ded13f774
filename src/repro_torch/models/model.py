"""``build_model(cfg)``: a model of a ported family as an ``nn.Module``
(twin of ``repro/models/model.py``).  The family picks the module, as the
reference's ``_family_module`` does: the dense, MoE and VLM families run
in ``models/transformer.py``, rwkv6 (the SSM family) in
``models/rwkv6.py``, zamba2 (the hybrid family) in ``models/hybrid.py``;
the audio family raises ``NotImplementedError`` naming its ROADMAP item.

The swarm works on param dicts functionally, as the reference does, so the
module's own surface is thin: ``init`` draws a fresh param dict,
``load_params`` registers a dict as the module's parameters (nested, so
``named_parameters()`` yields ``layers.attn.wq`` ...), ``loss`` is the
functional loss and ``forward(batch)`` the loss on the module's own
parameters.  Serving: ``prefill``, ``init_cache``, ``decode_step`` and
``decode_scan`` (the reference's scanned multi-token decode, here a loop
over ``decode_step``: the same math, and the logits at every position).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, rwkv6, transformer
from repro_torch.models.common import dtype_of
from repro_torch.models.convert import flat_order

Params = Dict[str, torch.Tensor]


def family_module(cfg: ModelConfig):
    """The module that runs ``cfg``'s family."""
    if cfg.family in (DENSE, MOE, VLM):
        return transformer
    if cfg.family == SSM:
        return rwkv6
    if cfg.family == HYBRID:
        return hybrid
    raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                              "(ROADMAP queue 1, item 11)")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.family = family_module(cfg)

    def init(self, seed: int = 0, device: DeviceLike = None) -> Params:
        return self.family.init_params(seed, self.cfg, resolve_device(device))

    def load_params(self, params: Params) -> None:
        for name in flat_order(self.cfg):
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, nn.Parameter(params[name]))

    def param_dict(self) -> Params:
        return {name: self.get_parameter(name) for name in flat_order(self.cfg)}

    def loss(self, params: Params, batch):
        return self.family.loss_fn(params, self.cfg, batch)

    def forward(self, batch):
        return self.loss(self.param_dict(), batch)

    # -- serving -----------------------------------------------------------------
    def prefill(self, params: Params, batch) -> torch.Tensor:
        return self.family.prefill(params, self.cfg, batch)

    def init_cache(self, batch: int, seq_len: int, device: DeviceLike = None):
        """A zero decode cache of ``batch`` rows at position 0 (a host int;
        ``decode_step`` also takes a (B,) tensor there, each row at its own
        position)."""
        return self.family.init_cache(self.cfg, batch, seq_len, resolve_device(device))

    @property
    def cache_batch_axes(self) -> Dict[str, int]:
        """The batch axis of each top-level cache entry but ``pos`` (for a
        nested entry, of each of its tensors)."""
        return self.family.CACHE_BATCH_AXES

    def decode_step(self, params: Params, tokens: torch.Tensor, cache):
        return self.family.decode_step(params, self.cfg, tokens, cache)

    def decode_scan(self, params: Params, tokens: torch.Tensor, cache):
        """Feed ``tokens`` (B, T) one position at a time through
        ``decode_step``: per-position logits (B, T, V) and the advanced
        cache."""
        logits = []
        for t in range(tokens.shape[1]):
            lg, cache = self.decode_step(params, tokens[:, t:t + 1], cache)
            logits.append(lg[:, 0])
        return torch.stack(logits, dim=1), cache

    def concrete_batch(self, seed: int, batch: int, seq: int,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A small concrete batch of random tokens and labels; a VLM's also
        holds ``media`` (B, M, d) normals in the model's dtype before its
        seq - M tokens, and the M-RoPE ``positions`` (3, B, seq), the
        streams (pos, pos // 4, pos % 4), as the reference's."""
        cfg = self.cfg
        g = torch.Generator().manual_seed(seed)
        m = cfg.num_media_tokens if cfg.family == VLM else 0
        out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq - m), generator=g),
               "labels": torch.randint(0, cfg.vocab_size, (batch, seq), generator=g)}
        if cfg.family == VLM:
            out.update(vlm_inputs(cfg, batch, seq, g))
        dev = resolve_device(device)
        return {k: t.to(dev) for k, t in out.items()}


def vlm_inputs(cfg: ModelConfig, batch: int, seq: int,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A VLM batch's stubbed media embeddings (B, M, d), standard normals in
    the model's dtype drawn from ``gen`` on the CPU, and its M-RoPE position
    streams (3, B, seq): (pos, pos // 4, pos % 4)."""
    media = torch.randn((batch, cfg.num_media_tokens, cfg.d_model), generator=gen)
    pos = torch.arange(seq).expand(batch, seq)
    return {"media": media.to(dtype_of(cfg)),
            "positions": torch.stack([pos, pos // 4, pos % 4])}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
