"""``build_model(cfg)``: the dense model as an ``nn.Module`` (twin of
``repro/models/model.py``).

The swarm works on param dicts functionally, as the reference does, so the
module's own surface is thin: ``init`` draws a fresh param dict,
``load_params`` registers a dict as the module's parameters (nested, so
``named_parameters()`` yields ``layers.attn.wq`` ...), ``loss`` is the
functional loss and ``forward(batch)`` the loss on the module's own
parameters.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.convert import flat_order

Params = Dict[str, torch.Tensor]


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, seed: int = 0, device: DeviceLike = None) -> Params:
        return transformer.init_params(seed, self.cfg, resolve_device(device))

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
        return transformer.loss_fn(params, self.cfg, batch)

    def forward(self, batch):
        return self.loss(self.param_dict(), batch)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
