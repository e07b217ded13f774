"""Config registry of the port: ``get_config("protocol-125m")``.

Holds only the configurations whose model family the port runs so far.
"""
from __future__ import annotations

from repro_torch.configs.base import DENSE, HYBRID, SSM, ModelConfig
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _h2o_danube
from repro_torch.configs.protocol_125m import CONFIG as _protocol_125m
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

REGISTRY = {c.name: c for c in (_protocol_125m, _h2o_danube, _rwkv6, _zamba2)}


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None


__all__ = ["DENSE", "HYBRID", "SSM", "ModelConfig", "REGISTRY", "get_config"]
