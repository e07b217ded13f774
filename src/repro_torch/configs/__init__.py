"""Config registry of the port: ``get_config("protocol-125m")``.

Holds only the configurations whose model family the port runs so far.
"""
from __future__ import annotations

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _h2o_danube
from repro_torch.configs.protocol_125m import CONFIG as _protocol_125m

REGISTRY = {c.name: c for c in (_protocol_125m, _h2o_danube)}


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None


__all__ = ["DENSE", "ModelConfig", "REGISTRY", "get_config"]
