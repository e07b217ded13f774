"""Config registry of the port: ``get_config("mixtral-8x7b")``.

Holds every configuration of the reference's registry whose model family
the port runs: all but seamless-m4t-medium, whose audio family waits for
ROADMAP queue 1, item 11.
"""
from __future__ import annotations

from repro_torch.configs.base import (AUDIO, DENSE, FAMILIES, HYBRID, INPUT_SHAPES, MOE,
                                      SSM, VLM, ModelConfig, ShapeConfig)
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _h2o_danube
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.protocol_125m import CONFIG as _protocol_125m
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm_3b
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

# the reference's registry order, seamless-m4t-medium left out
REGISTRY = {
    c.name: c
    for c in (
        _stablelm_3b,
        _mixtral_8x7b,
        _h2o_danube,
        _zamba2,
        _rwkv6,
        _qwen2_vl,
        _granite,
        _tinyllama,
        _qwen3_moe,
        _protocol_125m,
    )
}

ASSIGNED_ARCHS = [n for n in REGISTRY if n != "protocol-125m"]


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}") from None


def get_shape(name: str) -> ShapeConfig:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}") from None


def applicable_shapes(cfg: ModelConfig) -> list:
    """The assigned input shapes this architecture runs: every arch trains,
    prefills and decodes at 32k; the sub-quadratic ones also decode 500k."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_decode:
        out.append("long_500k")
    return out


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "REGISTRY",
    "ASSIGNED_ARCHS",
    "INPUT_SHAPES",
    "get_config",
    "get_shape",
    "applicable_shapes",
    "DENSE",
    "MOE",
    "HYBRID",
    "SSM",
    "VLM",
    "AUDIO",
    "FAMILIES",
]
