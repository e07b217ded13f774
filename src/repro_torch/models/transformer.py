"""Dense decoder-only transformer (twin of ``repro/models/transformer.py``).

Parameters are a flat ``{name: tensor}`` dict whose names mirror the
reference's nested tree (``layers.attn.wq`` is ``params["layers"]["attn"]
["wq"]`` there).  Layer weights are **stacked over layers** as in JAX —
``layers.attn.wq`` is one (L, d, H, hd) tensor — and the layers are applied
in a Python loop.  Only the dense family is ported; MoE, VLM and the other
families wait for their slices (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models.attention import attention
from repro_torch.models.common import (apply_rope, chunked_softmax_xent,
                                       dense_init, embed_init, rms_norm, swiglu)
from repro_torch.random import _INIT, generator

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != DENSE or cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention models are ported so far "
            "(other families and sliding windows: ROADMAP queue 1, item 9)")


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every parameter, stacked over layers."""
    _check_family(cfg)
    d, hd, L, f = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers, cfg.d_ff
    h, hkv, v = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
    dt, f32 = dtype_of(cfg), torch.float32
    out = {
        "embed": ((v, d), dt),
        "layers.attn.wq": ((L, d, h, hd), dt),
        "layers.attn.wk": ((L, d, hkv, hd), dt),
        "layers.attn.wv": ((L, d, hkv, hd), dt),
        "layers.attn.wo": ((L, h, hd, d), dt),
        "layers.ffn.w_gate": ((L, d, f), dt),
        "layers.ffn.w_up": ((L, d, f), dt),
        "layers.ffn.w_down": ((L, f, d), dt),
        "layers.ln_attn": ((L, d), f32),
        "layers.ln_ffn": ((L, d), f32),
        "ln_f": ((d,), f32),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ((d, v), dt)
    return out


def init_params(seed: int, cfg: ModelConfig, device: torch.device) -> Params:
    """Random params in the flat order, each tensor from its own generator
    of the key schedule (``(seed, _INIT, index)``).  Norm scales are ones."""
    shapes = param_shapes(cfg)
    params = {}
    for i, name in enumerate(sorted(shapes)):
        shape, dt = shapes[name]
        g = generator(seed, _INIT, i, device=device)
        if name.startswith("layers.ln") or name == "ln_f":
            params[name] = torch.ones(shape, dtype=dt, device=device)
        elif name == "embed":
            params[name] = embed_init(g, shape, dt, device)
        else:
            fan = shape[1:] if name.startswith("layers.") else shape
            params[name] = dense_init(g, shape, dt, device, fan_shape=fan)
    return params


def unembed_of(params: Params) -> torch.Tensor:
    return params["unembed"] if "unembed" in params else params["embed"].T


def _layer_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = torch.einsum("bsd,dhe->bshe", h, lp["wq"])
    k = torch.einsum("bsd,dhe->bshe", h, lp["wk"])
    v = torch.einsum("bsd,dhe->bshe", h, lp["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True)
    x = x + torch.einsum("bshe,hed->bsd", o, lp["wo"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


_LAYER_KEYS = {"wq": "layers.attn.wq", "wk": "layers.attn.wk",
               "wv": "layers.attn.wv", "wo": "layers.attn.wo",
               "w_gate": "layers.ffn.w_gate", "w_up": "layers.ffn.w_up",
               "w_down": "layers.ffn.w_down", "ln_attn": "layers.ln_attn",
               "ln_ffn": "layers.ln_ffn"}


def forward(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, d) and the (zero) MoE aux loss."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"])
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    # unbind once: its backward stacks the per-layer grads in one op
    per_layer = {k: params[n].unbind(0) for k, n in _LAYER_KEYS.items()}
    for i in range(cfg.num_layers):
        x = _layer_apply({k: t[i] for k, t in per_layer.items()}, cfg, x,
                         positions)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch):
    h, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    xent = chunked_softmax_xent(h, unembed_of(params), labels, mask,
                                cfg.xent_chunk)
    return xent + cfg.router_aux_loss_coef * aux, {"xent": xent, "moe_aux": aux}
