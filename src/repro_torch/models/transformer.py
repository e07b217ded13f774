"""Dense decoder-only transformer (twin of ``repro/models/transformer.py``).

Parameters are a flat ``{name: tensor}`` dict whose names mirror the
reference's nested tree (``layers.attn.wq`` is ``params["layers"]["attn"]
["wq"]`` there).  Layer weights are **stacked over layers** as in JAX —
``layers.attn.wq`` is one (L, d, H, hd) tensor — and the layers are applied
in a Python loop.  This module runs the dense family, with full or
sliding-window attention; rwkv6 runs in ``models/rwkv6.py``, zamba2 in
``models/hybrid.py`` (which takes its shared block's ``_qkv`` from here),
MoE, VLM and the others wait for ROADMAP queue 1, item 11.

Serving: :func:`prefill` is the full forward returning the last position's
logits; :func:`decode_step` feeds one token per sequence through a KV cache
of ``attention.cache_length`` slots (a ring buffer when the model has a
window), updating the cache's tensors in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models.attention import (attention, cache_insert, cache_length,
                                          decode_attention, row_positions)
from repro_torch.models.common import (apply_rope, chunked_softmax_xent,
                                       dense_init, dtype_of, embed_init, rms_norm,
                                       swiglu)
from repro_torch.random import _INIT, generator

Params = Dict[str, torch.Tensor]

def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.name}: models/transformer.py runs the dense family (rwkv6 runs "
            "in models/rwkv6.py, zamba2 in models/hybrid.py; the other families: "
            "ROADMAP queue 1, item 11)")


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


def _qkv(lp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhe->bshe", h, lp["wq"])
    k = torch.einsum("bsd,dhe->bshe", h, lp["wk"])
    v = torch.einsum("bsd,dhe->bshe", h, lp["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _layer_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(lp, cfg, h, positions)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                  use_pallas=cfg.use_pallas_kernels)
    x = x + torch.einsum("bshe,hed->bsd", o, lp["wo"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def layer_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                 vcache: torch.Tensor, pos) -> torch.Tensor:
    """One-token layer step.  x (B, 1, d); kcache/vcache (B, L, Hkv, hd),
    updated in place; ``pos`` a host int or a (B,) tensor of per-row
    positions."""
    ring = cfg.sliding_window is not None
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    pos = row_positions(pos, x.shape[0], x.device)
    q, k, v = _qkv(lp, cfg, h, pos[:, None])
    cache_insert(kcache, vcache, k, v, pos, ring=ring)
    o = decode_attention(q, kcache, vcache, pos, ring=ring)
    x = x + torch.einsum("bshe,hed->bsd", o, lp["wo"])
    h = rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


_LAYER_KEYS = {"wq": "layers.attn.wq", "wk": "layers.attn.wk",
               "wv": "layers.attn.wv", "wo": "layers.attn.wo",
               "w_gate": "layers.ffn.w_gate", "w_up": "layers.ffn.w_up",
               "w_down": "layers.ffn.w_down", "ln_attn": "layers.ln_attn",
               "ln_ffn": "layers.ln_ffn"}


def _per_layer(params: Params, cfg: ModelConfig):
    """One ``{short name: tensor}`` dict per layer.  Unbinds each stack once,
    so the backward stacks the per-layer grads in one op."""
    per_layer = {k: params[n].unbind(0) for k, n in _LAYER_KEYS.items()}
    return [{k: t[i] for k, t in per_layer.items()} for i in range(cfg.num_layers)]


def forward(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, d) and the (zero) MoE aux loss."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"])
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for lp in _per_layer(params, cfg):
        x = _layer_apply(lp, cfg, x, positions)
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


# -- serving -------------------------------------------------------------------
#: the batch axis of each cache tensor (the layer axis comes first)
CACHE_BATCH_AXES = {"k": 1, "v": 1}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device: torch.device) -> Dict:
    """Zero K/V caches (L, B, cache_length, Hkv, hd) in the model's dtype and
    position 0 (a host int; a (B,) tensor in its place puts each row at its
    own position)."""
    _check_family(cfg)
    lc = cache_length(seq_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, lc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device), "pos": 0}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict):
    """tokens (B, 1) -> logits (B, 1, V) float32 and the advanced cache
    (the same K/V tensors, written in place, and ``pos + 1``, on the
    device when ``pos`` is a per-row tensor)."""
    pos = cache["pos"]
    rows = row_positions(pos, tokens.shape[0], tokens.device)
    x = F.embedding(tokens, params["embed"])
    for i, lp in enumerate(_per_layer(params, cfg)):
        x = layer_decode(lp, cfg, x, cache["k"][i], cache["v"][i], rows)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.float(), unembed_of(params).float())
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full forward returning the last position's logits (B, V) float32."""
    h, _ = forward(params, cfg, batch)
    return torch.einsum("bd,dv->bv", h[:, -1].float(), unembed_of(params).float())
