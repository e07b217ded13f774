"""Decoder-only transformer: the dense, MoE and VLM families (twin of
``repro/models/transformer.py``).

Parameters are a flat ``{name: tensor}`` dict whose names mirror the
reference's nested tree (``layers.attn.wq`` is ``params["layers"]["attn"]
["wq"]`` there).  Layer weights are **stacked over layers** as in JAX —
``layers.attn.wq`` is one (L, d, H, hd) tensor — and the layers are applied
in a Python loop.  This module runs the dense family, with full or
sliding-window attention; the MoE family, whose ``layers.moe.*`` FFN is
``models/moe.py`` (the router float32, the experts stacked (L, E, ...));
and the VLM backbone, whose stubbed media embeddings (B, M, d) go before
the tokens and whose queries and keys take M-RoPE over (3, B, S) position
streams.  rwkv6 runs in ``models/rwkv6.py``, zamba2 in ``models/hybrid.py``
(which takes its shared block's ``_qkv`` from here); the audio family
waits for ROADMAP queue 1, item 11.

Serving: :func:`prefill` is the full forward returning the last position's
logits; :func:`decode_step` feeds one token per sequence through a KV cache
of ``attention.cache_length`` slots (a ring buffer when the model has a
window), updating the cache's tensors in place.  As in the reference, a
prefill's MoE runs at ``cfg.moe_capacity_factor`` (it can drop tokens) and
a decode step's at E / k (it drops none), and a decode step gives all three
M-RoPE streams the token's position.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DENSE, MOE, VLM, ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (attention, cache_insert, cache_length,
                                          decode_attention, row_positions)
from repro_torch.models.common import (apply_mrope, apply_rope, chunked_softmax_xent,
                                       dense_init, dtype_of, embed_init, rms_norm,
                                       swiglu)
from repro_torch.random import _INIT, generator

Params = Dict[str, torch.Tensor]

def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in (DENSE, MOE, VLM):
        raise NotImplementedError(
            f"{cfg.name}: models/transformer.py runs the dense, MoE and VLM families "
            "(rwkv6 runs in models/rwkv6.py, zamba2 in models/hybrid.py; the audio "
            "family: ROADMAP queue 1, item 11)")


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
        "layers.ln_attn": ((L, d), f32),
        "layers.ln_ffn": ((L, d), f32),
        "ln_f": ((d,), f32),
    }
    if cfg.family == MOE:
        e = cfg.num_experts
        out.update({"layers.moe.router": ((L, d, e), f32),
                    "layers.moe.w_gate": ((L, e, d, f), dt),
                    "layers.moe.w_up": ((L, e, d, f), dt),
                    "layers.moe.w_down": ((L, e, f, d), dt)})
    else:
        out.update({"layers.ffn.w_gate": ((L, d, f), dt),
                    "layers.ffn.w_up": ((L, d, f), dt),
                    "layers.ffn.w_down": ((L, f, d), dt)})
    if not cfg.tie_embeddings:
        out["unembed"] = ((d, v), dt)
    return out


def init_params(seed: int, cfg: ModelConfig, device: torch.device) -> Params:
    """Random params in the flat order, each tensor from its own generator
    of the key schedule (``(seed, _INIT, index)``).  Norm scales are ones;
    a stacked weight's fan-in is read from one layer's shape, as the
    reference inits each layer (and ``init_moe`` each expert stack)."""
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
    """Projections with RoPE; with ``cfg.mrope_sections`` set, M-RoPE over
    ``positions`` (3, B, S)."""
    q = torch.einsum("bsd,dhe->bshe", h, lp["wq"])
    k = torch.einsum("bsd,dhe->bshe", h, lp["wk"])
    v = torch.einsum("bsd,dhe->bshe", h, lp["wv"])
    if cfg.mrope_sections is not None:
        sec = cfg.mrope_sections
        return (apply_mrope(q, positions, cfg.rope_theta, sec),
                apply_mrope(k, positions, cfg.rope_theta, sec), v)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(lp: Params, cfg: ModelConfig, h: torch.Tensor,
         capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on normed h: SwiGLU, or the MoE at
    ``capacity_factor``.  Returns (update, MoE aux loss)."""
    if cfg.family == MOE:
        return moe_lib.moe_ffn(h, lp["moe"], top_k=cfg.experts_per_token,
                               capacity_factor=capacity_factor)
    return (swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def decode_capacity_factor(cfg: ModelConfig) -> float:
    """The MoE capacity factor of a decode step, E / k: one token's k
    distinct experts never overflow."""
    return float(cfg.num_experts) / max(cfg.experts_per_token, 1)


def layer_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer.  Returns (x, MoE aux loss), the MoE at
    ``cfg.moe_capacity_factor``."""
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(lp, cfg, h, positions)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window,
                  use_pallas=cfg.use_pallas_kernels)
    x = x + torch.einsum("bshe,hed->bsd", o, lp["wo"])
    f, aux = _ffn(lp, cfg, rms_norm(x, lp["ln_ffn"], cfg.norm_eps),
                  cfg.moe_capacity_factor)
    return x + f, aux


def _layer_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """:func:`layer_apply` without its aux loss."""
    return layer_apply(lp, cfg, x, positions)[0]


def decode_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """A decode step's RoPE positions from the (B,) row positions: (B, 1),
    or (3, B, 1) under M-RoPE, every stream the token's position (the
    reference's decode; a prefill batch's streams are (pos, pos // 4,
    pos % 4))."""
    if cfg.mrope_sections is not None:
        return pos[None, :, None].expand(3, pos.shape[0], 1)
    return pos[:, None]


def layer_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                 vcache: torch.Tensor, pos) -> torch.Tensor:
    """One-token layer step.  x (B, 1, d); kcache/vcache (B, L, Hkv, hd),
    updated in place; ``pos`` a host int or a (B,) tensor of per-row
    positions.  The MoE runs at capacity factor E / k."""
    ring = cfg.sliding_window is not None
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    pos = row_positions(pos, x.shape[0], x.device)
    q, k, v = _qkv(lp, cfg, h, decode_positions(cfg, pos))
    cache_insert(kcache, vcache, k, v, pos, ring=ring)
    o = decode_attention(q, kcache, vcache, pos, ring=ring)
    x = x + torch.einsum("bshe,hed->bsd", o, lp["wo"])
    f, _ = _ffn(lp, cfg, rms_norm(x, lp["ln_ffn"], cfg.norm_eps),
                decode_capacity_factor(cfg))
    return x + f


_ATTN_KEYS = {"wq": "layers.attn.wq", "wk": "layers.attn.wk",
              "wv": "layers.attn.wv", "wo": "layers.attn.wo",
              "ln_attn": "layers.ln_attn", "ln_ffn": "layers.ln_ffn"}
_FFN_KEYS = {"w_gate": "layers.ffn.w_gate", "w_up": "layers.ffn.w_up",
             "w_down": "layers.ffn.w_down"}
_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _per_layer(params: Params, cfg: ModelConfig):
    """One ``{short name: tensor}`` dict per layer (an MoE layer's FFN a
    dict under ``moe``).  Unbinds each stack once, so the backward stacks
    the per-layer grads in one op."""
    stacks = {k: params[n].unbind(0) for k, n in _ATTN_KEYS.items()}
    moe = {}
    if cfg.family == MOE:
        moe = {k: params[f"layers.moe.{k}"].unbind(0) for k in _MOE_KEYS}
    else:
        stacks.update({k: params[n].unbind(0) for k, n in _FFN_KEYS.items()})
    layers = [{k: t[i] for k, t in stacks.items()} for i in range(cfg.num_layers)]
    for i, lp in enumerate(layers):
        if moe:
            lp["moe"] = {k: t[i] for k, t in moe.items()}
    return layers


def positions_for(cfg: ModelConfig, batch, seq: int) -> torch.Tensor:
    """The batch's RoPE positions: its (3, B, S) ``positions`` under M-RoPE,
    else 0..S-1 on every row."""
    if cfg.mrope_sections is not None:
        return batch["positions"]
    tokens = batch["tokens"]
    return torch.arange(seq, device=tokens.device).expand(tokens.shape[0], seq)


def embed_inputs(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, after the VLM's media embeddings (B, M, d) where
    the model takes them."""
    tok = F.embedding(batch["tokens"], params["embed"])
    if cfg.family == VLM and cfg.num_media_tokens:
        tok = torch.cat([batch["media"].to(tok.dtype), tok], dim=1)
    return tok


def forward(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, d) and the MoE aux loss summed over the
    layers (zero for the dense and VLM families)."""
    _check_family(cfg)
    x = embed_inputs(params, cfg, batch)
    positions = positions_for(cfg, batch, x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _per_layer(params, cfg):
        x, a = layer_apply(lp, cfg, x, positions)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux


def loss_fn(params: Params, cfg: ModelConfig, batch):
    h, aux = forward(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        if cfg.family == VLM and cfg.num_media_tokens:
            mask[:, :cfg.num_media_tokens] = 0.0
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
