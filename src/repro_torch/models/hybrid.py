"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention block
applied after each group of mamba layers (twin of
``repro/models/hybrid.py``).  [arXiv:2411.15242]

38 mamba layers with ``mamba_per_group`` 6 give 6 groups of 6 (the shared
block after each group) and 2 remainder layers.  The shared block's
weights are the same at every application, as in zamba2.

Parameters are a flat ``{name: tensor}`` dict named after the reference's
nested tree: ``groups.*`` stacked (groups, per group, ...), ``rem.*``
stacked (remainder, ...), ``shared.attn.*``, ``shared.ffn.*``,
``shared.ln_*``, ``embed``, ``ln_f`` and ``unembed``; the layers run in a
Python loop.  The shared block is a dense transformer layer
(``transformer._layer_apply`` / ``layer_decode`` on ``shared.*``); zamba2
has no window, so with ``use_pallas_kernels`` its prefill attention is the
``swa_attention`` kernel at window = S (full causal), and without it the
blockwise online softmax of ``models/attention.py``.  Decode keeps one
full-length K/V cache per application of the shared block (no ring) and
one SSD state and conv buffer per mamba layer, updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2
from repro_torch.models.attention import row_positions
from repro_torch.models.common import (chunked_softmax_xent, dense_init, dtype_of,
                                       embed_init, rms_norm)
from repro_torch.models.transformer import _layer_apply, layer_decode, unembed_of
from repro_torch.random import _INIT, generator

Params = Dict[str, torch.Tensor]

_SHARED = {"wq": "shared.attn.wq", "wk": "shared.attn.wk", "wv": "shared.attn.wv",
           "wo": "shared.attn.wo", "w_gate": "shared.ffn.w_gate",
           "w_up": "shared.ffn.w_up", "w_down": "shared.ffn.w_down",
           "ln_attn": "shared.ln_attn", "ln_ffn": "shared.ln_ffn"}


def group_counts(cfg: ModelConfig) -> Tuple[int, int]:
    g = cfg.num_layers // cfg.mamba_per_group
    return g, cfg.num_layers - g * cfg.mamba_per_group


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every parameter, stacked as the
    reference stacks them."""
    d, hd, f, v = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    dt, f32 = dtype_of(cfg), torch.float32
    g, rem = group_counts(cfg)
    layer = {f"mamba.{k}": s for k, s in mamba2.block_shapes(cfg, dt).items()}
    layer["ln"] = ((d,), f32)
    out = {f"groups.{k}": ((g, cfg.mamba_per_group, *s), t) for k, (s, t) in layer.items()}
    if rem:
        out.update({f"rem.{k}": ((rem, *s), t) for k, (s, t) in layer.items()})
    out.update({
        "embed": ((v, d), dt),
        "shared.attn.wq": ((d, h, hd), dt), "shared.attn.wk": ((d, hkv, hd), dt),
        "shared.attn.wv": ((d, hkv, hd), dt), "shared.attn.wo": ((h, hd, d), dt),
        "shared.ffn.w_gate": ((d, f), dt), "shared.ffn.w_up": ((d, f), dt),
        "shared.ffn.w_down": ((f, d), dt),
        "shared.ln_attn": ((d,), f32), "shared.ln_ffn": ((d,), f32),
        "ln_f": ((d,), f32), "unembed": ((d, v), dt)})
    return out


def init_params(seed: int, cfg: ModelConfig, device: torch.device) -> Params:
    """Random params in the flat order, each tensor from its own generator
    of the key schedule (``(seed, _INIT, index)``), with the reference's
    distributions: ``a_log`` zeros, ``d_skip`` and norm scales ones,
    ``dt_bias`` uniform in [-4, -2), ``conv_w`` std 0.5, the rest fan-in
    (read from one layer's shape)."""
    shapes = param_shapes(cfg)
    params = {}
    for i, name in enumerate(sorted(shapes)):
        shape, dt = shapes[name]
        g = generator(seed, _INIT, i, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln") or leaf == "d_skip":
            params[name] = torch.ones(shape, dtype=dt, device=device)
        elif leaf == "a_log":
            params[name] = torch.zeros(shape, dtype=dt, device=device)
        elif leaf == "dt_bias":
            params[name] = torch.rand(shape, generator=g, device=device) * 2 - 4.0
        elif leaf == "embed":
            params[name] = embed_init(g, shape, dt, device)
        else:
            stacked = {"groups": 2, "rem": 1}.get(name.split(".", 1)[0], 0)
            scale = 0.5 if leaf == "conv_w" else None
            params[name] = dense_init(g, shape, dt, device, fan_shape=shape[stacked:],
                                      scale=scale)
    return params


def _mamba_stack(params: Params, prefix: str, depth: int) -> List[Params]:
    """One ``{short name: tensor}`` dict per layer of a stack already
    indexed down to its layer axis (``depth`` leading axes)."""
    names = [n for n in params if n.startswith(prefix + ".")]
    flat = {n[len(prefix) + 1:].split(".")[-1]: params[n].flatten(0, depth - 1).unbind(0)
            for n in names}
    count = len(next(iter(flat.values())))
    return [{k: t[i] for k, t in flat.items()} for i in range(count)]


def mamba_layers(params: Params, cfg: ModelConfig) -> Tuple[List[Params], List[Params]]:
    """The group layers in order (group by group) and the remainder layers."""
    rem = _mamba_stack(params, "rem", 1) if "rem.ln" in params else []
    return _mamba_stack(params, "groups", 2), rem


def shared_block(params: Params) -> Params:
    """The shared block's params, named as a dense layer's."""
    return {k: params[n] for k, n in _SHARED.items()}


def _mamba_layer(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mamba2.mamba_block_apply(lp, cfg, rms_norm(x, lp["ln"], cfg.norm_eps))


def forward(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, d) and a zero aux loss."""
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"])
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    groups, rem = mamba_layers(params, cfg)
    sp = shared_block(params)
    for gi in range(len(groups) // cfg.mamba_per_group):
        for lp in groups[gi * cfg.mamba_per_group:(gi + 1) * cfg.mamba_per_group]:
            x = _mamba_layer(lp, cfg, x)
        x = _layer_apply(sp, cfg, x, positions)
    for lp in rem:
        x = _mamba_layer(lp, cfg, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch):
    h, _ = forward(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    xent = chunked_softmax_xent(h, unembed_of(params), labels, mask, cfg.xent_chunk)
    return xent, {"xent": xent}


# -- serving -------------------------------------------------------------------
#: the batch axis of each cache tensor: ``mamba_g`` is stacked (groups,
#: layers a group, B, ...), the others (layers or applications, B, ...)
CACHE_BATCH_AXES = {"mamba_g": 2, "mamba_rem": 1, "attn_k": 1, "attn_v": 1}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device: torch.device) -> Dict:
    """The reference's cache: per mamba layer a zero SSD state (float32) and
    conv buffer (model dtype), stacked as the params are (``mamba_g``,
    ``mamba_rem``); per application of the shared block a zero K/V cache
    of ``seq_len`` slots (no ring); position 0 (a host int, or a (B,)
    tensor of per-row positions in its place)."""
    dtype = dtype_of(cfg)
    g, rem = group_counts(cfg)
    m = mamba2.init_mamba_cache(cfg, batch, dtype, device)
    kv = (g, batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"mamba_g": {k: t.new_zeros((g, cfg.mamba_per_group, *t.shape))
                         for k, t in m.items()},
             "attn_k": torch.zeros(kv, dtype=dtype, device=device),
             "attn_v": torch.zeros(kv, dtype=dtype, device=device), "pos": 0}
    if rem:
        cache["mamba_rem"] = {k: t.new_zeros((rem, *t.shape)) for k, t in m.items()}
    return cache


def _mamba_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
                  conv: torch.Tensor) -> torch.Tensor:
    return x + mamba2.mamba_block_decode(lp, cfg, rms_norm(x, lp["ln"], cfg.norm_eps), h, conv)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict):
    """tokens (B, 1) -> logits (B, 1, V) float32 and the advanced cache (the
    same tensors, written in place, and ``pos + 1``)."""
    pos = cache["pos"]
    rows = row_positions(pos, tokens.shape[0], tokens.device)
    x = F.embedding(tokens, params["embed"])
    groups, rem = mamba_layers(params, cfg)
    sp = shared_block(params)
    m = cfg.mamba_per_group
    mg = cache["mamba_g"]
    for gi in range(len(groups) // m):
        for li in range(m):
            x = _mamba_decode(groups[gi * m + li], cfg, x, mg["h"][gi, li], mg["conv"][gi, li])
        x = layer_decode(sp, cfg, x, cache["attn_k"][gi], cache["attn_v"][gi], rows)
    for ri, lp in enumerate(rem):
        x = _mamba_decode(lp, cfg, x, cache["mamba_rem"]["h"][ri],
                          cache["mamba_rem"]["conv"][ri])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.float(), unembed_of(params).float())
    return logits, {**cache, "pos": pos + 1}


def prefill(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full forward returning the last position's logits (B, V) float32."""
    h, _ = forward(params, cfg, batch)
    return torch.einsum("bd,dv->bv", h[:, -1].float(), unembed_of(params).float())
