"""RWKV6 ("Finch"), attention-free with data-dependent per-channel decay
(twin of ``repro/models/rwkv6.py``).  [arXiv:2404.05892]

Time-mix recurrence per head (K = V = head dim):
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ          S ∈ R^{K×V}
    y_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t
with w_t ∈ (0,1)^K a low-rank projection of the shifted input.

Parameters are a flat ``{name: tensor}`` dict named after the reference's
nested tree (``layers.block.w_r`` is ``params["layers"]["block"]["w_r"]``
there), with layer weights stacked over layers and the layers applied in a
Python loop, as in ``models/transformer.py``.

Prefill runs the WKV through ``kernels/rwkv6_wkv/ops.wkv`` (the CUDA kernel
on the card) when ``cfg.use_pallas_kernels`` is set, else through
:func:`wkv_chunked` with chunks of 256, the reference's own twin.  Both
routes cast w to the model's dtype first, and y comes back in it, as in the
reference; decode keeps w and y in float32 (see ROADMAP queue 3).  Decode
updates the cache's recurrent state and shift vectors in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv.ops import wkv
from repro_torch.models.common import (chunked_softmax_xent, dense_init, dtype_of,
                                       embed_init, rms_norm)
from repro_torch.random import _INIT, generator

Params = Dict[str, torch.Tensor]

_BLOCK = ("cm_k", "cm_r", "cm_v", "decay_base", "ln_x", "mu", "mu_cm", "u_bonus",
          "w_decay_a", "w_decay_b", "w_g", "w_k", "w_o", "w_r", "w_v")
_LAYER_KEYS = {**{k: f"layers.block.{k}" for k in _BLOCK},
               "ln_tm": "layers.ln_tm", "ln_cm": "layers.ln_cm"}


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of every parameter, stacked over layers."""
    d, L, f, v = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    lora = max(32, d // 16)
    dt, f32 = dtype_of(cfg), torch.float32
    block = {
        "mu": ((5, d), f32), "w_r": ((d, d), dt), "w_k": ((d, d), dt),
        "w_v": ((d, d), dt), "w_g": ((d, d), dt), "w_o": ((d, d), dt),
        "w_decay_a": ((d, lora), dt), "w_decay_b": ((lora, d), dt),
        "decay_base": ((d,), f32), "u_bonus": ((d,), f32), "ln_x": ((d,), f32),
        "mu_cm": ((2, d), f32), "cm_k": ((d, f), dt), "cm_v": ((f, d), dt),
        "cm_r": ((d, d), dt),
    }
    out = {f"layers.block.{k}": ((L, *s), t) for k, (s, t) in block.items()}
    out.update({"embed": ((v, d), dt), "ln_in": ((d,), f32),
                "layers.ln_tm": ((L, d), f32), "layers.ln_cm": ((L, d), f32),
                "ln_f": ((d,), f32), "unembed": ((d, v), dt)})
    return out


def init_params(seed: int, cfg: ModelConfig, device: torch.device) -> Params:
    """Random params in the flat order, each tensor from its own generator
    of the key schedule (``(seed, _INIT, index)``), with the reference's
    distributions: ``mu`` uniform, ``u_bonus`` normal × 0.1, ``decay_base``
    −6, ``w_decay_b`` std 0.1, norm scales ones, the rest fan-in."""
    shapes = param_shapes(cfg)
    params = {}
    for i, name in enumerate(sorted(shapes)):
        shape, dt = shapes[name]
        g = generator(seed, _INIT, i, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln"):
            params[name] = torch.ones(shape, dtype=dt, device=device)
        elif leaf in ("mu", "mu_cm"):
            params[name] = torch.rand(shape, generator=g, device=device)
        elif leaf == "u_bonus":
            params[name] = torch.randn(shape, generator=g, device=device) * 0.1
        elif leaf == "decay_base":
            params[name] = torch.full(shape, -6.0, device=device)
        elif leaf == "embed":
            params[name] = embed_init(g, shape, dt, device)
        else:
            fan = shape[1:] if name.startswith("layers.") else shape
            scale = 0.1 if leaf == "w_decay_b" else None
            params[name] = dense_init(g, shape, dt, device, fan_shape=fan, scale=scale)
    return params


def _per_layer(params: Params, cfg: ModelConfig):
    """One ``{short name: tensor}`` dict per layer."""
    per_layer = {k: params[n].unbind(0) for k, n in _LAYER_KEYS.items()}
    return [{k: t[i] for k, t in per_layer.items()} for i in range(cfg.num_layers)]


# -- the WKV --------------------------------------------------------------------------
def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> the previous token's x (zeros at position 0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv_chunked(r, k, v, w, u, *, chunk: int, s0=None):
    """The reference's chunked WKV: r, k, v, w (B, S, H, K) with w the
    per-step decay; u (H, K).  The chunk shrinks until it divides S, and
    k is scaled by exp(-cs), so strong decays overflow as in the reference.
    Returns y (B, S, H, K) in r's dtype and the final state (B, H, K, K)."""
    bsz, s, h, dk = r.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    nc = s // chunk
    logw = torch.log(w.float())
    rr, kk, vv, ww = (t.reshape(bsz, nc, chunk, h, dk) for t in (r, k, v, logw))
    sprev = torch.zeros((bsz, h, dk, dk), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    uf = u.float()
    ys = []
    for i in range(nc):
        wc = ww[:, i]
        cs = torch.cumsum(wc, dim=1)
        excl = cs - wc
        rf, kf, vf = rr[:, i].float(), kk[:, i].float(), vv[:, i].float()
        att = torch.einsum("bthk,bshk->bhts", rf * torch.exp(excl), kf * torch.exp(-cs))
        att = torch.where(mask[None, None], att, 0.0)
        y = torch.einsum("bhts,bshv->bthv", att, vf)
        y = y + torch.sum(rf * uf[None, None] * kf, dim=-1, keepdim=True) * vf
        y = y + torch.einsum("bthk,bhkv->bthv", rf * torch.exp(excl), sprev)
        end = cs[:, -1]
        sprev = sprev * torch.exp(end)[..., None] + torch.einsum(
            "bshk,bshv->bhkv", kf * torch.exp(end[:, None] - cs), vf)
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), sprev


def wkv_reference(r, k, v, w, u, s0=None):
    """Token-by-token oracle (float32)."""
    bsz, s, h, dk = r.shape
    sprev = torch.zeros((bsz, h, dk, dk), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    ys = []
    for t in range(s):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, sprev)
                  + torch.sum(rt * u.float()[None] * kt, dim=-1, keepdim=True) * vt)
        sprev = sprev * wt[..., None] + torch.einsum("bhk,bhv->bhkv", kt, vt)
    return torch.stack(ys, dim=1).to(r.dtype), sprev


# -- blocks ---------------------------------------------------------------------------
def _mix(x: torch.Tensor, shifted: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * torch.sigmoid(mu)[None, None].to(x.dtype)


def _time_mix_inputs(lp: Params, x: torch.Tensor, shifted: torch.Tensor):
    xr, xk, xv, xg, xw = (_mix(x, shifted, lp["mu"][i]) for i in range(5))
    r = torch.einsum("bsd,de->bse", xr, lp["w_r"])
    k = torch.einsum("bsd,de->bse", xk, lp["w_k"])
    v = torch.einsum("bsd,de->bse", xv, lp["w_v"])
    g = torch.einsum("bsd,de->bse", xg, lp["w_g"])
    lora = torch.einsum("bsl,le->bse", torch.einsum("bsd,dl->bsl", xw, lp["w_decay_a"]),
                        lp["w_decay_b"])
    w = torch.exp(-torch.exp(lp["decay_base"][None, None] + lora.float()))
    return r, k, v, g, w


def _group_norm_out(lp: Params, cfg: ModelConfig, y: torch.Tensor, g: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Per-head norm of y (B, S, H, K) in float32 with the population
    variance, scaled by ``ln_x``, gated by silu(g), through ``w_o``."""
    b, s = y.shape[:2]
    yh = y.float()
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, unbiased=False, keepdim=True) + 1e-5)
    out = (yh.reshape(b, s, cfg.d_model) * lp["ln_x"][None, None]).to(dtype)
    return torch.einsum("bsd,de->bse", out * F.silu(g), lp["w_o"])


def time_mix_state(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 256):
    """The time-mix block over a full sequence, and the WKV's final state
    (B, H, K, K) float32, which :func:`time_mix` drops as the reference does."""
    nheads, hd = rwkv_dims(cfg)
    b, s, _ = x.shape
    r, k, v, g, w = _time_mix_inputs(lp, x, _token_shift(x))
    heads = [t.reshape(b, s, nheads, hd) for t in (r, k, v, w.to(x.dtype))]
    u = lp["u_bonus"].reshape(nheads, hd)
    if cfg.use_pallas_kernels:
        y, state = wkv(*heads, u)
    else:
        y, state = wkv_chunked(*heads, u, chunk=chunk)
    return _group_norm_out(lp, cfg, y, g, x.dtype), state


def time_mix(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, chunk: int = 256):
    return time_mix_state(lp, cfg, x, chunk=chunk)[0]


def _channel_mix(lp: Params, x: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    xk = _mix(x, shifted, lp["mu_cm"][0])
    xr = _mix(x, shifted, lp["mu_cm"][1])
    kk = torch.square(torch.relu(torch.einsum("bsd,df->bsf", xk, lp["cm_k"])))
    kv = torch.einsum("bsf,fd->bsd", kk, lp["cm_v"])
    return torch.sigmoid(torch.einsum("bsd,de->bse", xr, lp["cm_r"])) * kv


def channel_mix(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(lp, x, _token_shift(x))


def layer_apply(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + time_mix(lp, cfg, rms_norm(x, lp["ln_tm"], cfg.norm_eps))
    return x + channel_mix(lp, cfg, rms_norm(x, lp["ln_cm"], cfg.norm_eps))


# -- decode ---------------------------------------------------------------------------
def time_mix_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor,
                    x_tm: torch.Tensor) -> torch.Tensor:
    """x (B, 1, d).  ``state`` (B, H, K, K) float32 and ``x_tm`` (B, d), the
    previous token's input, are updated in place."""
    nheads, hd = rwkv_dims(cfg)
    b = x.shape[0]
    r, k, v, g, w = _time_mix_inputs(lp, x, x_tm[:, None].to(x.dtype))
    rt, kt, vt, wt = (t[:, 0].reshape(b, nheads, hd).float() for t in (r, k, v, w))
    u = lp["u_bonus"].reshape(nheads, hd)
    yt = torch.einsum("bhk,bhkv->bhv", rt, state) + \
        torch.sum(rt * u[None] * kt, dim=-1, keepdim=True) * vt
    state.mul_(wt[..., None]).add_(torch.einsum("bhk,bhv->bhkv", kt, vt))
    x_tm.copy_(x[:, 0])
    return _group_norm_out(lp, cfg, yt[:, None], g, x.dtype)


def channel_mix_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                       x_cm: torch.Tensor) -> torch.Tensor:
    """x (B, 1, d); ``x_cm`` (B, d) is updated in place."""
    out = _channel_mix(lp, x, x_cm[:, None].to(x.dtype))
    x_cm.copy_(x[:, 0])
    return out


def layer_decode(lp: Params, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor,
                 x_tm: torch.Tensor, x_cm: torch.Tensor) -> torch.Tensor:
    x = x + time_mix_decode(lp, cfg, rms_norm(x, lp["ln_tm"], cfg.norm_eps), state, x_tm)
    return x + channel_mix_decode(lp, cfg, rms_norm(x, lp["ln_cm"], cfg.norm_eps), x_cm)


# -- full model -----------------------------------------------------------------------
def forward(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final hidden states (B, S, d) and a zero aux loss."""
    x = rms_norm(F.embedding(batch["tokens"], params["embed"]), params["ln_in"], cfg.norm_eps)
    for lp in _per_layer(params, cfg):
        x = layer_apply(lp, cfg, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch):
    h, _ = forward(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    xent = chunked_softmax_xent(h, params["unembed"], labels, mask, cfg.xent_chunk)
    return xent, {"xent": xent}


#: the batch axis of each cache tensor (the layer axis comes first)
CACHE_BATCH_AXES = {"s": 1, "x_tm": 1, "x_cm": 1}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device: torch.device) -> Dict:
    """Zero recurrent state (L, B, H, K, K) float32, zero shift vectors
    (L, B, d) in the model's dtype, position 0 (a host int, or a (B,)
    tensor in its place: decode only advances it).  ``seq_len`` is unused:
    the state does not grow with the context."""
    nheads, hd = rwkv_dims(cfg)
    L, d = cfg.num_layers, cfg.d_model
    return {"s": torch.zeros((L, batch, nheads, hd, hd), dtype=torch.float32, device=device),
            "x_tm": torch.zeros((L, batch, d), dtype=dtype_of(cfg), device=device),
            "x_cm": torch.zeros((L, batch, d), dtype=dtype_of(cfg), device=device),
            "pos": 0}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict):
    """tokens (B, 1) -> logits (B, 1, V) float32 and the advanced cache (the
    same tensors, written in place, and ``pos + 1``)."""
    x = rms_norm(F.embedding(tokens, params["embed"]), params["ln_in"], cfg.norm_eps)
    for i, lp in enumerate(_per_layer(params, cfg)):
        x = layer_decode(lp, cfg, x, cache["s"][i], cache["x_tm"][i], cache["x_cm"][i])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.float(), params["unembed"].float())
    return logits, {**cache, "pos": cache["pos"] + 1}


def prefill(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full forward returning the last position's logits (B, V) float32."""
    h, _ = forward(params, cfg, batch)
    return torch.einsum("bd,dv->bv", h[:, -1].float(), params["unembed"].float())
