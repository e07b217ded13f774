"""Flat layout and weight transfer between the JAX reference and the port.

The flat vector lays the parameters out in **exactly** the order of
``jax.tree.leaves`` on the reference's nested param dict: keys sorted at
every level, e.g. for the dense family ``embed``,
``layers.attn.{wk,wo,wq,wv}``, ``layers.ffn.{w_down,w_gate,w_up}``,
``layers.ln_attn``, ``layers.ln_ffn``, ``ln_f``, ``unembed``.  The order is
part of the contract: QSGD buckets are cut from the flat vector, so any
other order gives other bucket norms.
Sorting the dotted names gives that order, because ``.`` sorts below every
character a key uses.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
Layout = Sequence[Tuple[str, Tuple[int, ...], torch.dtype]]


def flat_order(cfg: ModelConfig):
    """Parameter names in the reference's ``jax.tree.leaves`` order."""
    from repro_torch.models.model import family_module   # model imports this module
    return sorted(family_module(cfg).param_shapes(cfg))


def layout_of(params: Mapping[str, torch.Tensor]) -> Layout:
    """``[(name, shape, dtype)]`` in flat order — what :func:`unflatten`
    needs to rebuild a param dict."""
    return [(k, tuple(params[k].shape), params[k].dtype) for k in sorted(params)]


def flat_size(layout: Layout) -> int:
    return sum(int(np.prod(s)) if s else 1 for _, s, _ in layout)


def flatten(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Param (or gradient) dict -> one float32 vector in flat order."""
    return torch.cat([params[k].reshape(-1).float() for k in sorted(params)])


def flatten_into(out: torch.Tensor, tree: Mapping[str, torch.Tensor]) -> None:
    """Write ``tree`` flattened into the float32 vector ``out`` (a row of a
    preallocated (N, D) stack), without a temporary vector."""
    off = 0
    for k in sorted(tree):
        x = tree[k].reshape(-1)
        out[off:off + x.numel()].copy_(x)
        off += x.numel()
    if off != out.numel():
        raise ValueError(f"tree has {off} elements, row has {out.numel()}")


def unflatten(vec: torch.Tensor, layout: Layout) -> Params:
    """Flat vector -> param dict, each leaf viewed from ``vec`` and cast to
    its dtype (a copy only where the dtype differs).  Leading axes of
    ``vec`` are kept: an (N, D) stack gives leaves of shape (N, *shape)."""
    out, off = {}, 0
    lead = tuple(vec.shape[:-1])
    for name, shape, dtype in layout:
        size = int(np.prod(shape)) if shape else 1
        out[name] = vec[..., off:off + size].reshape(lead + tuple(shape)).to(dtype)
        off += size
    return out


def _leaves(tree, prefix: str = ""):
    for k in sorted(tree):
        name = f"{prefix}{k}"
        if isinstance(tree[k], Mapping):
            yield from _leaves(tree[k], name + ".")
        else:
            yield name, tree[k]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: same bits as torch's
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Mapping, device: DeviceLike = None) -> Params:
    """The reference's nested param tree, as numpy arrays (float32, or
    bfloat16 via ``ml_dtypes``), -> the port's flat-order param dict with
    the same shapes, dtypes and flat layout."""
    dev = resolve_device(device)
    return {name: _to_torch(a).to(dev) for name, a in _leaves(tree)}
