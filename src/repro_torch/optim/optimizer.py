"""Optimizers over param dicts (twin of ``repro/optim/optimizer.py``).

AdamW with decoupled weight decay and global-norm clipping; SGD(+momentum)
for the swarm demos.  Parameters are a ``{name: tensor}`` dict in the flat
order of ``models.convert.flat_order``; optimizer state is float32 and
mirrors it.  Updates compute in float32 and cast back to each parameter's
dtype, as the reference does (``optimizer.py:52-55``).  ``update`` is
functional: it returns new tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

Params = Dict[str, torch.Tensor]
LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed in dict order."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale by min(1, max_norm / max(norm, 1e-12)), one float32 division
    as in the reference (a Python float over a tensor is reciprocal-then-
    multiply in torch: two roundings)."""
    norm = global_norm(grads)
    top = torch.full((), float(max_norm), dtype=torch.float32, device=norm.device)
    scale = torch.clamp(top / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak_lr`` at ``total``: ``lr(step) -> 0-d float32``.
    The reference's Python-float products (``floor · peak_lr`` and
    ``(1 − floor) · peak_lr · 0.5``) are formed in double and rounded once;
    everything that touches the step computes in float32, each constant a
    float32 tensor (a Python float over a tensor is reciprocal-then-multiply
    in torch)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)

        def c(x):
            return torch.full((), float(x), dtype=torch.float32, device=s.device)

        warm = c(peak_lr) * s / c(max(warmup, 1))
        t = torch.clamp((s - c(warmup)) / c(max(total - warmup, 1)), 0.0, 1.0)
        cos = c(floor * peak_lr) + c((1 - floor) * peak_lr * 0.5) * (
            c(1) + torch.cos(c(math.pi) * t))
        return torch.where(s < c(warmup), warm, cos)
    return lr


def _zeros_like(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _lr(lr: LR, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


@dataclass(frozen=True)
class AdamW:
    lr: LR = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Params) -> AdamState:
        dev = next(iter(params.values())).device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         m=_zeros_like(params), v=_zeros_like(params))

    def update(self, grads: Params, state: AdamState, params: Params):
        grads = {k: g.float() for k, g in grads.items()}
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state.v[k] + (1 - b2) * g * g for k, g in grads.items()}
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)
        lr = _lr(self.lr, step)
        new = {}
        for k, p in params.items():
            pf = p.float()
            u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + self.eps)
            u = u + self.weight_decay * pf
            new[k] = (pf - lr * u).to(p.dtype)
        return new, AdamState(step=step, m=m, v=v)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Params


@dataclass(frozen=True)
class SGD:
    lr: LR = 0.1
    momentum: float = 0.9
    clip_norm: Optional[float] = None

    def init(self, params: Params) -> SGDState:
        dev = next(iter(params.values())).device
        return SGDState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        momentum=_zeros_like(params))

    def update(self, grads: Params, state: SGDState, params: Params):
        grads = {k: g.float() for k, g in grads.items()}
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        lr = _lr(self.lr, step)
        mom = {k: self.momentum * state.momentum[k] + g
               for k, g in grads.items()}
        new = {k: (p.float() - lr * mom[k]).to(p.dtype)
               for k, p in params.items()}
        return new, SGDState(step=step, momentum=mom)
