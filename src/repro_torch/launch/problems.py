"""Small training problems for the phase-diagram sweeps (twin of
``examples/common.py``).

``tiny_quadratic_problem`` is the convex toy problem of the sweeps' fast
path: ``loss(w) = mean((x @ (w − target))²)`` over batches of 16 standard
normal rows, trained by SGD at lr 0.1.  Its ``target`` and every batch are
drawn on the CPU from seeded ``torch.Generator``s and then moved to the
device, so a run on the card and a run on the CPU see the same bits.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizer import SGD
from repro_torch.random import _DATA, _INIT, generator

#: the reference's key (``jax.random.PRNGKey(42)``), kept as the seed
QUADRATIC_SEED = 42
#: the round the eval batch is drawn for, beyond any run's rounds
EVAL_ROUND = 10_000

Problem = Tuple[Callable, Dict[str, torch.Tensor], Callable, Callable, SGD]


def quadratic_problem(target: torch.Tensor, data_fn: Callable[[int, int], dict]) -> Problem:
    """``(loss_fn, params, data_fn, eval_fn, optimizer)`` of the quadratic
    around ``target`` (its device is the problem's) on the batches of
    ``data_fn(node, rnd) -> {"x": (16, n)}``."""
    def loss_fn(p, b):
        return torch.mean(torch.square(b["x"] @ (p["w"] - target)))

    params = {"w": torch.zeros(target.shape, dtype=torch.float32, device=target.device)}

    def eval_fn(p):
        return loss_fn(p, data_fn(0, EVAL_ROUND))

    return loss_fn, params, data_fn, eval_fn, SGD(lr=0.1, momentum=0.0)


def tiny_quadratic_problem(n_params: int = 16, device: DeviceLike = None) -> Problem:
    """``(loss_fn, params, data_fn, eval_fn, optimizer)`` for the convex toy
    problem, on the card unless ``device`` names the CPU."""
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    target = torch.randn((n_params,), generator=generator(QUADRATIC_SEED, _INIT, device=cpu))

    def data_fn(node_idx: int, rnd: int) -> dict:
        g = generator(QUADRATIC_SEED, _DATA, rnd, node_idx, device=cpu)
        return {"x": torch.randn((16, n_params), generator=g).to(dev)}

    return quadratic_problem(target.to(dev), data_fn)
