"""Small training problems for the phase-diagram sweeps (twin of
``examples/common.py``).

``tiny_quadratic_problem`` is the convex toy problem of the sweeps' fast
path: ``loss(w) = mean((x @ (w − target))²)`` over batches of 16 standard
normal rows, trained by SGD at lr 0.1.  Its ``target`` and every batch are
drawn on the CPU from seeded ``torch.Generator``s and then moved to the
device, so a run on the card and a run on the CPU see the same bits.

``small_lm_problem`` is the small LM that both phase-diagram launchers
(``launch/derailment_no_off.py``, ``launch/topology_no_off.py``) sweep, so
that both diagrams move together: protocol-125m reduced to 2 layers of d
64 (4 heads of 16, 2 KV heads), d_ff 256, a 256-token vocabulary,
sequences of 32 tokens from the port's data pipeline, a global batch of 32
split over 32 shards (node i reads shard i mod 32), trained by SGD at lr
0.5 with momentum 0.9; the eval batch is step 10⁶'s.  Its tokens and
weights come from the port's generators (drawn on the CPU), so they are
the same on both devices and differ from the reference's; the tests give
:func:`lm_problem` the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.data.pipeline import DataConfig, data_fn_for_swarm, model_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import build_model
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


#: the small LM's data: sequences, global batch and shard count
LM_SEQ_LEN, LM_GLOBAL_BATCH, LM_SHARDS = 32, 32, 32
#: the step the small LM's eval batch is drawn for
LM_EVAL_STEP = 10**6


def small_lm_config() -> ModelConfig:
    """protocol-125m reduced as ``examples/common.py:small_lm_problem``
    reduces it."""
    return get_config("protocol-125m").reduced(
        num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256,
        vocab_size=256)


def lm_problem(cfg: ModelConfig, params: Dict[str, torch.Tensor],
               data_fn: Callable[[int, int], dict], eval_batch: dict) -> Problem:
    """``(loss_fn, params, data_fn, eval_fn, optimizer)`` of ``cfg``'s LM
    from the given weights and batches: the loss is the model's, the eval
    the loss on ``eval_batch``, the optimizer SGD at lr 0.5, momentum 0.9."""
    model = build_model(cfg)

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    def eval_fn(p):
        return loss_fn(p, eval_batch)

    return loss_fn, params, data_fn, eval_fn, SGD(lr=0.5, momentum=0.9)


def small_lm_problem(device: DeviceLike = None, seed: int = 0) -> Problem:
    """``(loss_fn, params, data_fn, eval_fn, optimizer)`` for the small LM
    (the module docstring), on the card unless ``device`` names the CPU;
    ``seed`` seeds the weights."""
    dev = resolve_device(device)
    cfg = small_lm_config()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ_LEN,
                      global_batch=LM_GLOBAL_BATCH)
    params = build_model(cfg).init(seed, torch.device("cpu"))
    return lm_problem(cfg, {k: v.to(dev) for k, v in params.items()},
                      data_fn_for_swarm(cfg, dcfg, LM_SHARDS, device=dev),
                      model_batch(cfg, dcfg, LM_EVAL_STEP, device=dev))
