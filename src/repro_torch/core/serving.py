"""Greedy decoding over the Model API (twin of the first part of
``repro/core/serving.py``).

:func:`greedy_decode` prefills by stepping the whole prompt through
``decode_step``, exactly as the reference does, then loops ``decode_step``
with argmax feedback.  The reference keeps two drivers of that math, a
scanned one compiled into two programs and the per-token loop it holds it
against.  PyTorch runs eagerly, so the port has one loop:
:func:`greedy_decode_loop` is another name for :func:`greedy_decode`.

The continuous-batching engine (``ServingEngine``, ``make_serve_step``,
the serving lanes and ``sweep``) waits for ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

ENGINE_ITEM = "ROADMAP queue 1, item 12"


@dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int
    batch: int

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out * self.batch / max(self.decode_s, 1e-9)


def device_clock(device: torch.device) -> float:
    """The host clock, after the device's queued work (on the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)                 # (B,)


def greedy_decode(model, params, prompts: torch.Tensor, max_new: int,
                  *, cache_len: Optional[int] = None):
    """prompts (B, S0) integer tokens -> (B, max_new) generated tokens and
    the :class:`ServeStats` (host clock, synchronised on the card)."""
    b, s0 = prompts.shape
    cache_len = cache_len or (s0 + max_new)
    dev = prompts.device
    with torch.inference_mode():
        cache = model.init_cache(b, cache_len, device=dev)
        t0 = device_clock(dev)
        logits = None
        for i in range(s0):
            logits, cache = model.decode_step(params, prompts[:, i:i + 1], cache)
        tok = _argmax(logits)
        t1 = device_clock(dev)
        outs = []
        for _ in range(max_new):
            outs.append(tok)
            logits, cache = model.decode_step(params, tok[:, None], cache)
            tok = _argmax(logits)
        gen = torch.stack(outs, dim=1)
        t2 = device_clock(dev)
    return gen, ServeStats(t1 - t0, t2 - t1, max_new, b)


#: the reference's per-token oracle; eagerly, the same loop
greedy_decode_loop = greedy_decode


# -- not ported yet ------------------------------------------------------------
class ServingEngine:
    """The fixed-slot continuous-batching engine: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ServingEngine is not ported yet ({ENGINE_ITEM})")


def make_serve_step(*args, **kwargs):
    raise NotImplementedError(f"make_serve_step is not ported yet ({ENGINE_ITEM})")


def build_lane(*args, **kwargs):
    raise NotImplementedError(f"serving lanes are not ported yet ({ENGINE_ITEM})")


def sweep(*args, **kwargs):
    raise NotImplementedError(f"the serving sweep is not ported yet ({ENGINE_ITEM})")
