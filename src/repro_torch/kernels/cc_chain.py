"""The column layout of the CenteredClip chains, shared by the masked
(``kernels/masked_agg``) and unmasked (``kernels/centered_clip``) wrappers,
as ``csrc/agg_common.cuh`` holds the passes both kernels run.

:func:`chain_plan` is the only source of the layout: the C entry points
take what it returns and check it (``chain_layout_ok``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

#: resident blocks an SM holds of the chain's passes, by NP = next_pow2(n):
#: the kernels' __launch_bounds__ minimum, ``kChainMinBlocks`` of
#: agg_common.cuh (a CPU test holds the two equal)
BLOCKS_PER_SM = {2: 4, 4: 4, 8: 3, 16: 2, 32: 1, 64: 1}
#: waves of resident blocks a pass's grid holds: tools/cc_chain_probe.py
#: read the chain 5% faster at 4 than at 1 on an H100 (at 5-8, 1-3% slower
#: than at 4)
WAVES = 4


class ChainPlan(NamedTuple):
    """Block b walks the columns [b·chunk, min(d, (b + 1)·chunk)), each
    thread ``vec`` neighbouring columns at a time."""
    nblk: int
    chunk: int
    vec: int
    d: int

    @property
    def runs(self) -> List[Tuple[int, int]]:
        return [(b * self.chunk, min(self.d, (b + 1) * self.chunk)) for b in range(self.nblk)]


def chain_plan(n: int, d: int, aligned: bool, sms: int) -> ChainPlan:
    """The layout for an (n, d) stack on a card of ``sms`` SMs: ``WAVES``
    waves of resident blocks (``BLOCKS_PER_SM`` an SM), each block a run of
    a multiple of 4 columns (the last run may be shorter), no run empty.
    16-byte loads (``vec`` 4) where the stack's base is 16-byte ``aligned``,
    d % 4 == 0 and n <= 32 (a step's rows stay in registers), else 1."""
    npow = max(2, 1 << (n - 1).bit_length())
    target = sms * BLOCKS_PER_SM[npow] * WAVES
    chunk = 4 * -(-(-(-d // target)) // 4)
    vec = 4 if aligned and d % 4 == 0 and n <= 32 else 1
    return ChainPlan(-(-d // chunk), chunk, vec, d)


def plan_for(x: torch.Tensor) -> ChainPlan:
    """:func:`chain_plan` for a contiguous (n, d) CUDA stack on its card."""
    n, d = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return chain_plan(n, d, x.data_ptr() % 16 == 0, sms)


def aligned_copy(v: torch.Tensor) -> torch.Tensor:
    """``v`` contiguous at a 16-byte aligned base (copied if it is not), so
    the layout of a call depends on x alone and a chain is bit-equal to its
    iterations called one by one."""
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def check_iters(iters, what: str) -> None:
    if isinstance(iters, bool) or not isinstance(iters, int) or iters < 0:
        raise ValueError(f"{what}: iters must be an int >= 0, got {iters!r}")
