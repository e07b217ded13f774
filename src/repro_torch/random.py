"""The port's key schedule and the draws a swarm round consumes.

The JAX reference keys every draw of a round by ``fold_in(seed, purpose,
round, node)`` (``repro/core/swarm.py:_node_key``), so the draws are a pure
function of that tuple and independent of evaluation order.  The port keeps
the schedule but not the bits: each ``(seed, purpose, round, node)`` gets
its own ``torch.Generator`` (Philox on the card), seeded by a fixed 64-bit
integer mix of the tuple.  A threefry twin written as eager tensor ops
would cost hundreds of passes over memory per draw at full width, where a
round draws ~1.6e9 wire uniforms and as many audit normals.

Because the bits differ from JAX's, a round also accepts its draws from the
caller as a :class:`RoundDraws`: the tests hand the port the reference's own
draws and compare whole rounds exactly.

The async round's per-node delays are drawn on the host, from a CPU
generator, whatever device the round runs on: they are N small integers
that pick host-side control flow (which snapshot each node's gradient
reads), so drawn there they cost the round no device read, and a round on
the card draws the same delays as one on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

# purposes, as at repro/core/swarm.py:123; _DATA and _INIT key the data
# pipeline and model init
_CORRUPT, _WIRE, _AUDIT_SEL, _AUDIT_NOISE, _DELAY = range(5)
_DATA, _INIT = 100, 101

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed for ``(seed, *path)``: splitmix64 chained
    over the tuple, so neighbouring tuples give unrelated streams."""
    h = _splitmix64(seed & _M64)
    for p in path:
        h = _splitmix64(h ^ (p & _M64))
    return h >> 1


def generator(seed: int, *path: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, *path))
    return g


@dataclass
class RoundDraws:
    """Every random number one round consumes, given by the caller instead
    of drawn.  Row ``i`` belongs to node ``i``.

    - ``wire``: (N, nb, B) uniforms in [0, 1) for QSGD's stochastic rounding
      (one per padded wire element), used by the submitted payload AND by
      the auditor's recomputation;
    - ``wire_normal``: (N, cols, rank) standard normals, PowerSGD's subspace
      init on the squarest grid of the flat vector, used alike;
    - ``audit_sel``: (N,) uniforms, node ``i`` is audited iff below p_check;
    - ``audit_noise``: (N, D) standard normals, the simulated cross-stack
      numeric spread added to the auditor's recomputation;
    - ``corrupt``: (N, D) standard normals for ``noise`` attackers;
    - ``delay``: (N,) integers, the async round's realized delays (node
      ``i``'s in [0, its cap]).

    A field the round needs must be present; one it does not need may be
    None.
    """
    wire: Optional[torch.Tensor] = None
    wire_normal: Optional[torch.Tensor] = None
    audit_sel: Optional[torch.Tensor] = None
    audit_noise: Optional[torch.Tensor] = None
    corrupt: Optional[torch.Tensor] = None
    delay: Optional[torch.Tensor] = None


class RoundRandom:
    """Per-node draws of round ``rnd``: from ``draws`` when given, else from
    the node generators of the key schedule.  Each call draws one node's
    row, so a full-width round never holds an (N, D) block of draws."""

    def __init__(self, seed: int, rnd: int, device: torch.device,
                 draws: Optional[RoundDraws] = None):
        self.seed, self.rnd, self.device, self.draws = seed, rnd, device, draws

    def _given(self, field: str, node: int) -> Optional[torch.Tensor]:
        if self.draws is None:
            return None
        x = getattr(self.draws, field)
        if x is None:
            raise ValueError(f"RoundDraws.{field} is needed by this round "
                             "but was not given")
        return x[node].to(self.device, torch.float32)

    def uniform(self, field: str, purpose: int, node: int,
                shape: Sequence[int]) -> torch.Tensor:
        x = self._given(field, node)
        if x is not None:
            return x.reshape(shape)
        g = generator(self.seed, purpose, self.rnd, node, device=self.device)
        return torch.rand(tuple(shape), generator=g, device=self.device)

    def normal(self, field: str, purpose: int, node: int,
               shape: Sequence[int]) -> torch.Tensor:
        x = self._given(field, node)
        if x is not None:
            return x.reshape(shape)
        g = generator(self.seed, purpose, self.rnd, node, device=self.device)
        return torch.randn(tuple(shape), generator=g, device=self.device)

    def wire(self, node: int, shape: Sequence[int]) -> torch.Tensor:
        return self.uniform("wire", _WIRE, node, shape)

    def wire_normal(self, node: int, shape: Sequence[int]) -> torch.Tensor:
        return self.normal("wire_normal", _WIRE, node, shape)

    def audit_sel(self, node: int) -> torch.Tensor:
        return self.uniform("audit_sel", _AUDIT_SEL, node, ())

    def audit_noise(self, node: int, d: int) -> torch.Tensor:
        return self.normal("audit_noise", _AUDIT_NOISE, node, (d,))

    def corrupt(self, node: int, d: int) -> torch.Tensor:
        return self.normal("corrupt", _CORRUPT, node, (d,))

    def delay(self, node: int, cap: int) -> int:
        """Node ``node``'s realized delay, an integer in [0, ``cap``], keyed
        by ``(seed, _DELAY, round, node)`` and drawn by a CPU generator (the
        module docstring).  A cap of 0 draws nothing: the delay is 0."""
        if cap <= 0:
            return 0
        if self.draws is not None:
            if self.draws.delay is None:
                raise ValueError("RoundDraws.delay is needed by this round "
                                 "but was not given")
            d = int(self.draws.delay[node])
            if not 0 <= d <= cap:
                raise ValueError(f"RoundDraws.delay[{node}] = {d} is outside "
                                 f"[0, {cap}]")
            return d
        g = generator(self.seed, _DELAY, self.rnd, node, device=torch.device("cpu"))
        return int(torch.randint(0, cap + 1, (), generator=g))
