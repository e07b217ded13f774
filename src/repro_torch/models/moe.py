"""Mixture-of-Experts FFN with capacity-based dispatch (twin of
``repro/models/moe.py``).

The reference's group is a batch row: it vmaps a one-row dispatch and
combine over the rows.  Here the rows are one batched dispatch into a
single (B, E, C, d) buffer, with no Python loop:

- each routed slot (token t, choice j) of a row is ranked within its
  expert in the row's flat order (t-major, then j) by an exclusive prefix
  count; slots ranked at or past the capacity C are dropped;
- kept slots are written into the buffer at (row, expert, rank), each at
  its own place; dropped ones go to one trash row past the buffer's end,
  which is then cut off (the reference adds them as zeros onto slot
  (e=0, c=0), which leaves that slot's value as it is);
- every expert runs on its C slots of every row in one batched product;
- the combine gathers each slot's output, dropped ones from slot (0, 0)
  as the reference does, multiplies by its gate (zero where dropped) in
  the activation dtype, and sums the k slots of each token in order.

The gates are cast to the activation dtype before the dispatch, as in the
reference.  The reference's sharding constraints are no-ops on one device
and are left out (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def capacity(seq: int, top_k: int, num_experts: int, factor: float) -> int:
    """Slots per expert and row: ``seq * top_k / num_experts * factor`` in
    that Python float order, truncated, then rounded up to 8, at least 8."""
    c = int(seq * top_k / num_experts * factor)
    return max(8, ((c + 7) // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """x (..., d) -> gates (..., k) float32, experts (..., k) int64, and the
    Switch load-balance aux loss.  Logits in float32; the k gates are
    renormalised to sum to 1."""
    logits = torch.einsum("...d,de->...e", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    e = router.shape[-1]
    me = probs.reshape(-1, e).mean(dim=0)
    counts = F.one_hot(experts, e).float().sum(dim=-2)               # (..., E)
    ce = counts.reshape(-1, e).mean(dim=0) / top_k
    return gates, experts, e * torch.sum(me * ce)


def slot_ranks(experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """experts (B, S, k) -> (B, S*k) rank of each routed slot within its
    expert, in the row's flat order: #{earlier slots of the row with the
    same expert}."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)
    onehot = F.one_hot(flat_e, num_experts).to(torch.int32)         # (B, S*k, E)
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot   # exclusive
    return torch.gather(rank, 2, flat_e[..., None])[..., 0].long()


class Dispatch(NamedTuple):
    buf: torch.Tensor         # (B, E, C, d) the experts' inputs
    index: torch.Tensor       # (B*S*k,) each slot's flat place in the buffer, (0, 0) if dropped
    gates: torch.Tensor       # (B*S*k,) gates in the activation dtype, 0 if dropped
    keep: torch.Tensor        # (B, S*k) bool


def dispatch(x: torch.Tensor, experts: torch.Tensor, gates: torch.Tensor,
             num_experts: int, cap: int) -> Dispatch:
    """x (B, S, d), experts/gates (B, S, k) -> the capacity buffer and the
    combine's plan.  ``gates`` are taken as they come (the caller casts)."""
    b, s, d = x.shape
    k = experts.shape[-1]
    rank = slot_ranks(experts, num_experts)
    keep = rank < cap
    flat_e = experts.reshape(b, -1)
    row = torch.arange(b, device=x.device)[:, None] * (num_experts * cap)
    place = row + torch.where(keep, flat_e * cap + rank, 0)          # (B, S*k)
    trash = b * num_experts * cap
    buf = x.new_zeros((trash + 1, d)).index_put(
        (torch.where(keep, place, trash).reshape(-1),),
        x.repeat_interleave(k, dim=1).reshape(-1, d))
    g = gates.reshape(b, -1) * keep.to(gates.dtype)
    return Dispatch(buf[:trash].view(b, num_experts, cap, d), place.reshape(-1),
                    g.reshape(-1), keep)


def experts_apply(buf: torch.Tensor, params: Params) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: (B, E, C, d) -> (B, E, C, d)."""
    g = torch.einsum("becd,edf->becf", buf, params["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, params["w_up"])
    return torch.einsum("becf,efd->becd", F.silu(g) * u, params["w_down"])


def combine(out: torch.Tensor, plan: Dispatch, seq: int, top_k: int) -> torch.Tensor:
    """The experts' outputs (B, E, C, d) -> (B, S, d): each slot's output
    times its gate, summed over the token's k slots one add at a time in
    slot order (the reference's reduction order; ``sum(dim=)`` takes
    another for k > 2)."""
    b, d = out.shape[0], out.shape[-1]
    gathered = out.reshape(-1, d)[plan.index]                          # (B*S*k, d)
    gathered = gathered * plan.gates[:, None].to(gathered.dtype)
    slots = gathered.reshape(b, seq, top_k, d).unbind(dim=2)
    acc = slots[0]
    for g in slots[1:]:
        acc = acc + g
    return acc


def moe_ffn(x: torch.Tensor, params: Params, *, top_k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (B, S, d) and the aux loss.  Group = batch row."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    cap = capacity(s, top_k, e, capacity_factor)
    gates, experts, aux = route(x, params["router"], top_k)
    plan = dispatch(x, experts, gates.to(x.dtype), e, cap)
    out = combine(experts_apply(plan.buf, params), plan, s, top_k)
    return out.to(x.dtype), aux


def moe_ffn_reference(x: torch.Tensor, params: Params, *, top_k: int) -> torch.Tensor:
    """Oracle: every expert on every token, masked combine (no capacity
    drops).  ``moe_ffn`` agrees with it when nothing is dropped."""
    gates, experts, _ = route(x, params["router"], top_k)
    e = params["router"].shape[-1]
    g = torch.einsum("bsd,edf->bsef", x, params["w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, params["w_up"])
    h = torch.einsum("bsef,efd->bsed", F.silu(g) * u, params["w_down"])
    onehot = F.one_hot(experts, e).to(h.dtype)                       # (B, S, k, E)
    w = torch.einsum("bske,bsk->bse", onehot, gates.to(h.dtype))
    return torch.einsum("bsed,bse->bsd", h, w).to(x.dtype)
