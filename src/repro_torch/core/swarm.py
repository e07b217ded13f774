"""Swarm simulator: the centralized synchronous round (twin of
``repro/core/swarm.py``).

N protocol participants train one model.  Each round, in order:

1. per-node gradients, written as flat float32 rows of one (N, D) stack in
   the reference's flat order (``models.convert``);
2. corruption of the Byzantine rows (``_corrupt_all``);
3. the wire: QSGD payloads (fused round) or the decoded round trip of
   ``compression.roundtrip`` (qsgd, top-k, PowerSGD);
4. stake/slash audits of a random subset (``verification.audit_flat``);
5. masked robust aggregation over ``keep = active & ~caught`` — the
   kernels of ``kernels/masked_agg`` and ``kernels/qsgd_decode`` when the
   round is fused, ``core.aggregation`` otherwise;
6. the optimizer update, slashing and speed-weighted minting.

The round is a function ``round_fn(lane, state, rnd, batches, draws=None)
-> (state, RoundRecord)`` built by :func:`make_round_fn`, as in the
reference; :class:`Swarm` steps it and keeps the ledger.
:class:`SequentialSwarm` is the readable per-node twin of the same round:
it loops over the active nodes, aggregates the compacted survivors with
the dense ``core.aggregation`` aggregators, and is held against
:class:`Swarm`.  Every draw comes from the ``(seed, purpose, round, node)``
schedule of ``repro_torch.random``, the same in both engines, or, when
``draws`` is given, from the caller (the tests pass the reference's draws
and compare rounds exactly).  The wire draw of a node is drawn once per use
from its node generator, so its payload and the auditor's recomputation
see the same numbers and honest nodes pass their audits.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item): multi-aggregator routing, ``scan_rounds`` / ``run_campaign``
(3), custody lanes (7), decentralized topologies (8), bounded staleness (9)
and the economy lane (10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set)

import numpy as np
import torch

from repro_torch.core import aggregation, compression
from repro_torch.core.ledger import Ledger
from repro_torch.core.verification import VerificationConfig, audit_flat
from repro_torch.kernels.masked_agg import ops as masked_agg_ops
from repro_torch.kernels.qsgd_decode import ops as qsgd_decode_ops
from repro_torch.models.convert import flat_size, flatten_into, layout_of, unflatten
from repro_torch.random import RoundDraws, RoundRandom

#: Byzantine behaviours, indexed by the code of the corruption table.
BEHAVIOURS = ("honest", "sign_flip", "scale", "noise", "zero", "inner_product")
BEHAVIOUR_CODES: Dict[str, int] = {name: i for i, name in enumerate(BEHAVIOURS)}

_FAR = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class NodeSpec:
    node_id: str
    speed: float = 1.0
    byzantine: Optional[str] = None      # None|sign_flip|scale|noise|zero|inner_product
    byzantine_scale: float = 10.0
    join_round: int = 0
    leave_round: Optional[int] = None
    #: max gradient staleness — read only by async rounds (not ported yet)
    delay: Optional[int] = None

    def active(self, rnd: int) -> bool:
        return self.join_round <= rnd and (self.leave_round is None or rnd < self.leave_round)

    @property
    def behaviour_code(self) -> int:
        kind = self.byzantine or "honest"
        if kind not in BEHAVIOUR_CODES:
            raise ValueError(f"unknown byzantine behaviour: {kind!r} "
                             f"(known: {BEHAVIOURS})")
        return BEHAVIOUR_CODES[kind]


@dataclass(frozen=True)
class SwarmConfig:
    aggregator: str = "centered_clip"
    agg_kwargs: Dict = field(default_factory=dict)
    verification: Optional[VerificationConfig] = None
    compression: Optional[str] = None    # None|"qsgd"|"topk"|"powersgd"
    compression_kwargs: Dict = field(default_factory=dict)
    seed: int = 0
    # the fields below mirror the reference's; non-default values wait for
    # their slices
    topology: Optional[str] = None
    topology_kwargs: Dict = field(default_factory=dict)
    topology_seed: int = 0
    churn_coupled: bool = False
    custody: Optional[Any] = None
    #: fused hot path (kernels.masked_agg + kernels.qsgd_decode): None =
    #: auto (see make_round_fn), True = force, False = never.
    fused: Optional[bool] = None
    staleness_bound: int = 0
    economy: Optional[Any] = None

    def __post_init__(self):
        waiting = [("topology", self.topology is not None, 8),
                   ("churn_coupled", self.churn_coupled, 8),
                   ("custody", self.custody is not None, 7),
                   ("staleness_bound", self.staleness_bound != 0, 9),
                   ("economy", self.economy is not None, 10)]
        for name, set_, item in waiting:
            if set_:
                raise NotImplementedError(
                    f"SwarmConfig.{name} is not ported yet "
                    f"(ROADMAP queue 1, item {item})")


def corrupt(kind: str, grad_flat: torch.Tensor, honest_mean: torch.Tensor,
            scale: float, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar (single-node) corruption table — the reference the row-wise
    ``_corrupt_all`` below must match branch for branch.  ``noise`` is the
    standard-normal draw of a ``noise`` attacker."""
    if kind == "sign_flip":
        return -scale * grad_flat
    if kind == "scale":
        return scale * grad_flat
    if kind == "noise":
        return grad_flat + scale * noise
    if kind == "zero":
        return torch.zeros_like(grad_flat)
    if kind == "inner_product":
        # [87]-style: oppose the honest consensus direction
        return -scale * honest_mean
    raise ValueError(kind)


def _corrupt_all(codes: Sequence[int], gf: torch.Tensor,
                 honest_mean: Optional[torch.Tensor], scales: torch.Tensor,
                 noise_row: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """The corruption table over the (N, D) stack, row by row by behaviour
    code (the reference selects per element among every branch; each
    branch here is the same float32 expression).  Honest rows are the
    gradient rows themselves: with no attacker the stack is returned as
    is, otherwise a copy with the attacker rows replaced."""
    if not any(codes):
        return gf
    out = gf.clone()
    for i, c in enumerate(codes):
        if c == 0:
            continue
        s = scales[i]
        kind = BEHAVIOURS[c]
        out[i] = corrupt(kind, gf[i], honest_mean, s,
                         noise_row(i) if kind == "noise" else None)
    return out


# ============================ functional core ==================================
class LaneParams(NamedTuple):
    """Per-run parameters of the round.  Roster fields are (N,) tensors on
    the round's device; ``seed`` keys the draws; the audit fields are
    floats (``p_check == 0`` disables auditing); ``agg_kwargs`` are passed
    to the aggregator.  The reference's mixing, custody, delay and economy
    lanes wait for their slices."""
    codes: torch.Tensor       # (N,) int32 behaviour codes (BEHAVIOUR_CODES)
    scales: torch.Tensor      # (N,) f32 byzantine scales
    speeds: torch.Tensor      # (N,) f32 capacity -> minted shares per kept round
    joins: torch.Tensor       # (N,) int32 join round (inclusive)
    leaves: torch.Tensor      # (N,) int32 leave round (exclusive; _FAR = never)
    seed: int                 # the run seed of the key schedule
    p_check: float            # audit probability (0 = never audited)
    tolerance: float          # audit relative-mismatch tolerance
    numeric_noise: float      # simulated cross-stack nondeterminism
    agg_kwargs: Dict[str, Any]


class SwarmState(NamedTuple):
    """Everything that evolves across rounds."""
    params: Dict[str, torch.Tensor]
    opt_state: Any
    slashed: torch.Tensor     # (N,) bool — caught by an audit in a prior round
    contrib: torch.Tensor     # (N,) f32 — speed-weighted kept rounds


class RoundRecord(NamedTuple):
    """Per-round outputs (0-d tensors, or (N,) masks)."""
    n_active: torch.Tensor
    n_byzantine: torch.Tensor
    caught: torch.Tensor      # (N,) bool — slashed in *this* round
    keep: torch.Tensor        # (N,) bool — active & not caught (minted this round)
    agg_norm: torch.Tensor
    consensus_err: torch.Tensor   # 0 in centralized rounds
    coverage: torch.Tensor        # 1.0 without a custody lane
    staleness: torch.Tensor       # 0 in synchronous rounds


def lane_for_nodes(nodes: Sequence[NodeSpec], cfg: SwarmConfig,
                   device: torch.device, *,
                   agg_kwargs: Optional[Dict] = None) -> LaneParams:
    """The single-run :class:`LaneParams` of a roster and config."""
    v = cfg.verification

    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return LaneParams(
        codes=t([n.behaviour_code for n in nodes], torch.int32),
        scales=t([n.byzantine_scale for n in nodes], torch.float32),
        speeds=t([n.speed for n in nodes], torch.float32),
        joins=t([n.join_round for n in nodes], torch.int32),
        leaves=t([_FAR if n.leave_round is None else n.leave_round
                  for n in nodes], torch.int32),
        seed=cfg.seed,
        p_check=float(v.p_check) if v else 0.0,
        tolerance=float(v.tolerance) if v else 1.0,
        numeric_noise=float(v.numeric_noise) if v else 0.0,
        agg_kwargs=dict(agg_kwargs or {}),
    )


def _wire_draw(rr: RoundRandom, draw: Optional[tuple], node: int) -> Optional[torch.Tensor]:
    """Node ``node``'s wire draw for ``compression.wire_draw``'s ``draw``:
    uniforms, normals, or None for a wire that takes none."""
    if draw is None:
        return None
    kind, shape = draw
    return rr.wire(node, shape) if kind == "uniform" else rr.wire_normal(node, shape)


def _node_gradient(loss_fn: Callable, params: Dict[str, torch.Tensor], batch):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves.keys(), grads))


def make_round_fn(loss_fn: Callable, optimizer, params_template, n_nodes: int, *,
                  aggregator: str, agg_kwargs: Optional[Dict] = None,
                  compression_kind: Optional[str] = None,
                  compression_kwargs: Optional[Dict] = None,
                  verify: bool = False, fused: Optional[bool] = None) -> Callable:
    """Build the round: ``round_fn(lane, state, rnd, batches, draws=None)
    -> (state, RoundRecord)``, ``batches`` one batch per node.

    ``fused`` selects the hot path: aggregators run their fused twins
    (``kernels.masked_agg``) and a qsgd wire keeps the int8 payload live
    into aggregation instead of a decoded float32 stack.  ``None`` turns it
    on when every aggregator has a fused twin and the wire is uncompressed
    or int8-codeable qsgd; on the CPU (where the fused path runs the
    kernels' plain versions) the (N, D) float32 stack must also reach
    ``FUSED_MIN_BYTES``, as in the reference.  On the card it takes no
    size threshold, so a fusable round always runs the kernels.  ``True``
    forces it (raising on unsupported combinations); ``False`` forces the
    reference path.  The choice is exposed as ``round_fn.fused``.
    """
    if not isinstance(aggregator, str):
        raise NotImplementedError("multi-aggregator routing waits for the "
                                  "campaign slice (ROADMAP queue 1, item 3)")
    if compression_kind not in compression.WIRE_CODECS:
        raise ValueError(f"unknown wire codec: {compression_kind!r} "
                         f"(known: {compression.WIRE_CODECS})")
    agg_kwargs = dict(agg_kwargs or {})
    ckw = dict(compression_kwargs or {})
    layout = layout_of(params_template)
    d_total = flat_size(layout)
    stack_bytes = n_nodes * d_total * 4
    fusable_agg = aggregator in masked_agg_ops.FUSED_MASKED_AGGREGATORS
    fusable_wire = (compression_kind is None
                    or (compression_kind == "qsgd" and ckw.get("levels", 16) <= 127))
    fused_ok = fusable_agg and fusable_wire
    if fused is None:
        on_card = next(iter(params_template.values())).is_cuda
        fused = fused_ok and (on_card
                              or stack_bytes >= masked_agg_ops.FUSED_MIN_BYTES)
    elif fused and not fused_ok:
        raise ValueError(
            "fused=True unsupported here: needs an aggregator within "
            f"{sorted(masked_agg_ops.FUSED_MASKED_AGGREGATORS)} (got "
            f"{aggregator!r}) and an uncompressed or int8-codeable qsgd wire "
            f"(got {compression_kind!r}, levels={ckw.get('levels', 16)})")
    fused_qsgd = fused and compression_kind == "qsgd"
    getter = (masked_agg_ops.get_fused_aggregator if fused
              else aggregation.get_masked_aggregator)
    agg_fn = getter(aggregator, **agg_kwargs)
    draw = compression.wire_draw(compression_kind, d_total, **ckw)

    def round_fn(lane: LaneParams, state: SwarmState, rnd: int, batches,
                 draws: Optional[RoundDraws] = None):
        dev = state.slashed.device
        n = n_nodes
        active = (lane.joins <= rnd) & (rnd < lane.leaves) & ~state.slashed
        maskf = active.float()
        nact = torch.sum(maskf)
        rr = RoundRandom(lane.seed, rnd, dev, draws)
        codes = lane.codes.tolist()

        # 1. per-node gradients -> rows of one (N, D) float32 stack
        gf = torch.empty((n, d_total), dtype=torch.float32, device=dev)
        for i in range(n):
            flatten_into(gf[i], _node_gradient(loss_fn, state.params, batches[i]))

        # 2. corruption
        honest_mean = None
        if BEHAVIOUR_CODES["inner_product"] in codes:
            acc = torch.zeros(d_total, dtype=torch.float32, device=dev)
            for i in range(n):
                acc = acc + gf[i] * maskf[i]
            honest_mean = acc / torch.clamp(nact, min=1.0)
        corrupted = _corrupt_all(codes, gf, honest_mean, lane.scales,
                                 lambda i: rr.corrupt(i, d_total))

        # 3 + 4. the wire, and the audits of the selected nodes: node i's
        # uniforms feed its payload and the auditor's recomputation alike
        audited = torch.zeros(n, dtype=torch.bool, device=dev)
        if verify:
            vcfg = VerificationConfig(p_check=lane.p_check,
                                      tolerance=lane.tolerance,
                                      numeric_noise=lane.numeric_noise)
            sel = torch.stack([rr.audit_sel(i) for i in range(n)])
            audited = active & (sel < lane.p_check)
        audited_host = audited.tolist()
        passes = torch.ones(n, dtype=torch.bool, device=dev)
        if fused_qsgd:
            wire_shape = draw[1]
            pay_codes = torch.empty((n, *wire_shape), dtype=torch.int8, device=dev)
            pay_norms = torch.empty((n, wire_shape[0], 1), dtype=torch.float32,
                                    device=dev)
        elif compression_kind is not None:
            submitted = torch.empty((n, d_total), dtype=torch.float32, device=dev)
        else:
            submitted = corrupted
        for i in range(n):
            u = _wire_draw(rr, draw, i)
            if fused_qsgd:
                pay = qsgd_decode_ops.wire_encode(corrupted[i], u, **ckw)
                pay_codes[i], pay_norms[i] = pay.codes, pay.norms
                claimed = qsgd_decode_ops.wire_decode(pay) if audited_host[i] else None
            else:
                if compression_kind is not None:
                    submitted[i] = compression.roundtrip(compression_kind, u,
                                                         corrupted[i], **ckw)
                claimed = submitted[i]
            if audited_host[i]:
                recomputed = compression.roundtrip(compression_kind, u, gf[i], **ckw)
                ok, _ = audit_flat(claimed, recomputed,
                                   rr.audit_noise(i, d_total), vcfg)
                passes[i] = ok
        if fused_qsgd:
            submitted = qsgd_decode_ops.QsgdPayload(
                pay_codes, pay_norms, levels=ckw.get("levels", 16),
                size=d_total, bucket_size=wire_shape[1])
        del gf, corrupted
        caught = audited & ~passes
        keep = active & ~caught

        # 5. masked robust aggregation
        agg = agg_fn(submitted, keep, **lane.agg_kwargs)
        del submitted
        any_keep = torch.any(keep)
        agg = torch.where(any_keep, agg, torch.zeros_like(agg))

        # 6. the optimizer update
        if bool(any_keep):
            new_params, new_opt = optimizer.update(unflatten(agg, layout),
                                                   state.opt_state, state.params)
        else:
            new_params, new_opt = state.params, state.opt_state
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        new_state = SwarmState(
            params=new_params, opt_state=new_opt,
            slashed=state.slashed | caught,
            contrib=state.contrib + lane.speeds * keep.float())
        rec = RoundRecord(
            n_active=torch.sum(active).to(torch.int32),
            n_byzantine=torch.sum(active & (lane.codes > 0)).to(torch.int32),
            caught=caught, keep=keep, agg_norm=torch.linalg.vector_norm(agg),
            consensus_err=zero, coverage=zero + 1.0, staleness=zero)
        return new_state, rec

    round_fn.fused = fused                    # resolved choice, inspectable
    round_fn.stack_bytes = stack_bytes
    return round_fn


def history_from_records(recs: Sequence[RoundRecord], node_ids: Sequence[str], *,
                         start_round: int = 0) -> List[dict]:
    """Rebuild the per-round host history from a run's records."""
    return [{
        "round": start_round + t,
        "n_active": int(r.n_active),
        "n_byzantine": int(r.n_byzantine),
        "caught": [node_ids[int(i)] for i in np.flatnonzero(r.caught.cpu().numpy())],
        "agg_norm": float(r.agg_norm),
        "consensus_error": float(r.consensus_err),
        "coverage": float(r.coverage),
        "staleness": float(r.staleness),
    } for t, r in enumerate(recs)]


# ================================ engines ======================================
class _SwarmBase:
    """State, ledger plumbing and the run() loop shared by both engines.

    ``loss_fn(params, batch) -> scalar``; ``data_fn(node_idx, rnd) ->
    batch``.  A round runs on the device of ``params``.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        self.loss_fn = loss_fn
        self.params = params
        self.optimizer = optimizer
        self.opt_state = optimizer.init(params)
        self.nodes = list(nodes)
        self.cfg = cfg
        self.data_fn = data_fn
        self.ledger = Ledger()
        self.slashed: Set[str] = set()
        self.history: List[dict] = []
        self.device = next(iter(params.values())).device
        if cfg.verification:
            for node in self.nodes:
                self.ledger.stake(node.node_id, cfg.verification.stake)

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        raise NotImplementedError

    def _slash(self, node: NodeSpec) -> None:
        self.ledger.slash(node.node_id)
        self.ledger.pay_jackpot("validator", self.cfg.verification.jackpot)
        self.slashed.add(node.node_id)

    def eval_params(self):
        return self.params

    def run(self, rounds: int, eval_fn: Optional[Callable] = None,
            eval_every: int = 10) -> List[float]:
        """Step rounds 0..rounds-1; ``eval_fn(params)`` every ``eval_every``
        rounds and after the last.  (The scanned run waits for the campaign
        slice.)"""
        losses = []
        for r in range(rounds):
            rec = self.step(r)
            if eval_fn and (r % eval_every == 0 or r == rounds - 1):
                rec["eval_loss"] = float(eval_fn(self.eval_params()))
                losses.append(rec["eval_loss"])
        return losses


class Swarm(_SwarmBase):
    """The batched engine: a thin wrapper that steps the round of
    :func:`make_round_fn` and keeps the host ledger.  Inactive nodes still
    occupy a row of the stack (their gradient is computed and then masked),
    as in the reference.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        super().__init__(loss_fn, params, optimizer, nodes, cfg, data_fn)
        n = len(self.nodes)
        self._lane = lane_for_nodes(self.nodes, cfg, self.device)
        self._joins_np = np.asarray([s.join_round for s in self.nodes], np.int64)
        self._leaves_np = np.asarray(
            [_FAR if s.leave_round is None else s.leave_round for s in self.nodes],
            np.int64)
        self._slashed_np = np.zeros(n, bool)
        self._core = make_round_fn(
            loss_fn, optimizer, self.params, n,
            aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs,
            compression_kind=cfg.compression,
            compression_kwargs=cfg.compression_kwargs,
            verify=cfg.verification is not None, fused=cfg.fused)

    @property
    def fused(self) -> bool:
        return self._core.fused

    def _state(self) -> SwarmState:
        return SwarmState(
            params=self.params, opt_state=self.opt_state,
            slashed=torch.as_tensor(self._slashed_np, device=self.device),
            contrib=torch.zeros(len(self.nodes), dtype=torch.float32,
                                device=self.device))

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        active_np = ((self._joins_np <= rnd) & (rnd < self._leaves_np)
                     & ~self._slashed_np)
        if not active_np.any():
            raise RuntimeError(f"round {rnd}: no active nodes")
        batches = [self.data_fn(i, rnd) for i in range(len(self.nodes))]
        state, rec = self._core(self._lane, self._state(), rnd, batches, draws)
        self.params, self.opt_state = state.params, state.opt_state
        row = history_from_records([rec], [n.node_id for n in self.nodes],
                                   start_round=rnd)[0]
        for i in np.flatnonzero(rec.caught.cpu().numpy()):
            self._slash(self.nodes[int(i)])
            self._slashed_np[int(i)] = True
        for i in np.flatnonzero(rec.keep.cpu().numpy()):
            node = self.nodes[int(i)]
            self.ledger.record_contribution(node.node_id, node.speed)
        self.history.append(row)
        return row


class SequentialSwarm(_SwarmBase):
    """The per-node engine: the readable twin of the reference's
    ``SequentialSwarm``, held against :class:`Swarm`.

    Each round loops over the active nodes only: a flat float32 gradient
    each (the reference's flat order), corruption with the honest mean of
    the active nodes, the wire (``compression.roundtrip``, decoded), audits
    that recompute the gradient and re-encode it with the submitter's wire
    draw, then the dense aggregator of ``core.aggregation`` over the
    compacted (k, D) stack of the survivors.  The draws are the batched
    engine's: the same ``(seed, purpose, round, node)`` generators, or the
    caller's ``draws``.  Bounded staleness and the other axes that
    ``SwarmConfig`` refuses wait for their items there.
    """

    def __init__(self, loss_fn: Callable, params, optimizer,
                 nodes: List[NodeSpec], cfg: SwarmConfig,
                 data_fn: Callable[[int, int], dict]):
        super().__init__(loss_fn, params, optimizer, nodes, cfg, data_fn)
        if cfg.compression not in compression.WIRE_CODECS:
            raise ValueError(f"unknown wire codec: {cfg.compression!r} "
                             f"(known: {compression.WIRE_CODECS})")
        self._layout = layout_of(params)
        self._d = flat_size(self._layout)
        self._draw = compression.wire_draw(cfg.compression, self._d,
                                           **cfg.compression_kwargs)
        self._aggregate = aggregation.get_aggregator(cfg.aggregator, **cfg.agg_kwargs)

    def _gradient(self, batch) -> torch.Tensor:
        g = torch.empty(self._d, dtype=torch.float32, device=self.device)
        flatten_into(g, _node_gradient(self.loss_fn, self.params, batch))
        return g

    def _wire(self, g: torch.Tensor, rr: RoundRandom, node: int) -> torch.Tensor:
        return compression.roundtrip(self.cfg.compression, _wire_draw(rr, self._draw, node),
                                     g, **self.cfg.compression_kwargs)

    def step(self, rnd: int, draws: Optional[RoundDraws] = None) -> dict:
        cfg, dev = self.cfg, self.device
        active = [(i, n) for i, n in enumerate(self.nodes)
                  if n.active(rnd) and n.node_id not in self.slashed]
        if not active:
            raise RuntimeError(f"round {rnd}: no active nodes")
        rr = RoundRandom(cfg.seed, rnd, dev, draws)
        batches = [self.data_fn(i, rnd) for i, _ in active]
        grads = [self._gradient(b) for b in batches]

        # corruption and the wire; the honest mean is the batched engine's
        # masked sum, added in node order, over the active count
        honest_mean = None
        if any(n.byzantine == "inner_product" for _, n in active):
            acc = torch.zeros(self._d, dtype=torch.float32, device=dev)
            for g in grads:
                acc = acc + g
            honest_mean = acc / torch.full((), float(len(active)), device=dev)
        submitted = []
        for (i, node), g in zip(active, grads):
            if node.byzantine:
                scale = torch.tensor(node.byzantine_scale, dtype=torch.float32, device=dev)
                noise = rr.corrupt(i, self._d) if node.byzantine == "noise" else None
                g = corrupt(node.byzantine, g, honest_mean, scale, noise)
            submitted.append(self._wire(g, rr, i))
        del grads, honest_mean

        # stake/slash audits (§4.2): recompute, re-encode with the
        # submitter's wire draw, compare with audit_flat
        caught, keep = [], [True] * len(active)
        if cfg.verification:
            v = cfg.verification
            for j, (i, node) in enumerate(active):
                if not bool(rr.audit_sel(i) < v.p_check):
                    continue
                recomputed = self._wire(self._gradient(batches[j]), rr, i)
                ok, _ = audit_flat(submitted[j], recomputed, rr.audit_noise(i, self._d), v)
                if not bool(ok):
                    self._slash(node)
                    caught.append(node.node_id)
                    keep[j] = False

        # aggregation of the compacted survivors, the optimizer update
        kept = [x for x, k in zip(submitted, keep) if k]
        del submitted
        if kept:
            survivors = torch.stack(kept)
            del kept
            agg = self._aggregate(survivors)
            del survivors
            self.params, self.opt_state = self.optimizer.update(
                unflatten(agg, self._layout), self.opt_state, self.params)
        else:
            agg = torch.zeros(self._d, dtype=torch.float32, device=dev)

        # mint shares in proportion to verified work (speed-weighted) (§4)
        for (_, node), k in zip(active, keep):
            if k:
                self.ledger.record_contribution(node.node_id, node.speed)
        rec = {
            "round": rnd,
            "n_active": len(active),
            "n_byzantine": sum(1 for _, n in active if n.byzantine),
            "caught": caught,
            "agg_norm": float(torch.linalg.vector_norm(agg)),
            "consensus_error": 0.0,
            "coverage": 1.0,
            "staleness": 0.0,
        }
        self.history.append(rec)
        return rec


ENGINES = {"batched": Swarm, "sequential": SequentialSwarm}


def make_swarm(loss_fn, params, optimizer, nodes: List[NodeSpec], cfg: SwarmConfig,
               data_fn, *, engine: str = "batched") -> _SwarmBase:
    """Build a swarm with the requested engine (``ENGINES``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine: {engine!r} (known: {sorted(ENGINES)})")
    return ENGINES[engine](loss_fn, params, optimizer, nodes, cfg, data_fn)
