"""Protocol serving (twin of ``repro/core/serving.py``): greedy decoding and
the continuous-batching engine, with serving as a campaign axis.

1. **Greedy decoding** — :func:`greedy_decode` prefills by stepping the
   whole prompt through ``decode_step``, exactly as the reference does,
   then loops ``decode_step`` with argmax feedback.  The reference keeps
   two drivers of that math, a scanned one compiled into two programs and
   the per-token loop it holds it against.  PyTorch runs eagerly, so the
   port has one loop: :func:`greedy_decode_loop` is another name for
   :func:`greedy_decode`.

2. **The continuous-batching engine** — :class:`ServingEngine` steps a
   fixed pool of decode *slots* (:func:`make_serve_step`): every step each
   occupied slot advances one token (mid-prompt slots feed the next prompt
   token, so prefill and decode are the same step), finished slots retire,
   and free slots admit queued requests by arrival order, all by masks on
   the device.  The slots are the rows of one batched decode cache whose
   ``pos`` is a (slots,) tensor, each row at its own position (the
   reference vmaps a B = 1 ``decode_step`` over the slots instead).  A step
   reads nothing back to the host and keeps its shapes fixed: each of the
   reference's dropping scatters is a write into a buffer one row longer,
   then a slice, so a step can be captured in a CUDA graph.  The step
   writes the cache in place; a row that does not advance is put back
   from a copy taken before the decode, bit for bit.

3. **Protocol coupling and the campaign axis** — the custody matrix gates
   serving: per-step node availability (outage windows) gives the live
   shard coverage, and the engine **halts exactly when coverage < 1** (no
   admissions, no token progress).  Credential balances gate admission on
   the device with ``Ledger.can_infer``'s strict ``balance - fee >
   min_shares`` boundary.  :func:`sweep` runs every lane of a
   ``scenarios.ServingGrid`` and renders the availability phase diagram
   (:meth:`ServingResult.availability_table`).  The reference vmaps the
   lanes into one program; the port runs them one after another through
   the same step function, as ``swarm.run_campaign`` does.

Everything runs on the card unless the caller names the CPU (``device=``).
A ``MeshPlan`` placement (``plan=``) waits for ROADMAP queue 1, item 13.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.swarm import lane_slice, stack_trees, tree_map
from repro_torch.device import DeviceLike, resolve_device

_FAR = np.iinfo(np.int32).max
PLAN_ITEM = "ROADMAP queue 1, item 13"


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


# ======================== the continuous-batching engine ========================
@dataclass(frozen=True)
class ServingConfig:
    """Static engine shape: slot-pool size, per-request decode budget (the
    output buffer's width), horizon, and the admission boundary
    (``min_shares``, the strict ``>`` of ``Ledger.can_infer``).  The fee
    rides :class:`ServeLane`, so a campaign can sweep pricing."""
    slots: int = 4
    max_new: int = 8
    steps: int = 64
    min_shares: float = 0.0
    cache_len: Optional[int] = None       # default: prompt_len + max_new


class ServeLane(NamedTuple):
    """One serving run's parameters, tensors on the lane's device (the
    inference twin of ``swarm.LaneParams``); :func:`stack_serve_lanes`
    gives every field a leading lane axis.

    Request fields are (R,); ``balances`` are the H credential holders'
    (``Ledger.balance_vector``); node n is offline while
    ``node_down_from <= t < node_down_until`` (a permanent defection is
    ``[defect_step, FAR)``, a transient outage heals).  ``custody`` is the
    (N, S) shard-custody matrix of ``core.unextractable`` (None:
    un-sharded serving, which never halts; all lanes of a campaign
    agree)."""
    arrivals: torch.Tensor        # (R,) int64: step at which request r arrives
    holders: torch.Tensor         # (R,) int64: credential-holder index per request
    prompt_lens: torch.Tensor     # (R,) int64
    max_new: torch.Tensor         # (R,) int64: per-request budget, <= ServingConfig.max_new
    balances: torch.Tensor        # (H,) float32: initial credential balances
    node_down_from: torch.Tensor  # (N,) int64: outage start (inclusive; _FAR = never)
    node_down_until: torch.Tensor # (N,) int64: outage end (exclusive)
    fee: torch.Tensor             # () float32: credentials spent per admission
    custody: Optional[torch.Tensor] = None   # (N, S) bool | None


class ServeState(NamedTuple):
    """The serve step's carry, all on the device.  ``caches`` is the
    model's decode cache with one row per slot and a (slots,) ``pos``."""
    caches: Any
    slot_req: torch.Tensor    # (slots,) int64: occupying request id; R = free
    slot_t: torch.Tensor      # (slots,) int64: tokens fed so far for the occupant
    last_tok: torch.Tensor    # (slots,) int64: the occupant's previous output
    admitted: torch.Tensor    # (R,) bool
    done: torch.Tensor        # (R,) bool: all of its budget delivered
    balances: torch.Tensor    # (H,) float32: live credential balances
    out_tokens: torch.Tensor  # (R, max_new) int64: delivered tokens


class ServeRecord(NamedTuple):
    """One step's outputs (0-d tensors; stacked (T,) over a run)."""
    coverage: torch.Tensor    # float32: live shard coverage (1.0 un-sharded)
    live: torch.Tensor        # bool: coverage complete, serving possible
    n_active: torch.Tensor    # int32: occupied slots after admission
    n_admitted: torch.Tensor  # int32: requests admitted this step
    new_tokens: torch.Tensor  # int32: tokens delivered this step
    queued: torch.Tensor      # int32: arrived, unadmitted, fundable after this step


def stack_serve_lanes(lanes: Sequence[ServeLane]) -> ServeLane:
    """Single-run lanes -> a campaign: every field gains a leading lane axis.
    All lanes share R, H and N and agree on ``custody`` (all None, or all
    same-shaped matrices)."""
    if len({lane.custody is None for lane in lanes}) > 1:
        raise ValueError("the lanes of a serving campaign must agree on custody")
    return stack_trees(lanes)


def _tokens_on(tokens, device: torch.device) -> torch.Tensor:
    """Token ids (a tensor, or anything numpy reads) as int64 on ``device``."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens))
    return tokens.to(device, torch.long)


def _lane_to(lane: ServeLane, device: torch.device) -> ServeLane:
    return tree_map(lambda x: x.to(device), lane)


def _cache_leaves(cache: Dict, axes: Dict[str, int]):
    """(tensor, slot axis) for every tensor of a decode cache but ``pos``."""
    for key, ax in axes.items():
        entry = cache.get(key)
        if isinstance(entry, dict):
            yield from ((t, ax) for t in entry.values())
        elif entry is not None:
            yield entry, ax


def _on_axis(mask: torch.Tensor, ndim: int, ax: int) -> torch.Tensor:
    """A (slots,) mask shaped to broadcast along axis ``ax`` of an ndim tensor."""
    shape = [1] * ndim
    shape[ax] = mask.shape[0]
    return mask.view(shape)


def _snapshot(cache: Dict, axes: Dict[str, int]):
    """A copy of a decode cache's tensors and its per-row ``pos``."""
    return [leaf.clone() for leaf, _ in _cache_leaves(cache, axes)], cache["pos"]


def _keep_rows(cache: Dict, axes: Dict[str, int], advance: torch.Tensor, snapshot) -> Dict:
    """The cache with every row where ``advance`` is False put back from
    ``snapshot`` (in place), bit for bit, ``pos`` included."""
    before, pos = snapshot
    for (leaf, ax), old in zip(_cache_leaves(cache, axes), before):
        torch.where(_on_axis(advance, leaf.ndim, ax), leaf, old, out=leaf)
    return {**cache, "pos": torch.where(advance, cache["pos"], pos)}


def make_serve_step(model, cfg: ServingConfig, prompt_shape: Tuple[int, int], *,
                    has_custody: bool, device: DeviceLike = None
                    ) -> Tuple[Callable, Callable]:
    """``(step, init_state)``: ``step(params, prompts, lane, state, t) ->
    (state, ServeRecord)`` with ``t`` the step index (a 0-d tensor on the
    device, or an int), and ``init_state(lane)`` the empty pool.  ``prompts``
    is (R, P) on the device.  The step's four masked stages, as in the
    reference:

    - **availability**: nodes online outside their outage window, the live
      shard coverage, ``live`` = every shard held; a dead step admits
      nothing and advances nothing;
    - **admission**: arrived, unadmitted requests whose holder can afford
      the fee (strictly, counting same-step same-holder siblings by request
      index) fill the free slots in (arrival, index) order; fees are
      deducted; an admitted slot's cache rows are reset to
      ``init_cache``'s and its position to 0;
    - **decode**: one batched ``decode_step`` over all slots, each at its
      own position; mid-prompt slots feed their next prompt token, the
      others their previous argmax;
    - **retire**: the token produced at prompt position ``plen - 1 + i`` is
      generated token i; token ``budget - 1`` completes the request and
      frees its slot.

    The step writes ``state.caches`` in place and returns them; a row that
    does not advance (an idle slot, or every slot on a dead step) ends the
    step with its cache tensors and ``pos`` bit-equal to before."""
    n_req, p_max = prompt_shape
    slots, max_new = cfg.slots, cfg.max_new
    cache_len = cfg.cache_len or (p_max + max_new)
    dev = resolve_device(device)
    axes = model.cache_batch_axes
    # init_cache's values, one row: each broadcasts along its slot axis
    template = [t for t, _ in _cache_leaves(model.init_cache(1, cache_len, dev), axes)]
    idx = torch.arange(n_req, device=dev)
    later = idx[:, None] > idx[None, :]                  # (R, R): index j before i
    trash_tok = torch.zeros((1, max_new), dtype=torch.long, device=dev)
    trash_flag = torch.zeros(1, dtype=torch.bool, device=dev)
    trash_slot = torch.full((slots + 1,), -1, dtype=torch.long, device=dev)
    trash_bal = torch.zeros(1, dtype=torch.float32, device=dev)

    def step(params, prompts: torch.Tensor, lane: ServeLane, state: ServeState, t):
        # -- availability: who holds the model right now ------------------------
        online = ~((lane.node_down_from <= t) & (t < lane.node_down_until))
        if has_custody:
            covered = torch.any(lane.custody & online[:, None], dim=0)
            coverage = torch.mean(covered.float())
            live = torch.all(covered)
        else:
            coverage = torch.ones((), dtype=torch.float32, device=dev)
            live = torch.ones((), dtype=torch.bool, device=dev)

        # -- admission: queued requests fill free slots in arrival order --------
        occ = state.slot_req < n_req
        waiting = ~state.admitted & (lane.arrivals <= t)
        # the k-th waiting request of a holder (by index) must afford k + 1 fees
        prior_same = torch.sum((lane.holders[:, None] == lane.holders[None, :])
                               & waiting[None, :] & later, dim=1)
        funded = (state.balances[lane.holders]
                  - (prior_same + 1).float() * lane.fee > cfg.min_shares)
        cand = waiting & funded & live
        fifo = lane.arrivals * n_req + idx                              # (R,)
        rank = torch.sum(cand[None, :] & (fifo[None, :] < fifo[:, None]), dim=1)
        admit = cand & (rank < torch.sum(~occ))
        free_first = torch.argsort(occ.long(), stable=True)   # free slots, in slot order
        slot_of = free_first[torch.clamp(rank, 0, slots - 1)]
        scatter_to = torch.where(admit, slot_of, slots)
        upd = trash_slot.clone().scatter_(0, scatter_to, idx)[:slots]
        newly = upd >= 0
        slot_req = torch.where(newly, upd, state.slot_req)
        slot_t = torch.where(newly, 0, state.slot_t)
        caches = state.caches
        for (leaf, ax), init in zip(_cache_leaves(caches, axes), template):
            torch.where(_on_axis(newly, leaf.ndim, ax), init, leaf, out=leaf)
        caches = {**caches, "pos": torch.where(newly, 0, caches["pos"])}
        balances = torch.cat([state.balances, trash_bal]).index_add_(
            0, torch.where(admit, lane.holders, lane.balances.shape[0]),
            (-lane.fee).expand(n_req))[:-1]
        admitted = state.admitted | admit
        occ = slot_req < n_req

        # -- decode: every slot advances one token ------------------------------
        req = torch.clamp(slot_req, max=n_req - 1)
        plen = lane.prompt_lens[req]
        tok_in = torch.where(slot_t < plen,
                             prompts[req, torch.clamp(slot_t, 0, p_max - 1)],
                             state.last_tok)
        # decode_step writes the cache in place: rows that do not advance are
        # put back from this copy below
        snapshot = _snapshot(caches, axes)
        logits, caches = model.decode_step(params, tok_in[:, None], caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1)

        # -- record / retire ----------------------------------------------------
        advance = occ & live
        gen_i = slot_t - (plen - 1)
        budget = lane.max_new[req]
        rec = advance & (gen_i >= 0) & (gen_i < budget)
        flat = (torch.where(rec, req, n_req) * max_new
                + torch.clamp(gen_i, 0, max_new - 1))
        out_tokens = torch.cat([state.out_tokens, trash_tok]).view(-1).scatter_(
            0, flat, next_tok).view(n_req + 1, max_new)[:n_req]
        finished = rec & (gen_i == budget - 1)
        done = torch.cat([state.done, trash_flag]).scatter_(
            0, torch.where(finished, req, n_req), finished)[:n_req]
        slot_t = torch.where(advance, slot_t + 1, slot_t)
        last_tok = torch.where(advance, next_tok, state.last_tok)
        caches = _keep_rows(caches, axes, advance, snapshot)
        slot_req = torch.where(finished, n_req, slot_req)

        new_state = ServeState(caches=caches, slot_req=slot_req, slot_t=slot_t,
                               last_tok=last_tok, admitted=admitted, done=done,
                               balances=balances, out_tokens=out_tokens)
        record = ServeRecord(
            coverage=coverage, live=live,
            n_active=torch.sum(occ).int(),
            n_admitted=torch.sum(admit).int(),
            new_tokens=torch.sum(rec).int(),
            # serviceable backlog only: credential-refused waiters are not demand
            queued=(torch.sum(waiting & funded) - torch.sum(admit)).int())
        return new_state, record

    def init_state(lane: ServeLane) -> ServeState:
        return ServeState(
            caches={**model.init_cache(slots, cache_len, dev),
                    "pos": torch.zeros(slots, dtype=torch.long, device=dev)},
            slot_req=torch.full((slots,), n_req, dtype=torch.long, device=dev),
            slot_t=torch.zeros(slots, dtype=torch.long, device=dev),
            last_tok=torch.zeros(slots, dtype=torch.long, device=dev),
            admitted=torch.zeros(n_req, dtype=torch.bool, device=dev),
            done=torch.zeros(n_req, dtype=torch.bool, device=dev),
            balances=lane.balances.float().clone(),
            out_tokens=torch.zeros((n_req, max_new), dtype=torch.long, device=dev))

    return step, init_state


@dataclass
class ServeResult:
    """One lane's outcome on the host.  ``wall_s`` is the run's wall time on
    the host clock, synchronised on the card (for ``run_many``: the whole
    campaign's split evenly across its lanes, as the reference does)."""
    tokens: np.ndarray        # (R, max_new) int32
    done: np.ndarray          # (R,) bool
    admitted: np.ndarray      # (R,) bool
    balances: np.ndarray      # (H,) float32: final credential balances
    coverage: np.ndarray      # (T,) float32
    live: np.ndarray          # (T,) bool
    n_active: np.ndarray      # (T,) int32
    n_admitted: np.ndarray    # (T,) int32
    new_tokens: np.ndarray    # (T,) int32
    queued: np.ndarray        # (T,) int32
    wall_s: float = 0.0

    @property
    def tokens_served(self) -> int:
        return int(self.new_tokens.sum())

    @property
    def tok_per_s(self) -> float:
        return self.tokens_served / max(self.wall_s, 1e-9)

    @property
    def availability(self) -> float:
        """Fraction of *demand* steps (work queued or in flight) on which
        serving was live.  1.0 when there was never demand."""
        demand = (self.n_active > 0) | (self.queued > 0)
        if not demand.any():
            return 1.0
        return float((self.live & demand).sum() / demand.sum())


def settle_fees(ledger, holders: Sequence[str], result: ServeResult,
                fee: float) -> Dict[str, float]:
    """Mirror a lane's fee spending back onto the host ``Ledger``: each
    holder's spend, recovered as a whole number of fees (the device
    balances are float32), becomes a ``charge_fee`` event, and the pool is
    paid out to the stakers pro rata (``distribute_fees``).  The lane must
    have been built from ``ledger.balance_vector(holders)``.  Returns the
    per-staker payouts."""
    init = ledger.balance_vector(holders)
    for name, b0, b1 in zip(holders, init, result.balances):
        spent = fee * round(float(b0 - b1) / fee) if fee > 0 else 0.0
        if spent > 0:
            ledger.charge_fee(name, spent)
    return ledger.distribute_fees()


def _host(x: torch.Tensor, dtype) -> np.ndarray:
    return x.cpu().numpy().astype(dtype, copy=False)


def _result_from_device(state: ServeState, recs: ServeRecord,
                        wall_s: float = 0.0) -> ServeResult:
    return ServeResult(
        tokens=_host(state.out_tokens, np.int32), done=_host(state.done, bool),
        admitted=_host(state.admitted, bool), balances=_host(state.balances, np.float32),
        coverage=_host(recs.coverage, np.float32), live=_host(recs.live, bool),
        n_active=_host(recs.n_active, np.int32), n_admitted=_host(recs.n_admitted, np.int32),
        new_tokens=_host(recs.new_tokens, np.int32), queued=_host(recs.queued, np.int32),
        wall_s=wall_s)


class ServingEngine:
    """The continuous-batching server on one device (default: the card).

    ``run`` serves one :class:`ServeLane` through ``cfg.steps`` steps of
    :func:`make_serve_step`, with nothing read back until the run ends: the
    records are stacked (T,) on the device and read once.  ``run_many``
    runs the lanes of a stacked campaign one after another through the same
    step.  ``prompts`` given at construction are the default workload;
    ``run`` / ``run_many`` take a same-shaped override.  ``plan`` (a
    ``MeshPlan``) waits for ROADMAP queue 1, item 13."""

    def __init__(self, model, cfg: ServingConfig, prompts, plan=None, *,
                 device: DeviceLike = None):
        if plan is not None:
            raise NotImplementedError(
                f"ServingEngine(plan=): a MeshPlan placement is not ported yet ({PLAN_ITEM})")
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prompts = _tokens_on(prompts, self.device)
        self._programs: Dict[Tuple[bool, bool], Callable] = {}

    def _program(self, has_custody: bool, vmapped: bool) -> Callable:
        key = (has_custody, vmapped)
        if key not in self._programs:
            step, init_state = make_serve_step(
                self.model, self.cfg, tuple(self.prompts.shape),
                has_custody=has_custody, device=self.device)
            steps, dev = self.cfg.steps, self.device

            def run(params, prompts, lane):
                with torch.inference_mode():
                    ts = torch.arange(steps, device=dev)
                    state, recs = init_state(lane), []
                    for i in range(steps):
                        state, rec = step(params, prompts, lane, state, ts[i])
                        recs.append(rec)
                    return state, stack_trees(recs)

            def run_lanes(params, prompts, lanes):
                # one lane at a time; a campaign keeps no lane's caches
                outs = [run(params, prompts, lane_slice(lanes, k))
                        for k in range(int(lanes.arrivals.shape[0]))]
                return (stack_trees([s._replace(caches=None) for s, _ in outs]),
                        stack_trees([r for _, r in outs]))

            self._programs[key] = run_lanes if vmapped else run
        return self._programs[key]

    def program(self, *, has_custody: bool, vmapped: bool) -> Callable:
        """The engine's ``fn(params, prompts, lane(s)) -> (ServeState,
        ServeRecord)`` for this signature, on the device with no host read
        (``vmapped``: over a stacked campaign, leading lane axis, caches
        None), straight from the program cache that ``run`` / ``run_many``
        use."""
        return self._program(has_custody, vmapped)

    def _check(self, lane: ServeLane, prompts) -> torch.Tensor:
        budgets = lane.max_new.cpu().numpy()
        if budgets.max() > self.cfg.max_new or budgets.min() < 1:
            raise ValueError(
                "per-request max_new must lie in [1, "
                f"{self.cfg.max_new}] (the engine's decode budget) — a "
                "zero budget would wedge its slot for the whole horizon")
        plens = lane.prompt_lens.cpu().numpy()
        if plens.max() > self.prompts.shape[-1] or plens.min() < 1:
            raise ValueError(
                f"prompt_lens must lie in [1, {self.prompts.shape[-1]}] "
                "(the engine's prompt buffer width) — a longer prompt "
                "would silently re-feed the last buffered token")
        if prompts is None:
            return self.prompts
        prompts = _tokens_on(prompts, self.device)
        if prompts.shape != self.prompts.shape:
            raise ValueError(
                f"prompts override must match the engine's compiled shape "
                f"{tuple(self.prompts.shape)}, got {tuple(prompts.shape)}")
        return prompts

    def run(self, params, lane: ServeLane, prompts=None) -> ServeResult:
        p = self._check(lane, prompts)
        fn = self._program(lane.custody is not None, False)
        lane = _lane_to(lane, self.device)
        t0 = device_clock(self.device)
        state, recs = fn(params, p, lane)
        return _result_from_device(state, recs, device_clock(self.device) - t0)

    def run_many(self, params, lanes: ServeLane, prompts=None) -> List[ServeResult]:
        p = self._check(lanes, prompts)
        fn = self._program(lanes.custody is not None, True)
        lanes = _lane_to(lanes, self.device)
        t0 = device_clock(self.device)
        state, recs = fn(params, p, lanes)
        wall = device_clock(self.device) - t0
        n = int(lanes.arrivals.shape[0])
        return [_result_from_device(lane_slice(state, i), lane_slice(recs, i), wall / n)
                for i in range(n)]


# ============================== lane building ==================================
def build_lane(*, n_requests: int, prompt_lens: Sequence[int],
               max_new, steps: int, n_nodes: int,
               balances: Sequence[float], fee: float = 1.0,
               load: Optional[float] = None,
               arrivals: Optional[Sequence[int]] = None,
               holders: Optional[Sequence[int]] = None,
               custody: Optional[np.ndarray] = None,
               churn_rate: float = 0.0,
               coalition_fraction: float = 0.0,
               defect_step: Optional[int] = None,
               seed: int = 0, device: DeviceLike = None) -> ServeLane:
    """A :class:`ServeLane` on ``device`` (default: the card), built on the
    host as the reference builds it (the serving twin of
    ``derailment._sweep_lane``).

    ``max_new`` is a scalar or a length-R sequence of per-request budgets.
    ``load`` (requests per step) spaces arrivals as ``floor(r / load)``
    unless ``arrivals`` are given.  ``coalition_fraction`` marks the last
    ``ceil(fraction * N)`` roster slots as a coalition that goes down at
    ``defect_step`` (default ``steps // 3``) and never returns.
    ``churn_rate`` gives that fraction of the other nodes one staggered
    mid-horizon outage each, drawn with numpy from ``seed``."""
    if arrivals is None:
        if load is None or load <= 0:
            raise ValueError("pass either arrivals or a positive load")
        arrivals = np.floor(np.arange(n_requests) / load).astype(np.int32)
    arrivals = np.asarray(arrivals, np.int32)
    prompt_lens = np.asarray(prompt_lens, np.int32)
    max_new = np.broadcast_to(np.asarray(max_new, np.int32), (n_requests,)).copy()
    if arrivals.shape != (n_requests,) or prompt_lens.shape != (n_requests,):
        raise ValueError("arrivals / prompt_lens must have shape (n_requests,)")
    balances = np.asarray(balances, np.float32)
    if holders is None:
        holders = np.arange(n_requests, dtype=np.int32) % balances.shape[0]
    holders = np.asarray(holders, np.int32)

    down_from = np.full(n_nodes, _FAR, np.int32)
    down_until = np.full(n_nodes, _FAR, np.int32)
    n_coal = int(np.ceil(coalition_fraction * n_nodes))
    if n_coal:
        down_from[n_nodes - n_coal:] = steps // 3 if defect_step is None else defect_step
    if churn_rate > 0:
        rng = np.random.default_rng(seed)
        rest = np.arange(n_nodes - n_coal)
        k = min(len(rest), int(np.ceil(churn_rate * len(rest))))
        picked = rng.choice(rest, size=k, replace=False)
        lo, hi = max(1, steps // 4), max(2, (3 * steps) // 4)
        dur = max(2, steps // 6)
        for j, node in enumerate(sorted(int(i) for i in picked)):
            at = lo + (j * max(1, (hi - lo) // max(1, k))) % max(1, hi - lo)
            down_from[node] = at
            down_until[node] = at + dur
    dev = resolve_device(device)

    def ints(a):
        return torch.as_tensor(a, dtype=torch.long).to(dev)

    return ServeLane(
        arrivals=ints(arrivals), holders=ints(holders), prompt_lens=ints(prompt_lens),
        max_new=ints(max_new), balances=torch.as_tensor(balances).to(dev),
        node_down_from=ints(down_from), node_down_until=ints(down_until),
        fee=torch.tensor(fee, dtype=torch.float32).to(dev),
        custody=None if custody is None
        else torch.as_tensor(np.asarray(custody, bool)).to(dev))


# ============================ the serving campaign ==============================
@dataclass(frozen=True)
class ServingCell:
    """One lane of a serving sweep, classified."""
    load: float
    churn_rate: float
    redundancy: int
    coalition_fraction: float
    seed: int
    n_requests: int
    completed: int
    refused: int              # unadmitted for lack of credentials
    tokens_served: int
    availability: float       # live fraction of demand steps
    final_coverage: float

    @property
    def regime(self) -> str:
        """``halted``: work left unserved after coverage loss stalled serving
        (availability < 1); ``backlogged``: work left unserved with every
        demand step live; ``degraded``: everything served, but coverage
        gaps stalled some demand steps; ``served``: everything served,
        every demand step live."""
        pending = self.n_requests - self.completed - self.refused
        if pending > 0:
            return "halted" if self.availability < 1.0 else "backlogged"
        if self.availability < 1.0:
            return "degraded"
        return "served"


@dataclass
class ServingResult:
    """Every cell of a ``scenarios.ServingGrid``, the number of step
    functions built (``n_programs``: one serves every lane), the lanes run
    and the aggregate decode rate."""
    grid: Any                 # scenarios.ServingGrid
    cells: List[ServingCell]
    n_programs: int
    n_runs: int
    wall_s: float
    tokens_total: int
    n_devices: int = 1

    @property
    def runs_per_s(self) -> float:
        return self.n_runs / max(self.wall_s, 1e-9)

    @property
    def tok_per_s(self) -> float:
        return self.tokens_total / max(self.wall_s, 1e-9)

    def availability_table(self) -> str:
        """The serving phase diagram: one row per (redundancy [, coalition
        fraction], churn rate), one column per load; each cell shows the
        regime letter per seed — S = served, D = degraded, H = halted,
        B = backlogged — plus the mean availability."""
        loads = sorted({c.load for c in self.cells})
        coal = len({c.coalition_fraction for c in self.cells}) > 1
        rows = sorted({(c.redundancy, c.coalition_fraction, c.churn_rate)
                       for c in self.cells})
        labels = [f"r={r}" + (f" coal={cf:.2f}" if coal else "")
                  + f" churn={ch:.2f}" for r, cf, ch in rows]
        width = max([22] + [len(l) + 2 for l in labels])
        head = "serving".ljust(width) + "".join(f"load={l:.2f}".rjust(16)
                                                for l in loads)
        code = {"served": "S", "degraded": "D", "halted": "H",
                "backlogged": "B"}
        lines = [head]
        for (r, cf, ch), label in zip(rows, labels):
            cells = []
            for l in loads:
                cell = [c for c in self.cells
                        if (c.redundancy, c.coalition_fraction,
                            c.churn_rate) == (r, cf, ch)
                        and abs(c.load - l) < 1e-9]
                if not cell:
                    cells.append("-".rjust(16))
                    continue
                marks = "".join(code[c.regime] for c in cell)
                avail = sum(c.availability for c in cell) / len(cell)
                cells.append(f"{marks} a={avail:.2f}".rjust(16))
            lines.append(label.ljust(width) + "".join(cells))
        lines.append("(S=served  D=degraded  H=halted  B=backlogged, one "
                     "letter per seed; a = availability)")
        return "\n".join(lines)


def sweep(model, params, grid, *, prompts=None, plan=None,
          device: DeviceLike = None) -> ServingResult:
    """Every (load x churn x redundancy x coalition x seed) cell of a
    ``scenarios.ServingGrid``, each lane a full engine run, on ``device``
    (default: the card).  Load rides the lane's arrivals, churn and
    coalition defection its outage windows, redundancy its custody matrix
    (one per redundancy, seed 0); prompts and the step function are shared
    by every lane, and each lane is exactly its single :meth:`ServingEngine.
    run`.  Default prompts come from a ``torch.Generator`` seeded 0.
    ``plan`` waits for ROADMAP queue 1, item 13."""
    from repro_torch.core.unextractable import assign_matrix

    if plan is not None:
        raise NotImplementedError(
            f"sweep(plan=): a MeshPlan placement is not ported yet ({PLAN_ITEM})")
    dev = resolve_device(device)
    r, p = grid.n_requests, grid.prompt_len
    if prompts is None:
        prompts = torch.randint(0, model.cfg.vocab_size, (r, p),
                                generator=torch.Generator().manual_seed(0))
    # varied prompt lengths exercise mixed prefill/decode slot states
    prompt_lens = (p // 2 + np.arange(r) % (p - p // 2 + 1)).astype(np.int32)
    cfg = ServingConfig(slots=grid.slots, max_new=grid.max_new, steps=grid.steps)
    balances = np.full(grid.n_holders, grid.fee * grid.n_requests + 1.0, np.float32)
    custody_for = {
        red: assign_matrix(grid.n_nodes, grid.num_shards, red, seed=0,
                           max_fraction=grid.max_fraction)
        for red in grid.redundancies}

    engine = ServingEngine(model, cfg, prompts, device=dev)
    lanes, metas = [], []
    for load in grid.loads:
        for churn in grid.churn_rates:
            for red in grid.redundancies:
                for cf in grid.coalition_fractions:
                    for seed in grid.seeds:
                        lanes.append(build_lane(
                            n_requests=r, prompt_lens=prompt_lens,
                            max_new=grid.max_new, steps=grid.steps,
                            n_nodes=grid.n_nodes, balances=balances, fee=grid.fee,
                            load=load, custody=custody_for[red], churn_rate=churn,
                            coalition_fraction=cf, defect_step=grid.defect_step,
                            seed=seed, device=dev))
                        metas.append((load, churn, red, cf, seed))

    t0 = time.perf_counter()
    results = engine.run_many(params, stack_serve_lanes(lanes))
    wall = time.perf_counter() - t0

    cells = []
    for (load, churn, red, cf, seed), lane, res in zip(metas, lanes, results):
        pending = ~res.done
        # a pending request counts as credential-refused only when serving
        # never halted in its lane: in a halted lane the coverage loss, not
        # the balance, explains unserved work
        refused = pending & ~res.admitted & res.live.all() & (
            res.balances[lane.holders.cpu().numpy()] - grid.fee <= cfg.min_shares)
        cells.append(ServingCell(
            load=load, churn_rate=churn, redundancy=red,
            coalition_fraction=cf, seed=seed, n_requests=r,
            completed=int(res.done.sum()), refused=int(refused.sum()),
            tokens_served=res.tokens_served, availability=res.availability,
            final_coverage=float(res.coverage[-1])))
    return ServingResult(grid=grid, cells=cells, n_programs=1, n_runs=len(lanes),
                         wall_s=wall, tokens_total=sum(c.tokens_served for c in cells))
