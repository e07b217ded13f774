"""Bounded-staleness async rounds (ROADMAP queue 1, item 9) against the JAX
reference, each round handed the reference's realized delays (and audit
draws), computed from its key schedule: node i's delay in round r is
``randint(fold_in(fold_in(fold_in(PRNGKey(seed), _DELAY), r), i), (), 0,
cap + 1)``, cap = min(delays[i], r, K).

The reference's scanned and stepped async runs part under jax 0.9.0
(``tests/test_async.py::test_async_scan_equals_step_loop``), so the port is
held against the reference's campaign (one ``lax.scan`` a lane) or its
jitted round.  On the 8-parameter quadratic of ``tests/conftest.py``:

- ``straggler_majority``, ``stale_poisoning`` and ``async_churn`` as
  campaigns over two seeds: ``n_active``, ``n_byzantine``, ``caught``,
  ``keep``, ``staleness``, ``slashed`` and ``contrib`` exactly equal,
  ``agg_norm`` and the final losses within 1e-5 relative (each node's
  gradient is taken alone here and at a gathered snapshot stack under
  ``vmap`` there: float32 reduction order);
- the decentralized round with K = 2 on a ring, round by round, free:
  the discrete fields and staleness equal, ``agg_norm`` within 1e-5,
  ``consensus_err`` within 1e-4 (1e-7 absolute), the replicas within 1e-5;
- a K > 0 round whose lanes all draw delay 0 bit-equal to the port's
  synchronous round (params, records, slashed, contrib);
- a ring slot taken at round r bit-equal, after later rounds, to a clone
  of the params taken then (AdamW, SGD with momentum, decentralized);
- ``Swarm`` against ``SequentialSwarm``: the discrete fields and
  staleness equal, ``agg_norm`` within 1e-5 (the dense aggregators over
  the survivors against the masked ones over the stack);
- honest nodes that run stale are never slashed, at p_check 1;
- ``no_off_async_smoke`` on ``examples/common.py``'s tiny quadratic:
  ``phase_table()`` equal to the reference's as a string, each cell's
  discrete fields equal and its losses within 1e-4 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro.core.verification import VerificationConfig as JVer
from repro.optim import optimizer as jopt
from repro_torch.core import derailment as tder
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.optim import optimizer as topt
from repro_torch.random import RoundDraws

from test_torch_decentralized import one_thread  # noqa: F401
from test_torch_derailment import quadratic  # noqa: F401

N_PARAMS, N_NODES, ROUNDS, SEEDS = 8, 8, 12, (0, 1)
EVAL_ROUND = 10_000
ASYNC_SCENARIOS = ["straggler_majority", "stale_poisoning", "async_churn"]


@jax.jit
def _ref_delays(seed, rnd, caps):
    """The reference's realized delays of one round: (N,) int32."""
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda i, c: jax.random.randint(
        jswarm._node_key(base, jswarm._DELAY, rnd, i), (), 0, c + jnp.int32(1)))(
        jnp.arange(caps.shape[0]), caps)


@functools.partial(jax.jit, static_argnums=(2,))
def _ref_audit(seed, rnd, d):
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda p: jax.vmap(lambda i: jswarm._node_key(base, p, rnd, i))(
        jnp.arange(N_NODES)))(jnp.array([jswarm._AUDIT_SEL, jswarm._AUDIT_NOISE]))
    return (jax.vmap(jax.random.uniform)(keys[0]),
            jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys[1]))


def reference_draws(seed: int, caps, bound: int, rnd: int, *, audit: bool = False,
                    d_total: int = N_PARAMS) -> RoundDraws:
    """Round ``rnd``'s draws of a run of ``seed`` whose nodes' delay caps are
    ``caps`` under ``bound``: the realized delays, and with ``audit`` the
    audit draws (``N_NODES`` nodes)."""
    caps = np.minimum(np.minimum(np.asarray(caps, np.int32), rnd), bound).astype(np.int32)
    draws = RoundDraws(delay=torch.from_numpy(np.array(_ref_delays(seed, rnd, caps))))
    if audit:
        sel, noise = _ref_audit(seed, rnd, d_total)
        draws.audit_sel = torch.from_numpy(np.array(sel))
        draws.audit_noise = torch.from_numpy(np.array(noise))
    return draws


@pytest.fixture(scope="module")
def problem():
    """``tests/conftest.py``'s quadratic on both sides, the port's on the
    reference's target and batches: ``(reference, port)``, each
    ``(loss_fn, params, data_fn, eval_fn)``."""
    loss_fn, params0, data_fn, target = tiny_quadratic_problem(N_PARAMS)
    jeval = jax.jit(lambda p: loss_fn(p, data_fn(0, EVAL_ROUND)))
    t_target = torch.from_numpy(np.array(target))
    cache = {}

    def t_data(i, rnd):
        if (i, rnd) not in cache:
            cache[i, rnd] = {"x": torch.from_numpy(np.array(data_fn(i, rnd)["x"]))}
        return cache[i, rnd]

    def t_loss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] - b["x"] @ t_target))

    return ((loss_fn, params0, data_fn, jeval),
            (t_loss, {"w": torch.zeros(N_PARAMS)}, t_data,
             lambda p: t_loss(p, t_data(0, EVAL_ROUND))))


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a is None or b is None:           # a record field of an axis not in the run
        return a is b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("scenario", ASYNC_SCENARIOS)
def test_async_scenario_campaign_matches_the_reference(problem, scenario):
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    jstate, jrecs, jfinal, node_ids, jcfg = jax.tree.map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
        jscen.scenario_campaign(scenario, jl, jp, jopt.SGD(lr=0.1, momentum=0.0), jd,
                                n_nodes=N_NODES, seeds=SEEDS, rounds=ROUNDS, eval_fn=je))
    scn = tscen.get_scenario(scenario)
    nodes, cfg = scn.build(N_NODES, SEEDS[0])
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, scn.make_config(s),
                                                      torch.device("cpu")) for s in SEEDS])
    assert np.array_equal(lanes.delays.numpy(), np.stack([np.asarray(jswarm.lane_for_nodes(
        [jswarm.NodeSpec(**n.__dict__) for n in nodes], jcfg).delays)] * len(SEEDS)))
    caps = lanes.delays[0].numpy()
    audit = cfg.verification is not None
    state, recs, final = tswarm.run_campaign(
        tl, tp, topt.SGD(lr=0.1, momentum=0.0), td, lanes, rounds=ROUNDS,
        aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs, verify=audit, eval_fn=te,
        draws_fn=lambda k, rnd: reference_draws(SEEDS[k], caps, cfg.staleness_bound, rnd,
                                                audit=audit))
    assert [n.node_id for n in nodes] == node_ids
    for field in ("n_active", "n_byzantine", "caught", "keep", "staleness"):
        assert np.array_equal(getattr(recs, field).numpy(), getattr(jrecs, field)), field
    assert np.array_equal(state.slashed.numpy(), jstate.slashed)
    assert np.array_equal(state.contrib.numpy(), jstate.contrib)
    np.testing.assert_allclose(recs.agg_norm.numpy(), jrecs.agg_norm, rtol=1e-5)
    np.testing.assert_allclose(final.numpy(), jfinal, rtol=1e-5)
    assert recs.staleness.numpy()[:, 1:].max() > 0, "the scenario should run stale"
    if scenario == "stale_poisoning":
        assert jstate.slashed.any() and not jstate.slashed[:, :-2].any()


def test_decentralized_async_round_matches_the_reference(problem):
    """K = 2 on a ring of 6 honest nodes and 2 attackers, CenteredClip,
    audits at p 0.5; 8 rounds free on both sides."""
    (jl, jp, jd, _), (tl, tp, td, _) = problem
    n, k, rounds = N_NODES, 2, 8

    def roster(mod):
        return [mod.NodeSpec(f"h{i}", delay=i % 3) for i in range(n - 2)] + [
            mod.NodeSpec("adv0", byzantine="sign_flip", byzantine_scale=10.0, delay=2),
            mod.NodeSpec("adv1", byzantine="inner_product", byzantine_scale=20.0, delay=1)]

    def cfg(mod, ver):
        return mod.SwarmConfig(aggregator="centered_clip", topology="ring", seed=5,
                               staleness_bound=k, verification=ver(p_check=0.5, stake=10.0,
                                                                   tolerance=1e-3))
    jlane = jswarm.lane_for_nodes(roster(jswarm), cfg(jswarm, JVer))
    tlane = tswarm.lane_for_nodes(roster(tswarm), cfg(tswarm, TVer), torch.device("cpu"))
    assert np.array_equal(tlane.delays.numpy(), np.asarray(jlane.delays))
    jround = jax.jit(jswarm.make_round_fn(jl, jopt.SGD(lr=0.1, momentum=0.9), jp, n,
                                          aggregator="centered_clip", verify=True,
                                          decentralized=True, staleness_bound=k))
    tround = tswarm.make_round_fn(tl, topt.SGD(lr=0.1, momentum=0.9), tp, n,
                                  aggregator="centered_clip", verify=True,
                                  decentralized=True, staleness_bound=k)
    jst = jswarm.init_decentralized_state(jp, jopt.SGD(lr=0.1, momentum=0.9), n,
                                          staleness_bound=k)
    tst = tswarm.init_decentralized_state(tp, topt.SGD(lr=0.1, momentum=0.9), n,
                                          staleness_bound=k)
    stale = 0.0
    for r in range(rounds):
        batches = [td(i, r) for i in range(n)]
        jst, jrec = jround(jlane, jst, r, jax.tree.map(lambda *x: jnp.stack(x),
                                                       *[jd(i, r) for i in range(n)]))
        tst, trec = tround(tlane, tst, r, batches,
                           reference_draws(5, tlane.delays.numpy(), k, r, audit=True))
        for field in ("n_active", "n_byzantine", "caught", "keep", "staleness"):
            assert np.array_equal(getattr(trec, field).numpy(),
                                  np.asarray(getattr(jrec, field))), (r, field)
        np.testing.assert_allclose(float(trec.agg_norm), float(jrec.agg_norm), rtol=1e-5)
        np.testing.assert_allclose(float(trec.consensus_err), float(jrec.consensus_err),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(tst.params["w"].numpy(), np.asarray(jst.params["w"]),
                                   rtol=1e-5, atol=1e-7)
        stale = max(stale, float(trec.staleness))
    assert stale > 0
    assert np.array_equal(tst.slashed.numpy(), np.asarray(jst.slashed))


def _churn_roster(delay):
    nodes = [tswarm.NodeSpec(f"h{i}", speed=1.0 + i % 2, delay=delay) for i in range(5)]
    nodes += [tswarm.NodeSpec("late", join_round=2, leave_round=7, delay=delay),
              tswarm.NodeSpec("adv0", byzantine="sign_flip", byzantine_scale=5.0, delay=delay),
              tswarm.NodeSpec("adv1", byzantine="inner_product", byzantine_scale=20.0,
                              delay=delay)]
    return nodes


def test_zero_delay_async_round_is_the_synchronous_round(problem):
    """K = 3 with every cap 0: every node reads the current params, each
    gradient taken alone as in the synchronous round, so the two are bit
    for bit one run (the reference's is only close: its async round
    batches the gradients at a gathered snapshot stack)."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    ver = TVer(p_check=0.5, stake=5.0, tolerance=1e-3, jackpot=5.0)
    runs = []
    for bound in (0, 3):
        cfg = tswarm.SwarmConfig(aggregator="centered_clip", verification=ver, seed=2,
                                 staleness_bound=bound)
        sw = tswarm.Swarm(loss_fn, dict(params0), topt.SGD(lr=0.1, momentum=0.9),
                          _churn_roster(0), cfg, data_fn)
        for r in range(ROUNDS):
            sw.step(r)
        runs.append(sw)
    sync, asy = runs
    assert asy._ring is not None and sync._ring is None
    assert _bits(sync.params["w"], asy.params["w"])
    assert _bits(sync.contrib, asy.contrib)
    assert sync.slashed == asy.slashed and sync.slashed
    assert sync.history == asy.history
    # the same in a campaign: a lane of all-zero caps next to a stale one
    # runs in a K = 3 campaign, bit-equal to the synchronous campaign
    cfg0 = tswarm.SwarmConfig(aggregator="centered_clip", verification=ver, seed=2)
    cpu = torch.device("cpu")
    plain = tswarm.stack_lanes([tswarm.lane_for_nodes(_churn_roster(0), cfg0, cpu)])
    cfg3 = dataclasses.replace(cfg0, staleness_bound=3)
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(_churn_roster(d), cfg3, cpu)
                                for d in (0, 3)])
    kw = dict(rounds=ROUNDS, aggregator="centered_clip", verify=True, eval_fn=eval_fn)
    a = tswarm.run_campaign(loss_fn, params0, topt.SGD(lr=0.1, momentum=0.9), data_fn,
                            plain, **kw)
    b = tswarm.run_campaign(loss_fn, params0, topt.SGD(lr=0.1, momentum=0.9), data_fn,
                            lanes, **kw)
    for field in tswarm.RoundRecord._fields:
        assert _bits(getattr(tswarm.lane_slice(a[1], 0), field),
                     getattr(tswarm.lane_slice(b[1], 0), field)), field
    assert _bits(a[0].params["w"][0], b[0].params["w"][0]) and _bits(a[2][0], b[2][0])
    assert float(b[1].staleness[1].max()) > 0


@pytest.mark.parametrize("what", ["adamw", "sgd_momentum", "decentralized"])
def test_ring_slot_is_unaliased_after_later_rounds(problem, what):
    loss_fn, params0, data_fn, _ = problem[1]
    k = 2
    opt = (topt.AdamW(lr=0.05) if what == "adamw"
           else topt.SGD(lr=0.1, momentum=0.9))
    cfg = tswarm.SwarmConfig(aggregator="mean", seed=1, staleness_bound=k,
                             topology="ring" if what == "decentralized" else None)
    sw = tswarm.Swarm(loss_fn, {"w": torch.ones(N_PARAMS)}, opt, _churn_roster(k)[:6],
                      cfg, data_fn)
    taken = {}
    for r in range(3 * (k + 1) + 1):
        taken[r] = {n: v.clone() for n, v in sw.params.items()}
        sw.step(r)
        # slot r % (K+1) now holds the params as of the start of round r,
        # and the K slots before it those of the K rounds before
        for back in range(min(r, k) + 1):
            slot = sw._ring[(r - back) % (k + 1)]
            for n, v in slot.items():
                assert _bits(v, taken[r - back][n]), (r, back, n)
    assert sum(h["staleness"] for h in sw.history) > 0
    # an async round given a state without its ring says what it needs
    with pytest.raises(ValueError, match="needs a SwarmState.ring of 3 slots"):
        sw._core(sw._lane, sw._state()._replace(ring=None), 0,
                 [data_fn(i, 0) for i in range(len(sw.nodes))])


@pytest.mark.parametrize("scenario", ASYNC_SCENARIOS)
def test_swarm_agrees_with_sequential_swarm(problem, scenario):
    loss_fn, params0, data_fn, _ = problem[1]
    runs = []
    for engine in ("batched", "sequential"):
        sw = tscen.get_scenario(scenario).build_swarm(
            loss_fn, dict(params0), topt.SGD(lr=0.1, momentum=0.0), data_fn,
            n_nodes=N_NODES, seed=1, engine=engine)
        sw.run(ROUNDS)
        runs.append(sw)
    b, s = runs
    for hb, hs in zip(b.history, s.history):
        for key in ("n_active", "n_byzantine", "caught", "staleness", "coverage"):
            assert hb[key] == hs[key], (hb["round"], key)
        np.testing.assert_allclose(hb["agg_norm"], hs["agg_norm"], rtol=1e-5)
    assert b.slashed == s.slashed
    assert b.ledger.balances == s.ledger.balances
    assert max(h["staleness"] for h in b.history) > 0


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_stale_honest_nodes_are_never_slashed(problem, engine):
    """Every node may lag 3 rounds and every node is audited every round:
    the audit recomputes at the snapshot the node claims, so only the
    attacker is slashed."""
    loss_fn, params0, data_fn, _ = problem[1]
    nodes = [tswarm.NodeSpec(f"h{i}", delay=3) for i in range(5)] + [
        tswarm.NodeSpec("adv0", byzantine="zero", delay=3)]
    cfg = tswarm.SwarmConfig(aggregator="mean", seed=4, staleness_bound=3,
                             verification=TVer(p_check=1.0, stake=5.0, tolerance=1e-3,
                                               jackpot=5.0))
    sw = tswarm.make_swarm(loss_fn, dict(params0), topt.SGD(lr=0.1, momentum=0.0), nodes,
                           cfg, data_fn, engine=engine)
    sw.run(ROUNDS)
    assert sw.slashed == {"adv0"}
    assert [h["caught"] for h in sw.history][0] == ["adv0"]
    assert sum(h["staleness"] > 0 for h in sw.history) >= ROUNDS // 2


def test_no_off_async_smoke_table_equals_the_reference(quadratic):  # noqa: F811
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = quadratic
    grid = tscen.get_sweep_grid("no_off_async_smoke")
    spec = tder.build_sweep_lanes(grid)
    bound = max(int(lane.delays.max()) for lane in spec.lanes)

    @functools.lru_cache(maxsize=None)
    def draws(j, rnd):
        lane = spec.lanes[j]
        return reference_draws(lane.seed, lane.delays, bound, rnd)

    jres = jder.sweep(jl, jp, jo, jd, je, jscen.get_sweep_grid("no_off_async_smoke"))
    tres = tder.sweep(tl, tp, to, td, te, grid, draws_fn=draws)
    assert tres.phase_table() == jres.phase_table()
    assert "s=2" in tres.phase_table()
    assert len(tres.results) == len(jres.results) == grid.n_points
    for j, t in zip(jres.results, tres.results):
        for field in ("regime", "n_attackers", "seed", "staleness_bound",
                      "attackers_slashed", "derailed", "attacker_fraction"):
            assert getattr(t, field) == getattr(j, field), (field, j)
        for field in ("final_loss", "baseline_loss", "init_loss"):
            a, b = getattr(t, field), getattr(j, field)
            assert np.isfinite(a) == np.isfinite(b), (field, j)
            if np.isfinite(b):
                np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"{field} {j}")
    jspec = jder.build_sweep_lanes(jscen.get_sweep_grid("no_off_async"))
    tspec = tder.build_sweep_lanes(tscen.get_sweep_grid("no_off_async"))
    assert [m[1:] for m in tspec.metas] == [m[1:] for m in jspec.metas]
    for tlane, jlane in zip(tspec.lanes, jspec.lanes):
        assert np.array_equal(tlane.delays, jlane.delays)
