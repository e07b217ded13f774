"""The decentralized axis (ROADMAP queue 1, item 8) against the JAX
reference: the graph layer, gossip, and the twins of
``tests/test_topology.py`` on the port's engine.

- every registered topology's adjacency and Metropolis matrix, the
  time-varying and churn-coupled stacks, bit-equal to the reference's at
  several sizes and seeds; spectral gaps, connectivity and the errors
  equal;
- ``gossip_round`` / ``gossip_average`` / ``consensus_error`` within 1e-6
  of the reference's on the same inputs; ``rounds_for_tolerance`` and the
  two traffic counters equal;
- on the 8-parameter quadratic of ``tests/conftest.py`` (the reference's
  target and batches carried across): a fully-connected decentralized
  swarm equals the centralized one within the reference test's tolerance
  (agg_norm 2e-3 relative, 1e-5 absolute); a ring disagrees, then
  converges; the scanned run equals the step loop; a churn-coupled
  leaver's replica freezes; the sequential engine refuses a topology; a
  time-varying lane runs in a campaign; the three decentralized scenarios
  step as the reference's within 1e-5;
- ``no_off_topology_smoke`` on ``examples/common.py``'s tiny quadratic, cell
  by cell against the reference's ``sweep``: tables equal, discrete fields
  equal, finite losses within 1e-4 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.core import gossip as jgossip
from repro.core import scenarios as jscen
from repro.core import topology as jtopo
from repro.optim.optimizer import SGD as JSGD
from repro_torch.core import derailment as tder
from repro_torch.core import gossip as tgossip
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.core import topology as ttopo
from repro_torch.optim.optimizer import SGD as TSGD

from test_torch_decentralized import one_thread  # noqa: F401
from test_torch_derailment import _assert_cells_equal, _sweeps, quadratic  # noqa: F401

SIZES = (2, 5, 9, 16)
SEEDS = (0, 3, 11)


@pytest.fixture(scope="module")
def problem():
    """The conftest quadratic (8 parameters) on both sides:
    ``(reference, port)``, each ``(loss_fn, params, data_fn, eval_fn)``."""
    loss_fn, params0, data_fn, target = tiny_quadratic_problem(8)
    t_target = torch.from_numpy(np.array(target))
    cache = {}

    def t_data(i, rnd):
        if (i, rnd) not in cache:
            cache[i, rnd] = {"x": torch.from_numpy(np.array(data_fn(i, rnd)["x"]))}
        return cache[i, rnd]

    def t_loss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] - b["x"] @ t_target))

    return ((loss_fn, params0, data_fn, lambda p: loss_fn(p, data_fn(0, 10_000))),
            (t_loss, {"w": torch.zeros(8)}, t_data, lambda p: t_loss(p, t_data(0, 10_000))))


def _bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# ----------------------------- graph layer -------------------------------------
@pytest.mark.parametrize("name", sorted(jtopo.TOPOLOGIES))
def test_mixing_matrices_bit_equal_to_the_reference(name):
    assert ttopo.list_topologies() == jtopo.list_topologies()
    for n in SIZES:
        if name == "clustered" and n < 4:
            with pytest.raises(ValueError, match="clusters"):
                ttopo.mixing_matrix(name, n)
            continue
        for seed in SEEDS:
            adj_t = ttopo.get_topology(name).builder(n, seed=seed)
            adj_j = jtopo.get_topology(name).builder(n, seed=seed)
            assert _bit_equal(adj_t, adj_j), (name, n, seed)
            w_t, w_j = ttopo.mixing_matrix(name, n, seed=seed), jtopo.mixing_matrix(name, n, seed=seed)
            assert _bit_equal(w_t, w_j), (name, n, seed)
            assert ttopo.is_connected(adj_t) == jtopo.is_connected(adj_j)
            if n > 2:
                assert ttopo.spectral_gap(w_t) == jtopo.spectral_gap(w_j)


def test_builders_and_errors_as_the_reference():
    for n in (4, 12, 13, 16, 30):
        assert _bit_equal(ttopo.torus_adjacency(n), jtopo.torus_adjacency(n))
        assert _bit_equal(ttopo.clustered_adjacency(n, 2), jtopo.clustered_adjacency(n, 2))
        assert _bit_equal(ttopo.random_regular_adjacency(n, 6, seed=5),
                          jtopo.random_regular_adjacency(n, 6, seed=5))
    assert _bit_equal(ttopo.clustered_adjacency(12, 3), jtopo.clustered_adjacency(12, 3))
    with pytest.raises(ValueError, match="n >= 2"):
        ttopo.random_regular_adjacency(1)
    with pytest.raises(KeyError, match="registered"):
        ttopo.get_topology("moebius")
    a = np.zeros((8, 8), bool)
    a[:4, :4] = ttopo.ring_adjacency(4)
    a[4:, 4:] = ttopo.ring_adjacency(4)
    assert not ttopo.is_connected(a)
    with pytest.raises(ValueError, match="symmetric"):
        ttopo.spectral_gap(np.triu(np.ones((4, 4))))


@pytest.mark.parametrize("name", ["random_regular", "ring", "torus"])
def test_time_varying_and_churn_coupled_stacks_bit_equal(name):
    for n, rounds, seed in ((6, 4, 0), (12, 5, 3)):
        st, sj = (m.time_varying_mixing(name, n, rounds, seed=seed) for m in (ttopo, jtopo))
        assert _bit_equal(st, sj)
        rng = np.random.default_rng(seed)
        joins = rng.integers(0, 3, n)
        leaves = joins + rng.integers(1, 6, n)
        base = jtopo.mixing_matrix(name, n, seed=seed)
        ct = ttopo.churn_coupled_mixing(base, joins, leaves, rounds=7)
        cj = jtopo.churn_coupled_mixing(base, joins, leaves, rounds=7)
        assert _bit_equal(ct, cj)


# ----------------------------- gossip ------------------------------------------
def test_gossip_functions_match_the_reference():
    rng = np.random.default_rng(0)
    for name, n in (("ring", 8), ("torus", 16), ("random_regular", 12), ("clustered", 10)):
        w = ttopo.mixing_matrix(name, n, seed=1)
        x = rng.normal(size=(n, 3, 5)).astype(np.float32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w.astype(np.float32))
        xj, wj = jnp.asarray(x), jnp.asarray(w, jnp.float32)
        np.testing.assert_allclose(tgossip.gossip_round(xt, wt).numpy(),
                                   np.asarray(jgossip.gossip_round(xj, wj)), rtol=1e-6, atol=1e-6)
        for rounds in (1, 7):
            np.testing.assert_allclose(tgossip.gossip_average(xt, wt, rounds).numpy(),
                                       np.asarray(jgossip.gossip_average(xj, wj, rounds)),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(tgossip.consensus_error(xt)),
                                   float(jgossip.consensus_error(xj)), rtol=1e-6)
        # over the active nodes only: the reference round's own formula
        for active in (rng.random(n) < 0.5, np.arange(n) == 2, np.zeros(n, bool)):
            m = jnp.asarray(active, jnp.float32)[:, None]
            flat = xj.reshape(n, -1)
            mean = jnp.sum(flat * m, axis=0, keepdims=True) / jnp.maximum(jnp.sum(m), 1.0)
            want = float(jnp.max(jnp.linalg.norm((flat - mean) * m, axis=1)))
            got = float(tgossip.consensus_error(xt, torch.from_numpy(active)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        # a float64 matrix is cast to the values' dtype, as the reference does
        np.testing.assert_allclose(tgossip.gossip_round(xt, torch.from_numpy(w)).numpy(),
                                   np.asarray(jgossip.gossip_round(xj, jnp.asarray(w))),
                                   rtol=1e-6, atol=1e-6)
        for tol in (2.0, 1.0, 1e-3, 1e-6):
            assert tgossip.rounds_for_tolerance(w, tol) == jgossip.rounds_for_tolerance(w, tol)
        adj = ttopo.get_topology(name).builder(n, seed=1)
        assert tgossip.gossip_traffic_bytes(adj, 1000) == jgossip.gossip_traffic_bytes(adj, 1000)
        assert tgossip.allreduce_traffic_bytes(n, 1000, 2) == \
            jgossip.allreduce_traffic_bytes(n, 1000, 2)
    a = np.zeros((8, 8), bool)
    a[:4, :4] = ttopo.ring_adjacency(4)
    a[4:, 4:] = ttopo.ring_adjacency(4)
    with pytest.raises(ValueError, match="spectral gap"):
        tgossip.rounds_for_tolerance(ttopo.metropolis_weights(a), 1e-3)


# ------------------- decentralized round == centralized (K_n) ------------------
@pytest.mark.parametrize("scenario", ["sign_flip_minority", "audit_heavy",
                                      "high_churn_elastic", "heterogeneous_speed"])
def test_fully_connected_decentralized_matches_centralized(problem, scenario):
    """The twin of ``tests/test_topology.py:160``: on a complete graph
    every neighbourhood is global and every replica identical, so the
    decentralized round reproduces the centralized engine: the same
    history, caught sets and minted balances; agg_norm within the
    reference test's 2e-3 relative, 1e-5 absolute."""
    loss_fn, params0, data_fn, _ = problem[1]
    nodes, cfg = tscen.get_scenario(scenario).build(n_nodes=8, seed=0)
    dcfg = dataclasses.replace(cfg, topology="fully_connected")
    cen = tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0), nodes, cfg, data_fn)
    dec = tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0), nodes, dcfg, data_fn)
    assert dec.params["w"].shape == (8, 8)
    for r in range(12):
        cen.step(r)
        dec.step(r)
    for key in ("n_active", "caught"):
        assert [h[key] for h in dec.history] == [h[key] for h in cen.history]
    np.testing.assert_allclose([h["agg_norm"] for h in dec.history],
                               [h["agg_norm"] for h in cen.history], rtol=2e-3, atol=1e-5,
                               err_msg=scenario)
    assert all(h["consensus_error"] < 1e-4 for h in dec.history)
    assert dec.ledger.balances == pytest.approx(cen.ledger.balances)
    assert dec.ledger.burned_stake == pytest.approx(cen.ledger.burned_stake)
    np.testing.assert_allclose(dec.eval_params()["w"].numpy(), cen.params["w"].numpy(),
                               rtol=2e-3, atol=1e-5)


def test_decentralized_ring_disagrees_then_converges(problem):
    """The twin of ``tests/test_topology.py:186``: replicas on a ring
    disagree (consensus_error > 0), gossip contracts the disagreement, and
    the consensus params learn."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    swarm = tscen.get_scenario("gossip_ring_honest").build_swarm(
        loss_fn, params0, TSGD(lr=0.1, momentum=0.0), data_fn, n_nodes=8)
    losses = swarm.run(40, eval_fn=eval_fn)
    errs = [h["consensus_error"] for h in swarm.history]
    assert max(errs) > 1e-4
    assert errs[-1] < max(errs)
    assert losses[-1] < 0.1 * losses[0]


def test_decentralized_scanned_run_matches_step_loop(problem):
    """The twin of ``tests/test_topology.py:200``: ``scan_rounds`` over the
    byzantine_neighborhood lane equals ``Swarm.step`` round by round,
    records and replicas bit for bit."""
    loss_fn, params0, data_fn, _ = problem[1]
    nodes, cfg = tscen.get_scenario("byzantine_neighborhood").build(n_nodes=8)
    stepped = tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0), nodes, cfg,
                                data_fn)
    for r in range(10):
        stepped.step(r)
    round_fn = tswarm.make_round_fn(loss_fn, TSGD(lr=0.1, momentum=0.0), params0, 8,
                                    aggregator=cfg.aggregator, decentralized=True)
    run = tswarm.make_scan_program(round_fn, lambda r: [data_fn(i, r) for i in range(8)], 10)
    state, recs, _ = run(tswarm.lane_for_nodes(nodes, cfg, torch.device("cpu")),
                         *tswarm.init_decentralized_state(params0, TSGD(lr=0.1, momentum=0.0), 8))
    assert tswarm.history_from_records(recs, [n.node_id for n in nodes]) == stepped.history
    assert torch.equal(state.params["w"], stepped.params["w"])


def test_churn_coupled_engine_freezes_leaver_replica(problem):
    """The twin of ``tests/test_topology.py:216``: with
    ``churn_coupled=True`` a departed node's replica freezes; with the
    static graph it keeps mixing and moves."""
    loss_fn, params0, data_fn, _ = problem[1]
    nodes = [tswarm.NodeSpec(f"h{i}") for i in range(5)] + \
        [tswarm.NodeSpec("leaver", leave_round=3)]
    cfg = tswarm.SwarmConfig(aggregator="mean", topology="ring", churn_coupled=True)
    swarm = tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0), nodes, cfg,
                              data_fn)
    assert swarm._lane.mixing.shape == (4, 6, 6)
    snap = None
    for r in range(8):
        swarm.step(r)
        if r == 3:
            snap = swarm.params["w"][5].clone()
    frozen = swarm.params["w"][5]
    assert torch.equal(frozen, snap)
    assert float((swarm.params["w"][0] - frozen).abs().max()) > 1e-6
    assert all(np.isfinite(h["consensus_error"]) for h in swarm.history)
    loose = tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0), nodes,
                              tswarm.SwarmConfig(aggregator="mean", topology="ring"), data_fn)
    for r in range(8):
        loose.step(r)
    assert float((loose.params["w"][5] - frozen).abs().max()) > 1e-6


def test_sequential_engine_rejects_topology(problem):
    """The twin of ``tests/test_topology.py:247``, with the reference's
    error; and the decentralized round is never fused on the CPU."""
    loss_fn, params0, data_fn, _ = problem[1]
    with pytest.raises(ValueError, match="centralized-only"):
        tswarm.make_swarm(loss_fn, params0, TSGD(lr=0.1, momentum=0.0),
                          [tswarm.NodeSpec("h0"), tswarm.NodeSpec("h1")],
                          tswarm.SwarmConfig(aggregator="mean", topology="ring"), data_fn,
                          engine="sequential")
    with pytest.raises(ValueError, match="needs a centralized round"):
        tswarm.make_round_fn(loss_fn, TSGD(), params0, 4, aggregator="mean",
                             decentralized=True, fused=True)
    with pytest.raises(ValueError, match="mixing_schedule"):
        tswarm.make_round_fn(loss_fn, TSGD(), params0, 4, aggregator="mean",
                             decentralized=True, mixing_schedule="wrap")
    fn = tswarm.make_round_fn(loss_fn, TSGD(), params0, 4, aggregator="centered_clip",
                              decentralized=True)
    assert not fn.fused


def test_time_varying_mixing_lane_runs_in_campaign(problem):
    """The twin of ``tests/test_topology.py:312``: a (T, N, N) stack rides
    through the campaign read at round % T, and equals the reference's
    campaign on the same stack within 1e-5."""
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    stack = ttopo.time_varying_mixing("random_regular", 6, 4, seed=0)
    lane = tswarm.lane_for_nodes([tswarm.NodeSpec(f"h{i}") for i in range(6)],
                                 tswarm.SwarmConfig(aggregator="mean"), torch.device("cpu"))
    lane = lane._replace(mixing=torch.from_numpy(stack.astype(np.float32)))
    state, recs, final = tswarm.run_campaign(
        tl, tp, TSGD(lr=0.1, momentum=0.0), td, tswarm.stack_lanes([lane]), rounds=10,
        aggregator="mean", eval_fn=te)
    assert torch.isfinite(final).all() and recs.consensus_err.shape == (1, 10)
    assert torch.isfinite(recs.consensus_err).all()
    from repro.core import swarm as jswarm
    jlane = jswarm.lane_for_nodes([jswarm.NodeSpec(f"h{i}") for i in range(6)],
                                  jswarm.SwarmConfig(aggregator="mean"))
    jlane = jlane._replace(mixing=jnp.asarray(stack, jnp.float32))
    jstate, jrecs, jfinal = jswarm.run_campaign(
        jl, jp, JSGD(lr=0.1, momentum=0.0), jd, jswarm.stack_lanes([jlane]), rounds=10,
        aggregator="mean", eval_fn=je)
    np.testing.assert_allclose(recs.consensus_err.numpy(), np.asarray(jrecs.consensus_err),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(recs.agg_norm.numpy(), np.asarray(jrecs.agg_norm), rtol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5)
    np.testing.assert_allclose(state.params["w"].numpy(), np.asarray(jstate.params["w"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scenario", ["gossip_ring_honest", "byzantine_neighborhood",
                                      "partitioned_swarm"])
def test_decentralized_scenarios_step_as_the_reference(problem, scenario):
    """The three decentralized scenarios register (no longer waiting) and
    step as the reference's over 10 rounds at N = 8: equal discrete
    fields, agg_norm within 1e-5 and consensus_error within 1e-4 relative
    (1e-7 absolute), replicas within 1e-5."""
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    assert scenario not in tscen.WAITING_SCENARIOS
    js = jscen.get_scenario(scenario).build_swarm(jl, jp, JSGD(lr=0.1, momentum=0.0), jd,
                                                  n_nodes=8)
    ts = tscen.get_scenario(scenario).build_swarm(tl, tp, TSGD(lr=0.1, momentum=0.0), td,
                                                  n_nodes=8)
    for r in range(10):
        a, b = js.step(r), ts.step(r)
        for key in ("n_active", "n_byzantine", "caught"):
            assert a[key] == b[key], (r, key)
        np.testing.assert_allclose(b["agg_norm"], a["agg_norm"], rtol=1e-5)
        np.testing.assert_allclose(b["consensus_error"], a["consensus_error"],
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(ts.params["w"].numpy(), np.asarray(js.params["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(te(ts.eval_params())), float(je(js.eval_params())),
                               rtol=1e-5)


# ------------------------- the §5.5 topology axis ------------------------------
def test_no_off_topology_smoke_cell_by_cell_against_the_reference(quadratic):  # noqa: F811
    """``no_off_topology_smoke`` (CenteredClip on a ring and the complete
    graph, 2 and 6 attackers beside 6 honest, 8 rounds, baselines per
    topology) on ``examples/common.py``'s quadratic against the
    reference's sweep: tables equal as strings, every cell's discrete
    fields equal, finite losses within 1e-4 relative."""
    grid_t, grid_j = (m.get_sweep_grid("no_off_topology_smoke") for m in (tscen, jscen))
    jres, tres = _sweeps(quadratic, grid_t, grid_j)
    _assert_cells_equal(jres, tres)
    assert [r.topology for r in tres.results] == [r.topology for r in jres.results]
    assert "centered_clip@ring" in tres.phase_table()


def test_sweep_lanes_with_topologies_equal_the_reference():
    """``build_sweep_lanes`` of ``no_off_topology``: the lane order, the
    metadata and each lane's mixing matrix (one a topology, at seed 0, over
    all slots) equal the reference's."""
    from repro.core import derailment as jder
    t = tder.build_sweep_lanes(tscen.get_sweep_grid("no_off_topology"))
    j = jder.build_sweep_lanes(jscen.get_sweep_grid("no_off_topology"))
    assert len(t.lanes) == len(j.lanes) == jscen.get_sweep_grid("no_off_topology").n_lanes
    for tm, jm in zip(t.metas, j.metas):
        assert tm[1:] == jm[1:]
        assert (tm[0] is None) == (jm[0] is None)
    for tl, jl in zip(t.lanes, j.lanes):
        assert _bit_equal(np.asarray(tl.mixing), np.asarray(jl.mixing))
        assert np.array_equal(tl.joins, jl.joins) and np.array_equal(tl.codes, jl.codes)


def test_simulate_derailment_sizes_the_baseline_graph(problem):
    """The twin of ``tests/test_topology.py:292``: at count = max the sweep
    cell and ``simulate_derailment(topology=...)`` (its baseline over a
    graph the attacked swarm's size) agree within the reference test's
    2e-3, and their verdicts are equal; the port's results also equal the
    reference's ``simulate_derailment`` within 1e-4."""
    from repro.core import derailment as jder
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    grid = tscen.SweepGrid(name="parity", description="", n_honest=6, attacker_counts=(3,),
                           seeds=(0,), rounds=8,
                           regimes=(tscen.Regime("centered_clip", "centered_clip"),),
                           topologies=("ring",))
    (cell,) = tder.sweep(tl, tp, TSGD(lr=0.1, momentum=0.0), td, te, grid).results
    kw = dict(n_honest=6, n_attack=3, rounds=8, aggregator="centered_clip", topology="ring",
              seed=0)
    single = tder.simulate_derailment(tl, tp, TSGD(lr=0.1, momentum=0.0), td, te, **kw)
    ref = jder.simulate_derailment(jl, jp, JSGD(lr=0.1, momentum=0.0), jd, je, **kw)
    np.testing.assert_allclose(cell.final_loss, single.final_loss, rtol=2e-3)
    np.testing.assert_allclose(cell.baseline_loss, single.baseline_loss, rtol=2e-3)
    assert cell.derailed == single.derailed == ref.derailed
    assert single.topology == ref.topology == "ring"
    np.testing.assert_allclose(single.final_loss, ref.final_loss, rtol=1e-4)
    np.testing.assert_allclose(single.baseline_loss, ref.baseline_loss, rtol=1e-4)
