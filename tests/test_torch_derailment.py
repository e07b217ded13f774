"""The §5.5 sweep (ROADMAP queue 1, item 4a) against the JAX reference.

- every registered sweep grid's ``n_points`` and ``n_lanes``, and
  ``build_sweep_lanes``' metadata and lane fields for four grids, equal the
  reference's;
- ``no_off_smoke`` on ``examples/common.py``'s tiny quadratic (16
  parameters; the reference's target and batches carried across), cell by
  cell against the reference's ``sweep``: the ``phase_table()`` strings
  equal, each cell's ``derailed``, ``attackers_slashed`` and
  ``n_attackers`` equal, its finite losses within 1e-4 relative;
- a verified regime (p_check 1) slashes as the reference's does;
- each sweep lane equals the port's own ``simulate_derailment``, on both
  engines;
- ``attack_cost`` and ``no_off_report`` render the reference's strings;
- ``plan`` raises its item; the topology (item 8), custody (7), staleness
  (9) and economy (10) grids build and sweep, and the economy scenarios
  build.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core.verification import VerificationConfig as JVer
from repro_torch.core import derailment as tder
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.launch import problems

ROOT = Path(__file__).resolve().parents[1]
# the grids of the reference's later axes, every axis ported (topologies
# item 8, custody 7, staleness 9, economy 10): each grid builds and sweeps
LATER_GRIDS = ("no_off_topology_smoke", "no_off_topology", "no_off_async_smoke",
               "no_off_async", "custody_smoke", "custody_frontier", "no_off_economy_smoke",
               "no_off_economy")


def _examples_common():
    spec = importlib.util.spec_from_file_location("examples_common",
                                                  ROOT / "examples" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quadratic():
    """``examples/common.py``'s tiny quadratic on both sides, the port's on
    the reference's target and batches: ``(reference, port)``, each
    ``(loss_fn, params, data_fn, eval_fn, optimizer)``."""
    ref = _examples_common().tiny_quadratic_problem()
    k1, _ = jax.random.split(jax.random.PRNGKey(42))
    target = torch.from_numpy(np.array(jax.random.normal(k1, (16,))))
    cache = {}

    def data_fn(i, rnd):
        if (i, rnd) not in cache:
            cache[i, rnd] = {"x": torch.from_numpy(np.array(ref[2](i, rnd)["x"]))}
        return cache[i, rnd]

    return ref, problems.quadratic_problem(target, data_fn)


def _sweeps(quadratic, grid_t, grid_j, **kw):
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = quadratic
    return (jder.sweep(jl, jp, jo, jd, je, grid_j, **kw),
            tder.sweep(tl, tp, to, td, te, grid_t, **kw))


def _grid_pair(**fields):
    """The same custom grid on both sides (regimes built from each side's
    Regime and VerificationConfig)."""
    regimes = fields.pop("regimes")

    def side(scen, ver):
        return scen.SweepGrid(
            name="custom", description="", **fields,
            regimes=tuple(scen.Regime(name, agg, dict(kw),
                                      verification=ver(**v) if v else None)
                          for name, agg, kw, v in regimes))
    return side(tscen, TVer), side(jscen, JVer)


def test_every_sweep_grid_counts_as_the_reference():
    assert tscen.list_sweep_grids() == jscen.list_sweep_grids()
    for name in jscen.list_sweep_grids():
        t, j = tscen.get_sweep_grid(name), jscen.get_sweep_grid(name)
        assert (t.n_points, t.n_lanes) == (j.n_points, j.n_lanes), name
        assert (t.has_custody, t.has_economy) == (j.has_custody, j.has_economy), name
    with pytest.raises(KeyError, match="registered"):
        tscen.get_sweep_grid("nope")


def _krum_grids():
    return _grid_pair(regimes=(("mean", "mean", {}, None), ("krum", "krum", {}, None),
                               ("krum2", "krum", {"f": 2},
                                dict(p_check=0.5, stake=5.0, tolerance=1e-3))),
                      n_honest=5, attacker_counts=(1, 4), seeds=(0, 3), scales=(5.0, 50.0),
                      attack="sign_flip", rounds=4)


@pytest.mark.parametrize("grid", ["no_off_smoke", "no_off_quick", "no_off_phase", "krum"])
def test_sweep_lanes_equal_the_reference(grid):
    if grid == "krum":
        tgrid, jgrid = _krum_grids()
    else:
        tgrid, jgrid = tscen.get_sweep_grid(grid), jscen.get_sweep_grid(grid)
    t, j = tder.build_sweep_lanes(tgrid), jder.build_sweep_lanes(jgrid)
    assert t.agg_specs == j.agg_specs
    assert (t.aggregator, t.agg_kwargs) == (j.aggregator, j.agg_kwargs)
    assert not j.has_custody
    assert (t.verify, t.n_honest, t.n_total) == \
        (j.verify, j.n_honest, j.n_total)
    assert len(t.metas) == len(j.metas) == jgrid.n_lanes
    for tm, jm in zip(t.metas, j.metas):
        assert (tm[0] is None) == (jm[0] is None)
        if tm[0] is not None:
            assert (tm[0].name, tm[0].aggregator, tm[0].agg_kwargs) == \
                (jm[0].name, jm[0].aggregator, jm[0].agg_kwargs)
        assert tm[1:] == jm[1:]
    for tl, jl in zip(t.lanes, j.lanes):
        for field in ("codes", "scales", "speeds", "joins", "leaves"):
            a, b = getattr(tl, field), getattr(jl, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        for field in ("p_check", "tolerance", "numeric_noise"):
            assert np.float32(getattr(tl, field)) == getattr(jl, field), field
        assert tl.agg_id == int(jl.agg_id)
        assert np.array_equal(jax.random.PRNGKey(tl.seed), jl.base_key)
        assert tl.agg_kwargs.keys() == jl.agg_kwargs.keys()
        for k in tl.agg_kwargs:
            assert int(tl.agg_kwargs[k]) == int(jl.agg_kwargs[k])
        assert all(getattr(tl, f) is None for f in ("mixing", "custody", "delays", "econ"))


def _assert_cells_equal(jres, tres, rtol=1e-4):
    assert tres.phase_table() == jres.phase_table()
    assert (tres.n_programs, tres.n_runs) == (jres.n_programs, jres.n_runs)
    assert len(tres.results) == len(jres.results) == jres.grid.n_points
    for j, t in zip(jres.results, tres.results):
        for field in ("regime", "aggregator", "verified", "n_attackers", "seed",
                      "attackers_slashed", "derailed", "attacker_fraction"):
            assert getattr(t, field) == getattr(j, field), (field, j)
        for field in ("final_loss", "baseline_loss", "init_loss"):
            a, b = getattr(t, field), getattr(j, field)
            assert np.isfinite(a) == np.isfinite(b), (field, j)
            if np.isfinite(b):
                np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f"{field} {j}")


def test_no_off_smoke_cell_by_cell_against_the_reference(quadratic):
    jres, tres = _sweeps(quadratic, tscen.get_sweep_grid("no_off_smoke"),
                         jscen.get_sweep_grid("no_off_smoke"))
    _assert_cells_equal(jres, tres)
    by = {(r.regime, r.n_attackers): r.derailed for r in tres.results}
    assert by == {("mean", 2): True, ("mean", 6): True,
                  ("centered_clip", 2): False, ("centered_clip", 6): True}
    assert tres.runs_per_s > 0


def test_verified_regime_slashes_as_the_reference(quadratic):
    """The reference's ``test_sweep_verified_regime_slashes_attackers``
    grid: with p_check 1 every zero-gradient attacker is slashed, and the
    unverified regime of the same campaign slashes none."""
    tgrid, jgrid = _grid_pair(
        regimes=(("mean", "mean", {}, None),
                 ("mean+verified", "mean", {}, dict(p_check=1.0, stake=5.0, tolerance=1e-3))),
        n_honest=6, attacker_counts=(2,), seeds=(0,), rounds=10, attack="zero")
    jres, tres = _sweeps(quadratic, tgrid, jgrid)
    _assert_cells_equal(jres, tres)
    by = {r.regime: r for r in tres.results}
    assert by["mean+verified"].attackers_slashed == 2 and not by["mean+verified"].derailed
    assert by["mean"].attackers_slashed == 0


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_sweep_lane_equals_simulate_derailment(quadratic, engine):
    """Each cell of a sweep (N = 9 with its padding) equals the single-run
    swarm of ``simulate_derailment`` (N = 6 + count) on the same baseline.
    The batched engine bit for bit where the padding leaves the arithmetic
    alone: the mean (its rows added in node order) and any cell at the
    largest count (the same N); CenteredClip below it sums its columns
    over a taller stack, within 1e-5.  The sequential engine (the dense
    aggregators over the survivors) within 1e-5."""
    tl, tp, td, te, to = quadratic[1]
    grid = tscen.SweepGrid(name="tiny", description="", n_honest=6,
                           attacker_counts=(1, 3), seeds=(0, 2), rounds=10,
                           regimes=tscen.get_sweep_grid("no_off_smoke").regimes)
    res = tder.sweep(tl, tp, to, td, te, grid)
    for r in res.results:
        single, swarm = tder.simulate_derailment(
            tl, tp, to, td, te, n_honest=6, n_attack=r.n_attackers, rounds=10,
            aggregator=r.aggregator, seed=r.seed, baseline_loss=r.baseline_loss,
            engine=engine, return_swarm=True)
        assert isinstance(swarm, tswarm.ENGINES[engine])
        assert single.derailed == r.derailed and single.init_loss == r.init_loss
        assert single.attackers_slashed == r.attackers_slashed
        if engine == "batched" and (r.aggregator == "mean" or r.n_attackers == 3):
            assert single.final_loss == r.final_loss, r
        else:
            np.testing.assert_allclose(single.final_loss, r.final_loss, rtol=1e-5)


def test_attack_cost_and_report_render_as_the_reference():
    jv, tv = JVer(p_check=0.25, stake=10.0), TVer(p_check=0.25, stake=10.0)
    for n, rounds, cost in ((3, 25, 1.5), (0, 4, 2.0), (12, 8, 0.1)):
        assert tder.attack_cost(n, rounds, compute_cost_per_round=cost, verification=tv) == \
            jder.attack_cost(n, rounds, compute_cost_per_round=cost, verification=jv)
        assert tder.attack_cost(n, rounds, compute_cost_per_round=cost, verification=None) == \
            jder.attack_cost(n, rounds, compute_cost_per_round=cost, verification=None)
    cells = [dict(attacker_fraction=0.25, aggregator="mean", verified=False,
                  final_loss=2.95e9, baseline_loss=0.2465, attackers_slashed=0,
                  n_attackers=2, init_loss=9.63),
             dict(attacker_fraction=0.5, aggregator="centered_clip", verified=True,
                  final_loss=1.13, baseline_loss=0.2465, attackers_slashed=3,
                  n_attackers=6, init_loss=9.63, seed=2, regime="centered_clip+v"),
             dict(attacker_fraction=0.1, aggregator="krum", verified=False,
                  final_loss=float("nan"), baseline_loss=0.3, attackers_slashed=0,
                  n_attackers=1)]
    tr = [tder.DerailmentResult(**c) for c in cells]
    jr = [jder.DerailmentResult(**c) for c in cells]
    assert [r.derailed for r in tr] == [r.derailed for r in jr]
    assert tder.no_off_report(tr) == jder.no_off_report(jr)
    assert [r.extractability for r in tr] == [r.extractability for r in jr] == ["", "", ""]


@pytest.mark.parametrize("grid", sorted(LATER_GRIDS))
def test_later_axis_grids_raise_their_item(quadratic, grid):
    """A grid of a later axis builds its lanes (one mixing matrix a
    topology, one set of delay caps a staleness bound, one custody matrix
    and coalition a custody cell, one economy a cell of the economy axes)
    and sweeps."""
    tl, tp, td, te, to = quadratic[1]
    g = tscen.get_sweep_grid(grid)
    spec = tder.build_sweep_lanes(g)
    assert len(spec.lanes) == g.n_lanes
    n = spec.n_total
    assert {m[1] for m in spec.metas} == set(g.topologies or ("",))
    assert {m[2] for m in spec.metas} == set(g.staleness_bounds or (0,))
    for lane in spec.lanes:
        assert (lane.mixing is None) == (not g.topologies)
        assert lane.mixing is None or lane.mixing.shape == (n, n)
        assert (lane.delays is None) == (not g.staleness_bounds)
        assert lane.delays is None or lane.delays.max() in g.staleness_bounds
        assert (lane.custody is None) == (not g.has_custody)
        assert lane.custody is None or lane.custody.shape == (n, g.num_shards)
        assert (lane.econ is None) == (not g.has_economy)
        assert lane.econ is None or lane.econ.coalition.shape == (n,)
    res = tder.sweep(tl, tp, to, td, te, g, rounds=1)
    assert {r.topology for r in res.results} == set(g.topologies or ("",))
    assert {r.staleness_bound for r in res.results} == set(g.staleness_bounds or (0,))
    assert {r.redundancy for r in res.results} == set(g.redundancies or (0,))
    assert all(np.isfinite(r.final_loss) for r in res.results)
    assert all(np.isfinite(r.extracted_loss) == g.has_custody for r in res.results)
    assert len(res.econ_results) == (g.n_points if g.has_economy else 0)
    assert {r.identity_cost for r in res.econ_results} == set(g.identity_costs)


def test_unported_scenarios_and_options_raise(quadratic):
    assert tscen.list_scenarios() == jscen.list_scenarios() and not tscen.WAITING_SCENARIOS
    for name in ("economy_rational", "economy_sybil_adaptive"):
        nodes, cfg = tscen.get_scenario(name).build(8, seed=3)
        jnodes, jcfg = jscen.get_scenario(name).build(8, seed=3)
        assert [n.__dict__ for n in nodes] == [n.__dict__ for n in jnodes]
        assert vars(cfg.economy) == vars(jcfg.economy) and cfg.seed == jcfg.seed == 3
    with pytest.raises(KeyError, match="registered"):
        tscen.get_scenario("nope")
    tl, tp, td, te, to = quadratic[1]
    grid = tscen.get_sweep_grid("no_off_smoke")
    with pytest.raises(NotImplementedError, match="item 13"):
        tder.sweep(tl, tp, to, td, te, grid, plan=object())
    res = tder.SweepResult(grid=grid, results=[], n_programs=1, n_runs=0, wall_s=1.0)
    assert res.extractability_table() == "(no custody axis in this sweep)"
    assert res.economy_phase_table("mean") == "cost\\fee  "
    assert res.economy_adaptive_gap()["cells"] == 0
    # the async point (item 9) runs, its baseline at the same bound
    (jl, jp, jd, je, jo) = quadratic[0]
    kw = dict(n_honest=3, n_attack=1, rounds=4, aggregator="mean", staleness_bound=2)
    res, sw = tder.simulate_derailment(tl, tp, to, td, te, return_swarm=True, **kw)
    assert res.staleness_bound == 2 and sw.cfg.staleness_bound == 2
    assert all(n.delay == 2 for n in sw.nodes) and sw.history[-1]["staleness"] >= 0
    assert np.isfinite(res.final_loss) and np.isfinite(res.baseline_loss)
    jres = jder.simulate_derailment(jl, jp, jo, jd, je, **kw)
    assert (res.n_attackers, res.attacker_fraction) == (jres.n_attackers, jres.attacker_fraction)


def test_tiny_quadratic_problem_is_seeded():
    """The port's own problem: the same bits on every call, the loss form
    of ``examples/common.py`` and SGD at lr 0.1."""
    a, b = (problems.tiny_quadratic_problem(device="cpu") for _ in range(2))
    assert torch.equal(a[2](3, 5)["x"], b[2](3, 5)["x"])
    assert not torch.equal(a[2](3, 5)["x"], a[2](4, 5)["x"])
    assert a[2](0, 0)["x"].shape == (16, 16) and a[1]["w"].shape == (16,)
    assert float(a[3](a[1])) > 0 and a[4].lr == 0.1 and a[4].momentum == 0.0
