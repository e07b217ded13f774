"""The port's continuous-batching engine (``core/serving.py``) against the
reference's ``ServingEngine`` on the reduced protocol-125m of
``tests/test_serving.py`` (1 layer, width 32, vocabulary 64).

Each test twins one of that file's: the same lanes, built by each side's
``build_lane`` from the same host arguments, and the reference's prompts
and weights (``params_from_jax``) go through both engines.  The
``ServeResult``'s tokens, done, admitted, balances and all six record
traces (coverage, live, n_active, n_admitted, new_tokens, queued) are held
exactly equal, dtypes included; then the reference test's own assertions
are made on the port's result.  ``settle_fees`` is held on both ledgers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import serving as jserving
from repro.core import scenarios as jscenarios
from repro.core.ledger import Ledger as JLedger
from repro.core.unextractable import ShardCustody, assign_matrix
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import scenarios as tscenarios
from repro_torch.core import serving as tserving
from repro_torch.core.ledger import Ledger
from repro_torch.models import convert
from repro_torch.models.model import build_model

_FAR = np.iinfo(np.int32).max
MODEL = dict(num_layers=1, d_model=32, num_heads=2, head_dim=16, d_ff=64, vocab_size=64)
FIELDS = ("tokens", "done", "admitted", "balances", "coverage", "live", "n_active",
          "n_admitted", "new_tokens", "queued")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, the same params)."""
    jmodel = jbuild_model(jget_config("protocol-125m").reduced(**MODEL))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(get_config("protocol-125m").reduced(**MODEL)), tparams


@pytest.fixture(scope="module")
def workload():
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (6, 6), 0,
                                           MODEL["vocab_size"]))
    return prompts, np.array([6, 4, 5, 6, 3, 4], np.int32)


class Engines:
    """The reference's engine and the port's over the same model and prompts."""

    def __init__(self, pair, cfg_kwargs, prompts):
        jmodel, self.jparams, tmodel, self.tparams = pair
        self.cfg = tserving.ServingConfig(**cfg_kwargs)
        self.ref = jserving.ServingEngine(jmodel, jserving.ServingConfig(**cfg_kwargs),
                                          jnp.asarray(prompts))
        self.port = tserving.ServingEngine(tmodel, self.cfg, prompts, device="cpu")

    def run(self, replace=None, **lane_kwargs):
        """Both engines on the lane ``build_lane(**lane_kwargs)`` (fields in
        ``replace`` swapped for the given host arrays); every field of the
        two results equal; the port's result."""
        replace = replace or {}
        jlane = jserving.build_lane(**lane_kwargs)._replace(
            **{k: jnp.asarray(v) for k, v in replace.items()})
        tlane = tserving.build_lane(**lane_kwargs, device="cpu")._replace(
            **{k: torch.as_tensor(np.asarray(v, np.int64)) for k, v in replace.items()})
        want, got = self.ref.run(self.jparams, jlane), self.port.run(self.tparams, tlane)
        for f in FIELDS:
            a, b = getattr(want, f), getattr(got, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (f, a, b)
        assert got.availability == want.availability
        return got


@pytest.fixture(scope="module")
def engines(pair, workload):
    return Engines(pair, dict(slots=3, max_new=5, steps=44), workload[0])


@pytest.fixture(scope="module")
def greedy_reference(pair, workload):
    """The port's per-request greedy outputs, each held against the
    reference's (the oracle of tests/test_serving.py)."""
    jmodel, jparams, tmodel, tparams = pair
    prompts, plens = workload
    refs = []
    for r in range(prompts.shape[0]):
        p = prompts[r:r + 1, :int(plens[r])]
        want, _ = jserving.greedy_decode_loop(jmodel, jparams, jnp.asarray(p), 5)
        got, _ = tserving.greedy_decode_loop(tmodel, tparams, torch.from_numpy(p).long(), 5)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        refs.append(got[0].numpy())
    return np.stack(refs)


def _lane(workload, engines, **kw):
    prompts, plens = workload
    return dict(dict(n_requests=prompts.shape[0], prompt_lens=plens, max_new=5,
                     steps=engines.cfg.steps, n_nodes=4, balances=[100.0], fee=1.0), **kw)


# ---------------------- greedy decoding ----------------------------------------
def test_greedy_matches_the_reference_scan_and_loop(pair, workload):
    jmodel, jparams, tmodel, tparams = pair
    prompts, _ = workload
    want, _ = jserving.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 6)
    got, stats = tserving.greedy_decode(tmodel, tparams, torch.from_numpy(prompts).long(), 6)
    loop, _ = tserving.greedy_decode_loop(tmodel, tparams, torch.from_numpy(prompts).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, loop) and got.shape == (6, 6) and stats.tokens_out == 6


# ---------------------- continuous-batching equivalence ------------------------
@pytest.mark.parametrize("order", [
    [0, 1, 2, 3, 4, 5],          # arrival = request order
    [5, 3, 1, 0, 2, 4],          # shuffled admission order
    [2, 2, 2, 9, 9, 9],          # bursts (ties admitted in request order)
])
def test_engine_reproduces_per_request_greedy(workload, greedy_reference, engines, order):
    res = engines.run(**_lane(workload, engines, balances=[100.0, 100.0],
                              arrivals=np.asarray(order, np.int32)))
    assert res.done.all()
    assert np.array_equal(res.tokens, greedy_reference)


def test_engine_recycles_slots_without_leaking_cache(workload, greedy_reference, engines):
    res = engines.run(**_lane(workload, engines, load=10.0))
    assert res.done.all()
    assert int(res.n_active.max()) == 3
    assert np.array_equal(res.tokens, greedy_reference)


def test_engine_honours_per_request_decode_budgets(pair, workload, engines):
    _, _, tmodel, tparams = pair
    prompts, plens = workload
    budgets = np.array([5, 2, 4, 1, 3, 5], np.int32)
    res = engines.run(**_lane(workload, engines, max_new=budgets, load=10.0))
    assert res.done.all()
    for r in range(prompts.shape[0]):
        ref, _ = tserving.greedy_decode(
            tmodel, tparams, torch.from_numpy(prompts[r:r + 1, :int(plens[r])]).long(),
            int(budgets[r]))
        np.testing.assert_array_equal(res.tokens[r, :budgets[r]], ref[0].numpy())
        assert (res.tokens[r, budgets[r]:] == 0).all()


# ---------------------- custody coupling ---------------------------------------
def test_serving_halts_exactly_when_coverage_below_one(workload, engines):
    custody = assign_matrix(4, 8, redundancy=1, seed=0, max_fraction=0.5)
    down_from = np.full(4, _FAR, np.int32)
    down_until = np.full(4, _FAR, np.int32)
    down_from[0], down_until[0] = 8, 20
    res = engines.run(replace=dict(node_down_from=down_from, node_down_until=down_until),
                      **_lane(workload, engines, load=0.5, custody=custody))
    assert (res.live == (res.coverage >= 1.0)).all()
    assert not res.live[8:20].any()
    assert (res.new_tokens[~res.live] == 0).all()
    assert res.new_tokens[20:].sum() > 0
    assert res.done.all()
    assert res.availability < 1.0


@pytest.mark.parametrize("departed", [[], ["n0"], ["n1", "n2"], ["n3"]])
def test_availability_agrees_with_tolerates_departures(workload, engines, departed):
    holds = assign_matrix(4, 8, redundancy=2, seed=0, max_fraction=0.5)
    custody = ShardCustody(8, 2, tuple(f"n{i}" for i in range(4)), jnp.asarray(holds))
    down_from = np.full(4, _FAR, np.int32)
    for d in departed:
        down_from[int(d[1:])] = 0
    res = engines.run(replace=dict(node_down_from=down_from),
                      **_lane(workload, engines, load=0.5, custody=holds))
    assert bool(res.live.all()) == custody.tolerates_departures(departed)


# ---------------------- credential admission -----------------------------------
def test_admission_gated_by_credentials_on_device(workload, engines):
    res = engines.run(**_lane(workload, engines, balances=[100.0, 1.0], load=10.0))
    assert res.admitted[0::2].all() and res.done[0::2].all()
    assert not res.admitted[1::2].any() and not res.done[1::2].any()
    np.testing.assert_allclose(res.balances, [97.0, 1.0])


def test_same_step_burst_cannot_overdraw_credentials(workload, engines):
    res = engines.run(**_lane(workload, engines, balances=[2.5, 100.0], load=10.0,
                              holders=np.array([0, 1, 0, 1, 0, 1], np.int32)))
    assert res.done[1::2].all()
    assert int(res.admitted[0::2].sum()) == 2
    assert not res.done[4]
    np.testing.assert_allclose(res.balances, [0.5, 97.0])
    assert res.balances.min() >= 0.0
    assert res.availability == 1.0


def test_admission_is_fifo_by_arrival_not_request_index(pair):
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(3), (3, 3), 0,
                                           MODEL["vocab_size"]))
    eng = Engines(pair, dict(slots=1, max_new=2, steps=10), prompts)
    res = eng.run(n_requests=3, prompt_lens=np.full(3, 3, np.int32), max_new=2,
                  steps=10, n_nodes=2, balances=[100.0], fee=1.0,
                  arrivals=np.array([5, 0, 0], np.int32))
    assert res.done.tolist() == [False, True, True]


def test_engine_validates_lane_shapes(workload, engines):
    prompts, plens = workload
    bad = plens.copy()
    bad[0] = prompts.shape[1] + 3
    for side, kw in ((jserving, {}), (tserving, {"device": "cpu"})):
        eng, params = ((engines.ref, engines.jparams) if side is jserving
                       else (engines.port, engines.tparams))
        lane = side.build_lane(**_lane(workload, engines, prompt_lens=bad, load=1.0), **kw)
        with pytest.raises(ValueError, match="prompt buffer width"):
            eng.run(params, lane)
        good = side.build_lane(**_lane(workload, engines, load=1.0), **kw)
        full = (jnp.full if side is jserving else
                lambda shape, v, dt: torch.full(shape, v, dtype=torch.long))
        with pytest.raises(ValueError, match="max_new"):
            eng.run(params, good._replace(max_new=full((6,), 99, jnp.int32)))
        with pytest.raises(ValueError, match="wedge"):
            eng.run(params, good._replace(max_new=full((6,), 0, jnp.int32)))
        with pytest.raises(ValueError, match="compiled shape"):
            eng.run(params, good, prompts=np.zeros((2, 2), np.int32))


# ---------------------- fees on the ledger -------------------------------------
def test_settle_fees_matches_the_reference_ledger(workload, engines):
    """Holder a funds requests 0/2/4 and holder b 1/3/5; the lanes' spends
    become fee events, and both ledgers pay the pool out to the stakers
    alike and stay conserving."""
    ledgers = []
    for cls in (JLedger, Ledger):
        led = cls()
        led.record_contribution("a", 40.0)
        led.record_contribution("b", 10.0)
        led.stake("a", 8.0)
        led.stake("b", 2.0)
        ledgers.append(led)
    balances = ledgers[1].balance_vector(["a", "b"])
    assert balances == ledgers[0].balance_vector(["a", "b"])
    kw = _lane(workload, engines, balances=balances, fee=1.5, load=10.0)
    res = engines.run(**kw)
    want = jserving.settle_fees(ledgers[0], ["a", "b"], engines.ref.run(
        engines.jparams, jserving.build_lane(**kw)), 1.5)
    got = tserving.settle_fees(ledgers[1], ["a", "b"], res, 1.5)
    assert got == want and got
    assert ledgers[1].balances == ledgers[0].balances
    assert ledgers[1].check_conservation()


# ---------------------- the serving campaign -----------------------------------
def _smoke_prompts(grid):
    return np.array(jax.random.randint(jax.random.PRNGKey(0),
                                        (grid.n_requests, grid.prompt_len), 0,
                                        MODEL["vocab_size"]))


@pytest.fixture(scope="module")
def smoke_sweeps(pair):
    """The serving_smoke sweep on both sides, from the reference's prompts."""
    jmodel, jparams, tmodel, tparams = pair
    grid = tscenarios.get_serving_grid("serving_smoke")
    prompts = _smoke_prompts(grid)
    want = jserving.sweep(jmodel, jparams, jscenarios.get_serving_grid("serving_smoke"),
                          prompts=jnp.asarray(prompts))
    got = tserving.sweep(tmodel, tparams, grid, prompts=prompts, device="cpu")
    return grid, prompts, want, got


def test_serving_sweep_one_program_and_table(smoke_sweeps):
    grid, _, want, res = smoke_sweeps
    assert res.n_programs == 1
    assert res.n_runs == grid.n_points == len(res.cells)
    table = res.availability_table()
    assert table == want.availability_table()
    assert "load=" in table and "S=served" in table
    for c in res.cells:
        if c.churn_rate == 0 and c.coalition_fraction == 0:
            assert c.regime == "served" and c.availability == 1.0
    assert {c.redundancy for c in res.cells} == set(grid.redundancies)
    assert {c.load for c in res.cells} == set(grid.loads)
    assert {c.churn_rate for c in res.cells} == set(grid.churn_rates)
    assert ([dataclasses.astuple(c) for c in res.cells]
            == [dataclasses.astuple(c) for c in want.cells])
    assert res.tokens_total == want.tokens_total


def test_sweep_lane_matches_single_run(pair, smoke_sweeps):
    """Lane 2 of the sweep equals its single run, on both sides."""
    _, _, tmodel, tparams = pair
    grid, prompts, _, res = smoke_sweeps
    cell = res.cells[2]
    cfg = tserving.ServingConfig(slots=grid.slots, max_new=grid.max_new, steps=grid.steps)
    plens = (grid.prompt_len // 2 + np.arange(grid.n_requests)
             % (grid.prompt_len - grid.prompt_len // 2 + 1)).astype(np.int32)
    eng = Engines(pair, dict(slots=grid.slots, max_new=grid.max_new, steps=grid.steps),
                  prompts)
    single = eng.run(
        n_requests=grid.n_requests, prompt_lens=plens, max_new=grid.max_new,
        steps=grid.steps, n_nodes=grid.n_nodes,
        balances=np.full(grid.n_holders, grid.fee * grid.n_requests + 1.0, np.float32),
        fee=grid.fee, load=cell.load,
        custody=assign_matrix(grid.n_nodes, grid.num_shards, cell.redundancy, seed=0,
                              max_fraction=grid.max_fraction),
        churn_rate=cell.churn_rate, coalition_fraction=cell.coalition_fraction,
        defect_step=grid.defect_step, seed=cell.seed)
    assert eng.cfg == cfg
    assert int(single.done.sum()) == cell.completed
    assert single.tokens_served == cell.tokens_served
    assert single.availability == cell.availability


def test_serving_grids_registered():
    names = tscenarios.list_serving_grids()
    assert names == jscenarios.list_serving_grids()
    assert {"serving_frontier", "serving_coalition", "serving_smoke"} <= set(names)
    for name in names:
        assert (vars(tscenarios.get_serving_grid(name))
                == vars(jscenarios.get_serving_grid(name)))
    with pytest.raises(KeyError, match="serving_smoke"):
        tscenarios.get_serving_grid("nope")
