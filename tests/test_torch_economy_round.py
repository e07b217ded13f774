"""The economy lane through the round, the campaign and the sweep (ROADMAP
queue 1, item 10) against the JAX reference: the twins of the reference's
``tests/test_economy.py`` pins, on the 8-parameter quadratic of
``tests/conftest.py`` (the reference's target and batches carried across),
every port round given the reference's draws from its ``_node_key``
schedule.

- the batched round against the reference's ``Swarm``, for a fixed
  CenteredClip coalition and an adaptive coalition against the mean, 6
  rounds: ``n_active``, ``n_byzantine``, ``caught``, the minting (kept)
  nodes and ``alive`` exactly equal after every round; ``coalition_stake``,
  ``agg_norm``, every ``EconState`` float and the final params within
  ``REL`` relative; the conservation gap below 1e-3 and the ledger view
  conserved;
- the port's ``SequentialEconomy`` against the reference's (the same, and
  the chosen scale equal) and against the port's ``Swarm`` on the port's
  own draws;
- both economy scenarios on both engines;
- a sweep cell bit-equal to its single run;
- ``no_off_economy_smoke``: its 16 ``EconomyResult``s against the
  reference's sweep (outcome, admitted counts and coalition size equal;
  payoffs and final losses within ``SWEEP_REL``), both regimes' phase
  tables equal, fixed and adaptive, and the adaptive gap over 8 cells;
- ``build_sweep_lanes(no_off_economy)``: 146 lanes whose economy knobs
  equal the reference's lane by lane;
- two rounds of ``economy_sybil_adaptive`` on the reduced LM: the discrete
  fields exactly equal, round 0's ``agg_norm`` within 1e-2 relative (the
  bound of ``test_torch_swarm.test_model_rounds_match_reference``: the
  LM's gradients differ by ~2e-5 relative).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.configs import get_config as jget_config
from repro.core import derailment as jder
from repro.core import economy as jecon
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro.core.verification import VerificationConfig as JVer
from repro.data import pipeline as jdata
from repro.models.model import build_model as jbuild_model
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.core import derailment as tder
from repro_torch.core import economy as tecon
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.models import convert
from repro_torch.models.model import build_model
from repro_torch.optim import optimizer as topt
from repro_torch.random import RoundDraws

N_PARAMS, ROUNDS, EVAL_ROUND = 8, 6, 10_000
REL = 1e-5            # EconState floats, coalition_stake, agg_norm, params
SWEEP_REL = 1e-4      # the smoke grid's payoffs and final losses
CASES = [(False, "centered_clip"), (True, "mean")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    """The reference's problem and the port's twin on the same target and
    batches: ``(reference, port)``, each ``(loss_fn, params, data_fn,
    eval_fn)``."""
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


def _sgd(mod):
    return mod.SGD(lr=0.1, momentum=0.0)


@functools.lru_cache(maxsize=None)
def _draws(seed, n, d, rnd):
    """The reference's audit draws of round ``rnd`` for ``n`` nodes of a
    run keyed by ``seed`` (the rounds here have no wire draw and no noise
    attacker)."""
    base = jax.random.PRNGKey(seed)
    keys = [[jswarm._node_key(base, p, rnd, i) for i in range(n)]
            for p in (jswarm._AUDIT_SEL, jswarm._AUDIT_NOISE)]
    return RoundDraws(
        audit_sel=torch.from_numpy(np.stack([np.array(jax.random.uniform(k))
                                             for k in keys[0]])),
        audit_noise=torch.from_numpy(np.stack([np.array(jax.random.normal(
            k, (d,), jnp.float32)) for k in keys[1]])))


def _roster(mod):
    """``tests/test_economy.py``'s roster: 4 honest nodes of speeds 0.5-2,
    two inner-product attackers at scale 2."""
    return ([mod.NodeSpec(f"h{i}", speed=s) for i, s in enumerate((1.0, 1.0, 0.5, 2.0))]
            + [mod.NodeSpec(f"adv{i}", byzantine="inner_product", byzantine_scale=2.0)
               for i in range(2)])


def _config(mod, econ_mod, ver, adaptive, aggregator):
    return mod.SwarmConfig(
        aggregator=aggregator,
        verification=ver(p_check=0.5, stake=5.0, tolerance=1e-3, jackpot=5.0),
        economy=econ_mod.EconomyConfig(identity_cost=0.5, budget=12.0, min_stake=5.0,
                                       fee_income=1.0, reward_rate=0.1, op_cost=0.05,
                                       jackpot=5.0, honest_reserve=1.0, adaptive=adaptive),
        seed=0)


def _host_state(econ):
    return {name: (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for name, x in zip(jecon.EconState._fields, econ)}


def _minted(ledger, start):
    return sorted(node for op, node, _ in ledger.history[start:] if op == "mint")


def _assert_econ_close(got, want, what):
    for name, w in want.items():
        g = got[name]
        if name == "alive":
            assert np.array_equal(g, w), (what, name)
        else:
            np.testing.assert_allclose(g, w, rtol=REL, atol=REL * 10, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def reference_runs(problem):
    """Each case's reference ``Swarm`` stepped ``ROUNDS`` rounds (history,
    minting nodes, the EconState after every round, final params) and its
    ``SequentialEconomy`` (history, final EconState and params)."""
    loss_fn, params0, data_fn, _ = problem[0]
    out = {}
    for adaptive, aggregator in CASES:
        cfg = _config(jswarm, jecon, JVer, adaptive, aggregator)
        sw = jswarm.make_swarm(loss_fn, params0, _sgd(jopt), _roster(jswarm), cfg, data_fn)
        rounds = []
        for r in range(ROUNDS):
            start = len(sw.ledger.history)
            rec = sw.step(r)
            rounds.append((rec, _minted(sw.ledger, start), _host_state(sw._econ_state)))
        oracle = jecon.SequentialEconomy(loss_fn, params0, _sgd(jopt), _roster(jswarm), cfg,
                                         data_fn)
        oracle.run(ROUNDS)
        out[adaptive, aggregator] = dict(
            rounds=rounds, params=np.asarray(sw.params["w"]),
            oracle=oracle.history, oracle_econ=_host_state(oracle.econ),
            oracle_params=np.asarray(oracle.params["w"]))
    return out


@pytest.mark.parametrize("adaptive,aggregator", CASES)
def test_batched_round_matches_the_reference(problem, reference_runs, adaptive, aggregator):
    loss_fn, params0, data_fn, _ = problem[1]
    ref = reference_runs[adaptive, aggregator]
    nodes = _roster(tswarm)
    cfg = _config(tswarm, tecon, TVer, adaptive, aggregator)
    sw = tswarm.make_swarm(loss_fn, params0, _sgd(topt), nodes, cfg, data_fn)
    caught_any = False
    for r, (jrec, jminted, jecon_state) in enumerate(ref["rounds"]):
        start = len(sw.ledger.history)
        rec = sw.step(r, draws=_draws(0, len(nodes), N_PARAMS, r))
        for key in ("n_active", "n_byzantine", "caught"):
            assert rec[key] == jrec[key], (r, key)
        assert _minted(sw.ledger, start) == jminted, r
        np.testing.assert_allclose(rec["coalition_stake"], jrec["coalition_stake"],
                                   rtol=REL, atol=1e-7)
        np.testing.assert_allclose(rec["agg_norm"], jrec["agg_norm"], rtol=REL)
        _assert_econ_close(_host_state(sw._econ_state), jecon_state, f"round {r}")
        caught_any |= bool(rec["caught"])
    assert caught_any, "the configuration should exercise a slash"
    np.testing.assert_allclose(sw.params["w"].numpy(), ref["params"], rtol=REL, atol=1e-7)
    assert float(tecon.conservation_gap(sw._econ_state)) < 1e-3
    assert tecon.ledger_view(sw._econ_state, [n.node_id for n in nodes]).check_conservation()
    assert sw.ledger.check_conservation()


@pytest.mark.parametrize("adaptive,aggregator", CASES)
def test_sequential_economy_matches_the_reference_and_the_batched_round(
        problem, reference_runs, adaptive, aggregator):
    loss_fn, params0, data_fn, _ = problem[1]
    ref = reference_runs[adaptive, aggregator]
    nodes = _roster(tswarm)
    cfg = _config(tswarm, tecon, TVer, adaptive, aggregator)
    oracle = tecon.SequentialEconomy(loss_fn, params0, _sgd(topt), nodes, cfg, data_fn)
    for r, jrec in enumerate(ref["oracle"]):
        rec = oracle.step(r, draws=_draws(0, len(nodes), N_PARAMS, r))
        for key in ("n_active", "n_byzantine", "caught", "chosen_scale"):
            assert rec[key] == jrec[key], (r, key)
        for key in ("keep", "admitted"):
            assert np.array_equal(rec[key], jrec[key]), (r, key)
        for key in ("coalition_stake", "agg_norm"):
            np.testing.assert_allclose(rec[key], jrec[key], rtol=REL, atol=1e-7)
    _assert_econ_close(_host_state(oracle.econ), ref["oracle_econ"], "oracle")
    np.testing.assert_allclose(oracle.params["w"].numpy(), ref["oracle_params"], rtol=REL,
                               atol=1e-7)
    # the port's two engines on the port's own draws
    own = tecon.SequentialEconomy(loss_fn, params0, _sgd(topt), nodes, cfg, data_fn)
    own.run(ROUNDS)
    sw = tswarm.make_swarm(loss_fn, params0, _sgd(topt), nodes, cfg, data_fn)
    sw.run(ROUNDS)
    for key in ("n_active", "caught"):
        assert [h[key] for h in sw.history] == [h[key] for h in own.history], key
    for key in ("coalition_stake", "agg_norm"):
        np.testing.assert_allclose([h[key] for h in sw.history], [h[key] for h in own.history],
                                   rtol=REL, atol=1e-7)
    _assert_econ_close(_host_state(sw._econ_state), _host_state(own.econ), "own draws")
    np.testing.assert_allclose(sw.params["w"].numpy(), own.params["w"].numpy(), rtol=REL,
                               atol=1e-7)


def test_sequential_economy_rejects_unsupported_configs(problem):
    loss_fn, params0, data_fn, _ = problem[1]
    with pytest.raises(ValueError, match="economy"):
        tecon.SequentialEconomy(loss_fn, params0, _sgd(topt), _roster(tswarm),
                                tswarm.SwarmConfig(aggregator="mean"), data_fn)
    with pytest.raises(ValueError, match="centralized"):
        tecon.SequentialEconomy(loss_fn, params0, _sgd(topt), _roster(tswarm),
                                tswarm.SwarmConfig(aggregator="mean", topology="ring",
                                                   economy=tecon.EconomyConfig()), data_fn)


def test_round_refuses_what_the_reference_refuses(problem):
    """An economy lane needs a centralized round and a state with its
    economy, as in the reference."""
    loss_fn, params0, data_fn, _ = problem[1]
    nodes = _roster(tswarm)
    cfg = _config(tswarm, tecon, TVer, True, "mean")
    lane = tswarm.lane_for_nodes(nodes, cfg, torch.device("cpu"))
    batches = [data_fn(i, 0) for i in range(len(nodes))]
    central = tswarm.make_round_fn(loss_fn, _sgd(topt), params0, len(nodes), aggregator="mean")
    with pytest.raises(ValueError, match="SwarmState.econ"):
        central(lane, tswarm.init_state(params0, _sgd(topt), len(nodes)), 0, batches)
    dec = tswarm.make_round_fn(loss_fn, _sgd(topt), params0, len(nodes), aggregator="mean",
                               decentralized=True)
    with pytest.raises(ValueError, match="centralized round"):
        dec(lane._replace(mixing=torch.eye(len(nodes))),
            tswarm.init_decentralized_state(params0, _sgd(topt), len(nodes)), 0, batches)


@pytest.mark.parametrize("name", ["economy_rational", "economy_sybil_adaptive"])
def test_economy_scenarios_run_on_both_engines(problem, name):
    """The registered §4 scenarios: the port's batched round agrees with
    the reference's on the admission trajectory (the reference's draws),
    and with the port's ``SequentialEconomy`` (the port's draws)."""
    (jl, jp, jd, _), (tl, tp, td, _) = problem
    jnodes, jcfg = jscen.get_scenario(name).build(6, seed=0)
    jsw = jswarm.make_swarm(jl, jp, _sgd(jopt), jnodes, jcfg, jd)
    jsw.run(4)
    nodes, cfg = tscen.get_scenario(name).build(6, seed=0)
    assert cfg.economy == tecon.EconomyConfig(**vars(jcfg.economy))
    sw = tswarm.make_swarm(tl, tp, _sgd(topt), nodes, cfg, td)
    for r in range(4):
        sw.step(r, draws=_draws(0, 6, N_PARAMS, r))
    assert [h["n_active"] for h in sw.history] == [h["n_active"] for h in jsw.history]
    assert [h["caught"] for h in sw.history] == [h["caught"] for h in jsw.history]
    own = tswarm.make_swarm(tl, tp, _sgd(topt), nodes, cfg, td)
    own.run(4)
    oracle = tecon.SequentialEconomy(tl, tp, _sgd(topt), nodes, cfg, td)
    oracle.run(4)
    assert [h["n_active"] for h in own.history] == [h["n_active"] for h in oracle.history]


def test_sweep_cell_equals_its_single_run(problem):
    """Lane == run on the economy axes: each cell of an economy sweep is
    its single-run ``Swarm`` bit for bit (final loss, admission, coalition
    stake share, honest payoff)."""
    tl, tp, td, te = problem[1]
    audit = TVer(p_check=0.25, stake=10.0, tolerance=1e-3, jackpot=5.0)
    grid = tscen.SweepGrid(
        name="econ-tiny", description="", n_honest=5, attacker_counts=(2,), seeds=(0,),
        scales=(2.0,), rounds=6, regimes=(tscen.Regime("mean+audit", "mean", verification=audit),),
        identity_costs=(0.5,), fees=(1.0,), reward_schedules=((0.1, 5.0),),
        adaptive=(False, True))
    res = tder.sweep(tl, tp, _sgd(topt), td, te, grid)
    assert len(res.results) == len(res.econ_results) == 2
    assert [r.adaptive for r in res.econ_results] == [False, True]
    for dres, eres in zip(res.results, res.econ_results):
        nodes = tder.make_swarm_nodes(5, 2, scale=2.0)
        cfg = tswarm.SwarmConfig(
            aggregator="mean", verification=audit, seed=0,
            economy=tecon.EconomyConfig(
                identity_cost=0.5, budget=grid.econ_budget, min_stake=grid.econ_min_stake,
                fee_income=1.0, reward_rate=0.1, op_cost=grid.econ_op_cost, jackpot=5.0,
                honest_reserve=grid.econ_reserve, adaptive=eres.adaptive))
        sw = tswarm.make_swarm(tl, tp, _sgd(topt), nodes, cfg, td)
        sw.run(6)
        assert dres.final_loss == float(te(sw.params))
        assert eres.n_admitted_last == sw.history[-1]["n_active"]
        assert eres.coalition_stake_share == sw.history[-1]["coalition_stake"]
        assert eres.honest_payoff == float(tecon.payoff(sw._econ_state)[:5].mean())


@pytest.fixture(scope="module")
def smoke_sweeps(problem):
    """``no_off_economy_smoke`` swept by the reference and by the port, each
    port lane given the reference's draws."""
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    jres = jder.sweep(jl, jp, _sgd(jopt), jd, je, jscen.get_sweep_grid("no_off_economy_smoke"))
    grid = tscen.get_sweep_grid("no_off_economy_smoke")
    spec = tder.build_sweep_lanes(grid)
    tres = tder.sweep(tl, tp, _sgd(topt), td, te, grid,
                      draws_fn=lambda j, r: _draws(spec.lanes[j].seed, spec.n_total,
                                                   N_PARAMS, r))
    return jres, tres


def test_smoke_grid_equals_the_reference(smoke_sweeps):
    jres, tres = smoke_sweeps
    assert len(tres.econ_results) == len(jres.econ_results) == tres.grid.n_points == 16
    for t, j in zip(tres.econ_results, jres.econ_results):
        for f in ("regime", "identity_cost", "fee", "reward_rate", "jackpot", "adaptive",
                  "coalition_size", "seed", "outcome", "n_admitted_first", "n_admitted_last"):
            assert getattr(t, f) == getattr(j, f), (f, t, j)
        for f in ("honest_payoff", "coalition_payoff", "coalition_stake_share", "final_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=SWEEP_REL,
                                       atol=1e-6, err_msg=f"{f}: {t}")
    for regime in ("mean+audit", "centered_clip+audit"):
        for adaptive in (False, True):
            assert tres.economy_phase_table(regime, adaptive=adaptive) == \
                jres.economy_phase_table(regime, adaptive=adaptive)
    assert tres.phase_table() == jres.phase_table()
    gap, jgap = tres.economy_adaptive_gap(), jres.economy_adaptive_gap()
    assert gap["cells"] == jgap["cells"] == 8
    for key in ("bad_frac_fixed", "bad_frac_adaptive", "gap"):
        assert gap[key] == jgap[key], key
    for key in ("honest_payoff_drop", "loss_ratio"):
        np.testing.assert_allclose(gap[key], jgap[key], rtol=SWEEP_REL, err_msg=key)
    assert gap["loss_ratio"] > 5.0 and {r.outcome for r in tres.econ_results} >= \
        {"sustained", "death_spiral"}


def test_full_grid_lanes_equal_the_reference():
    tgrid, jgrid = (m.get_sweep_grid("no_off_economy") for m in (tscen, jscen))
    t, j = tder.build_sweep_lanes(tgrid), jder.build_sweep_lanes(jgrid)
    assert len(t.lanes) == len(j.lanes) == jgrid.n_points + 2 == 146
    for tm, jm in zip(t.metas, j.metas):
        assert (tm[0] is None) == (jm[0] is None)
        assert tm[0] is None or tm[0].name == jm[0].name
        assert tm[1:] == jm[1:]
    for tl, jl in zip(t.lanes, j.lanes):
        for name in jecon.EconParams._fields:
            a, b = getattr(tl.econ, name), np.asarray(getattr(jl.econ, name))
            if name == "adaptive":
                assert a == int(b)
            else:
                assert np.array_equal(np.asarray(a), b), name
    stacked = tswarm.stack_lanes(t.lanes[:3])
    assert stacked.econ.adaptive == tuple(lane.econ.adaptive for lane in t.lanes[:3])
    assert stacked.econ.coalition.shape == (3, t.n_total) and stacked.econ.budget.shape == (3,)
    assert stacked.lane(2).econ.adaptive == t.lanes[2].econ.adaptive


SMALL = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256, vocab_size=256)


def test_model_rounds_match_the_reference():
    """``economy_sybil_adaptive`` at 10 nodes on the reduced LM, 2 rounds,
    both sides from the same params and the port given the reference's
    draws: admission, Byzantine counts, catches and the minting nodes
    equal, round 0's ``agg_norm`` within 1e-2."""
    n, rounds = 10, 2
    jcfg = jget_config("protocol-125m").reduced(**SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dcfg = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=2 * n)
    batches = {(r, i): jdata.model_batch(jcfg, dcfg, r, shard=i, num_shards=n)
               for r in range(rounds) for i in range(n)}
    d_total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    jnodes, jscfg = jscen.get_scenario("economy_sybil_adaptive").build(n)
    jsw = jswarm.make_swarm(lambda p, b: jmodel.loss(p, b)[0], jparams,
                            jopt.SGD(lr=0.5, momentum=0.9), jnodes, jscfg,
                            lambda i, r: batches[r, i])
    model = build_model(get_config("protocol-125m").reduced(**SMALL))
    nodes, cfg = tscen.get_scenario("economy_sybil_adaptive").build(n)
    tsw = tswarm.make_swarm(
        lambda p, b: model.loss(p, b)[0],
        convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        topt.SGD(lr=0.5, momentum=0.9), nodes, cfg,
        lambda i, r: {k: torch.from_numpy(np.array(v)).long() for k, v in batches[r, i].items()})
    for r in range(rounds):
        js, ts = len(jsw.ledger.history), len(tsw.ledger.history)
        jrec = jsw.step(r)
        trec = tsw.step(r, draws=_draws(jscfg.seed, n, d_total, r))
        for key in ("n_active", "n_byzantine", "caught"):
            assert trec[key] == jrec[key], (r, key)
        assert _minted(tsw.ledger, ts) == _minted(jsw.ledger, js)
        np.testing.assert_allclose(trec["coalition_stake"], jrec["coalition_stake"], rtol=REL)
        if r == 0:
            np.testing.assert_allclose(trec["agg_norm"], jrec["agg_norm"], rtol=1e-2)
    _assert_econ_close(_host_state(tsw._econ_state), _host_state(jsw._econ_state), "LM")
