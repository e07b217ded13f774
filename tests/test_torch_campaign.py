"""The campaign engine (ROADMAP queue 1, item 3) against the JAX reference.

On the 8-parameter quadratic of ``tests/conftest.py`` (the reference's
target and batches carried across), over the reference test's five
scenarios and seeds 0-2, 15 rounds:

- lane k of the port's ``run_campaign`` is bit-equal to the port's
  single-run ``Swarm`` of the same scenario and seed (params, the device
  counters, the history, the ledger) and, every record field, to the
  single-run ``make_scan_program``, with the port's own draws;
- the port's ``run_campaign`` against the reference's, each lane and round
  given the reference's draws: ``n_active``, ``caught``, ``keep``,
  ``slashed`` and ``contrib`` exactly equal, ``agg_norm`` and the final
  losses within 1e-5 relative, ``ledger_from_run`` equal (balances and
  history).

Then multi-aggregator routing (each lane bit-equal to its own aggregator's
campaign; static kwargs win over lane kwargs; the reference's ValueError),
``cosine_schedule`` against the reference's, and the items that raise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro.optim import optimizer as jopt
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.kernels.masked_agg import ops as magg
from repro_torch.optim import optimizer as topt
from repro_torch.random import RoundDraws

ROUNDS = 15
SEEDS = (0, 1, 2)
N_PARAMS, N_NODES = 8, 8
SCENARIOS = ["sign_flip_minority", "audit_heavy", "compressed_wire",
             "high_churn_elastic", "heterogeneous_speed"]
EVAL_ROUND = 10_000


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

    def t_eval(p):
        return t_loss(p, t_data(0, EVAL_ROUND))

    return ((loss_fn, params0, data_fn, jeval),
            (t_loss, {"w": torch.zeros(N_PARAMS)}, t_data, t_eval))


def _sgd(mod):
    return mod.SGD(lr=0.1, momentum=0.0)


def _reference_draws(cfg, seed, d_total):
    """``draws(rnd) -> RoundDraws``: the reference's draws of run ``seed``
    from its ``_node_key`` schedule (``test_torch_swarm._jax_draws``'s
    recipe, with the lane's seed)."""
    base = jax.random.PRNGKey(seed)
    nodes = jnp.arange(N_NODES)

    def keys(purpose, rnd):
        return jax.vmap(lambda i: jswarm._node_key(base, purpose, rnd, i))(nodes)

    wire_shape = None
    if cfg.compression == "qsgd":
        b = cfg.compression_kwargs["bucket_size"]
        wire_shape = (-(-d_total // b), b)

    @jax.jit
    def draw(rnd):
        out = {}
        if wire_shape is not None:
            out["wire"] = jax.vmap(lambda k: jax.random.uniform(k, wire_shape))(
                keys(jswarm._WIRE, rnd))
        if cfg.verification is not None:
            out["audit_sel"] = jax.vmap(jax.random.uniform)(keys(jswarm._AUDIT_SEL, rnd))
            out["audit_noise"] = jax.vmap(
                lambda k: jax.random.normal(k, (d_total,), jnp.float32))(
                keys(jswarm._AUDIT_NOISE, rnd))
        return out

    return lambda rnd: RoundDraws(**{k: torch.from_numpy(np.array(v))
                                     for k, v in draw(rnd).items()})


@pytest.fixture(scope="module")
def reference_campaigns(problem):
    """Each scenario's reference campaign over SEEDS, computed once:
    ``(state, recs, final, node_ids, cfg)`` as host arrays."""
    loss_fn, params0, data_fn, jeval = problem[0]
    out = {}
    for name in SCENARIOS:
        state, recs, final, node_ids, cfg = jscen.scenario_campaign(
            name, loss_fn, params0, _sgd(jopt), data_fn, n_nodes=N_NODES,
            seeds=SEEDS, rounds=ROUNDS, eval_fn=jeval)
        out[name] = (jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, recs),
                     np.asarray(final), node_ids, cfg)
    return out


def _scan_run(problem, nodes, cfg, rounds):
    """The single-run ``make_scan_program`` of a roster and config, from a
    fresh ``init_state``: ``(state, records, final loss)``."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    round_fn = tswarm.make_round_fn(
        loss_fn, _sgd(topt), params0, len(nodes), aggregator=cfg.aggregator,
        agg_kwargs=cfg.agg_kwargs, compression_kind=cfg.compression,
        compression_kwargs=cfg.compression_kwargs,
        verify=cfg.verification is not None)
    run = tswarm.make_scan_program(
        round_fn, lambda rnd: [data_fn(i, rnd) for i in range(len(nodes))], rounds, eval_fn)
    return run(tswarm.lane_for_nodes(nodes, cfg, torch.device("cpu")),
               *tswarm.init_state(params0, _sgd(topt), len(nodes)))


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a is None or b is None:           # a record field of an axis not in the run
        return a is b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_campaign_lane_bit_equal_to_single_run_swarm(problem, scenario):
    loss_fn, params0, data_fn, eval_fn = problem[1]
    state, recs, final, node_ids, _ = tscen.scenario_campaign(
        scenario, loss_fn, params0, _sgd(topt), data_fn, n_nodes=N_NODES,
        seeds=SEEDS, rounds=ROUNDS, eval_fn=eval_fn)
    assert recs.agg_norm.shape == (len(SEEDS), ROUNDS)
    assert recs.caught.shape == (len(SEEDS), ROUNDS, N_NODES)
    assert final.shape == (len(SEEDS),)
    for k, seed in enumerate(SEEDS):
        sw = tscen.get_scenario(scenario).build_swarm(
            loss_fn, {"w": torch.zeros(N_PARAMS)}, _sgd(topt), data_fn,
            n_nodes=N_NODES, seed=seed)
        for r in range(ROUNDS):
            sw.step(r)
        lane_recs = tswarm.lane_slice(recs, k)
        _, scan_recs, _ = _scan_run(problem, sw.nodes, sw.cfg, ROUNDS)
        for field in tswarm.RoundRecord._fields:
            assert _bits(getattr(lane_recs, field), getattr(scan_recs, field)), field
        assert _bits(state.params["w"][k], sw.params["w"])
        assert _bits(state.contrib[k], sw.contrib)
        assert state.slashed[k].tolist() == [n.node_id in sw.slashed for n in sw.nodes]
        assert _bits(final[k], torch.tensor(float(eval_fn(sw.params))))
        assert tswarm.history_from_records(lane_recs, node_ids) == sw.history
        led = tswarm.ledger_from_run(tswarm.lane_slice(state, k), node_ids,
                                     verification=sw.cfg.verification)
        assert led.balances == sw.ledger.balances
        assert led.burned_stake == sw.ledger.burned_stake


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_campaign_matches_reference_campaign(problem, reference_campaigns, scenario):
    loss_fn, params0, data_fn, eval_fn = problem[1]
    jstate, jrecs, jfinal, node_ids, jcfg = reference_campaigns[scenario]
    draws = [_reference_draws(jcfg, s, N_PARAMS) for s in SEEDS]
    scn = tscen.get_scenario(scenario)
    nodes, tcfg = scn.build(N_NODES, SEEDS[0])
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, scn.make_config(s),
                                                      torch.device("cpu"))
                                for s in SEEDS])
    state, recs, final = tswarm.run_campaign(
        loss_fn, params0, _sgd(topt), data_fn, lanes, rounds=ROUNDS,
        aggregator=tcfg.aggregator, agg_kwargs=tcfg.agg_kwargs,
        compression_kind=tcfg.compression, compression_kwargs=tcfg.compression_kwargs,
        verify=tcfg.verification is not None, eval_fn=eval_fn,
        draws_fn=lambda k, rnd: draws[k](rnd))
    assert [n.node_id for n in nodes] == node_ids
    for field in ("n_active", "n_byzantine", "caught", "keep"):
        np.testing.assert_array_equal(getattr(recs, field).numpy(),
                                      getattr(jrecs, field), err_msg=field)
    np.testing.assert_array_equal(state.slashed.numpy(), jstate.slashed)
    np.testing.assert_array_equal(state.contrib.numpy(), jstate.contrib)
    np.testing.assert_allclose(recs.agg_norm.numpy(), jrecs.agg_norm, rtol=1e-5)
    np.testing.assert_allclose(final.numpy(), jfinal, rtol=1e-5)
    if scenario == "audit_heavy":
        assert jstate.slashed.any(), "the configuration should exercise a slash"
    for k in range(len(SEEDS)):
        led = tswarm.ledger_from_run(tswarm.lane_slice(state, k), node_ids,
                                     verification=tcfg.verification)
        jled = jswarm.ledger_from_run(jax.tree.map(lambda x: x[k], jstate), node_ids,
                                      verification=jcfg.verification)
        assert led.balances == jled.balances
        assert led.history == jled.history
        assert led.burned_stake == jled.burned_stake


# ------------------------------ routing ----------------------------------------
ROUTED = [("mean", {}), ("centered_clip", {}), ("krum", {})]


def _routing_lanes(nodes, agg_ids, fs, seed=0):
    return tswarm.stack_lanes([
        tswarm.lane_for_nodes(nodes, tswarm.SwarmConfig(seed=seed), torch.device("cpu"),
                              agg_kwargs={"f": f})._replace(agg_id=aid)
        for aid, f in zip(agg_ids, fs)])


def _single(problem, nodes, rounds, name, static_kw):
    loss_fn, params0, data_fn, eval_fn = problem[1]
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, tswarm.SwarmConfig(seed=0),
                                                      torch.device("cpu"))])
    return tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes,
                               rounds=rounds, aggregator=name, agg_kwargs=static_kw,
                               eval_fn=eval_fn)


def _assert_lane_equal(out, k, single):
    (state, recs, final), (s1, r1, f1) = out, single
    for field in tswarm.RoundRecord._fields:
        assert _bits(getattr(tswarm.lane_slice(recs, k), field),
                     getattr(tswarm.lane_slice(r1, 0), field)), field
    assert _bits(state.params["w"][k], s1.params["w"][0])
    assert _bits(final[k], f1[0])


def test_routed_round_lanes_equal_their_own_aggregator(problem):
    """One campaign over mean, CenteredClip and krum with a per-lane f:
    each lane is bit-equal to its aggregator's own single-aggregator run,
    and the routed aggregators take only the lane kwargs they accept (f
    reaches krum alone)."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    nodes = [tswarm.NodeSpec(f"h{i}") for i in range(6)] + [
        tswarm.NodeSpec("adv0", byzantine="sign_flip", byzantine_scale=20.0),
        tswarm.NodeSpec("adv1", byzantine="inner_product", byzantine_scale=5.0)]
    agg_ids, fs = (0, 1, 2, 2), (1, 1, 2, 3)
    out = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn,
                              _routing_lanes(nodes, agg_ids, fs), rounds=10,
                              aggregator=ROUTED, eval_fn=eval_fn)
    assert out[2].shape == (4,)
    for k, (aid, f) in enumerate(zip(agg_ids, fs)):
        name = ROUTED[aid][0]
        _assert_lane_equal(out, k, _single(problem, nodes, 10, name,
                                           {"f": f} if name == "krum" else {}))
    assert not torch.equal(out[1].agg_norm[2], out[1].agg_norm[3])   # f differs


def test_routed_static_kwargs_beat_lane_kwargs(problem):
    """A regime pinned to a static krum f keeps it against the lane's f,
    which the auto-f regime takes."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    nodes = [tswarm.NodeSpec(f"h{i}") for i in range(5)] + [
        tswarm.NodeSpec("adv", byzantine="sign_flip", byzantine_scale=30.0)]
    out = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn,
                              _routing_lanes(nodes, (0, 1), (3, 3)), rounds=8,
                              aggregator=[("krum", {"f": 1}), ("krum", {})],
                              eval_fn=eval_fn)
    for k, f in ((0, 1), (1, 3)):
        _assert_lane_equal(out, k, _single(problem, nodes, 8, "krum", {"f": f}))


def test_routed_round_rejects_agg_kwargs_beside_pairs(problem):
    loss_fn, params0, data_fn, _ = problem[1]
    lanes = _routing_lanes([tswarm.NodeSpec("h0"), tswarm.NodeSpec("h1")], (0,), (1,))
    with pytest.raises(ValueError, match="static kwargs"):
        tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes, rounds=2,
                            aggregator=[("mean", {}), ("krum", {})], agg_kwargs={"f": 1})


def test_fused_choice_covers_the_whole_set():
    """On the CPU the fused path is chosen for the whole set, only when
    every aggregator of it has a fused twin (the reference's
    ``fusable_aggs``) and the stack is large enough.  On the card each
    aggregator with a twin takes its kernels whatever the set holds."""
    params = {"w": torch.zeros(4)}
    fn = tswarm.make_round_fn(None, _sgd(topt), params, 2, aggregator=ROUTED, fused=True)
    assert fn.fused and fn.fused_by_agg == (True, True, True)
    mixed = [("mean", {}), ("centered_clip", {}), ("median", {})]
    with pytest.raises(ValueError, match="fused=True unsupported"):
        tswarm.make_round_fn(None, _sgd(topt), params, 2, fused=True, aggregator=mixed)
    fn = tswarm.make_round_fn(None, _sgd(topt), params, 2, aggregator=mixed)
    assert not fn.fused and fn.fused_by_agg == (False, False, False)
    names = [name for name, _ in mixed]
    big = magg.FUSED_MIN_BYTES
    choose = functools.partial(tswarm.fused_choice, names, None)
    assert choose(on_card=False, stack_bytes=big) == (False, False, False)
    assert tswarm.fused_choice(names[:2], None, on_card=False, stack_bytes=big) == \
        (True, True)
    assert choose(on_card=True, stack_bytes=8) == (True, True, False)
    assert choose(on_card=True, stack_bytes=8, fused=False) == (False, False, False)
    assert tswarm.fused_choice(names, "qsgd", 200, on_card=True, stack_bytes=8) == \
        (False, False, False)
    assert tswarm.fused_choice(names, "topk", on_card=True, stack_bytes=8) == \
        (False, False, False)


def test_scan_program_equals_swarm(problem):
    """``make_scan_program``'s run from a fresh ``init_state`` is the
    single-run Swarm, and leaves the caller's params untouched."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    nodes, cfg = tscen.get_scenario("sign_flip_minority").build(N_NODES, 1)
    round_fn = tswarm.make_round_fn(loss_fn, _sgd(topt), params0, N_NODES,
                                    aggregator=cfg.aggregator)
    run = tswarm.make_scan_program(
        round_fn, lambda rnd: [data_fn(i, rnd) for i in range(N_NODES)], 6, eval_fn)
    st0 = tswarm.init_state(params0, _sgd(topt), N_NODES)
    lane = tswarm.lane_for_nodes(nodes, cfg, torch.device("cpu"))
    state, recs, final = run(lane, *st0)
    sw = tswarm.Swarm(loss_fn, {"w": torch.zeros(N_PARAMS)}, _sgd(topt), nodes, cfg, data_fn)
    for r in range(6):
        sw.step(r)
    assert _bits(state.params["w"], sw.params["w"])
    assert tswarm.history_from_records(recs, [n.node_id for n in nodes]) == sw.history
    assert _bits(state.contrib, sw.contrib)
    assert _bits(final, torch.tensor(float(eval_fn(sw.params))))
    assert not params0["w"].any()


def test_campaign_without_params_keeps_the_rest(problem):
    """``keep_params=False`` (what a sweep asks for) drops each lane's
    params and optimizer state and changes nothing else."""
    loss_fn, params0, data_fn, eval_fn = problem[1]
    scn = tscen.get_scenario("audit_heavy")
    nodes, cfg = scn.build(N_NODES, 0)
    lanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, scn.make_config(s),
                                                      torch.device("cpu")) for s in SEEDS])
    kw = dict(rounds=6, aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs,
              verify=True, eval_fn=eval_fn)
    full = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes, **kw)
    lean = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes,
                               keep_params=False, **kw)
    assert lean[0].params is None and lean[0].opt_state is None
    for a, b in ((full[0].slashed, lean[0].slashed), (full[0].contrib, lean[0].contrib),
                 (full[2], lean[2])):
        assert _bits(a, b)
    for field in tswarm.RoundRecord._fields:
        assert _bits(getattr(full[1], field), getattr(lean[1], field)), field


@pytest.mark.parametrize("peak,warmup,total,floor", [(3e-4, 100, 1000, 0.1),
                                                     (5e-3, 7, 33, 0.05),
                                                     (0.1, 1, 2, 0.0)])
def test_cosine_schedule_matches_reference(peak, warmup, total, floor):
    ref = jopt.cosine_schedule(peak, warmup, total, floor)
    port = topt.cosine_schedule(peak, warmup, total, floor)
    for step in (0, warmup - 1, warmup, (warmup + total) // 2, total + 5):
        want = np.float32(ref(jnp.asarray(step, jnp.int32)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.numpy() == want, step


def test_unported_campaign_options_raise(problem):
    loss_fn, params0, data_fn, _ = problem[1]
    nodes = [tswarm.NodeSpec("h0"), tswarm.NodeSpec("h1")]
    single = tswarm.lane_for_nodes(nodes, tswarm.SwarmConfig(), torch.device("cpu"))
    lanes = tswarm.stack_lanes([single])
    kw = dict(rounds=2, aggregator="mean")
    with pytest.raises(NotImplementedError, match="item 13"):
        tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes, plan=object(), **kw)
    with pytest.raises(ValueError, match="agree on mixing"):
        tswarm.stack_lanes([single, single._replace(mixing=torch.eye(2))])
    # the custody (item 7), async (item 9) and economy (item 10) lanes stack
    # and run, the economy's final state returned a lane
    later = {"custody": torch.ones(2, 3, dtype=torch.bool),
             "coalition": torch.tensor([False, True]),
             "delays": torch.tensor([0, 2], dtype=torch.int32)}
    for field, value in later.items():
        with pytest.raises(ValueError, match=f"agree on {field}"):
            tswarm.stack_lanes([single, single._replace(**{field: value})])
    stacked = tswarm.stack_lanes([single._replace(**later)] * 2)
    assert stacked.lane(1).delays.tolist() == [0, 2]
    assert stacked.custody.shape == (2, 2, 3) and stacked.coalition.shape == (2, 2)
    _, recs, final = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, stacked,
                                         eval_fn=problem[1][3], **kw)
    assert final.shape == (2, 2) and (recs.coverage == 1.0).all()
    from repro_torch.core import economy as tecon
    econ_lanes = [single._replace(econ=tecon.EconomyConfig(budget=b, adaptive=a).params_for(
        [False, True])) for b, a in ((5.5, False), (50.0, True))]
    with pytest.raises(ValueError, match="agree on econ"):
        tswarm.stack_lanes([single, econ_lanes[0]])
    stacked = tswarm.stack_lanes(econ_lanes)
    assert stacked.econ.adaptive == (0, 1) and stacked.econ.coalition.shape == (2, 2)
    state, recs, _ = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, stacked, **kw)
    assert recs.coalition_stake.shape == (2, 2) and state.econ.stake.shape == (2, 2)
    for k, lane in enumerate(econ_lanes):
        st = tswarm.init_state(params0, _sgd(topt), 2, econ=tecon.init_econ_state(lane.econ, 2))
        for r in range(2):
            st, _ = tswarm.make_round_fn(loss_fn, _sgd(topt), params0, 2, aggregator="mean")(
                lane, st, r, [data_fn(i, r) for i in range(2)])
        for field, x in zip(tecon.EconState._fields, st.econ):
            assert _bits(getattr(state.econ, field)[k], x), (k, field)
    assert state.econ.alive.tolist() == [[True, False], [True, True]]  # 5.5 buys no identity
    state = tswarm.init_state(params0, _sgd(topt), 2, staleness_bound=2)
    assert len(state.ring) == 3 and all(slot is params0 for slot in state.ring)
    with pytest.raises(ValueError, match="stacked campaign"):
        tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, single, **kw)
    # the reference's XLA option is accepted and changes nothing
    a = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes, **kw)
    b = tswarm.run_campaign(loss_fn, params0, _sgd(topt), data_fn, lanes,
                            fast_compile=True, **kw)
    assert _bits(a[1].agg_norm, b[1].agg_norm)
