"""The custody axis (ROADMAP queue 1, item 7) against the JAX reference.

- ``masked_reconstruct`` bit-equal to the reference's on converted params
  (float32 and bfloat16 leaves, negative values included) at full,
  partial and empty coverage, at 7 and 16 shards;
- a fully redundant custody lane (every node holds every shard) leaves
  the run bit-equal to the plain one: params, slashed, contrib and every
  record, ``coverage`` reading 1.0;
- ``custody_leech``, ``custody_churn_collapse`` and a custody lane over a
  ring (the decentralized round) as campaigns against the reference's on
  the 8-parameter quadratic of ``tests/conftest.py``: the coverage traces
  and the discrete fields exactly equal, ``agg_norm`` and the honest and
  extracted final losses within 1e-5 relative (each node's gradient is
  taken alone here and batched under ``vmap`` there: float32 reduction
  order);
- ``custody_smoke`` on ``examples/common.py``'s tiny quadratic:
  ``extractability_table()`` and ``phase_table()`` equal the reference's
  as strings, each cell's coverages exactly and its losses within 1e-4
  relative (the bound of ``test_torch_derailment.py``'s sweeps); on the
  port's small LM the extractability table equals the reference's
  quadratic one, its letters coming from coverage alone, and a cell whose
  coalition covers every shard extracts exactly the honest loss.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro.core import unextractable as junext
from repro.optim import optimizer as jopt
from repro_torch.core import derailment as tder
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.core import unextractable as tunext
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.launch import problems
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import optimizer as topt

from test_torch_decentralized import one_thread  # noqa: F401
from test_torch_derailment import quadratic  # noqa: F401

N_PARAMS, N_NODES, ROUNDS, SEEDS = 8, 8, 12, (0, 1)
EVAL_ROUND = 10_000


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


def _tree():
    """A nested param tree with float32 and bfloat16 leaves of ragged sizes
    (their sum, 1,517, no multiple of 7 or 16), both signs."""
    rng = np.random.default_rng(3)
    shapes = {"embed": ((37, 8), np.float32),
              "layers": {"attn": {"wq": ((3, 8, 16), ml_dtypes.bfloat16),
                                  "wo": ((16, 19), np.float32)},
                         "ln": ((3, 8), ml_dtypes.bfloat16)},
              "ln_f": ((29,), np.float32)}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        shape, dtype = node
        return (rng.standard_normal(shape) * 3).astype(np.float32).astype(dtype)
    return build(shapes)


@pytest.mark.parametrize("num_shards", [7, 16])
def test_masked_reconstruct_bit_equal_to_the_reference(num_shards):
    tree = _tree()
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, device="cpu")
    rng = np.random.default_rng(num_shards)
    for covered in (np.ones(num_shards, bool), rng.random(num_shards) < 0.5,
                    np.zeros(num_shards, bool)):
        want = jax.jit(junext.masked_reconstruct)(jparams, jnp.asarray(covered))
        got = tunext.masked_reconstruct(tparams, torch.from_numpy(covered))
        want = params_from_jax(jax.tree.map(np.asarray, want), device="cpu")
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(_bits(got[k]), _bits(want[k])), (k, covered)
        if covered.all():                # the identity, bf16 leaves included
            for k in tparams:
                assert np.array_equal(_bits(got[k]), _bits(tparams[k])), k


def test_custody_config_and_tail_mask_as_the_reference():
    for n in (1, 5, 8, 13):
        for frac in (0.0, 0.2, 0.25, 0.5, 0.99, 1.0):
            assert np.array_equal(tunext.coalition_tail_mask(n, frac),
                                  junext.coalition_tail_mask(n, frac)), (n, frac)
    assert tunext.CustodyConfig().__dict__ == junext.CustodyConfig().__dict__


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
            (t_loss, {"w": torch.zeros(N_PARAMS)}, t_data, lambda p: t_loss(p, t_data(0, EVAL_ROUND))))


def test_fully_redundant_custody_lane_leaves_the_run_unchanged(problem):
    loss_fn, params0, data_fn, eval_fn = problem[1]
    nodes = [tswarm.NodeSpec(f"h{i}", speed=1.0 + i % 2, join_round=i % 3) for i in range(6)]
    nodes += [tswarm.NodeSpec("adv0", byzantine="sign_flip", byzantine_scale=5.0,
                              leave_round=7)]
    ver = TVer(p_check=0.5, stake=5.0, tolerance=1e-3, jackpot=5.0)
    full = tunext.CustodyConfig(num_shards=4, redundancy=len(nodes), max_fraction=1.0,
                                coalition_fraction=0.3)
    runs = []
    for custody in (None, full):
        cfg = tswarm.SwarmConfig(aggregator="centered_clip", verification=ver, seed=3,
                                 custody=custody)
        sw = tswarm.Swarm(loss_fn, dict(params0), topt.SGD(lr=0.1, momentum=0.9), nodes,
                          cfg, data_fn)
        sw.run(ROUNDS)
        runs.append(sw)
    plain, cust = runs
    assert cust.custody_matrix.all() and plain.custody_matrix is None
    assert torch.equal(plain.params["w"].view(torch.int32), cust.params["w"].view(torch.int32))
    assert torch.equal(plain.contrib.view(torch.int32), cust.contrib.view(torch.int32))
    assert plain.slashed == cust.slashed == {"adv0"}
    for a, b in zip(plain.history, cust.history):
        assert a == b
        assert b["coverage"] == 1.0


def _campaigns(problem, nodes, jcfg_of, tcfg_of):
    """The reference's and the port's campaign over SEEDS of one roster:
    ``((state, recs, final), (state, recs, final))``, the reference's as
    host arrays."""
    (jl, jp, jd, je), (tl, tp, td, te) = problem
    jnodes = [jswarm.NodeSpec(**n.__dict__) for n in nodes]
    jlanes = jswarm.stack_lanes([jswarm.lane_for_nodes(jnodes, jcfg_of(s)) for s in SEEDS])
    tlanes = tswarm.stack_lanes([tswarm.lane_for_nodes(nodes, tcfg_of(s), torch.device("cpu"))
                                 for s in SEEDS])
    cfg = tcfg_of(0)
    kw = dict(rounds=ROUNDS, aggregator=cfg.aggregator, agg_kwargs=cfg.agg_kwargs)
    jout = jswarm.run_campaign(jl, jp, jopt.SGD(lr=0.1, momentum=0.0), jd, jlanes,
                               eval_fn=je, **kw)
    tout = tswarm.run_campaign(tl, tp, topt.SGD(lr=0.1, momentum=0.0), td, tlanes,
                               eval_fn=te, **kw)
    return jax.tree.map(np.asarray, jout), tout


def _assert_campaigns_equal(jout, tout):
    (jstate, jrecs, jfinal), (tstate, trecs, tfinal) = jout, tout
    for field in ("n_active", "n_byzantine", "caught", "keep", "coverage", "staleness"):
        assert np.array_equal(getattr(trecs, field).numpy(), getattr(jrecs, field)), field
    assert np.array_equal(tstate.slashed.numpy(), jstate.slashed)
    assert np.array_equal(tstate.contrib.numpy(), jstate.contrib)
    np.testing.assert_allclose(trecs.agg_norm.numpy(), jrecs.agg_norm, rtol=1e-5)
    assert tfinal.shape == jfinal.shape == (len(SEEDS), 2)
    np.testing.assert_allclose(tfinal.numpy(), jfinal, rtol=1e-5)


@pytest.mark.parametrize("scenario", ["custody_leech", "custody_churn_collapse"])
def test_custody_scenario_campaign_matches_the_reference(problem, scenario):
    tscn, jscn = tscen.get_scenario(scenario), jscen.get_scenario(scenario)
    nodes = tscn.make_nodes(N_NODES)
    assert [n.node_id for n in nodes] == [n.node_id for n in jscn.make_nodes(N_NODES)]
    jout, tout = _campaigns(problem, nodes, jscn.make_config, tscn.make_config)
    _assert_campaigns_equal(jout, tout)
    cov = tout[1].coverage.numpy()
    if scenario == "custody_churn_collapse":
        assert cov[:, 0].min() == 1.0 and cov[:, -1].max() < 1.0, "coverage should collapse"
    else:
        assert (cov == 1.0).all()
        honest, extracted = tout[2][:, 0], tout[2][:, 1]
        assert (extracted > honest).all(), "a partial coalition should extract garbage"


def test_custody_over_a_ring_matches_the_reference(problem):
    """Custody x topology: a churning roster on a ring, the decentralized
    round, the reconstruct attack on the consensus replica."""
    nodes = [tswarm.NodeSpec(f"core{i}") for i in range(4)] + [
        tswarm.NodeSpec(f"leaver{i}", leave_round=3 + 2 * i) for i in range(4)]

    def cfg_of(mod, unext):
        return lambda seed: mod.SwarmConfig(
            aggregator="mean", topology="ring", seed=seed,
            custody=unext.CustodyConfig(num_shards=8, redundancy=1, max_fraction=0.25,
                                        coalition_fraction=0.5))
    jout, tout = _campaigns(problem, nodes, cfg_of(jswarm, junext), cfg_of(tswarm, tunext))
    _assert_campaigns_equal(jout, tout)
    assert tout[1].coverage.numpy()[:, -1].max() < 1.0


def _custody_smoke_sweeps(quadratic):  # noqa: F811
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = quadratic
    return (jder.sweep(jl, jp, jo, jd, je, jscen.get_sweep_grid("custody_smoke")),
            tder.sweep(tl, tp, to, td, te, tscen.get_sweep_grid("custody_smoke")))


def test_custody_smoke_tables_equal_the_reference(quadratic):  # noqa: F811
    jres, tres = _custody_smoke_sweeps(quadratic)
    assert tres.extractability_table() == jres.extractability_table()
    assert tres.phase_table() == jres.phase_table()
    assert "D" in tres.extractability_table() and "X" in tres.extractability_table()
    assert len(tres.results) == len(jres.results) == jres.grid.n_points
    for j, t in zip(jres.results, tres.results):
        for field in ("regime", "n_attackers", "seed", "redundancy", "coalition_fraction",
                      "coalition_coverage", "final_coverage", "extractability", "derailed"):
            assert getattr(t, field) == getattr(j, field), (field, j)
        for field in ("final_loss", "baseline_loss", "extracted_loss"):
            np.testing.assert_allclose(getattr(t, field), getattr(j, field), rtol=1e-4,
                                       err_msg=f"{field} {j}")
    assert tder.no_off_report(tres.results) == jder.no_off_report(jres.results)
    # a reference custody grid's lanes, field for field
    tspec = tder.build_sweep_lanes(tscen.get_sweep_grid("custody_frontier"))
    jspec = jder.build_sweep_lanes(jscen.get_sweep_grid("custody_frontier"))
    assert tspec.has_custody and jspec.has_custody
    assert [m[1:] for m in tspec.metas] == [m[1:] for m in jspec.metas]
    for tlane, jlane in zip(tspec.lanes, jspec.lanes):
        for field in ("custody", "coalition", "leaves", "joins", "codes"):
            assert np.array_equal(getattr(tlane, field), getattr(jlane, field)), field
    for red, frac, count in ((1, 0.2, 0), (2, 0.6, 0), (3, 1.0, 0)):
        assert tspec.coalition_coverage(red, frac, count) == \
            jspec.coalition_coverage(red, frac, count)


def test_custody_smoke_on_the_small_lm_letters_from_coverage(quadratic):  # noqa: F811
    """The small LM's extractability table is the quadratic's: its letters
    and coverages read the custody matrix and the churn, not the losses."""
    (jl, jp, jd, je, jo) = quadratic[0]
    jtable = jder.sweep(jl, jp, jo, jd, je,
                        jscen.get_sweep_grid("custody_smoke")).extractability_table()
    loss_fn, params, data_fn, eval_fn, opt = problems.small_lm_problem("cpu")
    res = tder.sweep(loss_fn, params, opt, data_fn, eval_fn,
                     tscen.get_sweep_grid("custody_smoke"))
    assert res.extractability_table() == jtable
    for r in res.results:
        assert np.isfinite(r.final_loss) and np.isfinite(r.extracted_loss)
        if r.coalition_coverage == 1.0:
            assert r.extracted_loss == r.final_loss, r
        else:
            assert r.extracted_loss > r.final_loss, r
