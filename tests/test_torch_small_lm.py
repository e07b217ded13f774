"""The small LM of the phase-diagram launchers (ROADMAP queue 1, step 4b)
against the reference's ``examples/common.py:small_lm_problem``, and the
``no_off_smoke`` phase table on it.

- ``launch/problems.py:small_lm_problem``: the config equals the
  reference's field for field, the weights' layout (names, shapes, dtypes)
  too, its data are the reference pipeline's shapes and sharding (32
  shards of a global batch of 32, node i on shard i mod 32), SGD at lr 0.5
  with momentum 0.9; on the reference's weights and batch the loss is
  within 1e-6 relative of the reference's.
- ``no_off_smoke`` (mean and CenteredClip against 2 and 6 inner-product
  attackers at scale 50 beside 6 honest nodes, the honest baseline: 5
  lanes of N = 12, the grid's 8 rounds) with each round of the port run
  from the reference's state (the reference's jitted round over the
  sweep's own lanes and aggregator set, its params, momentum, slashed and
  contrib carried across): every round's ``n_active``, ``caught`` and
  ``keep`` equal, ``agg_norm`` within 1e-3 relative (measured 2.9e-4 on
  the attacked lanes, 7.2e-5 on the CenteredClip lane at 2 attackers and
  the baseline) while the model has not blown up (an aggregate norm up to
  ``BLOWN_UP``; past it, where the attacked lanes' losses run into the
  thousands, the two sides part by up to 0.73 in one round and only
  finiteness is held); the final losses within 1e-5 relative (measured 4.3e-7),
  non-finite on both sides where either is; the phase tables built from
  the two sets of final losses equal as strings, each cell's verdict
  equal.
- the same sweep run free on both sides (``derailment.sweep``, 8 rounds):
  the cells' discrete fields (counts, slashed, seeds) and ``init_loss``
  equal, every lane's ``n_active`` and ``keep`` equal each round, round 0's
  ``agg_norm`` within 1e-4, the honest baseline's final loss within 2e-2
  relative (measured 4.7e-3).  The free tables are not held: the reduced
  LM's gradients differ from the reference's by ~2e-5 relative, and lr
  0.5 with momentum 0.9 multiplies that ~30x a round, so by round 3 the
  attacked lanes are apart; the mean lanes' blow-up ends in the
  reference at loss log 256 with zero gradients (not derailed by the
  half-progress rule) and in the port at NaN (derailed).  ROADMAP queue 3
  records it; the rounds from the reference's state show the port's round
  is the reference's, and ``test_torch_small_lm_blow_up.py`` shows that
  the ending is the trajectory's: each side's round from the other's
  state ends as the other does.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro_torch.core import derailment as tder
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm
from repro_torch.launch import problems
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.optimizer import SGDState

from test_torch_decentralized import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
#: an aggregate norm past which the model has blown up (its loss in the
#: thousands): float32 gradients there are ill-conditioned, and one round
#: from the same state parts the two sides by up to 0.73 relative
BLOWN_UP = 1e3


def _examples_common():
    spec = importlib.util.spec_from_file_location("examples_common_lm",
                                                  ROOT / "examples" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_lm():
    """``examples/common.py``'s small LM and the port's on the reference's
    weights and batches: ``(reference, port)``, each ``(loss_fn, params,
    data_fn, eval_fn, optimizer)``."""
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, model_batch
    ref = _examples_common().small_lm_problem()
    cfg = get_config("protocol-125m").reduced(num_layers=2, d_model=64, num_heads=4,
                                              head_dim=16, d_ff=256, vocab_size=256)
    dcfg = DataConfig(vocab_size=256, seq_len=32, global_batch=32)
    cache = {}

    def data_fn(i, rnd):
        if (i, rnd) not in cache:
            cache[i, rnd] = {k: torch.from_numpy(np.array(v)).long()
                             for k, v in ref[2](i, rnd).items()}
        return cache[i, rnd]

    evb = {k: torch.from_numpy(np.array(v)).long()
           for k, v in model_batch(cfg, dcfg, problems.LM_EVAL_STEP).items()}
    params = params_from_jax(jax.tree.map(np.asarray, ref[1]), "cpu")
    return ref, problems.lm_problem(problems.small_lm_config(), params, data_fn, evb)


def test_small_lm_problem_is_the_reference_problem(small_lm):
    from repro.configs import get_config
    from repro.models.model import build_model
    ref, port = small_lm
    jcfg = get_config("protocol-125m").reduced(num_layers=2, d_model=64, num_heads=4,
                                               head_dim=16, d_ff=256, vocab_size=256)
    tcfg = problems.small_lm_config()
    for field in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "max_seq_len", "dtype", "xent_chunk",
                  "norm_eps", "rope_theta"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    own = problems.small_lm_problem("cpu")
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(ref[1])[0])
    assert len(ref_leaves) == len(own[1])
    for (name, t), a in zip(sorted(own[1].items()), jax.tree.leaves(ref[1])):
        assert tuple(t.shape) == a.shape and str(t.dtype).endswith(str(a.dtype)), name
    assert sum(t.numel() for t in own[1].values()) == int(build_model(jcfg).cfg.param_count())
    b0, b32 = own[2](0, 3), own[2](32, 3)
    assert b0["tokens"].shape == (1, 32) and b0["labels"].shape == (1, 32)
    assert torch.equal(b0["tokens"], b32["tokens"])       # node 32 reads shard 0
    assert not torch.equal(own[2](1, 3)["tokens"], b0["tokens"])
    assert own[4].lr == 0.5 and own[4].momentum == 0.9
    assert all(torch.equal(own[1][k], problems.small_lm_problem("cpu")[1][k]) for k in own[1])
    jb = ref[2](5, 2)
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    np.testing.assert_allclose(float(port[0](port[1], tb)), float(ref[0](ref[1], jb)), rtol=1e-6)
    np.testing.assert_allclose(float(port[3](port[1])), float(ref[3](ref[1])), rtol=1e-6)


def _to_port(jstate) -> tswarm.SwarmState:
    host = jax.tree.map(np.asarray, jstate)
    return tswarm.SwarmState(
        params=params_from_jax(host.params, "cpu"),
        opt_state=SGDState(step=torch.from_numpy(np.array(host.opt_state.step)),
                           momentum=params_from_jax(host.opt_state.momentum, "cpu")),
        slashed=torch.from_numpy(host.slashed.copy()),
        contrib=torch.from_numpy(host.contrib.copy()))


def _results(grid, spec, finals, slashed, init_loss, module):
    """The sweep's DerailmentResults from per-lane final losses."""
    baselines = {(m[1], m[7]): finals[j] for j, m in enumerate(spec.metas) if m[0] is None}
    out = []
    for j, (reg, topo, _, _, _, count, _, seed, *_) in enumerate(spec.metas):
        if reg is None:
            continue
        out.append(module.DerailmentResult(
            attacker_fraction=count / (spec.n_honest + count), aggregator=reg.aggregator,
            verified=reg.verification is not None, final_loss=finals[j],
            baseline_loss=baselines[topo, seed],
            attackers_slashed=int(slashed[j][spec.n_honest:spec.n_honest + count].sum()),
            n_attackers=count, init_loss=init_loss, seed=seed, regime=reg.name,
            topology=topo))
    return module.SweepResult(grid=grid, results=out, n_programs=1, n_runs=len(spec.lanes),
                              wall_s=1.0)


def test_no_off_smoke_from_the_reference_state_each_round(small_lm):
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = small_lm
    grid_j, grid_t = jscen.get_sweep_grid("no_off_smoke"), tscen.get_sweep_grid("no_off_smoke")
    jspec, tspec = jder.build_sweep_lanes(grid_j), tder.build_sweep_lanes(grid_t)
    n = jspec.n_total
    jround = jax.jit(jswarm.make_round_fn(jl, jo, jp, n, aggregator=jspec.aggregator,
                                          agg_kwargs=jspec.agg_kwargs, verify=jspec.verify))
    tround = tswarm.make_round_fn(tl, to, tp, n, aggregator=tspec.aggregator,
                                  agg_kwargs=tspec.agg_kwargs, verify=tspec.verify)
    tlanes = tswarm.stack_lanes(tspec.lanes)
    jeval = jax.jit(je)
    jfinal, tfinal, jslashed, tslashed = [], [], [], []
    for j, jlane in enumerate(jspec.lanes):
        jlane = jax.tree.map(jnp.asarray, jlane)
        jstate = jswarm.init_state(jp, jo, n)
        for r in range(grid_j.rounds):
            jb = jax.vmap(lambda i: jd(i, r))(jnp.arange(n))
            tb = [td(i, r) for i in range(n)]
            tstate = _to_port(jstate)
            jstate, jrec = jround(jlane, jstate, r, jb)
            tstate, trec = tround(tlanes.lane(j), tstate, r, tb)
            for field in ("n_active", "caught", "keep"):
                assert np.array_equal(getattr(trec, field).numpy(),
                                      np.asarray(getattr(jrec, field))), (j, r, field)
            a, b = float(trec.agg_norm), float(jrec.agg_norm)
            assert np.isfinite(a) == np.isfinite(b), (j, r)
            if np.isfinite(b) and b <= BLOWN_UP:
                np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=f"lane {j} round {r}")
        jfinal.append(float(jeval(jstate.params)))
        with torch.no_grad():
            tfinal.append(float(te(tstate.params)))
        jslashed.append(np.asarray(jstate.slashed))
        tslashed.append(tstate.slashed.numpy())
        assert np.isfinite(jfinal[-1]) == np.isfinite(tfinal[-1]), j
        if np.isfinite(jfinal[-1]):
            np.testing.assert_allclose(tfinal[-1], jfinal[-1], rtol=1e-5, err_msg=f"lane {j}")
    init = float(je(jp))
    jres = _results(grid_j, jspec, jfinal, jslashed, init, jder)
    tres = _results(grid_t, tspec, tfinal, tslashed, init, tder)
    assert tres.phase_table() == jres.phase_table()
    assert [r.derailed for r in tres.results] == [r.derailed for r in jres.results]


def test_no_off_smoke_run_free_against_the_reference(small_lm):
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = small_lm
    grid_j, grid_t = jscen.get_sweep_grid("no_off_smoke"), tscen.get_sweep_grid("no_off_smoke")
    jres = jder.sweep(jl, jp, jo, jd, je, grid_j)
    tres, (state, recs, final) = tder.sweep(tl, tp, to, td, te, grid_t, return_campaign=True)
    assert (tres.n_programs, tres.n_runs) == (jres.n_programs, jres.n_runs)
    for j, t in zip(jres.results, tres.results):
        for field in ("regime", "n_attackers", "attackers_slashed", "seed",
                      "attacker_fraction"):
            assert getattr(t, field) == getattr(j, field), field
        np.testing.assert_allclose(t.init_loss, j.init_loss, rtol=1e-6)
        np.testing.assert_allclose(t.baseline_loss, j.baseline_loss, rtol=2e-2)
    jspec = jder.build_sweep_lanes(grid_j)
    _, jrecs, _ = jswarm.run_campaign(
        jl, jp, jo, jd, jswarm.stack_lanes(jspec.lanes), rounds=grid_j.rounds,
        aggregator=jspec.aggregator, agg_kwargs=jspec.agg_kwargs, verify=jspec.verify)
    for field in ("n_active", "keep"):
        assert np.array_equal(getattr(recs, field).numpy(), np.asarray(getattr(jrecs, field)))
    np.testing.assert_allclose(recs.agg_norm[:, 0].numpy(), np.asarray(jrecs.agg_norm)[:, 0],
                               rtol=1e-4)
