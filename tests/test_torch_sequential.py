"""The port's sequential engine and its aggregators against the JAX
reference, and against the port's batched engine.

Inputs are made with numpy or JAX from a seed and handed to both sides.
Equalities, after ``docs/kernels.md``:

- ``cc_iter_plain`` (the unmasked CenteredClip kernel's plain version)
  within 3e-5 of the reference's Pallas kernel in interpret mode, the bound
  of the reference's own kernel test;
- ``coordinate_median`` bit-equal to ``jnp.median`` (pure selection, a
  stable sort), signed zeros included; krum and multi-krum select the same
  rows; the other dense aggregators within 3e-5;
- each masked aggregator within 1e-5 of its dense twin on ``updates[mask]``
  (the reference's own bound, ``tests/test_scenarios.py``);
- whole sequential rounds against the reference's ``SequentialSwarm``, with
  the reference's draws and weights: ``n_active``, ``caught``, the minted
  nodes, ``slashed`` and the ledger exactly equal; ``agg_norm`` as in
  ``test_torch_swarm.py`` (1e-4 where both sides see the same gradients,
  1e-2 in the first round where each side takes its own);
- the port's two engines on one problem: ``slashed`` equal, ``agg_norm``
  within 2e-3, balances equal (the reference's engine-equivalence bound).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import swarm as jswarm
from repro.core.verification import VerificationConfig as JVer
from repro.data import pipeline as jdata
from repro.kernels.centered_clip import kernel as jcc_kernel
from repro.kernels.centered_clip import ops as jcc_ops
from repro.models.model import build_model as jbuild_model
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.kernels.centered_clip import ops as tcc
from repro_torch.launch import swarm as launch_swarm
from repro_torch.models import convert
from repro_torch.models.model import build_model
from repro_torch.optim import optimizer as topt
from repro_torch.random import RoundDraws
from test_torch_decentralized import one_thread  # noqa: F401


def _stack(n, d, seed=0):
    return np.asarray(np.random.default_rng(seed).normal(size=(n, d)) * 2 + 1, np.float32)


# ============================ unmasked CenteredClip ============================
CC_GRID = [(8, 4096), (16, 1000), (5, 257), (32, 128)]


@pytest.mark.parametrize("n,d", CC_GRID)
@pytest.mark.parametrize("tau,iters", [(1.0, 3), (0.5, 1), (10.0, 5)])
def test_centered_clip_matches_pallas_kernel(n, d, tau, iters):
    """``kernels.centered_clip.centered_clip`` (dense median, then
    ``cc_iter_plain`` on the CPU) and one iteration from the same v, each
    within 3e-5 of the reference's Pallas kernel in interpret mode."""
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d)) * 2 + 1
    tx = torch.from_numpy(np.array(x))
    ref = np.asarray(jcc_ops.centered_clip(x, clip_tau=tau, iters=iters, interpret=True))
    out = tcc.centered_clip(tx, clip_tau=tau, iters=iters).numpy()
    np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-5)
    v = jnp.median(x, axis=0)
    one = np.asarray(jcc_kernel.centered_clip_iter_fwd(x, v, clip_tau=tau, interpret=True))
    np.testing.assert_allclose(tcc.cc_iter_plain(tx, torch.from_numpy(np.array(v)), tau).numpy(),
                               one, rtol=3e-5, atol=3e-5)
    assert tcc.LAUNCHES["cc_iter"] == 0                # the CPU never launches


@pytest.mark.parametrize("n,d", [(1, 300), (2, 257), (3, 1000), (7, 257), (10, 1000)])
def test_cc_iter_adaptive_tau_matches_reference(n, d):
    """Adaptive τ (the median of the k row norms, the midpoint for an even
    k), k = 1, 2, 3, 7, 10: three iterations from the median, within 3e-5
    of the reference's ``aggregation.centered_clip``, through the port's
    dense aggregator."""
    x = _stack(n, d, seed=n)
    ref = np.asarray(jagg.centered_clip(jnp.asarray(x), clip_tau=None, iters=3))
    np.testing.assert_allclose(tagg.centered_clip(torch.from_numpy(x), clip_tau=None,
                                                  iters=3).numpy(),
                               ref, rtol=3e-5, atol=3e-5)
    v0 = np.asarray(np.median(x, axis=0) * 0.5, np.float32)
    ref1 = np.asarray(jagg.centered_clip(jnp.asarray(x), clip_tau=None, iters=1,
                                         v0=jnp.asarray(v0)))
    np.testing.assert_allclose(
        tcc.cc_iter_plain(torch.from_numpy(x), torch.from_numpy(v0), None).numpy(),
        ref1, rtol=3e-5, atol=3e-5)


def test_cc_iter_rejects_what_the_kernel_does_not_take():
    x = torch.ones(3, 8)
    with pytest.raises(TypeError, match="float32"):
        tcc.cc_iter(x.double(), torch.ones(8))
    with pytest.raises(ValueError, match="1..64"):
        tcc.cc_iter(torch.ones(65, 8), torch.ones(8))
    with pytest.raises(ValueError, match="v must be"):
        tcc.cc_iter(x, torch.ones(7))


# ============================= dense aggregators ===============================
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 10])
def test_coordinate_median_bit_equal_to_jnp_median(n):
    """Odd and even k, with +0.0 / −0.0 ties in most columns: the same bits
    as ``jnp.median``, signed zeros included."""
    rng = np.random.default_rng(n)
    x = np.round(rng.normal(size=(n, 400)) * 0.6).astype(np.float32)   # many zeros
    x = np.where(rng.random((n, 400)) < 0.5, np.float32(0.0), x)
    x = np.where(x == 0, np.where(rng.random((n, 400)) < 0.5, np.float32(-0.0),
                                  np.float32(0.0)), x).astype(np.float32)
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    out = tagg.coordinate_median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert np.signbit(ref).any() and (ref == 0).any()


AGG_CASES = [("mean", {}), ("median", {}), ("trimmed_mean", {"trim": 2}),
             ("trimmed_mean", {"trim": 1}), ("krum", {"f": 1}), ("krum", {"f": 3}),
             ("multi_krum", {"f": 1}), ("multi_krum", {"f": 1, "m": 20}),
             ("centered_clip", {"iters": 3}), ("centered_clip", {"clip_tau": 1.0, "iters": 3})]


@pytest.mark.parametrize("name,kwargs", AGG_CASES)
@pytest.mark.parametrize("n", [1, 4, 9])
def test_dense_aggregator_matches_reference(name, kwargs, n):
    x = _stack(n, 257, seed=n + 3)
    x[-1] *= 25.0                                        # an outlier row
    ref = np.asarray(jagg.get_aggregator(name, **kwargs)(jnp.asarray(x)))
    out = tagg.get_aggregator(name, **kwargs)(torch.from_numpy(x)).numpy()
    if name == "krum":                                   # selection-equal
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("name,kwargs", AGG_CASES)
def test_masked_aggregator_matches_dense_subset(name, kwargs):
    """As the reference's ``test_scenarios.py`` pins its own: each masked
    aggregator equals its dense twin on ``updates[mask]``."""
    rng = np.random.default_rng(0)
    for trial in range(4):
        x = rng.normal(size=(12, 17)).astype(np.float32)
        mask = rng.random(12) < 0.7
        mask[0] = True
        dense = tagg.get_aggregator(name, **kwargs)(torch.from_numpy(x[mask]))
        masked = tagg.get_masked_aggregator(name, **kwargs)(torch.from_numpy(x),
                                                            torch.from_numpy(mask))
        np.testing.assert_allclose(masked.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} trial {trial}")


@pytest.mark.parametrize("name,kwargs", [("median", {}), ("trimmed_mean", {"trim": 2}),
                                         ("multi_krum", {"f": 1}),
                                         ("multi_krum", {"f": 0, "m": 3})])
def test_new_masked_aggregators_match_reference(name, kwargs):
    """The three masked aggregators new to the port against the reference's,
    on churned, single-survivor and all-masked rows."""
    x = _stack(9, 300, seed=4)
    for mask in (np.arange(9) % 3 != 0, np.arange(9) == 4, np.zeros(9, bool)):
        ref = np.asarray(jagg.get_masked_aggregator(name, **kwargs)(jnp.asarray(x),
                                                                    jnp.asarray(mask)))
        out = tagg.get_masked_aggregator(name, **kwargs)(torch.from_numpy(x),
                                                         torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-5, err_msg=str(mask))


def test_masked_multi_krum_clamps_m_and_single_survivor_krum():
    """The reference's two regressions: m above the kept count never
    averages masked rows in; one survivor is krum's pick."""
    x = torch.tensor([[100.0] * 3, [1.0] * 3, [3.0] * 3])
    out = tagg.masked_multi_krum(x, torch.tensor([False, True, True]), f=0, m=3)
    np.testing.assert_allclose(out.numpy(), [2.0, 2.0, 2.0])
    x = torch.tensor([[100.0] * 3, [1.0] * 3, [2.0] * 3])
    out = tagg.masked_krum(x, torch.tensor([False, True, False]), f=1)
    np.testing.assert_allclose(out.numpy(), [1.0, 1.0, 1.0])


# ======================= whole rounds against the reference =====================
def _draws(cfg, d_total, n, rnd):
    """Round ``rnd``'s draws from the reference's key schedule, for the
    port's ``RoundDraws``."""
    key = functools.partial(jswarm._node_key, jax.random.PRNGKey(cfg.seed))
    draws = RoundDraws()

    def rows(fn):
        return torch.from_numpy(np.stack([np.array(fn(i)) for i in range(n)]))

    draw = tcomp.wire_draw(cfg.compression, d_total, **cfg.compression_kwargs)
    if draw is not None and draw[0] == "uniform":
        draws.wire = rows(lambda i: jax.random.uniform(key(jswarm._WIRE, rnd, i), draw[1]))
    elif draw is not None:
        draws.wire_normal = rows(lambda i: jax.random.normal(
            key(jswarm._WIRE, rnd, i), draw[1], jnp.float32))
    if cfg.verification is not None:
        draws.audit_sel = rows(lambda i: jax.random.uniform(key(jswarm._AUDIT_SEL, rnd, i)))
        draws.audit_noise = rows(lambda i: jax.random.normal(
            key(jswarm._AUDIT_NOISE, rnd, i), (d_total,), jnp.float32))
    draws.corrupt = rows(lambda i: jax.random.normal(key(jswarm._CORRUPT, rnd, i), (d_total,)))
    return draws


def _config(mod, ver_cls, name):
    """(nodes, SwarmConfig) of configuration ``name``, from ``mod`` (the
    JAX or the port's swarm module)."""
    NS = mod.NodeSpec
    ver = ver_cls(p_check=0.5, stake=10.0, tolerance=1e-3, jackpot=5.0)
    honest = [NS(f"h{i}") for i in range(6)]
    if name == "showcase":
        nodes = [NS("h0", speed=3.0), NS("h1"), NS("h2"), NS("h3", speed=0.5),
                 NS("h4", leave_round=1), NS("h5"), NS("late0", speed=2.0, join_round=1),
                 NS("late1"), NS("adv0", byzantine="inner_product", byzantine_scale=20.0),
                 NS("adv1", byzantine="sign_flip", byzantine_scale=10.0)]
        kw = dict(aggregator="centered_clip", agg_kwargs={"clip_tau": 2.0, "iters": 3},
                  compression="qsgd", compression_kwargs={"levels": 127, "bucket_size": 512},
                  seed=10)
    elif name == "krum_noise":
        nodes = honest + [NS("adv0", byzantine="noise", byzantine_scale=3.0),
                          NS("adv1", byzantine="scale", byzantine_scale=-4.0)]
        kw = dict(aggregator="krum", agg_kwargs={"f": 2}, seed=3)
    elif name == "topk_median":
        nodes = honest + [NS("h6", join_round=1), NS("adv0", byzantine="sign_flip",
                                                     byzantine_scale=5.0)]
        kw = dict(aggregator="median", compression="topk",
                  compression_kwargs={"k_frac": 0.25}, seed=4)
    elif name == "powersgd_multi_krum":
        nodes = honest + [NS("adv0", byzantine="zero"),
                          NS("adv1", byzantine="inner_product", byzantine_scale=3.0)]
        kw = dict(aggregator="multi_krum", agg_kwargs={"f": 2}, compression="powersgd",
                  compression_kwargs={"rank": 2, "iters": 2}, seed=5)
    else:                                                  # trimmed_adaptive_cc
        nodes = honest + [NS("h6", leave_round=2),
                          NS("adv0", byzantine="sign_flip", byzantine_scale=10.0)]
        kw = dict(aggregator="trimmed_mean", agg_kwargs={"trim": 2}, seed=6)
    return nodes, mod.SwarmConfig(verification=ver, **kw)


def _minted(ledger, start):
    return sorted(node for op, node, _ in ledger.history[start:] if op == "mint")


def _lockstep(jsw, tsw, d_total, rounds, agg_rtol, first_only=False):
    """Step both engines, the port on the reference's draws, and hold the
    discrete outcomes exactly and agg_norm to ``agg_rtol``."""
    for r in range(rounds):
        js, ts = len(jsw.ledger.history), len(tsw.ledger.history)
        jrec = jsw.step(r)
        trec = tsw.step(r, draws=_draws(jsw.cfg, d_total, len(jsw.nodes), r))
        for key in ("n_active", "n_byzantine", "caught"):
            assert trec[key] == jrec[key], (r, key)
        assert _minted(tsw.ledger, ts) == _minted(jsw.ledger, js)
        assert tsw.ledger.balances == jsw.ledger.balances
        if not first_only or r == 0:
            np.testing.assert_allclose(trec["agg_norm"], jrec["agg_norm"], rtol=agg_rtol)
    assert tsw.slashed == jsw.slashed and tsw.ledger.check_conservation()
    assert jsw.slashed, "every configuration has an attacker for the audits to slash"


CONFIGS = ["showcase", "krum_noise", "topk_median", "powersgd_multi_krum",
           "trimmed_adaptive_cc"]


@pytest.mark.parametrize("name", CONFIGS)
def test_sequential_matches_reference_on_the_tiny_quadratic(name):
    """The reference's tiny quadratic (8 params, data from its key schedule
    carried across) on both sequential engines, 4 rounds of SGD."""
    loss_fn, params0, data_fn, target = tiny_quadratic_problem(8)
    nodes, cfg = _config(jswarm, JVer, name)
    jsw = jswarm.make_swarm(loss_fn, params0, jopt.SGD(lr=0.1, momentum=0.0), nodes, cfg,
                            data_fn, engine="sequential")
    tt = torch.from_numpy(np.array(target))
    tdata = {}

    def tdata_fn(i, r):
        if (i, r) not in tdata:
            tdata[i, r] = {"x": torch.from_numpy(np.array(data_fn(i, r)["x"]))}
        return tdata[i, r]

    def tloss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] - b["x"] @ tt))

    tnodes, tcfg = _config(tswarm, TVer, name)
    tsw = tswarm.make_swarm(tloss, {"w": torch.zeros(8)}, topt.SGD(lr=0.1, momentum=0.0),
                            tnodes, tcfg, tdata_fn, engine="sequential")
    assert isinstance(tsw, tswarm.SequentialSwarm)
    _lockstep(jsw, tsw, 8, 4, agg_rtol=1e-4)


SMALL = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256, vocab_size=256)
LM_ROUNDS = 3


@pytest.fixture(scope="module")
def lm():
    """The reduced LM, its params, and per (round, node) a token batch and
    the reference's gradient at the initial params."""
    jcfg = jget_config("protocol-125m").reduced(**SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dcfg = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=20)
    batches = {(r, i): jdata.model_batch(jcfg, dcfg, r, shard=i, num_shards=10)
               for r in range(LM_ROUNDS) for i in range(10)}
    grad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    grads = {k: grad(jparams, b) for k, b in batches.items()}
    d_total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    return jmodel, jparams, batches, grads, d_total


def _padded_config(name):
    """A configuration of ``_config`` padded to the 10 nodes of the LM's
    data shards."""
    out = []
    for mod, ver in ((jswarm, JVer), (tswarm, TVer)):
        nodes, cfg = _config(mod, ver, name)
        out.append((nodes + [mod.NodeSpec(f"x{i}") for i in range(10 - len(nodes))], cfg))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_sequential_matches_reference_on_the_reduced_lm(lm, name):
    """The reduced LM's per-node gradients (D = 164,160) fed to both engines
    through a linear loss, whose gradient is its batch exactly, so both see
    the same gradients; every round's outcomes equal, agg_norm within
    1e-4."""
    _, jparams, _, grads, d_total = lm
    (jnodes, jcfg), (tnodes, tcfg) = _padded_config(name)
    jsw = jswarm.make_swarm(
        lambda p, g: sum(jnp.sum(a * b) for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(g))),
        jparams, jopt.SGD(lr=0.5, momentum=0.9), jnodes, jcfg, lambda i, r: grads[r, i],
        engine="sequential")
    tgrads = {k: convert.params_from_jax(jax.tree.map(np.asarray, g), "cpu")
              for k, g in grads.items()}
    tsw = tswarm.make_swarm(
        lambda p, g: sum(torch.sum(p[k] * g[k]) for k in p),
        convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        topt.SGD(lr=0.5, momentum=0.9), tnodes, tcfg, lambda i, r: tgrads[r, i],
        engine="sequential")
    _lockstep(jsw, tsw, d_total, LM_ROUNDS, agg_rtol=1e-4)


def test_sequential_lm_loss_matches_reference(lm):
    """The showcase on the reduced LM's own loss, each side taking its own
    gradients (~2e-5 apart, which moves some 127-level codes): the discrete
    outcomes every round, the first round's agg_norm within 1e-2."""
    jmodel, jparams, batches, _, d_total = lm
    (jnodes, jcfg), (tnodes, tcfg) = _padded_config("showcase")
    jsw = jswarm.make_swarm(lambda p, b: jmodel.loss(p, b)[0], jparams,
                            jopt.SGD(lr=0.5, momentum=0.9), jnodes, jcfg,
                            lambda i, r: batches[r, i], engine="sequential")
    model = build_model(get_config("protocol-125m").reduced(**SMALL))
    tsw = tswarm.make_swarm(
        lambda p, b: model.loss(p, b)[0],
        convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        topt.SGD(lr=0.5, momentum=0.9), tnodes, tcfg,
        lambda i, r: {k: torch.from_numpy(np.array(v)).long()
                      for k, v in batches[r, i].items()}, engine="sequential")
    _lockstep(jsw, tsw, d_total, LM_ROUNDS, agg_rtol=1e-2, first_only=True)


# ===================== the port's two engines on one problem =====================
def _torch_quadratic(n_params=8):
    """A torch twin of the reference's tiny quadratic, data from numpy."""
    rng = np.random.default_rng(42)
    target = torch.from_numpy(rng.normal(size=n_params).astype(np.float32))

    def loss_fn(params, batch):
        return torch.mean(torch.square(batch["x"] @ params["w"] - batch["x"] @ target))

    def data_fn(node_idx, rnd):
        g = np.random.default_rng(1000 * rnd + node_idx)
        return {"x": torch.from_numpy(g.normal(size=(16, n_params)).astype(np.float32))}

    return loss_fn, {"w": torch.zeros(n_params)}, data_fn


def _run_both(nodes, cfg, rounds=15):
    loss_fn, params0, data_fn = _torch_quadratic()
    out = {}
    for engine in ("sequential", "batched"):
        sw = tswarm.make_swarm(loss_fn, {k: v.clone() for k, v in params0.items()},
                               topt.SGD(lr=0.1, momentum=0.0), nodes, cfg, data_fn,
                               engine=engine)
        sw.run(rounds)
        out[engine] = sw
    return out["sequential"], out["batched"]


def _assert_equivalent(seq, bat):
    assert [r["n_active"] for r in seq.history] == [r["n_active"] for r in bat.history]
    assert [r["caught"] for r in seq.history] == [r["caught"] for r in bat.history]
    assert seq.slashed == bat.slashed
    np.testing.assert_allclose([r["agg_norm"] for r in bat.history],
                               [r["agg_norm"] for r in seq.history], rtol=2e-3, atol=1e-5)
    assert seq.ledger.balances == pytest.approx(bat.ledger.balances)


NS = tswarm.NodeSpec


@pytest.mark.parametrize("aggregator,kwargs", [
    ("mean", {}),
    ("centered_clip", {"clip_tau": 1.0, "iters": 3}),
    ("centered_clip", {}),
    ("median", {}),
    ("trimmed_mean", {"trim": 2}),
    ("krum", {"f": 2}),
    ("multi_krum", {"f": 2}),
])
def test_batched_matches_sequential_byzantine(aggregator, kwargs):
    nodes = [NS(f"h{i}") for i in range(6)] + [
        NS("adv0", byzantine="sign_flip", byzantine_scale=20.0),
        NS("adv1", byzantine="inner_product", byzantine_scale=10.0)]
    _assert_equivalent(*_run_both(nodes, tswarm.SwarmConfig(aggregator=aggregator,
                                                            agg_kwargs=kwargs)))


@pytest.mark.parametrize("compression,kwargs", [("qsgd", {"levels": 64}),
                                                ("topk", {"k_frac": 0.25}),
                                                ("powersgd", {"rank": 2})])
def test_batched_matches_sequential_compressed_wire(compression, kwargs):
    nodes = [NS(f"h{i}") for i in range(5)] + [NS("late", join_round=3),
                                               NS("gone", leave_round=7)]
    cfg = tswarm.SwarmConfig(aggregator="mean", compression=compression,
                             compression_kwargs=kwargs)
    _assert_equivalent(*_run_both(nodes, cfg))


def test_batched_matches_sequential_verification_and_noise():
    """Audits slash the zero attacker on both engines alike; the noise
    attacker's draws come from the shared key schedule."""
    nodes = [NS(f"h{i}") for i in range(5)] + [NS("cheat", byzantine="zero"),
                                               NS("nz", byzantine="noise", byzantine_scale=5.0)]
    cfg = tswarm.SwarmConfig(aggregator="centered_clip",
                             verification=TVer(p_check=0.4, stake=5.0, tolerance=1e-3),
                             compression="qsgd", compression_kwargs={"levels": 16})
    seq, bat = _run_both(nodes, cfg, rounds=20)
    _assert_equivalent(seq, bat)
    assert bat.slashed == {"cheat", "nz"}


def test_launcher_runs_the_sequential_showcase_on_the_cpu(capsys):
    out = launch_swarm.main(["--device", "cpu", "--rounds", "3", "--engine", "sequential"])
    sw = out["swarm"]
    assert isinstance(sw, tswarm.SequentialSwarm) and len(sw.history) == 3
    assert all(np.isfinite(out["losses"])) and sw.ledger.check_conservation()
    assert sw.slashed <= {"adv0", "adv1"}
    text = capsys.readouterr().out
    assert "engine=sequential" in text and "fused=" not in text
