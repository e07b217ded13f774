"""The whole slice: the port's swarm round against the JAX reference round.

Four configurations at the reduced width of ``small_lm_problem`` (2
layers, d_model 64, vocab 256; D = 164,160 parameters), 10 nodes, 3
rounds each:

- ``showcase``: the flagship roster (speeds 0.5-3x, a leaver, two attackers,
  QSGD 127 levels / buckets of 512, CenteredClip τ = 2.0, audits p = 0.25);
  seed 10 audits and slashes both attackers;
- ``krum``: an uncompressed wire, krum f = 2, a noise and a scale attacker,
  audits p = 0.5;
- ``compressed_wire``: mean over a 64-level QSGD wire (the registry
  scenario at 10 honest nodes);
- ``adaptive_cc``: CenteredClip with adaptive τ against two 10x sign-flip
  attackers (``sign_flip_minority`` at 10 nodes).

Both engines start from the same params and receive the reference's draws
(wire uniforms, audit selections and noise, corruption noise) from its
``_node_key`` schedule.  The port runs fused (its kernels' plain versions,
on the CPU) and unfused (``core.aggregation``).

``test_round_matches_reference`` compares everything after the gradient:
both engines' "batches" are the reduced LM's per-node gradients (at the
initial params, one token batch per node and round), through a linear loss
whose gradient is its batch exactly.  After every round:

- ``n_active``, ``caught``, ``keep`` (the minting nodes) and the ledger
  balances: exactly equal;
- the params (SGD, lr 0.5): 1e-5 of the largest parameter, absolute (the
  two sides differ only in float sums — bucket and node norms, the
  inner-product attacker's honest mean — which move an update by ulps; a
  QSGD code landing one level apart would exceed it, and none does);
- ``agg_norm``: 1e-4 relative (the reference's float32 norm of a 164K
  vector carries more rounding than the update itself).

``test_model_rounds_match_reference`` runs the showcase with the LM's own
loss on both sides.  Gradients then differ by ~2e-5 relative, which moves
some QSGD codes one level, and the lr-0.5 run amplifies that from round to
round; so only the discrete outcomes are held exactly (``n_active``,
``caught``, ``keep``, ledger), and the first round's ``agg_norm`` — from
identical params — to 1e-2 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import swarm as jswarm
from repro.core.verification import VerificationConfig as JVer
from repro.data import pipeline as jdata
from repro.models.model import build_model as jbuild_model
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.models import convert
from repro_torch.models.model import build_model
from repro_torch.optim import optimizer as topt
from repro_torch.random import RoundDraws
from test_torch_decentralized import one_thread  # noqa: F401

SMALL = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256,
             vocab_size=256)
ROUNDS, N = 3, 10


def _roster(name, mod):
    """(nodes, cfg kwargs) of configuration ``name`` built from ``mod``'s
    NodeSpec (the JAX or the port's swarm module)."""
    NS = mod.NodeSpec
    honest = [NS(f"h{i}") for i in range(8)]
    if name == "showcase":
        nodes = [NS("h0", speed=3.0), NS("h1"), NS("h2"), NS("h3", speed=0.5),
                 NS("h4", leave_round=ROUNDS // 2), NS("h5"),
                 NS("late0", speed=2.0, join_round=ROUNDS // 4), NS("late1"),
                 NS("adv0", byzantine="inner_product", byzantine_scale=20.0),
                 NS("adv1", byzantine="sign_flip", byzantine_scale=10.0)]
        kw = dict(aggregator="centered_clip", agg_kwargs={"clip_tau": 2.0, "iters": 3},
                  verify=0.25, compression="qsgd",
                  compression_kwargs={"levels": 127, "bucket_size": 512}, seed=10)
    elif name == "krum":
        nodes = honest + [NS("adv0", byzantine="noise", byzantine_scale=3.0),
                          NS("adv1", byzantine="scale", byzantine_scale=-4.0)]
        kw = dict(aggregator="krum", agg_kwargs={"f": 2}, verify=0.5, seed=3)
    elif name == "compressed_wire":
        nodes = honest + [NS("h8"), NS("h9", leave_round=2)]
        kw = dict(aggregator="mean", compression="qsgd",
                  compression_kwargs={"levels": 64, "bucket_size": 512}, seed=0)
    else:                                            # adaptive_cc
        nodes = honest + [NS(f"adv{i}", byzantine="sign_flip", byzantine_scale=10.0)
                          for i in range(2)]
        kw = dict(aggregator="centered_clip", seed=0)
    return nodes, kw


def _swarm_config(kw, ver_cls, cfg_cls, **extra):
    kw = dict(kw)
    p = kw.pop("verify", None)
    ver = ver_cls(p_check=p, stake=10.0, tolerance=1e-3, jackpot=5.0) if p else None
    return cfg_cls(verification=ver, **kw, **extra)


def _jax_draws(cfg, d_total, nodes, rnd):
    base = jax.random.PRNGKey(cfg.seed)
    key = functools.partial(jswarm._node_key, base)
    draws = RoundDraws()
    if cfg.compression == "qsgd":
        b = cfg.compression_kwargs["bucket_size"]
        shape = (-(-d_total // b), b)
        draws.wire = torch.from_numpy(np.stack([np.array(jax.random.uniform(
            key(jswarm._WIRE, rnd, i), shape)) for i in range(N)]))
    if cfg.verification is not None:
        draws.audit_sel = torch.from_numpy(np.stack([np.array(jax.random.uniform(
            key(jswarm._AUDIT_SEL, rnd, i))) for i in range(N)]))
        draws.audit_noise = torch.from_numpy(np.stack([np.array(jax.random.normal(
            key(jswarm._AUDIT_NOISE, rnd, i), (d_total,), jnp.float32))
            for i in range(N)]))
    if any(n.byzantine == "noise" for n in nodes):
        draws.corrupt = torch.from_numpy(np.stack([np.array(jax.random.normal(
            key(jswarm._CORRUPT, rnd, i), (d_total,))) for i in range(N)]))
    return draws


def _minted(ledger, start):
    return sorted(node for op, node, _ in ledger.history[start:] if op == "mint")


def _jax_linear_loss(p, g):
    """<params, g>: its gradient is ``g`` exactly, so a round fed the
    model's gradients as batches sees exactly those gradients."""
    return sum(jnp.sum(x * y) for x, y in zip(jax.tree.leaves(p), jax.tree.leaves(g)))


def _torch_linear_loss(p, g):
    return sum(torch.sum(p[k] * g[k]) for k in p)


@pytest.fixture(scope="module")
def setup():
    """The reduced LM's params, and as the round's "batches" its per-node
    gradients at those params for each round's token batch."""
    jcfg = jget_config("protocol-125m").reduced(**SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dcfg = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=2 * N)
    grad = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))
    grads = {(r, i): grad(jparams, jdata.model_batch(jcfg, dcfg, r, shard=i, num_shards=N))
             for r in range(ROUNDS) for i in range(N)}
    return jparams, grads


@pytest.fixture(scope="module")
def reference_runs(setup):
    """Each configuration's reference run: per round, the record, the
    minted nodes, the ledger balances, the flat params, and the draws."""
    jparams, grads = setup
    d_total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    runs = {}
    for name in ("showcase", "krum", "compressed_wire", "adaptive_cc"):
        nodes, kw = _roster(name, jswarm)
        cfg = _swarm_config(kw, JVer, jswarm.SwarmConfig)
        sw = jswarm.make_swarm(_jax_linear_loss, jparams, jopt.SGD(lr=0.5, momentum=0.9),
                               nodes, cfg, lambda i, r: grads[r, i])
        rounds = []
        for r in range(ROUNDS):
            start = len(sw.ledger.history)
            rec = sw.step(r)
            rounds.append(dict(
                rec=rec, minted=_minted(sw.ledger, start),
                balances=dict(sw.ledger.balances),
                params=np.concatenate([np.asarray(l, np.float32).reshape(-1)
                                       for l in jax.tree.leaves(sw.params)]),
                draws=_jax_draws(cfg, d_total, nodes, r)))
        runs[name] = rounds
    return runs


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["showcase", "krum", "compressed_wire", "adaptive_cc"])
def test_round_matches_reference(setup, reference_runs, name, fused):
    jparams, grads = setup
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tgrads = {k: convert.params_from_jax(jax.tree.map(np.asarray, g), "cpu")
              for k, g in grads.items()}
    nodes, kw = _roster(name, tswarm)
    cfg = _swarm_config(kw, TVer, tswarm.SwarmConfig, fused=fused)
    sw = tswarm.make_swarm(_torch_linear_loss, params, topt.SGD(lr=0.5, momentum=0.9),
                           nodes, cfg, lambda i, r: tgrads[r, i])
    assert sw.fused is fused
    caught_any = False
    for r, ref in enumerate(reference_runs[name]):
        start = len(sw.ledger.history)
        rec = sw.step(r, draws=ref["draws"])
        assert rec["n_active"] == ref["rec"]["n_active"]
        assert rec["n_byzantine"] == ref["rec"]["n_byzantine"]
        assert rec["caught"] == ref["rec"]["caught"]
        assert _minted(sw.ledger, start) == ref["minted"]
        assert sw.ledger.balances == ref["balances"]
        np.testing.assert_allclose(rec["agg_norm"], ref["rec"]["agg_norm"], rtol=1e-4)
        np.testing.assert_allclose(convert.flatten(sw.params).numpy(), ref["params"],
                                   rtol=0, atol=1e-5 * np.abs(ref["params"]).max())
        caught_any |= bool(rec["caught"])
    assert sw.ledger.check_conservation()
    if name in ("showcase", "krum"):
        assert caught_any, "the configuration should exercise a slash"
        assert all(n.startswith("adv") for n in sw.slashed)


def test_model_rounds_match_reference():
    jcfg = jget_config("protocol-125m").reduced(**SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dcfg = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=2 * N)
    batches = {(r, i): jdata.model_batch(jcfg, dcfg, r, shard=i, num_shards=N)
               for r in range(ROUNDS) for i in range(N)}
    d_total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jparams))
    nodes, kw = _roster("showcase", jswarm)
    jcfg_s = _swarm_config(kw, JVer, jswarm.SwarmConfig)
    jsw = jswarm.make_swarm(lambda p, b: jmodel.loss(p, b)[0], jparams,
                            jopt.SGD(lr=0.5, momentum=0.9), nodes, jcfg_s,
                            lambda i, r: batches[r, i])
    model = build_model(get_config("protocol-125m").reduced(**SMALL))
    tnodes, tkw = _roster("showcase", tswarm)
    tsw = tswarm.make_swarm(
        lambda p, b: model.loss(p, b)[0],
        convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        topt.SGD(lr=0.5, momentum=0.9), tnodes,
        _swarm_config(tkw, TVer, tswarm.SwarmConfig, fused=True),
        lambda i, r: {k: torch.from_numpy(np.array(v)).long()
                      for k, v in batches[r, i].items()})
    for r in range(ROUNDS):
        js, ts = len(jsw.ledger.history), len(tsw.ledger.history)
        jrec = jsw.step(r)
        trec = tsw.step(r, draws=_jax_draws(jcfg_s, d_total, nodes, r))
        for key in ("n_active", "n_byzantine", "caught"):
            assert trec[key] == jrec[key], (r, key)
        assert _minted(tsw.ledger, ts) == _minted(jsw.ledger, js)
        assert tsw.ledger.balances == jsw.ledger.balances
        if r == 0:
            np.testing.assert_allclose(trec["agg_norm"], jrec["agg_norm"], rtol=1e-2)
    assert tsw.slashed == jsw.slashed == {"adv0", "adv1"}


def test_unported_axes_raise():
    """The custody (item 7), async (item 9) and economy (item 10) axes are
    accepted, as the reference's config takes them, and ``lane_for_nodes``
    gives the reference's lanes: the economy's knobs, its coalition the
    roster's byzantine slots and ``adaptive`` a host int."""
    from repro.core.unextractable import CustodyConfig as JCustody
    from repro_torch.core.unextractable import CustodyConfig as TCustody
    cfg = tswarm.SwarmConfig(custody=TCustody(num_shards=4, redundancy=2),
                             staleness_bound=2)
    assert (cfg.custody, cfg.staleness_bound) == (TCustody(num_shards=4, redundancy=2), 2)
    nodes = [tswarm.NodeSpec("a", speed=0.25), tswarm.NodeSpec("b", delay=5),
             tswarm.NodeSpec("c", speed=2.0), tswarm.NodeSpec("d", speed=0.5, delay=0)]
    jnodes = [jswarm.NodeSpec(**n.__dict__) for n in nodes]
    assert [n.effective_delay for n in nodes] == [n.effective_delay for n in jnodes] == \
        [3, 5, 0, 0]
    lane = tswarm.lane_for_nodes(nodes, cfg, torch.device("cpu"))
    jlane = jswarm.lane_for_nodes(jnodes, jswarm.SwarmConfig(
        custody=JCustody(num_shards=4, redundancy=2), staleness_bound=2))
    for field in ("custody", "coalition", "delays"):
        assert np.array_equal(getattr(lane, field).numpy(), np.asarray(getattr(jlane, field)))
    from repro.core.economy import EconomyConfig as JEcon
    from repro_torch.core.economy import EconomyConfig as TEcon
    econ = dict(identity_cost=0.3, budget=17.0, adaptive=True)
    ecfg = tswarm.SwarmConfig(economy=TEcon(**econ))
    assert ecfg.economy == TEcon(**econ)
    byz = nodes[:2] + [tswarm.NodeSpec("adv0", byzantine="sign_flip"),
                       tswarm.NodeSpec("adv1", byzantine="inner_product")]
    lane = tswarm.lane_for_nodes(byz, ecfg, torch.device("cpu"))
    jlane = jswarm.lane_for_nodes([jswarm.NodeSpec(**n.__dict__) for n in byz],
                                  jswarm.SwarmConfig(economy=JEcon(**econ)))
    assert lane.econ.adaptive == int(jlane.econ.adaptive) == 1
    for field in lane.econ._fields[:-2] + ("coalition",):
        assert np.array_equal(getattr(lane.econ, field).numpy(),
                              np.asarray(getattr(jlane.econ, field))), field
    assert lane.econ.coalition.tolist() == [False, False, True, True]
    with pytest.raises(ValueError, match="unknown engine"):
        tswarm.make_swarm(None, {"w": torch.zeros(2)}, topt.SGD(), [], tswarm.SwarmConfig(),
                          None, engine="async")
    with pytest.raises(ValueError, match="unknown wire codec"):
        tswarm.make_round_fn(None, topt.SGD(), {"w": torch.zeros(2)}, 2,
                             aggregator="mean", compression_kind="fp8")
    with pytest.raises(ValueError, match="fused=True unsupported"):
        tswarm.make_round_fn(None, topt.SGD(), {"w": torch.zeros(2)}, 2,
                             aggregator="mean", compression_kind="qsgd",
                             compression_kwargs={"levels": 200}, fused=True)


def test_corruption_table_matches_reference():
    """Every behaviour of the row-wise table equals the reference's scalar
    ``corrupt`` on the same inputs (the noise draw handed across)."""
    rng = np.random.default_rng(0)
    g, hm = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (64,)))
    for kind in tswarm.BEHAVIOURS[1:]:
        ref = np.asarray(jswarm.corrupt(kind, jnp.asarray(g), jnp.asarray(hm), 3.0, key))
        out = tswarm.corrupt(kind, torch.from_numpy(g), torch.from_numpy(hm), 3.0,
                             torch.from_numpy(noise))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6, err_msg=kind)
