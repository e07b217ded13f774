"""The decentralized round (ROADMAP queue 1, item 8) against the reference's
jitted round, with the reference's draws handed to the port.

Roster: N = 6 (4 honest, a sign-flip and an inner-product attacker), on a
ring and on a degree-4 random-regular graph, with mean and CenteredClip,
without and with audits (p_check 0.5); each round's audit draws are the
reference's (``(seed, purpose, round, node)`` keys).

- On the 8-parameter quadratic of ``tests/conftest.py``, 6 rounds run free
  on both sides: ``n_active``, ``n_byzantine``, ``caught`` and ``keep``
  exactly equal each round, ``agg_norm`` within 1e-5 relative,
  ``consensus_err`` within 1e-4 relative (1e-7 absolute), the replicas at
  the end within 1e-5.

The same rounds on the reduced LM are in ``test_torch_decentralized_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_quadratic_problem
from repro.core import swarm as jswarm
from repro.core.verification import VerificationConfig as JVer
from repro.optim.optimizer import SGD as JSGD
from repro_torch.core import swarm as tswarm
from repro_torch.core.verification import VerificationConfig as TVer
from repro_torch.optim.optimizer import SGD as TSGD
from repro_torch.random import RoundDraws

N = 6
CASES = [(agg, topo, audit) for agg in ("mean", "centered_clip")
         for topo in ("ring", "random_regular") for audit in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(case):
    return "-".join((case[0], case[1], "audit" if case[2] else "plain"))


def _roster(mod):
    return [mod.NodeSpec(f"h{i}") for i in range(N - 2)] + [
        mod.NodeSpec("adv0", byzantine="sign_flip", byzantine_scale=10.0),
        mod.NodeSpec("adv1", byzantine="inner_product", byzantine_scale=20.0)]


def _configs(agg, topo, audit, seed=4):
    def ver(cls):
        return cls(p_check=0.5, stake=10.0, tolerance=1e-3, jackpot=5.0) if audit else None
    return (jswarm.SwarmConfig(aggregator=agg, topology=topo, seed=seed, verification=ver(JVer)),
            tswarm.SwarmConfig(aggregator=agg, topology=topo, seed=seed, verification=ver(TVer)))


def _draws(cfg, d_total, rnd):
    """The reference's audit draws of round ``rnd`` as a RoundDraws."""
    if cfg.verification is None:
        return None
    base = jax.random.PRNGKey(cfg.seed)
    sel = jax.vmap(lambda i: jax.random.uniform(jswarm._node_key(base, jswarm._AUDIT_SEL,
                                                                  rnd, i)))(jnp.arange(N))
    noise = jax.vmap(lambda i: jax.random.normal(
        jswarm._node_key(base, jswarm._AUDIT_NOISE, rnd, i), (d_total,), jnp.float32))(
        jnp.arange(N))
    return RoundDraws(audit_sel=torch.from_numpy(np.array(sel)),
                      audit_noise=torch.from_numpy(np.array(noise)))


def _rounds(jl, jp, tl, tp, case, lr, momentum):
    """The reference's jitted decentralized round and the port's (SGD at
    ``lr``, ``momentum``), their lanes and initial states."""
    agg, topo, audit = case
    jcfg, tcfg = _configs(agg, topo, audit)
    jlane = jswarm.lane_for_nodes(_roster(jswarm), jcfg)
    tlane = tswarm.lane_for_nodes(_roster(tswarm), tcfg, torch.device("cpu"))
    assert np.array_equal(tlane.mixing.numpy(), np.asarray(jlane.mixing))
    jround = jax.jit(jswarm.make_round_fn(jl, JSGD(lr=lr, momentum=momentum), jp, N,
                                          aggregator=agg, verify=audit, decentralized=True))
    tround = tswarm.make_round_fn(tl, TSGD(lr=lr, momentum=momentum), tp, N,
                                  aggregator=agg, verify=audit, decentralized=True)
    assert not tround.fused
    jstate = jswarm.init_decentralized_state(jp, JSGD(lr=lr, momentum=momentum), N)
    tstate = tswarm.init_decentralized_state(tp, TSGD(lr=lr, momentum=momentum), N)
    return jcfg, jlane, tlane, jround, tround, jstate, tstate


def _check_records(jrec, trec, rtol_agg, rtol_cons, what):
    for field in ("n_active", "n_byzantine", "caught", "keep"):
        assert np.array_equal(getattr(trec, field).numpy(), np.asarray(getattr(jrec, field))), \
            (what, field)
    np.testing.assert_allclose(float(trec.agg_norm), float(jrec.agg_norm), rtol=rtol_agg,
                               err_msg=f"{what} agg_norm")
    np.testing.assert_allclose(float(trec.consensus_err), float(jrec.consensus_err),
                               rtol=rtol_cons, atol=1e-7, err_msg=f"{what} consensus_err")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_round_on_the_quadratic_equals_the_reference(case):
    audit = case[2]
    jl, jp, jd, target = tiny_quadratic_problem(8)
    t_target = torch.from_numpy(np.array(target))

    def tl(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] - b["x"] @ t_target))

    tp = {"w": torch.zeros(8)}
    jcfg, jlane, tlane, jround, tround, jstate, tstate = _rounds(jl, jp, tl, tp, case,
                                                                 0.1, 0.0)
    caught_any = False
    for r in range(6):
        jb = jax.vmap(lambda i: jd(i, r))(jnp.arange(N))
        tb = [{"x": torch.from_numpy(np.array(jb["x"][i]))} for i in range(N)]
        jstate, jrec = jround(jlane, jstate, r, jb)
        tstate, trec = tround(tlane, tstate, r, tb, _draws(jcfg, 8, r))
        _check_records(jrec, trec, 1e-5, 1e-4, f"round {r}")
        caught_any |= bool(np.any(np.asarray(jrec.caught)))
    assert caught_any == audit
    np.testing.assert_allclose(tstate.params["w"].numpy(), np.asarray(jstate.params["w"]),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(tstate.slashed.numpy(), np.asarray(jstate.slashed))
    assert np.array_equal(tstate.contrib.numpy(), np.asarray(jstate.contrib))
