"""The decentralized round on the reduced LM against the reference's jitted
round (the roster, graphs, aggregators and audits of
``test_torch_decentralized.py``, whose helpers this file uses).

The reduced LM is ``launch/problems.py:small_lm_config`` (protocol-125m at
2 layers of d 64), the reference's weights and per-node batches carried
across, SGD at lr 0.5 with momentum 0.9, N = 6.  Three rounds, each round
of the port run from the reference's state (its replicas, per-node
momenta, slashed and contrib carried across) with the reference's audit
draws: ``n_active``, ``n_byzantine``, ``caught`` and ``keep`` exactly
equal, ``agg_norm`` and ``consensus_err`` within 1e-3 relative, the next
replicas within 1e-3 of each leaf's largest entry (measured over the 8
cases: 5.5e-5, 2.3e-5 and 2.4e-4 at worst).  The LM's gradients differ
from the reference's by ~2e-5 relative (ROADMAP queue 3), and lr 0.5 with
momentum 0.9 multiplies a difference ~30x a round, so a free run is held
only on the quadratic (``test_torch_decentralized.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig, data_fn_for_swarm
from repro.models.model import build_model as jbuild_model
from repro_torch.core import swarm as tswarm
from repro_torch.launch import problems
from repro_torch.models.convert import flat_size, layout_of, params_from_jax
from repro_torch.optim.optimizer import SGDState

from test_torch_decentralized import (CASES, N, _check_records, _draws, _ids, _rounds,  # noqa: F401
                                      one_thread)


@pytest.fixture(scope="module")
def small_lm():
    """The reduced LM on both sides: the reference's loss, params and the
    per-node batches of rounds 0-2; the port's loss on those params and
    batches."""
    jcfg = jget_config("protocol-125m").reduced(
        num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256, vocab_size=256)
    model = jbuild_model(jcfg)
    jp = model.init(jax.random.PRNGKey(0))
    data_fn = data_fn_for_swarm(jcfg, DataConfig(vocab_size=256, seq_len=32,
                                                 global_batch=32), 32)
    jbatches = [jax.vmap(lambda i: data_fn(i, r))(jnp.arange(N)) for r in range(3)]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tl = problems.lm_problem(problems.small_lm_config(), tp, None, None)[0]
    return (lambda p, b: model.loss(p, b)[0]), jp, jbatches, tl, tp


def _to_port(jstate) -> tswarm.SwarmState:
    host = jax.tree.map(np.asarray, jstate)
    return tswarm.SwarmState(
        params=params_from_jax(host.params, "cpu"),
        opt_state=SGDState(step=torch.from_numpy(host.opt_state.step.copy()),
                           momentum=params_from_jax(host.opt_state.momentum, "cpu")),
        slashed=torch.from_numpy(host.slashed.copy()),
        contrib=torch.from_numpy(host.contrib.copy()))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_round_on_the_reduced_lm_equals_the_reference(small_lm, case):
    jl, jp, jbatches, tl, tp = small_lm
    jcfg, jlane, tlane, jround, tround, jstate, tstate = _rounds(jl, jp, tl, tp, case,
                                                                 0.5, 0.9)
    d_total = flat_size(layout_of(tp))
    for r in range(3):
        tb = [{k: torch.from_numpy(np.array(v[i])).long() for k, v in jbatches[r].items()}
              for i in range(N)]
        tstate = _to_port(jstate)           # the round from the reference's state
        jstate, jrec = jround(jlane, jstate, r, jbatches[r])
        tstate, trec = tround(tlane, tstate, r, tb, _draws(jcfg, d_total, r))
        _check_records(jrec, trec, 1e-3, 1e-3, f"round {r}")
        want = _to_port(jstate)
        for k, v in want.params.items():
            scale = float(v.abs().max())
            assert float((tstate.params[k] - v).abs().max()) <= 1e-3 * scale, (r, k)
        assert torch.equal(tstate.opt_state.step, want.opt_state.step)
