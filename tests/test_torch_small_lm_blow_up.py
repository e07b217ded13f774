"""Where the small LM's blown-up mean lanes end, and why the port's and the
reference's free ``no_off_smoke`` runs end differently there.

Run free, the reference's two mean lanes (2 and 6 inner-product attackers
at scale 50 beside 6 honest nodes) saturate: the residual stream grows
until the final RMSNorm's variance overflows float32, its rsqrt is 0, the
normed hidden state is 0, the logits are uniform (loss log 256) and every
gradient is 0 from then on.  The port's free lanes reach that same
saturated forward a round later or sooner, and then its next round gives
NaN: the backward of that norm's rsqrt multiplies the overflowed variance's
0 by a gradient·x sum that overflows too (the first non-finite value of
the run).  Whether a saturated state's gradient is 0 or NaN depends on how
far the residual has grown (a row at ~1e20 gives 0, one at ~1e32 gives
NaN), so it is the trajectory's, not an implementation's:

- the reference's jitted round from the port's saturated state gives NaN
  as well;
- the port's round from the reference's state just before its saturation
  saturates too (loss log 256), and its next round's aggregate is exactly
  0, as the reference's is.

ROADMAP queue 3 ("Recorded differences", slice 12) records the parting.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import derailment as jder
from repro.core import scenarios as jscen
from repro.core import swarm as jswarm
from repro_torch.core import derailment as tder
from repro_torch.core import scenarios as tscen
from repro_torch.core import swarm as tswarm

from test_torch_decentralized import one_thread  # noqa: F401
from test_torch_small_lm import _to_port, small_lm  # noqa: F401

LOG_V = math.log(256)        # the uniform prediction's loss


def _to_reference(tstate: tswarm.SwarmState, like):
    """The port's state as the reference's, leaf by leaf by name."""
    def tree(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(params[".".join(k.key for k in path)].numpy(),
                                        a.dtype), like.params)
    return like._replace(
        params=tree(tstate.params),
        opt_state=like.opt_state._replace(step=jnp.asarray(tstate.opt_state.step.numpy()),
                                          momentum=tree(tstate.opt_state.momentum)),
        slashed=jnp.asarray(tstate.slashed.numpy()),
        contrib=jnp.asarray(tstate.contrib.numpy()))


def test_mean_lanes_blow_up_end_by_the_trajectory(small_lm):
    (jl, jp, jd, je, jo), (tl, tp, td, te, to) = small_lm
    grid_j, grid_t = jscen.get_sweep_grid("no_off_smoke"), tscen.get_sweep_grid("no_off_smoke")
    jspec, tspec = jder.build_sweep_lanes(grid_j), tder.build_sweep_lanes(grid_t)
    n, rounds = jspec.n_total, grid_j.rounds
    jround = jax.jit(jswarm.make_round_fn(jl, jo, jp, n, aggregator=jspec.aggregator,
                                          agg_kwargs=jspec.agg_kwargs, verify=jspec.verify))
    tround = tswarm.make_round_fn(tl, to, tp, n, aggregator=tspec.aggregator,
                                  agg_kwargs=tspec.agg_kwargs, verify=tspec.verify)
    tlanes = tswarm.stack_lanes(tspec.lanes)
    jeval = jax.jit(je)
    jbatch = [jax.vmap(lambda i: jd(i, r))(jnp.arange(n)) for r in range(rounds)]
    tbatch = [[td(i, r) for i in range(n)] for r in range(rounds)]
    mean_lanes = [j for j, m in enumerate(tspec.metas) if m[0] is not None
                  and m[0].name == "mean"]
    assert len(mean_lanes) == 2
    for j in mean_lanes:
        jlane, tlane = jax.tree.map(jnp.asarray, jspec.lanes[j]), tlanes.lane(j)
        # the port run free: the round whose aggregate is first non-finite
        # starts from a saturated state
        tstates = [tswarm.init_state(tp, to, n)]
        for r in range(rounds):
            st, rec = tround(tlane, tstates[-1], r, tbatch[r])
            if not math.isfinite(float(rec.agg_norm)):
                break
            tstates.append(st)
        else:
            raise AssertionError(f"lane {j}: the port's free run stayed finite")
        first_nan = r
        with torch.no_grad():
            np.testing.assert_allclose(float(te(tstates[first_nan].params)), LOG_V, rtol=1e-6)
        # witness 1: the reference's round from the port's saturated state
        _, jrec = jround(jlane, _to_reference(tstates[first_nan], jswarm.init_state(jp, jo, n)),
                         first_nan, jbatch[first_nan])
        assert not np.isfinite(float(jrec.agg_norm)), (j, first_nan)
        # the reference run free: saturated from some round on, gradients 0
        jstates = [jswarm.init_state(jp, jo, n)]
        for r in range(rounds):
            st, jrec = jround(jlane, jstates[-1], r, jbatch[r])
            jstates.append(st)
            assert np.isfinite(float(jrec.agg_norm)), (j, r)
        sat = next(r for r in range(1, rounds + 1)
                   if abs(float(jeval(jstates[r].params)) - LOG_V) < 1e-5 * LOG_V)
        assert sat < rounds, (j, sat)
        # witness 2: the port's round from the reference's state before its
        # saturation saturates, and its next round's aggregate is exactly 0
        st, rec = tround(tlane, _to_port(jstates[sat - 1]), sat - 1, tbatch[sat - 1])
        assert math.isfinite(float(rec.agg_norm))
        with torch.no_grad():
            np.testing.assert_allclose(float(te(st.params)), LOG_V, rtol=1e-6)
        _, rec = tround(tlane, st, sat, tbatch[sat])
        assert float(rec.agg_norm) == 0.0, (j, sat)
