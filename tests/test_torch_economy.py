"""The economy engine's functions (ROADMAP queue 1, item 10) against the JAX
reference's ``repro/core/economy.py``, on seeded numpy inputs.

- ``init_econ_state`` where the budget buys fewer identities than the
  coalition, exactly as many, more, or none, and ``admitted_mask``: masks
  exactly equal, float fields within 1e-6 relative;
- eight rounds of ``econ_round_update`` over random active / keep / caught
  masks, each side from its own state: ``alive`` and the admission masks
  exactly equal, every float field within 1e-6 relative (the sums over
  nodes are added in another order; every other step is elementwise);
- ``conservation_gap`` (below 1e-4 of the inflow on both sides),
  ``payoff`` and ``EconomyConfig.params_for``;
- ``best_response_scale`` against the mean and CenteredClip: the four
  scores within 1e-5 (relative to the largest), the chosen scale equal
  where the reference's best two scores are further apart than that;
- ``classify_outcome``, the ``phase_table`` strings and the
  ``adaptive_gap`` dicts equal on the same result lists;
- ``ledger_view(...).check_conservation()`` on both sides' final states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import economy as jecon
from repro_torch.core import aggregation as tagg
from repro_torch.core import economy as tecon

FLOAT_REL = 1e-6          # float fields of the state
SCORE_REL = 1e-5          # best-response scores, relative to the largest
N = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    return jecon.EconomyConfig(**kw), tecon.EconomyConfig(**kw)


def _params(coal, **kw):
    jc, tc = _configs(**kw)
    return jc.params_for(coal), tc.params_for(coal)


def _assert_state_close(t, j, what=""):
    for name in jecon.EconState._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        if name == "alive":
            assert np.array_equal(a, b), (what, name)
        else:
            np.testing.assert_allclose(a, b, rtol=FLOAT_REL,
                                       atol=FLOAT_REL * max(1.0, float(np.abs(b).max())),
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("budget,identity_cost,coal_size", [
    (10.0, 4.0, 4),        # buys 1 of 4 (+1 top-up)
    (36.0, 4.0, 4),        # buys exactly 4
    (50.0, 1.0, 4),        # could buy 8, the coalition holds 4
    (3.0, 1.0, 3),         # buys none
    (50.0, 0.1, 5),        # economy_sybil_adaptive's: all 5, stakes 9.9
    (7.3, 0.0, 0),         # no coalition
])
def test_init_econ_state_and_admission(budget, identity_cost, coal_size):
    coal = np.zeros(N, bool)
    coal[N - coal_size:] = True
    jp, tp = _params(coal, budget=budget, identity_cost=identity_cost, min_stake=5.0,
                     honest_reserve=1.5)
    js, ts = jecon.init_econ_state(jp, N), tecon.init_econ_state(tp, N)
    _assert_state_close(ts, js, "init")
    assert np.array_equal(tecon.admitted_mask(tp, ts).numpy(),
                          np.asarray(jecon.admitted_mask(jp, js)))
    n_funded = int(ts.alive[coal].sum())
    assert n_funded == min(int(budget // (identity_cost + 5.0)), coal_size)
    assert float(tecon.conservation_gap(ts)) < 1e-4
    if coal_size == 5 and identity_cost == 0.1:
        np.testing.assert_allclose(ts.stake[coal].numpy(), 9.9, rtol=1e-6)


def test_round_updates_follow_the_reference():
    rng = np.random.default_rng(7)
    speeds = rng.uniform(0.5, 3.0, N).astype(np.float32)
    coal = np.zeros(N, bool)
    coal[5:] = True
    kw = dict(identity_cost=0.5, budget=20.0, min_stake=5.0, fee_income=1.7,
              reward_rate=0.13, op_cost=0.9, jackpot=6.0, honest_reserve=0.4)
    jp, tp = _params(coal, **kw)
    js, ts = jecon.init_econ_state(jp, N), tecon.init_econ_state(tp, N)
    for rnd in range(8):
        jadm, tadm = jecon.admitted_mask(jp, js), tecon.admitted_mask(tp, ts)
        assert np.array_equal(tadm.numpy(), np.asarray(jadm)), rnd
        active = tadm.numpy() & (rng.uniform(size=N) < 0.9)
        caught = active & (rng.uniform(size=N) < 0.2)
        keep = active & ~caught
        if rnd == 3:
            keep[:] = caught[:] = False              # nobody kept: no fee inflow
        js = jecon.econ_round_update(jp, js, active=jnp.asarray(active), keep=jnp.asarray(keep),
                                     caught=jnp.asarray(caught), speeds=jnp.asarray(speeds))
        ts = tecon.econ_round_update(tp, ts, active=torch.from_numpy(active),
                                     keep=torch.from_numpy(keep),
                                     caught=torch.from_numpy(caught),
                                     speeds=torch.from_numpy(speeds))
        _assert_state_close(ts, js, f"round {rnd}")
        inflow = float(ts.capital_in.sum() + ts.minted + ts.fees_in)
        assert float(tecon.conservation_gap(ts)) <= 1e-4 * inflow
        assert float(jecon.conservation_gap(js)) <= 1e-4 * inflow
        np.testing.assert_allclose(tecon.payoff(ts).numpy(), np.asarray(jecon.payoff(js)),
                                   rtol=FLOAT_REL, atol=FLOAT_REL * 50)
    assert not ts.alive.all() and ts.validator_income > 0    # the run drains and slashes
    for s in (ts, js):
        led = tecon.ledger_view(s, [f"n{i}" for i in range(N)])
        assert led.check_conservation()
    jled = jecon.ledger_view(js, [f"n{i}" for i in range(N)])
    tled = tecon.ledger_view(ts, [f"n{i}" for i in range(N)])
    assert tled.balances.keys() == jled.balances.keys()
    assert tled.stakes.keys() == jled.stakes.keys()
    assert [op for op, *_ in tled.history] == [op for op, *_ in jled.history]


def test_params_for_is_the_reference():
    coal = np.array([False, True, False, True])
    for adaptive in (False, True):
        jp, tp = _params(coal, identity_cost=0.3, fee_income=2.5, adaptive=adaptive)
        for name in jecon.EconParams._fields:
            a, b = getattr(tp, name), getattr(jp, name)
            if name == "adaptive":
                assert a == int(b) == int(adaptive)
            elif name == "coalition":
                assert a.dtype == torch.bool and np.array_equal(a.numpy(), np.asarray(b))
            else:
                assert a.dtype == torch.float32 and a.shape == ()
                assert a.numpy() == np.asarray(b), name
    assert [f.name for f in dataclasses.fields(tecon.EconomyConfig)] == \
        [f.name for f in dataclasses.fields(jecon.EconomyConfig)]
    assert tecon.EconomyConfig() == tecon.EconomyConfig(**dataclasses.asdict(
        jecon.EconomyConfig()))
    assert tecon.ADAPTIVE_SCALES == jecon.ADAPTIVE_SCALES and tecon.OUTCOMES == jecon.OUTCOMES


def _reference_scores(agg, gf, hm, coal_act, mask):
    """The reference's candidate scores (``best_response_scale``'s inner
    ``score``), which it reduces to their argmax."""
    return np.array([float(-jnp.vdot(agg(jnp.where(coal_act[:, None], -s * hm[None, :], gf),
                                          mask), hm))
                     for s in jecon.ADAPTIVE_SCALES])


@pytest.mark.parametrize("aggregator", ["mean", "centered_clip"])
@pytest.mark.parametrize("seed", range(4))
def test_best_response_follows_the_reference(aggregator, seed):
    rng = np.random.default_rng(seed)
    n, d = 7, 96
    gf = (rng.normal(size=(n, d)) + 0.3).astype(np.float32)
    mask = rng.uniform(size=n) < 0.85
    mask[0] = True
    coal_act = mask & (np.arange(n) >= n - 1 - seed % 3)
    hm = (gf * mask[:, None]).sum(0) / mask.sum()
    hm = hm.astype(np.float32)
    jfn = jagg.get_masked_aggregator(aggregator)
    want = _reference_scores(jfn, jnp.asarray(gf), jnp.asarray(hm), jnp.asarray(coal_act),
                             jnp.asarray(mask))
    tfn = tagg.get_masked_aggregator(aggregator)
    args = (torch.from_numpy(gf), torch.from_numpy(hm), torch.from_numpy(coal_act),
            torch.from_numpy(mask))
    got = tecon.best_response_scores(tfn, *args).numpy()
    tol = SCORE_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    jbest = float(jecon.best_response_scale(jfn, jnp.asarray(gf), jnp.asarray(hm),
                                            jnp.asarray(coal_act), jnp.asarray(mask)))
    assert jbest == tecon.ADAPTIVE_SCALES[int(np.argmax(want))]
    tbest = tecon.best_response_scale(tfn, *args, buf=torch.empty(n, d))
    assert tbest.dtype == torch.float32 and tbest.shape == ()
    top2 = np.sort(want)[-2:]
    if top2[1] - top2[0] > tol:
        assert float(tbest) == jbest
    if aggregator == "mean" and coal_act.any():
        assert float(tbest) == max(tecon.ADAPTIVE_SCALES)      # monotone against a mean


def test_classify_outcome_is_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        kw = dict(honest_active_first=int(rng.integers(0, 9)),
                  honest_active_last=int(rng.integers(0, 9)),
                  coalition_stake_last=float(rng.uniform(0, 1)),
                  honest_payoff_mean=float(rng.normal()))
        thr = float(rng.uniform(0.3, 0.7))
        assert tecon.classify_outcome(**kw, capture_threshold=thr) == \
            jecon.classify_outcome(**kw, capture_threshold=thr)


def _results(rng, n):
    out = []
    for _ in range(n):
        out.append(dict(
            regime=str(rng.choice(["mean+audit", "centered_clip+audit"])),
            identity_cost=float(rng.choice([0.5, 4.0])), fee=float(rng.choice([0.5, 2.0])),
            reward_rate=0.1, jackpot=5.0, adaptive=bool(rng.integers(0, 2)),
            coalition_size=int(rng.choice([0, 3])), seed=int(rng.integers(0, 2)),
            outcome=str(rng.choice(jecon.OUTCOMES)), honest_payoff=float(rng.normal()),
            coalition_payoff=float(rng.normal()), coalition_stake_share=float(rng.uniform()),
            n_admitted_first=9, n_admitted_last=int(rng.integers(0, 10)),
            final_loss=float(rng.uniform(0.1, 5.0))))
    return out


@pytest.mark.parametrize("n", [0, 1, 12, 40])
def test_phase_table_and_adaptive_gap_are_the_reference(n):
    cells = _results(np.random.default_rng(n), n)
    tr = [tecon.EconomyResult(**c) for c in cells]
    jr = [jecon.EconomyResult(**c) for c in cells]
    for regime in ("mean+audit", "centered_clip+audit"):
        for adaptive in (False, True):
            assert tecon.phase_table(tr, regime=regime, adaptive=adaptive) == \
                jecon.phase_table(jr, regime=regime, adaptive=adaptive)
    assert tecon.adaptive_gap(tr) == jecon.adaptive_gap(jr)
