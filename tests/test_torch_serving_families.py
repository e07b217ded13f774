"""The continuous-batching engine on the three served families against the
reference's engine, and the per-row decode positions it stands on.

Models, float32, weights the reference's (``params_from_jax``):
- reduced h2o-danube-1.8b with ``sliding_window=8``: prompts of up to 6
  tokens and 5 new tokens make 11 positions, so the 8-slot ring of each
  row wraps at its own step;
- reduced rwkv6-1.6b and reduced zamba2-1.2b.

On each family:
- the engine (3 slots, 6 requests of mixed lengths, budgets and arrivals,
  a redundancy-1 custody matrix whose node 0 is down over steps [10, 16))
  gives tokens, done, admitted, balances and every record trace exactly
  equal to the reference's ``ServingEngine``;
- a batched ``decode_step`` with per-row positions (rows starting at
  different steps) is within ``STEP_REL`` relative L2 (1e-5; 1e-4 on
  zamba2, whose attention amplifies float order) of a B = 1
  ``decode_step`` of each row from the same cache row, and with every row
  at one position it gives the int-position path's bits;
- a slot that does not advance, idle or on a dead step, ends the step with
  every cache tensor and its ``pos`` bit-equal to before.

And the ``serving_smoke`` sweep on the windowed danube: its
``availability_table()`` equals the reference's as a string, its cells
equal cell by cell.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import scenarios as jscenarios
from repro.core import serving as jserving
from repro.core.unextractable import assign_matrix
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import scenarios as tscenarios
from repro_torch.core import serving as tserving
from repro_torch.models import convert
from repro_torch.models.model import build_model

_FAR = np.iinfo(np.int32).max
FAMILIES = {"h2o-danube-1.8b": dict(sliding_window=8), "rwkv6-1.6b": {}, "zamba2-1.2b": {}}
FIELDS = ("tokens", "done", "admitted", "balances", "coverage", "live", "n_active",
          "n_admitted", "new_tokens", "queued")
SERVE = dict(slots=3, max_new=5, steps=40)
# one batched step against one B = 1 step from the same row, relative L2 of
# the logits: float order alone.  The reduced zamba2 with the reference's
# init reads 6.4e-5 at one step, where its shared attention (scores of a
# random init, output norm ~140 from an input of ~1.6) turns an input gap
# of 2.8e-6 into 6.6e-5; the int-position batch reads the same bits there
STEP_REL = {"h2o-danube-1.8b": 1e-5, "rwkv6-1.6b": 1e-5, "zamba2-1.2b": 1e-4}
PROMPT_LEN, N_REQ = 6, 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pairs():
    """arch -> (reference model, its params, port model, the same params)."""
    out = {}
    for arch, kw in FAMILIES.items():
        jmodel = jbuild_model(jget_config(arch).reduced(**kw))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        out[arch] = (jmodel, jparams, build_model(get_config(arch).reduced(**kw)), tparams)
    return out


def _prompts(vocab):
    return np.random.default_rng(7).integers(0, vocab, (N_REQ, PROMPT_LEN)).astype(np.int32)


def _lane_kwargs():
    custody = assign_matrix(4, 8, redundancy=1, seed=0, max_fraction=0.5)
    return dict(n_requests=N_REQ, prompt_lens=np.array([6, 3, 5, 6, 4, 6], np.int32),
                max_new=np.array([5, 5, 2, 4, 5, 3], np.int32), steps=SERVE["steps"],
                n_nodes=4, balances=[100.0, 100.0], fee=1.0,
                arrivals=np.array([0, 0, 1, 3, 3, 9], np.int32), custody=custody)


def _outage():
    down_from = np.full(4, _FAR, np.int32)
    down_until = np.full(4, _FAR, np.int32)
    down_from[0], down_until[0] = 10, 16
    return down_from, down_until


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_engine_matches_the_reference(pairs, arch):
    jmodel, jparams, tmodel, tparams = pairs[arch]
    prompts = _prompts(tmodel.cfg.vocab_size)
    down_from, down_until = _outage()
    jlane = jserving.build_lane(**_lane_kwargs())._replace(
        node_down_from=jnp.asarray(down_from), node_down_until=jnp.asarray(down_until))
    tlane = tserving.build_lane(**_lane_kwargs(), device="cpu")._replace(
        node_down_from=torch.from_numpy(down_from).long(),
        node_down_until=torch.from_numpy(down_until).long())
    want = jserving.ServingEngine(jmodel, jserving.ServingConfig(**SERVE),
                                  jnp.asarray(prompts)).run(jparams, jlane)
    got = tserving.ServingEngine(tmodel, tserving.ServingConfig(**SERVE), prompts,
                                 device="cpu").run(tparams, tlane)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (arch, f, a, b)
    assert got.done.all() and not got.live[10:16].any() and got.live[16:].all()
    assert (got.new_tokens[10:16] == 0).all() and (got.n_admitted[10:16] == 0).all()
    if arch == "h2o-danube-1.8b":          # the rings wrap: 6 + 5 - 1 positions > 8 slots
        assert tmodel.init_cache(1, PROMPT_LEN + SERVE["max_new"], "cpu")["k"].shape[2] == 8


def _row(cache, axes, b):
    """Row ``b`` of a per-row cache as a B = 1 cache with a host int ``pos``."""
    def one(t, ax):
        return t.narrow(ax, b, 1).clone()
    out = {k: ({kk: one(t, ax) for kk, t in cache[k].items()} if isinstance(cache[k], dict)
               else one(cache[k], ax)) for k, ax in axes.items() if k in cache}
    return dict(out, pos=int(cache["pos"][b]))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_per_row_decode_matches_one_row_at_a_time(pairs, arch):
    """Three rows entering at steps 0, 3 and 7 of 16, so each sits at its own
    position (a row stands still, by the engine's row keeping, until it
    enters).  At every step each live row's logits are held against a
    B = 1 ``decode_step`` from that row's cache before the step."""
    _, _, model, params = pairs[arch]
    starts, steps, seq = [0, 3, 7], 16, 16
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (3, steps))).long()
    axes = model.cache_batch_axes
    worst = 0.0
    with torch.inference_mode():
        cache = dict(model.init_cache(3, seq, "cpu"), pos=torch.zeros(3, dtype=torch.long))
        for t in range(steps):
            live = torch.tensor([t >= s for s in starts])
            tok = torch.stack([toks[b, max(t - s, 0)] for b, s in enumerate(starts)])[:, None]
            alone = [model.decode_step(params, tok[b:b + 1], _row(cache, axes, b))[0]
                     for b, s in enumerate(starts) if t >= s]
            snapshot = tserving._snapshot(cache, axes)        # the engine's row keeping
            logits, cache = model.decode_step(params, tok, cache)
            cache = tserving._keep_rows(cache, axes, live, snapshot)
            for b, one in zip([b for b, s in enumerate(starts) if t >= s], alone):
                worst = max(worst, float((logits[b] - one[0]).norm() / one.norm()))
    assert cache["pos"].tolist() == [steps - s for s in starts]
    assert worst <= STEP_REL[arch], worst


def test_per_row_positions_change_no_bit_when_rows_agree(pairs):
    """Rows at one position: the per-row path gives the int path's bits
    (cache and logits), so the positions add no arithmetic of their own."""
    for arch in FAMILIES:
        _, _, model, params = pairs[arch]
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, model.cfg.vocab_size, (3, 12))).long()
        with torch.inference_mode():
            a = model.init_cache(3, 12, "cpu")
            b = dict(model.init_cache(3, 12, "cpu"), pos=torch.zeros(3, dtype=torch.long))
            for t in range(12):
                la, a = model.decode_step(params, toks[:, t:t + 1], a)
                lb, b = model.decode_step(params, toks[:, t:t + 1], b)
                assert torch.equal(la, lb), (arch, t)
        axes = model.cache_batch_axes
        assert all(torch.equal(x, y) for (x, _), (y, _) in
                   zip(tserving._cache_leaves(a, axes), tserving._cache_leaves(b, axes)))
        assert b["pos"].tolist() == [a["pos"]] * 3


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_slots_that_do_not_advance_keep_their_cache_bits(pairs, arch):
    """Run the engine's step on a pool with two occupied slots and one idle
    slot: the idle slot's cache rows and position are bit-equal after the
    step; then a step with the only holder of every shard down leaves every
    row bit-equal."""
    _, _, model, params = pairs[arch]
    prompts = torch.from_numpy(_prompts(model.cfg.vocab_size)).long()
    step, init_state = tserving.make_serve_step(
        model, tserving.ServingConfig(**SERVE), (N_REQ, PROMPT_LEN), has_custody=True,
        device="cpu")
    kw = dict(_lane_kwargs(), arrivals=np.array([0, 0, 50, 50, 50, 50], np.int32))
    lane = tserving.build_lane(**kw, device="cpu")
    axes = model.cache_batch_axes

    def rows(state, slot):
        leaves = [leaf.select(ax, slot).clone() for leaf, ax in
                  tserving._cache_leaves(state.caches, axes)]
        return leaves + [state.caches["pos"][slot].clone()]

    def bit_equal(a, b):
        return all(torch.equal(x.view(torch.uint8) if x.is_floating_point() else x,
                               y.view(torch.uint8) if y.is_floating_point() else y)
                   for x, y in zip(a, b))

    with torch.inference_mode():
        state = init_state(lane)
        for t in range(4):                       # two requests admitted, slot 2 idle
            state, _ = step(params, prompts, lane, state, torch.tensor(t))
        assert state.slot_req.tolist() == [0, 1, N_REQ]
        idle = rows(state, 2)
        busy = [rows(state, s) for s in (0, 1)]
        state, rec = step(params, prompts, lane, state, torch.tensor(4))
        assert bool(rec.live) and int(rec.n_active) == 2
        assert bit_equal(rows(state, 2), idle)
        assert not any(bit_equal(rows(state, s), b) for s, b in zip((0, 1), busy))
        down_from, down_until = _outage()
        dead = lane._replace(node_down_from=torch.from_numpy(down_from).long(),
                             node_down_until=torch.from_numpy(down_until).long())
        every = [rows(state, s) for s in range(SERVE["slots"])]
        state, rec = step(params, prompts, dead, state, torch.tensor(12))
        assert not bool(rec.live) and int(rec.new_tokens) == 0
        assert all(bit_equal(rows(state, s), b) for s, b in enumerate(every))


def test_serving_smoke_table_matches_the_reference(pairs):
    jmodel, jparams, tmodel, tparams = pairs["h2o-danube-1.8b"]
    grid = tscenarios.get_serving_grid("serving_smoke")
    prompts = np.random.default_rng(0).integers(
        0, tmodel.cfg.vocab_size, (grid.n_requests, grid.prompt_len)).astype(np.int32)
    want = jserving.sweep(jmodel, jparams, jscenarios.get_serving_grid("serving_smoke"),
                          prompts=jnp.asarray(prompts))
    got = tserving.sweep(tmodel, tparams, grid, prompts=prompts, device="cpu")
    assert got.availability_table() == want.availability_table()
    assert ([dataclasses.astuple(c) for c in got.cells]
            == [dataclasses.astuple(c) for c in want.cells])
