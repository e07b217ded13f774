"""The port's serving path against the JAX reference: sliding-window
prefill, ring-buffer decode, greedy decoding, custody and the Protocol
Model server.

Weights are the reference's, carried across with ``params_from_jax``;
tokens are drawn with numpy from a seed and handed to both sides.  The
reference's Pallas kernel runs in interpret mode.  Tolerances, in float32:
logits within 1e-4 (reductions in another order over two layers); greedy
tokens, custody matrices, coverage and shards exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import protocol as jprotocol
from repro.core import serving as jserving
from repro.core import unextractable as junx
from repro.core.ledger import Ledger as JLedger
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import protocol as tprotocol
from repro_torch.core import scenarios as tscenarios
from repro_torch.core import serving as tserving
from repro_torch.core import unextractable as tunx
from repro_torch.core.ledger import Ledger
from repro_torch.models import convert
from repro_torch.models.model import build_model


def _pair(arch, use_kernel=False, **overrides):
    """(JAX model, JAX params, port model, port params) at the reduced width
    (2 layers; h2o-danube: window 32)."""
    jcfg = jget_config(arch).reduced(use_pallas_kernels=use_kernel, **overrides)
    tcfg = get_config(arch).reduced(use_pallas_kernels=use_kernel, **overrides)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def danube():
    return _pair("h2o-danube-1.8b")


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


# -- prefill ----------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
def test_danube_prefill_matches_jax(danube, use_kernel):
    jmodel, jparams, tmodel, tparams = danube
    if use_kernel:
        jmodel = jbuild_model(dataclasses.replace(jmodel.cfg, use_pallas_kernels=True))
        tmodel = build_model(dataclasses.replace(tmodel.cfg, use_pallas_kernels=True))
    assert tmodel.cfg.sliding_window == 32
    toks = _tokens((2, 64), tmodel.cfg.vocab_size)
    ref = np.asarray(jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}))
    with torch.inference_mode():
        got = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, tmodel.cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_danube_prefill_kernel_route_matches_swa_route(danube):
    """As tests/test_kernels.py does for the reference: the flag swaps the
    window's compute for the kernel's function, the logits stay put."""
    tmodel, tparams = danube[2], danube[3]
    krn = build_model(dataclasses.replace(tmodel.cfg, use_pallas_kernels=True))
    batch = tmodel.concrete_batch(1, 2, 64, "cpu")
    with torch.inference_mode():
        a, b = tmodel.prefill(tparams, batch), krn.prefill(tparams, batch)
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    assert batch["tokens"].shape == batch["labels"].shape == (2, 64)


# -- decode -------------------------------------------------------------------------
def test_danube_decode_steps_match_jax_across_the_ring_wrap(danube):
    """A 40-token prompt through decode_step with a 32-slot ring: the logits
    at every position match the reference's, before and after the wrap,
    and match the prefill at the last position."""
    jmodel, jparams, tmodel, tparams = danube
    toks = _tokens((2, 40), tmodel.cfg.vocab_size, seed=2)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(2, 40)
    tcache = tmodel.init_cache(2, 40, "cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape == (2, 2, 32, 2, 32)
    with torch.inference_mode():
        for i in range(40):
            jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache)
            tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]).long(),
                                            tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                       err_msg=f"position {i}")
        assert tcache["pos"] == int(jcache["pos"]) == 40
        jk = np.asarray(jcache["k"])            # the second layer's keys carry the first's rounding
        np.testing.assert_allclose(tcache["k"].numpy(), jk, rtol=1e-4,
                                   atol=1e-4 * np.abs(jk).max())
        scan_logits, _ = tmodel.decode_scan(tparams, torch.from_numpy(toks).long(),
                                            tmodel.init_cache(2, 40, "cpu"))
        prefilled = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(scan_logits[:, -1].numpy(), tl[:, 0].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(tl[:, 0].numpy(), prefilled.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,prompt_len,max_new", [
    ("h2o-danube-1.8b", 24, 12),      # the ring of 32 wraps while decoding
    ("protocol-125m", 8, 6),
])
def test_greedy_decode_tokens_match_jax(arch, prompt_len, max_new):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    prompts = _tokens((2, prompt_len), tmodel.cfg.vocab_size, seed=3)
    jgen, _ = jserving.greedy_decode(jmodel, jparams, jnp.asarray(prompts), max_new)
    tp = torch.from_numpy(prompts).long()
    scan, stats = tserving.greedy_decode(tmodel, tparams, tp, max_new)
    np.testing.assert_array_equal(scan.numpy(), np.asarray(jgen))
    assert tserving.greedy_decode_loop is tserving.greedy_decode     # one eager loop
    assert stats.tokens_out == max_new and stats.batch == 2 and stats.tok_per_s > 0


# -- custody --------------------------------------------------------------------------
@pytest.mark.parametrize("n,shards,r,seed,frac", [
    (8, 16, 2, 0, 0.35), (6, 12, 2, 3, 0.4), (5, 9, 1, 7, 0.5), (10, 20, 3, 1, 0.5)])
def test_custody_matches_jax(n, shards, r, seed, frac):
    nodes = [f"n{i}" for i in range(n)]
    jc = junx.ShardCustody.assign(nodes, shards, r, seed, frac)
    tc = tunx.ShardCustody.assign(nodes, shards, r, seed, frac)
    np.testing.assert_array_equal(tc.holds.numpy(), np.asarray(jc.holds))
    assert tc.holds.device.type == "cpu"
    assert tc.assignment == jc.assignment and tc.node_shards == jc.node_shards
    rng = np.random.default_rng(seed)
    for _ in range(6):
        members = [m for m in nodes if rng.random() < 0.5] + ["stranger"]
        assert tc.coverage(members) == jc.coverage(members)
        assert tc.can_extract(members) == jc.can_extract(members)
        assert tc.tolerates_departures(members) == jc.tolerates_departures(members)
        assert tc.missing_shards(members) == jc.missing_shards(members)
        assert tunx.extraction_cost_flops(tc, members, 3.0) == \
            junx.extraction_cost_flops(jc, members, 3.0)
        assert tunx.is_protocol_model(tc, members, 1000, 50, 1e6) == \
            junx.is_protocol_model(jc, members, 1000, 50, 1e6)
    for exact in (False, True):
        assert tc.min_extraction_coalition(exact) == jc.min_extraction_coalition(exact)
    # batched reductions over a stack of coalitions
    masks = rng.random((3, 4, n)) < 0.4
    for tf, jf in ((tunx.coverage_frac, junx.coverage_frac),
                   (tunx.can_extract_all, junx.can_extract_all),
                   (tunx.tolerates_departures_all, junx.tolerates_departures_all),
                   (tunx.missing_shards, junx.missing_shards)):
        np.testing.assert_array_equal(tf(tc.holds, torch.from_numpy(masks)).numpy(),
                                      np.asarray(jf(jc.holds, jnp.asarray(masks))))
    assert tunx.retrain_cost_flops(10**9, 2 * 10**10) == junx.retrain_cost_flops(10**9, 2 * 10**10)


def test_custody_draw_refuses_what_the_reference_refuses():
    for args in ((4, 8, 0, 0, 0.5), (3, 10, 3, 0, 0.3)):
        with pytest.raises(ValueError):
            junx.assign_matrix(*args)
        with pytest.raises(ValueError):
            tunx.assign_matrix(*args)


def test_shards_bit_equal_and_reconstruct_round_trips():
    jmodel, jparams, tmodel, tparams = _pair("h2o-danube-1.8b", dtype="bfloat16")
    assert tparams["embed"].dtype == torch.bfloat16
    jshards, jsize = junx.shard_params(jparams, 7)
    tshards, tsize = tunx.shard_params(tparams, 7)
    assert tsize == jsize and len(tshards) == 7
    for a, b in zip(tshards, jshards):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    layout = convert.layout_of(tparams)
    full = tunx.reconstruct_params(dict(enumerate(tshards)), layout, 7, tsize)
    for k, t in tparams.items():
        assert full[k].dtype == t.dtype and torch.equal(full[k], t), k
    held = {i: s for i, s in enumerate(tshards) if i != 2}
    part = tunx.reconstruct_params(held, layout, 7, tsize)
    flat = convert.flatten(part)
    size = tshards[0].numel()
    assert not flat[2 * size:3 * size].any()
    assert torch.equal(flat[:2 * size], convert.flatten(tparams)[:2 * size])
    jpart = junx.reconstruct_params({i: jshards[i] for i in held}, jparams, 7, jsize)
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.asarray(l, np.float32).reshape(-1)
                                      for l in jax.tree.leaves(jpart)]))
    empty = tunx.reconstruct_params({}, layout, 7, tsize, device="cpu")
    assert not convert.flatten(empty).any() and empty["embed"].dtype == torch.bfloat16


# -- the Protocol Model server -----------------------------------------------------------
def test_protocol_server_gates_serves_and_caches(danube):
    """The port's twin of tests/test_launch.py's two server tests, on the
    reduced sliding-window model with the kernel flag set."""
    jmodel, jparams, tmodel, tparams = danube
    tmodel = build_model(dataclasses.replace(tmodel.cfg, use_pallas_kernels=True))
    nodes = [f"n{i}" for i in range(6)]
    led, jled = Ledger(), JLedger()
    led.record_contribution("n0", 1.0)
    jled.record_contribution("n0", 1.0)
    srv = tprotocol.ProtocolModelServer.create(tmodel, tparams, nodes, led, num_shards=12,
                                               redundancy=2, max_fraction=0.4)
    jsrv = jprotocol.ProtocolModelServer.create(jmodel, jparams, nodes, jled, num_shards=12,
                                                redundancy=2, max_fraction=0.4)
    toks = _tokens((1, 40), tmodel.cfg.vocab_size, seed=4)
    batch = {"tokens": torch.from_numpy(toks).long()}
    with pytest.raises(tprotocol.CredentialError):
        srv.serve("outsider", batch)
    logits = srv.serve("n0", batch)
    assert logits.shape == (1, tmodel.cfg.vocab_size)
    with torch.inference_mode():
        ref = tmodel.prefill(tparams, batch)
    assert torch.equal(logits, ref)
    jlogits = jsrv.serve("n0", {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    # one entry per online-node set, order-free, reused
    assert len(srv._params_cache) == 1
    cached = srv._params_cache[frozenset(nodes)]
    srv.serve("n0", batch, online_nodes=list(reversed(nodes)))
    assert len(srv._params_cache) == 1 and srv._params_cache[frozenset(nodes)] is cached
    survivors = [n for n in nodes if n != "n5"]
    assert srv.custody.tolerates_departures(["n5"])
    assert torch.equal(srv.serve("n0", batch, online_nodes=survivors), logits)
    assert len(srv._params_cache) == 2
    # a partial swarm cannot serve, and the error names the missing shards
    with pytest.raises(tprotocol.ExtractionError) as err:
        srv.serve("n0", batch, online_nodes=nodes[:1])
    assert str(srv.custody.missing_shards(nodes[:1])) in str(err.value)
    # a coalition's extraction yields garbage; a covering one is refused
    broken = srv.attempt_extraction(nodes[:2])
    with torch.inference_mode():
        assert float((tmodel.prefill(broken, batch) - ref).abs().max()) > 1e-2
    with pytest.raises(tprotocol.ExtractionError, match="NOT a Protocol Model"):
        srv.attempt_extraction(nodes)
    # the decode path serves tokens without exposing weights
    prompts = torch.zeros((2, 4), dtype=torch.long)
    gen, _ = srv.decode("n0", prompts, 3)
    want, _ = tserving.greedy_decode(tmodel, tparams, prompts, 3)
    jgen, _ = jsrv.decode("n0", jnp.zeros((2, 4), jnp.int32), 3)
    assert torch.equal(gen, want)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))


def test_server_lru_evicts_the_oldest_set():
    _, _, tmodel, tparams = _pair("protocol-125m")
    led = Ledger()
    led.record_contribution("n0", 1.0)
    nodes = [f"n{i}" for i in range(6)]
    srv = tprotocol.ProtocolModelServer.create(tmodel, tparams, nodes, led, num_shards=6,
                                               redundancy=3, max_fraction=0.6, seed=2)
    srv.cache_size = 2
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    sets = [nodes, nodes[1:], nodes[:-1]]
    for s in sets:
        srv.serve("n0", batch, online_nodes=s)
    assert list(srv._params_cache) == [frozenset(s) for s in sets[1:]]


def test_serving_engine_waits_for_its_item():
    """The engine is ported; a MeshPlan placement (``plan=``) of the engine
    and of the serving sweep waits for ROADMAP queue 1, item 13."""
    tmodel = build_model(get_config("protocol-125m").reduced())
    grid = tscenarios.get_serving_grid("serving_smoke")
    for call in (lambda: tserving.ServingEngine(tmodel, tserving.ServingConfig(),
                                                np.zeros((2, 4), np.int32), plan=object(),
                                                device="cpu"),
                 lambda: tserving.sweep(tmodel, {}, grid, plan=object(), device="cpu")):
        with pytest.raises(NotImplementedError, match="queue 1, item 13"):
            call()
