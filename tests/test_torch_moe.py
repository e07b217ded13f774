"""The port's Mixture-of-Experts FFN and MoE transformer against the JAX
reference (``repro/models/moe.py``, ``repro/models/transformer.py``).

Inputs are drawn with numpy from a seed and handed to both sides; model
weights are the reference's, carried across with ``params_from_jax``.
Tolerances, in float32:

- ``capacity``: equal over a grid of lengths, k, expert counts and factors;
- routing away from ties (``torch.topk`` promises no order among equal
  probabilities, ``jax.lax.top_k`` takes the lower index; random inputs
  have none): experts equal, gates and the aux loss within 1e-6;
- dispatch and combine, fed the reference's own routing: the capacity
  buffer, each slot's place and gate, the drop count and the combined
  output exactly equal, at a factor of 1.25 with one expert crowded so
  that slots are dropped; the combine equal to the reference's eager
  ops, and within k float32 roundings of the terms of its compiled form
  (XLA contracts each gate multiply and slot add into an FMA);
- the experts' products and ``moe_ffn``: within 1e-5 (float32 matmuls in
  another order);
- the reduced mixtral-8x7b (4 experts, k 2) and qwen3-moe-30b-a3b (16
  experts, k 8): hidden states, prefill and decode logits within 1e-4,
  the loss, its cross-entropy and the aux loss within 1e-5 relative, the
  gradient within 1e-4 of its largest entry, greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import serving as jserving
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import serving as tserving
from repro_torch.models import convert, moe
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model

ARCHS = {"mixtral-8x7b": {},
         "qwen3-moe-30b-a3b": dict(num_experts=16, experts_per_token=8)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# -- capacity and routing -----------------------------------------------------------
@pytest.mark.parametrize("seq", [1, 7, 64, 392, 4160, 32768])
def test_capacity_matches_reference(seq):
    for k, e in ((2, 8), (8, 128), (8, 16), (1, 4), (2, 4)):
        for f in (1.0, 1.25, e / k, 2.0, 0.1):
            assert moe.capacity(seq, k, e, f) == jmoe.capacity(seq, k, e, f), (seq, k, e, f)


def _inputs(b, s, d, e, seed, crowd=False):
    """x (B, S, d) and a router (d, E); ``crowd`` makes expert 0 the first
    choice of nearly every token (a shared positive feature it reads)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    if crowd:
        x[..., 0] = np.abs(x[..., 0]) + 2.0
        router[0, 0] = 1.5
    return x, router


@pytest.mark.parametrize("k,e", [(2, 8), (8, 16), (1, 4)])
def test_route_matches_reference(k, e):
    x, router = _inputs(2, 24, 32, e, seed=k * e)
    jg, je, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(router), k)
    tg, te, taux = moe.route(_t(x), _t(router), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert tg.dtype == torch.float32 and te.shape == (2, 24, k)


def _reference_dispatch(x, experts, gates, e, cap):
    return jax.jit(jax.vmap(lambda xg, eg, gg: jmoe._dispatch_one_group(xg, eg, gg, e, cap)))(
        x, experts, gates)


@pytest.mark.parametrize("k,e,factor", [(2, 4, 1.25), (2, 8, 1.25), (8, 16, 1.25),
                                        (2, 4, 2.0), (8, 16, 2.0)])
def test_dispatch_and_combine_exact_given_reference_routing(k, e, factor):
    b, s, d = 3, 64, 16
    x, router = _inputs(b, s, d, e, seed=e + k, crowd=True)
    jx = jnp.asarray(x)
    jg, je, _ = jmoe.route(jx, jnp.asarray(router), k)
    cap = jmoe.capacity(s, k, e, factor)
    jbuf, (slot_e, slot_c, jgate) = _reference_dispatch(jx, je, jg, e, cap)
    plan = moe.dispatch(_t(x), _t(je).long(), _t(jg), e, cap)
    assert plan.buf.shape == (b, e, cap, d)
    np.testing.assert_array_equal(plan.buf.numpy(), np.asarray(jbuf))
    row = np.arange(b)[:, None] * (e * cap)
    np.testing.assert_array_equal(
        plan.index.numpy(), (row + np.asarray(slot_e) * cap + np.asarray(slot_c)).reshape(-1))
    np.testing.assert_array_equal(plan.gates.numpy(), np.asarray(jgate).reshape(-1))
    # a routed slot's gate is positive, so the reference zeroes exactly the dropped ones
    ref_dropped = int((np.asarray(jgate) == 0).sum())
    assert int((~plan.keep).sum()) == ref_dropped
    if factor == 1.25:
        assert ref_dropped > 0, "the crowded expert drops no slot: the case tests nothing"
    # combine the same expert outputs: exactly the reference's eager ops
    out = np.random.default_rng(1).standard_normal((b, e, cap, d)).astype(np.float32)
    combine = jax.vmap(lambda ho, m: jmoe._combine_one_group(ho, m, s, k))
    got = moe.combine(_t(out), plan, s, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(combine(jnp.asarray(out), (slot_e, slot_c, jgate))))
    # compiled, XLA fuses each gate multiply and slot add into one FMA on the
    # CPU, a rounding fewer a slot: within k float32 roundings of the terms
    jitted = np.asarray(jax.jit(combine)(jnp.asarray(out), (slot_e, slot_c, jgate)))
    terms = np.abs(out.reshape(-1, d)[plan.index.numpy()] * plan.gates.numpy()[:, None])
    assert (np.abs(got - jitted) <= k * 2.0 ** -23 * terms.reshape(b, s, k, d).sum(2)).all()


def _expert_params(d, f, e, seed):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
            "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            "w_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
            "w_down": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}


def test_experts_apply_matches_reference_products():
    p = _expert_params(16, 24, 4, seed=3)
    buf = np.random.default_rng(4).standard_normal((2, 4, 8, 16)).astype(np.float32)
    g = jnp.einsum("becd,edf->becf", buf, p["w_gate"])
    u = jnp.einsum("becd,edf->becf", buf, p["w_up"])
    ref = jnp.einsum("becf,efd->becd", jax.nn.silu(g) * u, p["w_down"])
    got = moe.experts_apply(_t(buf), {k: _t(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,e", [(2, 4), (8, 16)])
@pytest.mark.parametrize("factor", [1.25, None])
def test_moe_ffn_matches_reference(k, e, factor):
    """At 1.25 (slots dropped where the router crowds one expert) and at
    E / k; at E / k nothing drops and both equal the every-expert oracle."""
    d, f = 16, 24
    x, _ = _inputs(2, 40, d, e, seed=5, crowd=True)
    p = _expert_params(d, f, e, seed=6)
    p["router"][0, 0] = 1.5                       # crowd expert 0
    factor = factor or e / k
    jout, jaux = jax.jit(lambda a, q: jmoe.moe_ffn(a, q, top_k=k, capacity_factor=factor))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tp = {n: _t(v) for n, v in p.items()}
    tout, taux = moe.moe_ffn(_t(x), tp, top_k=k, capacity_factor=factor)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if factor == e / k:
        oracle = moe.moe_ffn_reference(_t(x), tp, top_k=k)
        np.testing.assert_allclose(tout.numpy(), oracle.numpy(), rtol=1e-5, atol=1e-5)
        joracle = jax.jit(lambda a, q: jmoe.moe_ffn_reference(a, q, top_k=k))(
            jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
        np.testing.assert_allclose(oracle.numpy(), np.asarray(joracle), rtol=1e-5, atol=1e-5)


# -- the MoE transformer -------------------------------------------------------------------
def _pair(arch):
    jcfg = jget_config(arch).reduced(**ARCHS[arch])
    tcfg = get_config(arch).reduced(**ARCHS[arch])
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    return _pair(request.param)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": _t(toks).long(), "labels": _t(labels).long()})


def test_flat_order_is_jax_leaf_order(pair):
    jmodel, jparams, tmodel, tparams = pair
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    names = [".".join(str(getattr(p, "key", p)) for p in path) for path, _ in leaves]
    assert convert.flat_order(tmodel.cfg) == names == list(tparams)
    shapes = T.param_shapes(tmodel.cfg)
    for (_, leaf), name in zip(leaves, names):
        assert shapes[name][0] == leaf.shape
        assert str(shapes[name][1]).split(".")[-1] == leaf.dtype.name
    assert shapes["layers.moe.router"][1] == torch.float32
    cfg = tmodel.cfg
    assert shapes["layers.moe.w_down"][0] == (cfg.num_layers, cfg.num_experts, cfg.d_ff,
                                              cfg.d_model)


def test_forward_prefill_and_loss_match(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch(tmodel.cfg, 2, 32, seed=7)
    from repro.models import transformer as jT
    jh, jaux = jax.jit(lambda p, b: jT.forward(p, jmodel.cfg, b, remat=False))(jparams, jb)
    with torch.inference_mode():
        th, taux = T.forward(tparams, tmodel.cfg, tb)
        tl, tparts = tmodel.loss(tparams, tb)
        tpre = tmodel.prefill(tparams, tb)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0                      # summed over the layers, as the reference's
    jl, jparts = jax.jit(jmodel.loss)(jparams, jb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["xent"]), float(jparts["xent"]), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["moe_aux"]), float(jparts["moe_aux"]), rtol=1e-5)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jax.jit(jmodel.prefill)(jparams, jb)),
                               rtol=1e-4, atol=1e-4)


def test_loss_gradient_matches_jax_grad(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _batch(tmodel.cfg, 2, 32, seed=8)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(p, jb)[0]))(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl = tmodel.loss(leaves, tb)[0]
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = np.concatenate([np.asarray(g).reshape(-1) for g in jax.tree.leaves(jg)])
    tflat = convert.flatten(dict(zip(leaves, tg))).numpy()
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4, atol=1e-4 * np.abs(jflat).max())
    router = convert.flatten({"g": tg[list(leaves).index("layers.moe.router")]})
    assert float(router.abs().max()) > 0        # the router learns through the gates


def test_decode_steps_match_jax(pair):
    """12 positions through decode_step (capacity factor E / k: nothing
    drops), logits at each against the reference's; teacher-forced, the
    last equals a prefill whose capacity factor is E / k too."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, tcache = jmodel.init_cache(2, 12), tmodel.init_cache(2, 12, "cpu")
    with torch.inference_mode():
        for i in range(12):
            jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache)
            tl, tcache = tmodel.decode_step(tparams, _t(toks[:, i:i + 1]).long(), tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                       err_msg=f"position {i}")
        wide = build_model(dataclasses.replace(
            cfg, moe_capacity_factor=T.decode_capacity_factor(cfg)))
        prefilled = wide.prefill(tparams, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(tl[:, 0].numpy(), prefilled.numpy(), rtol=1e-4, atol=1e-4)


def test_greedy_tokens_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    prompts = np.random.default_rng(10).integers(0, tmodel.cfg.vocab_size, (2, 6))
    prompts = prompts.astype(np.int32)
    jgen, _ = jserving.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 5)
    tgen, _ = tserving.greedy_decode(tmodel, tparams, _t(prompts).long(), 5)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_count_at_full_width(arch):
    """The shapes of the full-width config hold ``param_count()`` params,
    and so do mixtral's at 3 layers (the depth its card serves)."""
    cfg = get_config(arch)
    count = lambda c: sum(int(np.prod(s)) for s, _ in T.param_shapes(c).values())
    assert count(cfg) == cfg.param_count()
    cut = dataclasses.replace(cfg, num_layers=3)
    assert count(cut) == cut.param_count()
    if arch == "mixtral-8x7b":
        assert cfg.param_count() == 46_702_792_704 and cut.param_count() == 4_615_958_528


def test_protocol_inference_serves_mixtral_with_its_depth_cut(capsys):
    """``--layers`` cuts the depth and keeps the width: the params built are
    the cut config's ``param_count()``, the server's logits bit-equal to
    ``Model.prefill``, and the ``model:`` line names the cut."""
    from repro_torch.launch import protocol_inference
    torch.manual_seed(0)
    out = protocol_inference.main(["--device", "cpu", "--arch", "mixtral-8x7b",
                                   "--layers", "1", "--seq", "12", "--batch", "2"])
    cfg = out["model"].cfg
    assert cfg.num_layers == 1 and cfg.num_experts == 4 and cfg.d_model == 256
    assert out["n_params"] == cfg.param_count()
    assert torch.equal(out["logits"], out["ref"]) and out["protocol_model"]
    assert "depth cut to 1 of 32 layers" in capsys.readouterr().out
    with pytest.raises(ValueError, match="has 32 layers"):
        protocol_inference.main(["--device", "cpu", "--arch", "mixtral-8x7b", "--layers", "33"])
