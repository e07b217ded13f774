"""The port's dense protocol-125m against the JAX reference, at the reduced
width of ``examples/common.py:small_lm_problem`` (2 layers, d_model 64,
4 heads of 16, d_ff 256, vocab 256, sequences of 32).

Weights are the reference's, carried across with ``params_from_jax``; the
token batches are the reference's too.  Tolerances, in float32:

- loss: 1e-5 relative (two layers of reductions in another order);
- gradients: 1e-4 relative to the largest gradient entry of the tree;
- optimizer updates from identical gradients: 1e-6 relative, 1e-7 absolute
  (the same elementwise float32 expressions; the global norm of the clip
  and ``b ** step`` may differ by an ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild_model
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tdata
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import transformer as ttrans
from repro_torch.models.model import build_model
from repro_torch.optim import optimizer as topt

SMALL = dict(num_layers=2, d_model=64, num_heads=4, head_dim=16, d_ff=256,
             vocab_size=256)


@pytest.fixture(scope="module")
def problem():
    jcfg = jget_config("protocol-125m").reduced(**SMALL)
    tcfg = get_config("protocol-125m").reduced(**SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    dcfg = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=4)
    jbatch = jdata.model_batch(jcfg, dcfg, 3)
    tbatch = {k: torch.from_numpy(np.array(v)).long() for k, v in jbatch.items()}
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jmodel, jparams, jbatch, tparams, tbatch


@pytest.fixture(scope="module")
def jax_loss_and_grads(problem):
    jmodel, jparams, jbatch = problem[2], problem[3], problem[4]
    return jax.value_and_grad(lambda p, b: jmodel.loss(p, b)[0])(jparams, jbatch)


def _jax_names(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(p.key for p in path) for path, _ in paths]


def test_flat_order_is_jax_leaf_order(problem):
    jcfg, tcfg, _, jparams, _, tparams, _ = problem
    assert convert.flat_order(tcfg) == _jax_names(jparams)
    assert list(tparams) == _jax_names(jparams)
    ref = np.concatenate([np.asarray(l).reshape(-1).astype(np.float32)
                          for l in jax.tree.leaves(jparams)])
    np.testing.assert_array_equal(convert.flatten(tparams).numpy(), ref)
    back = convert.unflatten(convert.flatten(tparams), convert.layout_of(tparams))
    for k in tparams:
        assert torch.equal(back[k], tparams[k])


def test_unflatten_keeps_leading_axes(problem):
    """An (N, D) stack unflattens to per-node leaves, row i equal to
    ``unflatten`` of row i."""
    tparams = problem[5]
    layout = convert.layout_of(tparams)
    flat = convert.flatten(tparams)
    stack = torch.stack([flat, 2 * flat, -flat])
    batched = convert.unflatten(stack, layout)
    for i in range(3):
        row = convert.unflatten(stack[i], layout)
        for k in tparams:
            assert batched[k].shape == (3, *tparams[k].shape)
            assert batched[k].dtype == tparams[k].dtype
            assert torch.equal(batched[k][i], row[k]), (i, k)


def test_param_shapes_and_count_at_full_width():
    cfg = get_config("protocol-125m")
    shapes = ttrans.param_shapes(cfg)
    total = sum(int(np.prod(s)) for s, _ in shapes.values())
    assert total == cfg.param_count() == 162_417_408
    jshapes = jbuild_model(jget_config("protocol-125m")).param_shapes()
    jflat = dict(zip(_jax_names(jshapes), jax.tree.leaves(jshapes)))
    for name, (shape, dtype) in shapes.items():
        assert tuple(jflat[name].shape) == shape
        assert str(dtype).split(".")[-1] == jflat[name].dtype.name


def test_loss_and_gradients_match(problem, jax_loss_and_grads):
    jcfg, tcfg, jmodel, jparams, jbatch, tparams, tbatch = problem
    jl, jg = jax_loss_and_grads
    model = build_model(tcfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tl = model.loss(leaves, tbatch)[0]
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = np.concatenate([np.asarray(g).reshape(-1) for g in jax.tree.leaves(jg)])
    tflat = convert.flatten(dict(zip(leaves, tg))).numpy()
    scale = np.abs(jflat).max()
    np.testing.assert_allclose(tflat, jflat, rtol=1e-4, atol=1e-4 * scale)


def test_module_surface(problem):
    _, tcfg, _, _, _, tparams, tbatch = problem
    model = build_model(tcfg)
    model.load_params(tparams)
    assert sorted(n for n, _ in model.named_parameters()) == list(tparams)
    with torch.no_grad():
        assert float(model(tbatch)[0]) == float(model.loss(tparams, tbatch)[0])


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_one_optimizer_update_matches(problem, jax_loss_and_grads, opt_name):
    jcfg, tcfg, jmodel, jparams, jbatch, tparams, tbatch = problem
    jg = jax_loss_and_grads[1]
    tg = convert.params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
    if opt_name == "adamw":
        jo, to = jopt.AdamW(lr=5e-3), topt.AdamW(lr=5e-3)
    else:
        jo, to = jopt.SGD(lr=0.5, momentum=0.9), topt.SGD(lr=0.5, momentum=0.9)
    jp, js = jparams, jo.init(jparams)
    tp, ts = tparams, to.init(tparams)
    for _ in range(2):                       # second step reads the state
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
    for name, ref in zip(_jax_names(jp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert int(ts.step) == int(js.step) == 2


def test_global_norm_and_clip_match(problem):
    jparams, tparams = problem[3], problem[5]
    np.testing.assert_allclose(float(topt.global_norm(tparams)),
                               float(jopt.global_norm(jparams)), rtol=1e-6)
    tc = topt.clip_by_global_norm(tparams, 1.0)
    jc = jopt.clip_by_global_norm(jparams, 1.0)
    np.testing.assert_allclose(convert.flatten(tc).numpy(),
                               np.concatenate([np.asarray(l).reshape(-1)
                                               for l in jax.tree.leaves(jc)]),
                               rtol=1e-6, atol=1e-9)


def test_bf16_weights_carry_bit_for_bit():
    cfg = jget_config("protocol-125m").reduced(dtype="bfloat16", **SMALL)
    jparams = jbuild_model(cfg).init(jax.random.PRNGKey(1))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    for name, ref in zip(_jax_names(jparams), jax.tree.leaves(jparams)):
        t = tparams[name]
        assert str(t.dtype).split(".")[-1] == ref.dtype.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(ref).astype(np.float32))


def test_layers_match():
    """rms_norm, RoPE, SwiGLU and causal GQA attention on the same inputs
    (1e-5 relative, and 1e-6 of the output's largest entry absolute)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16))
    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))
    t = torch.from_numpy
    close(tcommon.apply_rope(t(x), t(pos.copy()), 1e4),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    close(tattn.attention(t(x), t(k), t(v)),
          jattn.attention(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v)))
    h = rng.normal(size=(2, 16, 32)).astype(np.float32)
    sc = rng.normal(size=(32,)).astype(np.float32)
    close(tcommon.rms_norm(t(h), t(sc), 1e-5),
          jcommon.rms_norm(jnp.asarray(h), jnp.asarray(sc), 1e-5))
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32)
    close(tcommon.swiglu(t(h), t(wg), t(wu), t(wd)),
          jcommon.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd))))


def test_data_pipeline_shares_the_markov_table():
    jd = jdata.DataConfig(vocab_size=256, seq_len=32, global_batch=8, seed=3)
    td = tdata.DataConfig(vocab_size=256, seq_len=32, global_batch=8, seed=3)
    table = tdata._transition_table(td)
    np.testing.assert_array_equal(table, jdata._transition_table(jd))
    toks = tdata.sample_tokens(td, 5, shard=1, num_shards=2, device="cpu").numpy()
    assert toks.shape == (4, 33)
    # every step follows the table from the previous token's state
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            assert b in table[a % td.num_states]
    again = tdata.sample_tokens(td, 5, shard=1, num_shards=2, device="cpu")
    assert torch.equal(again, torch.from_numpy(toks))
    other = tdata.sample_tokens(td, 6, shard=1, num_shards=2, device="cpu")
    assert not torch.equal(other, again)
    b = tdata.data_fn_for_swarm(get_config("protocol-125m"), td, 4, "cpu")(2, 5)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
