"""The port's config registry against the reference's, and the three dense
archs it adds (stablelm-3b, tinyllama-1.1b, granite-20b) at reduced width
against the JAX reference.

- Every registered config equals the reference's field by field; the
  registry is the reference's less seamless-m4t-medium (the audio family,
  ROADMAP queue 1, item 11), in the reference's order; ``ASSIGNED_ARCHS``,
  ``get_shape`` and ``applicable_shapes`` equal the reference's.
- Weights are the reference's (``params_from_jax``), tokens drawn with
  numpy; in float32, prefill logits and decode logits at each of 12
  positions within 1e-4, the loss within 1e-5 relative.  granite-20b is
  multi-query (kv 1) at reduced width too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import build_model as jbuild_model
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models.model import build_model

DENSE_ARCHS = ["stablelm-3b", "tinyllama-1.1b", "granite-20b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for the module: the suite runs several
    test files at once, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_registry_is_the_references_less_the_audio_family():
    want = [n for n in jconfigs.REGISTRY if jconfigs.REGISTRY[n].family != jconfigs.AUDIO]
    assert list(configs.REGISTRY) == want and len(want) == 10
    assert configs.ASSIGNED_ARCHS == [n for n in jconfigs.ASSIGNED_ARCHS
                                      if n != "seamless-m4t-medium"]
    assert "protocol-125m" not in configs.ASSIGNED_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("seamless-m4t-medium")
    assert configs.FAMILIES == jconfigs.FAMILIES
    assert (configs.MOE, configs.VLM) == (jconfigs.MOE, jconfigs.VLM)


@pytest.mark.parametrize("arch", list(configs.REGISTRY))
def test_config_equals_the_references_field_by_field(arch):
    got, ref = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(ref.reduced())
    assert configs.applicable_shapes(got) == jconfigs.applicable_shapes(ref)


def test_shapes_equal_the_references():
    assert configs.INPUT_SHAPES.keys() == jconfigs.INPUT_SHAPES.keys()
    for name in jconfigs.INPUT_SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == dataclasses.asdict(
            jconfigs.get_shape(name))
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("train_8k")
    assert "long_500k" in configs.applicable_shapes(configs.get_config("mixtral-8x7b"))
    assert "long_500k" not in configs.applicable_shapes(configs.get_config("granite-20b"))


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def pair(request):
    jmodel = jbuild_model(jconfigs.get_config(request.param).reduced())
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tmodel = build_model(configs.get_config(request.param).reduced())
    assert convert.flat_order(tmodel.cfg) == list(tparams)
    return jmodel, jparams, tmodel, tparams


def test_dense_prefill_and_loss_match(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    with torch.inference_mode():
        pre = tmodel.prefill(tparams, tb)
        loss = tmodel.loss(tparams, tb)[0]
    np.testing.assert_allclose(pre.numpy(), np.asarray(jax.jit(jmodel.prefill)(jparams, jb)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss), float(jax.jit(jmodel.loss)(jparams, jb)[0]),
                               rtol=1e-5)
    if cfg.name == "granite-20b":
        assert cfg.num_kv_heads == 1 and tparams["layers.attn.wk"].shape[2] == 1


def test_dense_decode_steps_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    toks = np.random.default_rng(2).integers(0, tmodel.cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, tcache = jmodel.init_cache(2, 12), tmodel.init_cache(2, 12, "cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    with torch.inference_mode():
        for i in range(12):
            jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache)
            tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]).long(),
                                            tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                       err_msg=f"position {i}")
