"""The port's VLM backbone (qwen2-vl-2b: stubbed media embeddings before
the tokens, M-RoPE) against the JAX reference.

Inputs are drawn with numpy from a seed and handed to both sides; model
weights are the reference's, carried across with ``params_from_jax``.
Tolerances, in float32:

- ``apply_mrope``: within 1e-5 of the reference's (its cos/sin in another
  library), at the reduced and the full sections;
- ``model_batch`` and ``Model.concrete_batch``: the reference's shapes,
  dtypes and position streams (pos, pos // 4, pos % 4) exactly; the media
  stubs are the port's own draws (its key schedule), so they are held to
  their shape, dtype and determinism, not to JAX's bits;
- the reduced qwen2-vl: prefill logits and decode logits within 1e-4, the
  masked loss (media positions left out) within 1e-5 relative, greedy
  tokens equal.  Decode gives all three M-RoPE streams the token's
  position (the reference's decode, ROADMAP queue 3), so a teacher-forced
  decode equals a media-free prefill whose streams are (pos, pos, pos).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import serving as jserving
from repro.data import pipeline as jpipeline
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import serving as tserving
from repro_torch.data import pipeline
from repro_torch.models import common, convert
from repro_torch.models.model import build_model

ARCH = "qwen2-vl-2b"


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


@pytest.mark.parametrize("hd,sections", [(32, (8, 4, 4)), (128, (16, 24, 24)),
                                         (64, (8, 12, 12))])
def test_apply_mrope_matches_reference(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = np.stack([rng.integers(0, 5000, (2, 40)) for _ in range(3)]).astype(np.int32)
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = common.apply_mrope(_t(x), _t(pos).long(), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # one stream throughout is plain RoPE
    same = np.broadcast_to(pos[0], (3, 2, 40))
    np.testing.assert_array_equal(
        common.apply_mrope(_t(x), _t(same).long(), 1e6, sections).numpy(),
        common.apply_rope(_t(x), _t(pos[0]).long(), 1e6).numpy())
    with pytest.raises(ValueError, match="sum to hd/2"):
        common.apply_mrope(_t(x), _t(pos).long(), 1e6, (1, 2, 3))


def _positions(b, s):
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    return np.stack([pos, pos // 4, pos % 4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_batch_vlm_fields(dtype):
    cfg = get_config(ARCH).reduced(dtype=dtype)
    jcfg = jget_config(ARCH).reduced(dtype=dtype)
    dc = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4, seed=3)
    jdc = jpipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4, seed=3)
    got = pipeline.model_batch(cfg, dc, 2, shard=1, num_shards=2, device="cpu")
    ref = jpipeline.model_batch(jcfg, jdc, 2, shard=1, num_shards=2)
    assert set(got) == set(ref) == {"tokens", "labels", "media", "positions"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
    m = cfg.num_media_tokens
    assert got["tokens"].shape == (2, 24 - m) and got["labels"].shape == (2, 24)
    assert str(got["media"].dtype).split(".")[-1] == ref["media"].dtype.name == dtype
    np.testing.assert_array_equal(got["positions"].numpy(), np.asarray(ref["positions"]))
    np.testing.assert_array_equal(got["positions"].numpy(), _positions(2, 24))
    # the tokens are the LM batch's first seq - M; the draws are deterministic
    lm = pipeline.lm_batch(dc, 2, shard=1, num_shards=2, device="cpu")
    assert torch.equal(got["tokens"], lm["tokens"][:, :24 - m])
    again = pipeline.model_batch(cfg, dc, 2, shard=1, num_shards=2, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = pipeline.model_batch(cfg, dc, 2, shard=0, num_shards=2, device="cpu")
    assert not torch.equal(got["media"], other["media"])
    assert abs(float(got["media"].float().std()) - 1.0) < 0.2


def test_concrete_batch_vlm_fields():
    model = build_model(get_config(ARCH).reduced())
    b = model.concrete_batch(1, 3, 20, "cpu")
    jb = jbuild_model(jget_config(ARCH).reduced()).concrete_batch(jax.random.PRNGKey(1), 3, 20)
    assert {k: tuple(v.shape) for k, v in b.items()} == {k: v.shape for k, v in jb.items()}
    np.testing.assert_array_equal(b["positions"].numpy(), np.asarray(jb["positions"]))
    assert b["media"].dtype == torch.float32


@pytest.fixture(scope="module")
def pair():
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tmodel = build_model(get_config(ARCH).reduced())
    assert convert.flat_order(tmodel.cfg) == list(tparams)
    return jmodel, jparams, tmodel, tparams


def _vlm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    m = cfg.num_media_tokens
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s - m)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "media": rng.standard_normal((b, m, cfg.d_model)).astype(np.float32),
            "positions": _positions(b, s).astype(np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in batch.items()})


def test_prefill_and_masked_loss_match(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _both(_vlm_batch(tmodel.cfg, 2, 32, seed=4))
    with torch.inference_mode():
        pre = tmodel.prefill(tparams, tb)
        loss, parts = tmodel.loss(tparams, tb)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jax.jit(jmodel.prefill)(jparams, jb)),
                               rtol=1e-4, atol=1e-4)
    jl, jparts = jax.jit(jmodel.loss)(jparams, jb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["xent"]), float(jparts["xent"]), rtol=1e-5)
    assert float(parts["moe_aux"]) == 0.0
    # the media positions carry no label: their labels do not move the loss
    tb2 = dict(tb, labels=tb["labels"].clone())
    tb2["labels"][:, :tmodel.cfg.num_media_tokens] = 0
    with torch.inference_mode():
        assert float(tmodel.loss(tparams, tb2)[0]) == float(loss)
        full = tmodel.loss(tparams, dict(tb, mask=torch.ones(tb["labels"].shape)))[0]
    assert float(full) != float(loss)


def test_decode_steps_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, tcache = jmodel.init_cache(2, 10), tmodel.init_cache(2, 10, "cpu")
    with torch.inference_mode():
        for i in range(10):
            jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache)
            tl, tcache = tmodel.decode_step(tparams, _t(toks[:, i:i + 1]).long(), tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                       err_msg=f"position {i}")
        # teacher-forced decode is a media-free prefill with streams (pos, pos, pos)
        bare = build_model(dataclasses.replace(cfg, num_media_tokens=0))
        pos = torch.arange(10).expand(2, 10)
        flat = bare.prefill(tparams, {"tokens": _t(toks).long(),
                                      "positions": torch.stack([pos, pos, pos])})
        split = bare.prefill(tparams, {"tokens": _t(toks).long(),
                                       "positions": _t(_positions(2, 10)).long()})
    np.testing.assert_allclose(tl[:, 0].numpy(), flat.numpy(), rtol=1e-4, atol=1e-4)
    assert float((tl[:, 0] - split).abs().max()) > 1e-3


def test_greedy_tokens_match_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    prompts = np.random.default_rng(6).integers(0, tmodel.cfg.vocab_size, (2, 6))
    prompts = prompts.astype(np.int32)
    jgen, _ = jserving.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 5)
    tgen, _ = tserving.greedy_decode(tmodel, tparams, _t(prompts).long(), 5)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


def test_protocol_inference_carries_media_and_positions():
    """A VLM request through the Protocol Model server carries its media
    stubs and M-RoPE streams; the launcher's reduced head dim (64) keeps
    the split's proportions, (8, 12, 12)."""
    from repro_torch.launch import protocol_inference
    out = protocol_inference.main(["--device", "cpu", "--arch", ARCH, "--seq", "16",
                                   "--batch", "2"])
    cfg, batch = out["model"].cfg, out["batch"]
    assert cfg.mrope_sections == (8, 12, 12) and cfg.resolved_head_dim == 64
    assert batch["tokens"].shape == (2, 16 - cfg.num_media_tokens)
    assert batch["media"].shape == (2, cfg.num_media_tokens, cfg.d_model)
    assert batch["positions"].shape == (3, 2, 16) and "labels" not in batch
    assert torch.equal(out["logits"], out["ref"])
    with torch.inference_mode():
        bare = out["model"].prefill(out["params"], {k: batch[k] for k in ("tokens", "positions")}
                                    | {"media": torch.zeros_like(batch["media"])})
    assert not torch.equal(bare, out["ref"])            # the media reach the logits
