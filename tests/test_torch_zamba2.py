"""The port's zamba2 against the JAX reference: the SSD scan (the kernel's
plain version against the reference's Pallas kernel in interpret mode and
its token recurrence), the two routes' twins, the blockwise full attention
of the shared block, prefill on both routes, loss, decode, greedy tokens and
the Protocol Model server, at a reduced width that has both group and
remainder layers (3 mamba layers, 2 a group: one group and one remainder;
d 128, 8 SSD heads of 32, state 16).

Inputs are drawn with numpy from a seed and handed to both sides; weights
are the reference's, carried across with ``params_from_jax``.  Tolerances:

- the SSD in float32: 1e-4 against the Pallas kernel, the token
  recurrence and (under strong decay) a float64 recurrence: float sums in
  another order, and chunks of 32 with a padded end where the reference
  shrinks its chunk to a divisor of S;
- the blockwise attention: 1e-5 against the reference's and its naive
  oracle (float32 sums in another order);
- the model in float32: logits, caches and loss within 1e-4;
- the model in bfloat16: logits, caches and loss within 1e-2 relative
  (3.4e-3 measured), with torch's silu rounded as XLA rounds it on the
  CPU.  XLA evaluates a bf16 silu as x * 1/(1 + exp(-x)), rounding
  exp(-x), the sum, the quotient and the product to bf16 each; torch
  rounds silu once.  The port keeps torch's silu; the tests give it XLA's
  roundings (``like_xla``), because the random model's sharp softmax
  carries that one rounding far: without it the logits part by up to
  2.2e-2 in prefill and 0.26 over 40 decode steps.

The CUDA kernel is held against its plain version on the card in
``tests/test_torch_package.py`` (which imports no JAX).
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
from repro.core.ledger import Ledger as JLedger
from repro.data import pipeline as jdata
from repro.kernels.mamba2_scan.ops import ssd_chunked_pallas
from repro.models import attention as jattn
from repro.models import mamba2 as jmamba2
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import protocol as tprotocol
from repro_torch.core import serving as tserving
from repro_torch.core.ledger import Ledger
from repro_torch.data import pipeline as tdata
from repro_torch.kernels.mamba2_scan import ops
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import hybrid as thybrid
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models.common import rms_norm
from repro_torch.models.model import build_model
from test_torch_decentralized import one_thread  # noqa: F401

ARCH = "zamba2-1.2b"
SMALL = dict(num_layers=3, mamba_per_group=2)    # one group of 2, one remainder layer


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ssd_inputs(bsz, s, h, p, n, seed=0, strong=False):
    """x, dt, a, b, c, d_skip as tests/test_kernels.py draws them (dt =
    softplus(normal), a = -exp(normal / 2)); ``strong``: dt near 4 and a
    near -8, so a·Δ sums to about -1,000 over a chunk of 32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    shift = 4.0 if strong else 0.0
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)) + shift)).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5) * (8.0 if strong else 1.0)).astype(np.float32)
    b = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    d = rng.uniform(0.0, 1.0, h).astype(np.float32)
    return x, dt, a, b, c, d


def _recurrence64(x, dt, a, b, c, d, h0=None):
    """The token recurrence in float64 (numpy)."""
    bsz, s, h, p = x.shape
    st = np.zeros((bsz, h, p, b.shape[-1])) if h0 is None else h0.astype(np.float64)
    ys = np.zeros((bsz, s, h, p))
    for t in range(s):
        xt, dtt = x[:, t].astype(np.float64), dt[:, t].astype(np.float64)
        st = st * np.exp(a * dtt)[..., None, None] + np.einsum(
            "bhp,bn,bh->bhpn", xt, b[:, t].astype(np.float64), dtt)
        ys[:, t] = np.einsum("bn,bhpn->bhp", c[:, t].astype(np.float64), st) + xt * d[:, None]
    return ys, st


# -- the SSD --------------------------------------------------------------------------
@pytest.mark.parametrize("bsz,s,h,p,n,chunk,with_h0", [
    (2, 64, 3, 16, 8, 16, False),      # tests/test_kernels.py's cases
    (1, 128, 2, 32, 16, 32, False),
    (1, 60, 1, 8, 4, 16, False),       # seq not a multiple of chunk
    (1, 97, 2, 16, 16, 32, False),     # a prime S: the reference's chunk shrinks to 1
    (2, 48, 2, 16, 16, 16, True),      # a non-zero initial state
    (1, 1, 2, 32, 16, 16, True),       # one token
])
def test_ssd_plain_matches_jax_kernel_and_reference(bsz, s, h, p, n, chunk, with_h0):
    args = _ssd_inputs(bsz, s, h, p, n)
    h0 = (np.random.default_rng(1).standard_normal((bsz, h, p, n)).astype(np.float32)
          if with_h0 else None)
    jargs = [jnp.asarray(t) for t in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jh = ssd_chunked_pallas(*jargs, chunk=chunk, h0=jh0, interpret=True)
    ry, rh = jmamba2.ssd_reference(*jargs, h0=jh0)
    targs = [torch.from_numpy(t) for t in args]
    th0 = None if h0 is None else torch.from_numpy(h0)
    ty, th = ops.ssd_plain(*targs, th0)
    assert ty.dtype == torch.float32 and ty.shape == (bsz, s, h, p)
    assert th.dtype == torch.float32 and th.shape == (bsz, h, p, n)
    for wy, wh in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(th.numpy(), np.asarray(wh), rtol=1e-4, atol=1e-4)
    if p % 16 == 0 and n % 16 == 0:     # the wrapper on CPU tensors is the plain version
        wy2, wh2 = ops.ssd(*targs, th0)
        assert torch.equal(wy2, ty) and torch.equal(wh2, th)


@pytest.mark.parametrize("s,with_h0", [(96, True), (61, False)])
def test_ssd_plain_under_strong_decay(s, with_h0):
    """a·Δ summing to about -1,000 over a chunk (below -100 on every
    chunk): every factor the SSD form uses on and below the diagonal is
    exp(<= 0), and above it the band is selected before any product, so
    it stays finite and within 1e-4 of a float64 recurrence, of the
    reference's Pallas kernel and of its token recurrence."""
    args = _ssd_inputs(1, s, 2, 16, 16, seed=3, strong=True)
    _, dt, a = args[:3]
    adt = (a * dt[0])[: (s // 32) * 32].reshape(-1, 32, 2)
    assert float(adt.sum(1).max()) < -100          # every full chunk, every head
    h0 = (np.random.default_rng(4).standard_normal((1, 2, 16, 16)).astype(np.float32)
          if with_h0 else None)
    want_y, want_h = _recurrence64(*args, h0)
    ty, th = ops.ssd_plain(*(torch.from_numpy(t) for t in args),
                           None if h0 is None else torch.from_numpy(h0))
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    assert _rel(ty.numpy(), want_y) <= 1e-4 and _rel(th.numpy(), want_h) <= 1e-4
    jargs = [jnp.asarray(t) for t in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    for wy, wh in (ssd_chunked_pallas(*jargs, chunk=32, h0=jh0, interpret=True),
                   jmamba2.ssd_reference(*jargs, h0=jh0)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(th.numpy(), np.asarray(wh), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_twins_match_jax(chunk):
    """The port's ssd_chunked and ssd_reference against the reference's,
    in float32 and with bf16 x, b and c (each side rounds as its twin)."""
    x, dt, a, b, c, d = _ssd_inputs(2, 48, 2, 16, 8, seed=2)
    h0 = np.random.default_rng(3).standard_normal((2, 2, 16, 8)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jx, jb, jc = (jnp.asarray(t).astype(jdt) for t in (x, b, c))
        tx, tb, tc = (torch.from_numpy(t).to(tdt) for t in (x, b, c))
        j_rest = [jnp.asarray(t) for t in (dt, a)]
        t_rest = [torch.from_numpy(t) for t in (dt, a)]
        jy, jh = jmamba2.ssd_chunked(jx, *j_rest, jb, jc, jnp.asarray(d), chunk=chunk,
                                     h0=jnp.asarray(h0))
        ty, th = tmamba2.ssd_chunked(tx, *t_rest, tb, tc, torch.from_numpy(d), chunk=chunk,
                                     h0=torch.from_numpy(h0))
        assert ty.dtype == tdt
        tol = 1e-5 if tdt == torch.float32 else 1e-2
        np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        jy, jh = jmamba2.ssd_reference(jx, *j_rest, jb, jc, jnp.asarray(d))
        ty, th = tmamba2.ssd_reference(tx, *t_rest, tb, tc, torch.from_numpy(d))
        np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_bf16_cb_rounding_of_the_jnp_route():
    """In bf16 the reference's jnp route rounds C·Bᵀ to bf16 (an einsum of
    two bf16 operands gives bf16) and its kernel route casts B and C to
    float32 first.  The port keeps both: its ssd_chunked and ssd_plain part
    as the reference's two routes do.  In float32 the two routes agree."""
    x, dt, a, b, c, d = _ssd_inputs(1, 256, 4, 32, 16, seed=5)
    bf = jnp.bfloat16
    jargs = (jnp.asarray(x).astype(bf), jnp.asarray(dt), jnp.asarray(a),
             jnp.asarray(b).astype(bf), jnp.asarray(c).astype(bf), jnp.asarray(d))
    targs = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt), torch.from_numpy(a),
             torch.from_numpy(b).bfloat16(), torch.from_numpy(c).bfloat16(),
             torch.from_numpy(d))
    jy_j, jh_j = jmamba2.ssd_chunked(*jargs, chunk=256)
    jy_k, _ = ssd_chunked_pallas(*jargs, chunk=256, interpret=True)
    ty_j, th_j = tmamba2.ssd_chunked(*targs, chunk=256)
    ty_k, _ = ops.ssd_plain(*targs)
    jgap, tgap = _rel(_f32(jy_j), _f32(jy_k)), _rel(_f32(ty_j), _f32(ty_k))
    # the size: about one bf16 rounding of C·Bᵀ (2^-9 relative) carried into y
    assert 1e-3 < jgap < 1e-2 and 1e-3 < tgap < 1e-2, (jgap, tgap)
    assert abs(tgap - jgap) <= 0.2 * jgap, (tgap, jgap)
    # each route matches its counterpart more closely than the routes match;
    # the state update reads B unrounded on both routes
    assert _rel(_f32(ty_j), _f32(jy_j)) < 0.1 * jgap
    assert _rel(_f32(ty_k), _f32(jy_k)) < 0.1 * jgap
    assert _rel(th_j.numpy(), np.asarray(jh_j)) <= 1e-5
    f32 = [torch.from_numpy(t) for t in (x, dt, a, b, c, d)]
    assert _rel(tmamba2.ssd_chunked(*f32, chunk=256)[0].numpy(),
                ops.ssd_plain(*f32)[0].numpy()) <= 1e-5


def test_ssd_wrapper_checks_its_inputs():
    x, dt, a, b, c, d = (torch.from_numpy(t) for t in _ssd_inputs(1, 8, 2, 16, 16))
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.ssd(x[..., :8], dt, a, b, c, d)
    with pytest.raises(ValueError, match="state size N"):
        ops.ssd(x, dt, a, b[..., :8], c[..., :8], d)
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd(x, dt[..., :1], a, b, c, d)
    with pytest.raises(ValueError, match="h0 must be"):
        ops.ssd(x, dt, a, b, c, d, torch.zeros(1, 2, 16, 8))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ops.ssd(x.half(), dt, a, b.half(), c.half(), d)
    with pytest.raises(TypeError, match="dt in float32"):
        ops.ssd(x, dt.double(), a, b, c, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_kernel(x, dt, a, b, c, d)


# -- the shared block's full attention ------------------------------------------------
@pytest.mark.parametrize("sq,hq,hkv,q_block,kv_block,causal", [
    (64, 4, 2, 16, 16, True),        # 4 x 4 blocks, GQA
    (64, 4, 2, 16, 8, True),         # kv blocks smaller than q blocks
    (48, 4, 1, 32, 16, True),        # q_block halves to 16 to divide 48; MQA
    (64, 2, 2, 8, 32, False),        # not causal: every block visited
    (40, 4, 2, 64, 64, False),       # one block of each
])
def test_full_attention_matches_jax_blockwise(sq, hq, hkv, q_block, kv_block, causal):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, sq, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, hkv, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = tattn.attention(tq, tk, tv, causal=causal, q_block=q_block, kv_block=kv_block)
    want = jattn.attention(jq, jk, jv, causal=causal, q_block=q_block, kv_block=kv_block)
    oracle = jattn.reference_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), tattn.reference_attention(tq, tk, tv, causal=causal).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_attention_at_one_block_is_unchanged(dtype):
    """At one block (protocol-125m's 128 tokens) the blockwise attention
    gives the bits of the single einsum-softmax-einsum it replaced."""
    g = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((2, 128, 4, 32), generator=g).to(dtype) for _ in range(3))
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(2, 128, 4, 1, 32).float(),
                     k.float()) * 32 ** -0.5
    pos = torch.arange(128)
    s = torch.where(pos[:, None] >= pos[None, :], s, torch.full((), tattn.NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    pv = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    old = (pv / torch.clamp(torch.sum(p, dim=-1).permute(0, 3, 1, 2), min=1e-30)[..., None]
           ).reshape(2, 128, 4, 32).to(dtype)
    assert torch.equal(tattn.attention(q, k, v, causal=True), old)


# -- the model ------------------------------------------------------------------------
def _pair(dtype="float32", **overrides):
    """(JAX model, JAX params, port model, port params), reduced."""
    kw = {**SMALL, "dtype": dtype, **overrides}
    jmodel = jbuild_model(jget_config(ARCH).reduced(**kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, build_model(get_config(ARCH).reduced(**kw)), tparams


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def zamba_params(request):
    return _pair(request.param)


def _xla_silu(x, _silu=torch.nn.functional.silu):
    """silu rounded as XLA rounds it on the CPU in bf16 (see above)."""
    if x.dtype != torch.bfloat16:
        return _silu(x)
    e = torch.exp(-x.float()).to(torch.bfloat16).float()
    return x * (1.0 / (1.0 + e).to(torch.bfloat16).float()).to(torch.bfloat16)


@pytest.fixture
def zamba(zamba_params, monkeypatch):
    """The pair, with torch's silu rounded like XLA's for this test."""
    monkeypatch.setattr(torch.nn.functional, "silu", _xla_silu)
    return zamba_params


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _jax_names(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(p.key for p in path) for path, _ in paths]


def test_leaves_match_jax(zamba):
    jmodel, jparams, tmodel, tparams = zamba
    assert thybrid.group_counts(tmodel.cfg) == (1, 1)
    assert convert.flat_order(tmodel.cfg) == _jax_names(jparams) == list(tparams)
    mine = tmodel.init(0, "cpu")
    for (name, want), got in zip(zip(_jax_names(jparams), jax.tree.leaves(jparams)),
                                 (mine[n] for n in convert.flat_order(tmodel.cfg))):
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    np.testing.assert_array_equal(
        _f32(convert.flatten(tparams)),
        np.concatenate([_f32(l).reshape(-1) for l in jax.tree.leaves(jparams)]))


def test_init_draws_the_reference_distributions():
    cfg = get_config(ARCH).reduced(num_layers=4, mamba_per_group=2, d_model=256)
    p = thybrid.init_params(3, cfg, torch.device("cpu"))
    assert p["groups.mamba.in_proj"].shape == (2, 2, 256, 2 * 512 + 2 * 16 + 16)
    assert "rem.ln" not in p                     # 4 = 2 groups of 2, no remainder
    assert bool((p["groups.mamba.a_log"] == 0).all())
    assert bool((p["groups.mamba.d_skip"] == 1).all())
    dtb = p["groups.mamba.dt_bias"]
    assert bool(((dtb >= -4) & (dtb < -2)).all()) and abs(float(dtb.mean()) + 3) < 0.2
    # truncated normal at +-2: std 0.88 of the scale
    assert abs(float(p["groups.mamba.conv_w"].std()) - 0.88 * 0.5) < 0.02
    assert abs(float(p["groups.mamba.in_proj"].std()) - 0.88 / 16) < 0.003
    assert abs(float(p["shared.attn.wq"].std()) - 0.88 / 2) < 0.02      # fan-in H = 4
    for name in ("ln_f", "groups.ln", "shared.ln_attn", "shared.ln_ffn"):
        assert bool((p[name] == 1).all())


def test_param_count_at_full_width():
    """The params built hold 1,170,157,696 parameters, as the reference's
    tree does; ``param_count()`` (a copy of the reference's formula) counts
    2 per head for a_log and d_skip and omits dt_bias, 38 x 64 = 2,432
    fewer: 1,170,155,264."""
    cfg = get_config(ARCH)
    built = sum(int(np.prod(s)) for s, _ in thybrid.param_shapes(cfg).values())
    jshapes = jbuild_model(jget_config(ARCH)).param_shapes()
    assert built == sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jshapes)) \
        == 1_170_157_696
    assert cfg.param_count() == jget_config(ARCH).param_count() == 1_170_155_264
    assert thybrid.group_counts(cfg) == (6, 2)


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 1e-2


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seq", [64, 45])
def test_prefill_matches_jax(zamba, use_kernel, seq):
    """Both routes: ``ssd_chunked`` (flag off) and the kernel's plain
    version against the Pallas kernel in interpret mode (flag on)."""
    jmodel, jparams, tmodel, tparams = zamba
    jmodel = jbuild_model(dataclasses.replace(jmodel.cfg, use_pallas_kernels=use_kernel))
    tmodel = build_model(dataclasses.replace(tmodel.cfg, use_pallas_kernels=use_kernel))
    toks = _tokens((2, seq), tmodel.cfg.vocab_size)
    ref = np.asarray(jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}))
    with torch.inference_mode():
        got = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, tmodel.cfg.vocab_size) and got.dtype == torch.float32
    if tmodel.cfg.dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got.numpy(), ref) <= _tol("bfloat16")


def test_loss_matches_jax(zamba):
    jmodel, jparams, tmodel, tparams = zamba
    dcfg = jdata.DataConfig(vocab_size=tmodel.cfg.vocab_size, seq_len=32, global_batch=4)
    jbatch = jdata.model_batch(jmodel.cfg, dcfg, 2)
    tbatch = {k: torch.from_numpy(np.array(v)).long() for k, v in jbatch.items()}
    jloss = float(jmodel.loss(jparams, jbatch)[0])
    tloss, aux = tmodel.loss(tparams, tbatch)
    assert abs(float(tloss) - jloss) <= _tol(tmodel.cfg.dtype) * abs(jloss)
    assert float(aux["xent"]) == float(tloss)
    # the hybrid family takes the LM batch, as in the reference
    tb = tdata.model_batch(tmodel.cfg, tdata.DataConfig(512, 16, 2), 0, device="cpu")
    assert set(tb) == {"tokens", "labels"} and tb["tokens"].shape == (2, 16)
    cb = tmodel.concrete_batch(0, 2, 12, "cpu")
    assert cb["tokens"].shape == cb["labels"].shape == (2, 12)


def test_decode_steps_match_jax(zamba):
    """40 tokens through decode_step: the logits at every position and the
    caches (SSD states, conv buffers, the shared block's K/V) match the
    reference's.  In float32 the last position matches the prefill on
    both routes."""
    jmodel, jparams, tmodel, tparams = zamba
    f32 = tmodel.cfg.dtype == "float32"
    toks = _tokens((2, 40), tmodel.cfg.vocab_size, seed=2)
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(2, 40)
    tcache = tmodel.init_cache(2, 40, "cpu")
    pairs = [(tcache["mamba_g"]["h"], "mamba_g", "h"),
             (tcache["mamba_g"]["conv"], "mamba_g", "conv"),
             (tcache["mamba_rem"]["h"], "mamba_rem", "h"),
             (tcache["mamba_rem"]["conv"], "mamba_rem", "conv"),
             (tcache["attn_k"], "attn_k", None), (tcache["attn_v"], "attn_v", None)]

    def jleaf(c, a, b):
        return c[a] if b is None else c[a][b]

    for t, a, b in pairs:
        want = jleaf(jcache, a, b)
        assert tuple(t.shape) == want.shape and str(t.dtype).split(".")[-1] == str(want.dtype)
    tol = _tol(tmodel.cfg.dtype)
    with torch.inference_mode():
        for i in range(40):
            jl, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache)
            tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]).long(),
                                            tcache)
            if f32:
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4,
                                           err_msg=f"position {i}")
            else:
                assert _rel(tl.numpy(), np.asarray(jl)) <= tol, f"position {i}"
        assert tcache["pos"] == int(jcache["pos"]) == 40
        for t, a, b in pairs:
            assert _rel(_f32(t), _f32(jleaf(jcache, a, b))) <= tol, (a, b)
        scan_logits, _ = tmodel.decode_scan(tparams, torch.from_numpy(toks).long(),
                                            tmodel.init_cache(2, 40, "cpu"))
        np.testing.assert_array_equal(scan_logits[:, -1].numpy(), tl[:, 0].numpy())
        if f32:
            for flag in (False, True):
                m = build_model(dataclasses.replace(tmodel.cfg, use_pallas_kernels=flag))
                prefilled = m.prefill(tparams, {"tokens": torch.from_numpy(toks).long()})
                np.testing.assert_allclose(tl[:, 0].numpy(), prefilled.numpy(),
                                           rtol=1e-4, atol=1e-4)


def test_decode_states_match_the_kernel_prefill():
    """In float32 the SSD state each mamba layer's decode reaches after the
    prompt equals the kernel route's h_final (``mamba_block_state``), layer
    by layer on the prefill's inputs, within 1e-4."""
    _, _, tmodel, tparams = _pair(use_pallas_kernels=True)
    cfg = tmodel.cfg
    toks = torch.from_numpy(_tokens((2, 37), cfg.vocab_size, seed=9)).long()
    with torch.inference_mode():
        _, cache = tmodel.decode_scan(tparams, toks, tmodel.init_cache(2, 37, "cpu"))
        x = torch.nn.functional.embedding(toks, tparams["embed"])
        groups, rem = thybrid.mamba_layers(tparams, cfg)
        lp = groups[0]
        _, h_final = tmamba2.mamba_block_state(
            lp, cfg, rms_norm(x, lp["ln"], cfg.norm_eps))
    assert _rel(cache["mamba_g"]["h"][0, 0].numpy(), h_final.numpy()) <= 1e-4


# -- serving --------------------------------------------------------------------------
def test_greedy_decode_tokens_match_jax():
    jmodel, jparams, tmodel, tparams = _pair()
    prompts = _tokens((2, 10), tmodel.cfg.vocab_size, seed=3)
    jgen, _ = jserving.greedy_decode(jmodel, jparams, jnp.asarray(prompts), 8)
    gen, stats = tserving.greedy_decode(tmodel, tparams, torch.from_numpy(prompts).long(), 8)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    assert stats.tokens_out == 8 and stats.batch == 2


def test_protocol_server_on_zamba2():
    """Served logits bit-equal to the port's prefill and within 1e-4 of the
    reference's, with the kernel flag set on both sides; the refusal, one
    node offline, the missing shard ids, and greedy tokens equal."""
    jmodel, jparams, tmodel, tparams = _pair(use_pallas_kernels=True)
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
    with torch.inference_mode():
        assert torch.equal(logits, tmodel.prefill(tparams, batch))
    jlogits = jsrv.serve("n0", {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert torch.equal(srv.serve("n0", batch, online_nodes=nodes[:-1]), logits)
    with pytest.raises(tprotocol.ExtractionError, match="missing shard ids"):
        srv.serve("n0", batch, online_nodes=nodes[:1])
    gen, _ = srv.decode("n0", torch.zeros((2, 4), dtype=torch.long), 3)
    jgen, _ = jsrv.decode("n0", jnp.zeros((2, 4), jnp.int32), 3)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
