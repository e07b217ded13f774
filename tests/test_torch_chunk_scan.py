"""The plain versions of the two chunk-parallel scan kernels (``wkv_plain``,
``ssd_plain``: chunks of 64 tokens, the WKV's sub-chunks of 16) against the
JAX reference's Pallas kernels in interpret mode (``wkv_chunked_pallas``,
``ssd_chunked_pallas``), its token recurrences (``wkv_reference``,
``ssd_reference``) and a float64 token recurrence, at small widths.

Lengths S = 63, 64, 65 and 197 (one chunk less a token, one chunk, one
more token, three chunks and 5 tokens), model-like and strong decays, a
non-zero initial state.  Everything in float32, within 1e-4 relative L2
(y and the final state): the same function with sums in another order.
Under strong decay the Pallas WKV is run with chunks short enough for its
exp(-cs) form to stay finite.

The bf16-operand control (``bf16_operands=True``, each float32 operand of
the kernels' tensor-core products rounded to bfloat16, the single-pass
design) is shown to land far from the plain version where the plain
version lands near the float64 recurrence: the gap the card's checks use
to tell the kernels' hi/lo split from a single bf16 pass.

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_package.py`` (which imports no JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.ops import ssd_chunked_pallas
from repro.kernels.rwkv6_wkv.ops import wkv_chunked_pallas
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops


def _lengths(chunk):
    """S at a chunk's boundaries: one chunk less a token, one chunk, one
    more token, three chunks and 5 tokens (63, 64, 65, 197 at 64)."""
    return [chunk - 1, chunk, chunk + 1, 3 * chunk + 5]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _wkv_inputs(bsz, s, h, dk, seed, strong):
    """r, k, v, w, u as tests/test_kernels.py draws them (w in [0.45,
    0.95]), or with strong decays (w in [0.05, 0.95]), and s0."""
    rng = np.random.default_rng(seed)
    shape = (bsz, s, h, dk)
    r = rng.standard_normal(shape).astype(np.float32) * 0.5
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32)
    if strong:
        w = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    else:
        w = (0.5 / (1 + np.exp(1 - rng.standard_normal(shape))) + 0.45).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((bsz, h, dk, dk)).astype(np.float32)
    return (r, k, v, w, u), s0


def _wkv64(r, k, v, w, u, s0):
    """The WKV token recurrence in float64 (numpy)."""
    st = s0.astype(np.float64)
    ys = np.zeros(r.shape)
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (x[:, t].astype(np.float64) for x in (r, k, v, w))
        ys[:, t] = np.einsum("bhk,bhkv->bhv", rt, st) + np.sum(rt * u * kt, -1, keepdims=True) * vt
        st = st * wt[..., None] + np.einsum("bhk,bhv->bhkv", kt, vt)
    return ys, st


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("s", _lengths(wkv_ops.CHUNK))
def test_wkv_plain_at_chunk_boundaries(s, strong):
    (r, k, v, w, u), s0 = _wkv_inputs(2, s, 2, 16, seed=s, strong=strong)
    ty, ts = wkv_ops.wkv_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                               torch.from_numpy(s0))
    assert ty.shape == (2, s, 2, 16) and ts.shape == (2, 2, 16, 16)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(ts).all())
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    # the Pallas form scales k by exp(-cs): chunks of 16 keep it finite under strong decay
    pallas = wkv_chunked_pallas(*jargs, chunk=16 if strong else 64, s0=jnp.asarray(s0),
                                interpret=True)
    for wy, ws in (pallas, jrwkv6.wkv_reference(*jargs, s0=jnp.asarray(s0)),
                   _wkv64(r, k, v, w, u, s0)):
        assert _rel(ty.numpy(), np.asarray(wy)) <= 1e-4
        assert _rel(ts.numpy(), np.asarray(ws)) <= 1e-4
    wy2, ws2 = wkv_ops.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u)), torch.from_numpy(s0))
    assert torch.equal(wy2, ty) and torch.equal(ws2, ts)   # CPU tensors: the plain version


def _ssd_inputs(bsz, s, h, p, n, seed, strong):
    """x, dt, a, b, c, d_skip as tests/test_kernels.py draws them, or with
    strong decays (dt near 4, a near -8: a·Δ about -32 a token), and h0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)) + (4.0 if strong else 0.0))
                  ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5) * (8.0 if strong else 1.0)).astype(np.float32)
    b = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    d = rng.uniform(0.0, 1.0, h).astype(np.float32)
    h0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return (x, dt, a, b, c, d), h0


def _ssd64(x, dt, a, b, c, d, h0):
    """The SSD token recurrence in float64 (numpy)."""
    st = h0.astype(np.float64)
    ys = np.zeros(x.shape)
    for t in range(x.shape[1]):
        xt, dtt = x[:, t].astype(np.float64), dt[:, t].astype(np.float64)
        st = st * np.exp(a * dtt)[..., None, None] + np.einsum(
            "bhp,bn,bh->bhpn", xt, b[:, t].astype(np.float64), dtt)
        ys[:, t] = np.einsum("bn,bhpn->bhp", c[:, t].astype(np.float64), st) + xt * d[:, None]
    return ys, st


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("s", _lengths(ssd_ops.CHUNK))
def test_ssd_plain_at_chunk_boundaries(s, strong):
    args, h0 = _ssd_inputs(2, s, 3, 16, 32, seed=s, strong=strong)
    ty, th = ssd_ops.ssd_plain(*(torch.from_numpy(t) for t in args), torch.from_numpy(h0))
    assert ty.shape == (2, s, 3, 16) and th.shape == (2, 3, 16, 32)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    jargs = [jnp.asarray(t) for t in args]
    for wy, wh in (ssd_chunked_pallas(*jargs, chunk=64, h0=jnp.asarray(h0), interpret=True),
                   jmamba2.ssd_reference(*jargs, h0=jnp.asarray(h0)),
                   _ssd64(*args, h0)):
        assert _rel(ty.numpy(), np.asarray(wy)) <= 1e-4
        assert _rel(th.numpy(), np.asarray(wh)) <= 1e-4
    wy2, wh2 = ssd_ops.ssd(*(torch.from_numpy(t) for t in args), torch.from_numpy(h0))
    assert torch.equal(wy2, ty) and torch.equal(wh2, th)   # CPU tensors: the plain version


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("strong", [False, True])
def test_wkv_bf16_operand_control_is_far_from_plain(strong):
    """On inputs that are bf16 values: the plain version within 1e-5 of the
    float64 recurrence, the control at least 5e-4 from the plain version."""
    (r, k, v, w, u), s0 = _wkv_inputs(1, 197, 2, 32, seed=7, strong=strong)
    r, k, v, w = (_bf16(t) for t in (r, k, v, w))
    targs = [torch.from_numpy(t) for t in (r, k, v, w, u)]
    ty, ts = wkv_ops.wkv_plain(*targs, torch.from_numpy(s0))
    cy, cs = wkv_ops.wkv_plain(*targs, torch.from_numpy(s0), bf16_operands=True)
    want_y, want_s = _wkv64(r, k, v, w, u, s0)
    assert _rel(ty.numpy(), want_y) <= 1e-5 and _rel(ts.numpy(), want_s) <= 1e-5
    assert _rel(cy.numpy(), ty.numpy()) >= 5e-4 and _rel(cs.numpy(), ts.numpy()) >= 5e-4


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_bf16_operand_control_is_far_from_plain(strong):
    """On inputs that are bf16 values: the plain version within 1e-5 of the
    float64 recurrence, the control at least 5e-4 from the plain version."""
    (x, dt, a, b, c, d), h0 = _ssd_inputs(1, 197, 3, 16, 32, seed=7, strong=strong)
    x, b, c = (_bf16(t) for t in (x, b, c))
    targs = [torch.from_numpy(t) for t in (x, dt, a, b, c, d)]
    ty, th = ssd_ops.ssd_plain(*targs, torch.from_numpy(h0))
    cy, ch = ssd_ops.ssd_plain(*targs, torch.from_numpy(h0), bf16_operands=True)
    want_y, want_h = _ssd64(x, dt, a, b, c, d, h0)
    assert _rel(ty.numpy(), want_y) <= 1e-5 and _rel(th.numpy(), want_h) <= 1e-5
    assert _rel(cy.numpy(), ty.numpy()) >= 5e-4 and _rel(ch.numpy(), th.numpy()) >= 5e-4
