"""The port's wire codecs and the QSGD encode kernel's plain version against
the JAX reference.

The reference keys its draws; the port takes the draws themselves, so each
test draws JAX's uniforms or normals and hands the same numbers to both
sides.  Equalities, after ``docs/kernels.md``:

- QSGD codes are exact given the same norm(s) and uniforms: the plain
  version repeats the Pallas kernel's expressions (``qsgd/kernel.py:30-38``)
  op for op, in float32; the reference's Pallas kernel runs in interpret
  mode;
- decoded values: the reference test's own bound (1e-6 relative, 1e-7
  absolute), as the norms are float sums in another order;
- top-k: values and bits equal, indices equal as sets (random normal data:
  no ties in |x|), error-feedback residual equal;
- PowerSGD: the reconstruction p·qᵀ within 1e-5 relative L2 (QR's column
  signs may differ from XLA's; the reconstruction does not depend on them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels.qsgd import kernel as jqkernel
from repro.kernels.qsgd import ops as jqops
from repro.kernels.qsgd.ref import qsgd_roundtrip_ref
from repro.kernels.qsgd_decode import ops as jqdec
from repro_torch.core import compression as tcomp
from repro_torch.kernels.qsgd import ops as tq
from repro_torch.kernels.qsgd_decode import ops as tqdec

SHAPES = [(1000,), (128, 128), (7,), (3, 5, 17)]
LEVELS = [16, 64, 127]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _lanes_case(shape, levels):
    """x, its (R, 128) uniforms and global norm, as the reference's kernel
    test draws them."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(jax.random.PRNGKey(1), shape) * 3
    x2d, _ = jqops._to_lanes(x)
    rnd = jax.random.uniform(key, x2d.shape, jnp.float32)
    return key, x, x2d, rnd, jnp.linalg.norm(x2d)


# ================================ QSGD encode ==================================
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("levels", LEVELS)
def test_qsgd_encode_plain_code_equal_to_pallas_kernel(shape, levels):
    """Given the reference's uniforms and norm, the plain version (and the
    dispatcher on a CPU tensor) gives the Pallas kernel's int8 codes."""
    key, x, x2d, rnd, norm = _lanes_case(shape, levels)
    ref = np.asarray(jqkernel.qsgd_encode_fwd(x2d, rnd, norm, levels=levels,
                                              interpret=True))
    args = (_t(x).reshape(-1), _t(rnd), torch.tensor([float(norm)]))
    out = tq.qsgd_encode_plain(*args, levels=levels, bucket_size=x2d.size)
    assert out.dtype == torch.int8 and tuple(out.shape) == x2d.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tq.qsgd_encode_buckets(*args, levels=levels, bucket_size=x2d.size).numpy(), ref)
    assert tq.LAUNCHES["qsgd_encode"] == 0          # the CPU never launches


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("levels", LEVELS)
def test_qsgd_surface_matches_reference(shape, levels):
    """The global-norm surface: codes equal to the reference's oracle, the
    round trip within the reference test's own bound of
    ``qsgd_roundtrip_ref``, and the same wire bits."""
    key, x, x2d, rnd, norm = _lanes_case(shape, levels)
    codes, tnorm = tq.qsgd_encode(_t(x), _t(rnd), levels=levels)
    np.testing.assert_allclose(float(tnorm), float(norm), rtol=1e-6)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jqkernel.qsgd_encode_fwd(
        x2d, rnd, norm, levels=levels, interpret=True)))
    got = tq.qsgd_roundtrip(_t(x), _t(rnd), levels=levels).numpy()
    np.testing.assert_allclose(got, np.asarray(qsgd_roundtrip_ref(key, x, levels=levels)),
                               rtol=1e-6, atol=1e-7)
    assert got.shape == shape and tq.wire_bits(_t(x)) == jqops.wire_bits(x)


def test_single_bucket_regime_matches_reference():
    """The predicate on the reference's pinned table and on a sweep."""
    table = [(100, 128, True), (128, 128, True), (129, 256, True), (1000, 1024, True),
             (129, 128, False), (512, 128, False), (100, 256, False), (1025, 1024, False)]
    for size, bucket, want in table:
        assert tq.single_bucket_regime(size, bucket_size=bucket) is want
    for size in range(1, 1100, 7):
        for bucket in (128, 256, 512, 1024):
            assert tq.single_bucket_regime(size, bucket_size=bucket) == \
                jqops.single_bucket_regime(size, bucket_size=bucket)


@pytest.mark.parametrize("size,bucket", [(100, 128), (128, 128), (129, 256), (1000, 1024)])
@pytest.mark.parametrize("levels", LEVELS)
def test_qsgd_surface_equals_bucketed_wire_in_single_bucket_regime(size, bucket, levels):
    """One bucket spanning the lane-padded tensor: the surface and the
    bucketed wire quantize with the same numbers (the uniforms of (R, 128)
    are those of (1, R·128)), so they reconstruct within an ulp of
    norm/levels — the reference's own bound — of each other and of the
    reference's wire codec."""
    key = jax.random.PRNGKey(size + levels)
    x = jax.random.normal(jax.random.PRNGKey(0), (size,)) * 2
    rows = -(-size // tq.LANE)
    u = jax.random.uniform(key, (rows, tq.LANE), jnp.float32)
    kern = tq.qsgd_roundtrip(_t(x), _t(u), levels=levels).numpy()
    wire = tcomp.roundtrip("qsgd", _t(u).reshape(1, bucket), _t(x), levels=levels,
                           bucket_size=bucket).numpy()
    ref = np.asarray(jcomp.roundtrip("qsgd", key, x, levels=levels, bucket_size=bucket))
    atol = 1e-6 * float(jnp.linalg.norm(x))
    np.testing.assert_allclose(kern, wire, atol=atol, rtol=0)
    np.testing.assert_allclose(wire, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("size,bucket", [(512, 128), (129, 128), (100, 256), (2000, 1024)])
def test_qsgd_surface_vs_bucketed_wire_divergence_bounded(size, bucket):
    """Outside the regime the global norm and the bucket norms differ; each
    reconstruction stays within the QSGD bound √d/levels·‖x‖ of x."""
    levels = 64
    x = _t(jax.random.normal(jax.random.PRNGKey(1), (size,)))
    g = np.random.default_rng(size)
    u_lanes = torch.from_numpy(g.random((-(-size // tq.LANE), tq.LANE), np.float32))
    u_wire = torch.from_numpy(g.random((-(-size // bucket), bucket), np.float32))
    kern = tq.qsgd_roundtrip(x, u_lanes, levels=levels)
    wire = tcomp.roundtrip("qsgd", u_wire, x, levels=levels, bucket_size=bucket)
    bound = np.sqrt(size) / levels * float(x.norm())
    assert float((kern - x).norm()) <= bound and float((wire - x).norm()) <= bound
    assert float((kern - wire).norm()) <= 2 * bound


WIRE_CASES = [(100, 16, 1024), (5000, 16, 1024), (3000, 127, 256), (128, 15, 128),
              (4099, 127, 512), (2048, 64, 512)]


@pytest.mark.parametrize("size,levels,bucket", WIRE_CASES)
def test_wire_encode_through_the_encode_kernel_is_code_equal(size, levels, bucket):
    """``wire_encode`` now takes its codes from the encode kernel's plain
    version: they equal ``compression.qsgd_compress``'s folded codes (same
    norms), and, given the reference's bucket norms, the reference
    ``wire_encode``'s."""
    x = np.asarray(np.random.default_rng(size).normal(size=(size,)) * 2, np.float32)
    key = jax.random.PRNGKey(size + 1)
    jpay = jqdec.wire_encode(key, jnp.asarray(x), levels=levels, bucket_size=bucket)
    u = _t(jax.random.uniform(key, jpay.codes.shape))
    tx = torch.from_numpy(x)
    pay = tqdec.wire_encode(tx, u, levels=levels, bucket_size=bucket)
    c = tcomp.qsgd_compress(tx, u, levels=levels, bucket_size=bucket)
    folded = torch.where(c.payload["sign"], -c.payload["q"], c.payload["q"]).to(torch.int8)
    np.testing.assert_array_equal(pay.codes.numpy(), folded.numpy())
    np.testing.assert_array_equal(pay.norms.numpy(), c.payload["norms"].numpy())
    with_ref_norms = tq.qsgd_encode_buckets(tx, u, _t(jpay.norms), levels=levels,
                                            bucket_size=bucket)
    np.testing.assert_array_equal(with_ref_norms.numpy(), np.asarray(jpay.codes))


def test_encode_rejects_what_the_kernel_does_not_take():
    x, u, n = torch.ones(10), torch.zeros(1, 16), torch.ones(1)
    with pytest.raises(ValueError, match="levels"):
        tq.qsgd_encode_buckets(x, u, n, levels=128, bucket_size=16)
    with pytest.raises(ValueError, match="whole buckets"):
        tq.qsgd_encode_buckets(torch.ones(20), u, n, levels=16, bucket_size=16)
    with pytest.raises(ValueError, match="one norm a bucket"):
        tq.qsgd_encode_buckets(x, u, torch.ones(2), levels=16, bucket_size=16)
    with pytest.raises(TypeError, match="float32"):
        tq.qsgd_encode_buckets(x.double(), u, n, levels=16, bucket_size=16)
    with pytest.raises(ValueError, match="CUDA"):
        tq.qsgd_encode_kernel(x, u, n, levels=16, bucket_size=16)


# =================================== top-k ======================================
def _normal(shape, seed):
    return np.asarray(np.random.default_rng(seed).normal(size=shape), np.float32)


@pytest.mark.parametrize("shape,k_frac", [((1000,), 0.01), ((64, 33), 0.1),
                                          ((7,), 0.5), ((5000,), 0.25)])
def test_topk_matches_reference(shape, k_frac):
    x = _normal(shape, 3)
    c = jcomp.topk_compress(jnp.asarray(x), k_frac=k_frac)
    t = tcomp.topk_compress(torch.from_numpy(x), k_frac=k_frac)
    assert set(t.payload["idx"].tolist()) == set(np.asarray(c.payload["idx"]).tolist())
    np.testing.assert_array_equal(np.sort(t.payload["vals"].numpy()),
                                  np.sort(np.asarray(c.payload["vals"])))
    assert (t.bits, t.orig_bits, t.orig_shape) == (c.bits, c.orig_bits, tuple(c.orig_shape))
    np.testing.assert_array_equal(tcomp.topk_decompress(t).numpy(),
                                  np.asarray(jcomp.topk_decompress(c)))
    np.testing.assert_array_equal(tcomp.decompress(t).numpy(), tcomp.topk_decompress(t).numpy())
    np.testing.assert_array_equal(tcomp.roundtrip("topk", None, torch.from_numpy(x),
                                                  k_frac=k_frac).numpy(),
                                  np.asarray(jcomp.roundtrip("topk", None, jnp.asarray(x),
                                                             k_frac=k_frac)))
    assert tcomp.compression_ratio(t) == pytest.approx(jcomp.compression_ratio(c))


def test_topk_error_feedback_matches_reference():
    """Three steps of error feedback: the residual carried equals the
    reference's exactly."""
    err_j = jnp.zeros(2000, jnp.float32)
    err_t = torch.zeros(2000)
    for step in range(3):
        x = _normal((2000,), 10 + step)
        cj, err_j = jcomp.topk_with_error_feedback(jnp.asarray(x), err_j, k_frac=0.05)
        ct, err_t = tcomp.topk_with_error_feedback(torch.from_numpy(x), err_t, k_frac=0.05)
        np.testing.assert_array_equal(err_t.numpy(), np.asarray(err_j))
        assert set(ct.payload["idx"].tolist()) == set(np.asarray(cj.payload["idx"]).tolist())


# ================================= PowerSGD =====================================
def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape,rank,iters", [((64, 48), 4, 1), ((100, 30), 2, 3),
                                              ((9, 200), 8, 2), ((3, 3), 4, 1)])
def test_powersgd_reconstruction_matches_reference(shape, rank, iters):
    x = _normal(shape, 5)
    key = jax.random.PRNGKey(7)
    c = jcomp.powersgd_compress(key, jnp.asarray(x), rank=rank, iters=iters)
    q0 = _t(jax.random.normal(key, (shape[1], rank), jnp.float32))
    t = tcomp.powersgd_compress(torch.from_numpy(x), q0, rank=rank, iters=iters)
    assert (t.bits, t.orig_bits) == (c.bits, c.orig_bits)
    assert _rel(tcomp.decompress(t).numpy(), np.asarray(jcomp.powersgd_decompress(c))) <= 1e-5
    assert tcomp.compression_ratio(t) == pytest.approx(jcomp.compression_ratio(c))


@pytest.mark.parametrize("size,rank", [(1000, 4), (8, 2), (4099, 3), (161, 4)])
def test_powersgd_flat_roundtrip_on_the_squarest_grid(size, rank):
    """A flat vector goes onto its squarest zero-padded grid and back; the
    normal draw is (cols, rank), as ``wire_draw`` says."""
    x = _normal((size,), size)
    key = jax.random.PRNGKey(size)
    kind, shape = tcomp.wire_draw("powersgd", size, rank=rank)
    rows, cols = tcomp.squarest_grid(size)
    assert kind == "normal" and shape == (cols, rank) and rows * cols >= size > (rows - 1) * cols
    ref = np.asarray(jcomp.roundtrip("powersgd", key, jnp.asarray(x), rank=rank))
    q0 = _t(jax.random.normal(key, shape, jnp.float32))
    out = tcomp.roundtrip("powersgd", q0, torch.from_numpy(x), rank=rank).numpy()
    assert out.shape == (size,) and _rel(out, ref) <= 1e-5


def test_powersgd_refuses_zero_iterations_and_non_matrices():
    with pytest.raises(ValueError, match="iters >= 1"):
        tcomp.powersgd_compress(torch.ones(4, 4), torch.ones(4, 2), rank=2, iters=0)
    with pytest.raises(ValueError, match="iters >= 1"):
        jcomp.powersgd_compress(jax.random.PRNGKey(0), jnp.ones((4, 4)), rank=2, iters=0)
    with pytest.raises(ValueError, match="matrices"):
        tcomp.powersgd_compress(torch.ones(4), torch.ones(4, 2), rank=2)
    with pytest.raises(ValueError, match="normal draw"):
        tcomp.powersgd_compress(torch.ones(4, 4), torch.ones(3, 2), rank=2)


def test_wire_registry_matches_reference():
    assert tcomp.WIRE_CODECS == jcomp.WIRE_CODECS
    assert set(tcomp.DECOMPRESSORS) == set(jcomp.DECOMPRESSORS)
    assert tcomp.wire_draw("qsgd", 1000, bucket_size=256) == ("uniform", (4, 256))
    assert tcomp.wire_draw("topk", 1000) is None and tcomp.wire_draw(None, 10) is None
    x = torch.from_numpy(_normal((300,), 1))
    u = torch.rand(1, 1024)
    c = tcomp.qsgd_compress(x, u, levels=16)
    np.testing.assert_array_equal(tcomp.decompress(c).numpy(), tcomp.qsgd_decompress(c).numpy())
    with pytest.raises(ValueError, match="unknown wire codec"):
        tcomp.roundtrip("fp8", None, x)
