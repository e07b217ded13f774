"""The port's masked aggregation and QSGD decode against the JAX reference.

Inputs are made with numpy from a seed and handed to both frameworks.  On
the CPU the port's kernel wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (as ``test_kernel_conformance.py``
does) and its jnp reference.  Tolerances:

- median: equal values (the network is pure selection; ``assert_array_equal``
  treats +0.0 and -0.0 as equal, the only bits that may differ);
- CenteredClip: 3e-5 relative and absolute, the documented bound of the
  reference's own tiled kernel (``docs/kernels.md``) — per-node norms are
  float sums in another order;
- krum: the selected row is equal (selection-equal: the score gaps of the
  random stacks are far above the ~1e-6 relative d2 rounding);
- krum d2: 2e-5 relative / 2e-3 absolute, the bound the reference pins its
  own gram-form kernel to;
- decode-accumulate: 1e-6 relative (node sums in another order), and 1e-6
  absolute where the weighted terms (~1 here) cancel to a small sum — the
  bound the reference pins its own kernel to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.masked_agg import kernel as jkernel
from repro.kernels.masked_agg import ops as jmagg
from repro.kernels.qsgd_decode import kernel as jqkernel
from repro.kernels.qsgd_decode import ops as jqdec
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.masked_agg import ops as tmagg
from repro_torch.kernels.qsgd_decode import ops as tqdec

MASKS = ["all_live", "churned", "single_survivor", "even_k", "all_masked"]
LIVE_MASKS = MASKS[:-1]
# (5, 257): N not a power of two (the network pads to 8), D prime
SHAPES = [(8, 512), (16, 1000), (5, 257), (3, 300)]


def _mask(name: str, n: int) -> np.ndarray:
    i = np.arange(n)
    return {
        "all_live": np.ones(n, bool),
        "churned": i % 3 != 0,
        "single_survivor": i == min(2, n - 1),
        "even_k": i < 2 * max(1, n // 3),
        "all_masked": np.zeros(n, bool),
    }[name]


def _stack(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * 2 + 0.5).astype(np.float32)


def _both(x: np.ndarray, m: np.ndarray):
    return (jnp.asarray(x), jnp.asarray(m)), (torch.from_numpy(x), torch.from_numpy(m))


# ============================ median ==========================================
def test_oddeven_network_is_the_reference_network():
    for n in (2, 4, 8, 16, 32, 64):
        assert tmagg.oddeven_merge_pairs(n) == jkernel.oddeven_merge_pairs(n)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("mask_name", MASKS)
def test_median_equals_reference(n, d, mask_name):
    """The network median (the kernel's plain version), ``masked_median_net``
    and the port's sort-based ``_masked_median`` equal the reference's
    nanmedian; all-masked columns are NaN on every side."""
    (jx, jm), (tx, tm) = _both(_stack(n, d), _mask(mask_name, n))
    ref = np.asarray(jagg._masked_median(jx, jm))
    np.testing.assert_array_equal(tmagg.masked_median(tx, tm).numpy(), ref)
    np.testing.assert_array_equal(tmagg.masked_median_net(tx, tm).numpy(),
                                  np.asarray(jmagg.masked_median_net(jx, jm)))
    np.testing.assert_array_equal(tagg._masked_median(tx, tm).numpy(), ref)


@pytest.mark.parametrize("n,d", SHAPES[:3])
def test_median_equals_pallas_kernel(n, d):
    (jx, jm), (tx, tm) = _both(_stack(n, d, seed=1), _mask("churned", n))
    ref = np.asarray(jkernel.masked_median_fwd(jx, jm, block_d=256, interpret=True))
    np.testing.assert_array_equal(tmagg.masked_median(tx, tm).numpy(), ref)


def test_median_signed_zeros_follow_the_network():
    """Columns of tied +0.0/-0.0 values: the plain version swaps only on
    b < a, exactly like the kernel, so ties never move and the median is
    the middle row's zero, sign and all."""
    x = torch.tensor([[0.0, -0.0], [-0.0, 0.0], [0.0, -0.0]])
    m = torch.ones(3, dtype=torch.bool)
    out = tmagg.masked_median(x, m)
    assert torch.equal(torch.signbit(out), torch.tensor([True, False]))


# ============================ CenteredClip ====================================
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("clip_tau", [None, 0.7])
def test_centered_clip_matches_reference(n, d, mask_name, clip_tau):
    (jx, jm), (tx, tm) = _both(_stack(n, d), _mask(mask_name, n))
    ref = np.asarray(jagg.masked_centered_clip(jx, jm, clip_tau=clip_tau, iters=3))
    fused = tmagg.masked_centered_clip_fused(tx, tm, clip_tau=clip_tau, iters=3)
    plain = tagg.masked_centered_clip(tx, tm, clip_tau=clip_tau, iters=3)
    np.testing.assert_allclose(fused.numpy(), ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=3e-5, atol=3e-5)
    if mask_name == "all_masked":
        assert not fused.any() and not plain.any()


@pytest.mark.parametrize("n,d", SHAPES[:3])
@pytest.mark.parametrize("clip_tau", [None, 0.7])
def test_cc_iter_matches_pallas_kernel(n, d, clip_tau):
    """One iteration of the kernel's plain version against one iteration of
    the reference's Pallas kernel, from the same v."""
    x = _stack(n, d, seed=2)
    v = _stack(1, d, seed=3)[0] * 0.1
    m = _mask("churned", n)
    ref = np.asarray(jkernel.masked_cc_iter_fwd(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(m), clip_tau=clip_tau,
        block_d=256, interpret=True))
    out = tmagg.masked_cc_iter(torch.from_numpy(x), torch.from_numpy(v),
                               torch.from_numpy(m), clip_tau=clip_tau)
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)


def test_cc_iter_all_masked_adaptive_is_nan_then_guarded():
    """k = 0 with adaptive τ: τ is the median of nothing (NaN), which the
    kernel and its plain version both propagate; the fused aggregator's
    guard then returns zeros."""
    x = torch.from_numpy(_stack(4, 64))
    m = torch.zeros(4, dtype=torch.bool)
    out = tmagg.masked_cc_iter(x, torch.zeros(64), m, clip_tau=None)
    assert torch.isnan(out).all()
    assert not tmagg.masked_centered_clip_fused(x, m).any()


# ================================ krum ========================================
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("f", [1, 2])
def test_krum_selection_equal(n, d, mask_name, f):
    (jx, jm), (tx, tm) = _both(_stack(n, d), _mask(mask_name, n))
    ref = np.asarray(jagg.masked_krum(jx, jm, f=f))
    np.testing.assert_array_equal(tmagg.masked_krum_fused(tx, tm, f=f).numpy(), ref)
    np.testing.assert_array_equal(tagg.masked_krum(tx, tm, f=f).numpy(), ref)


def test_krum_d2_matches_pallas_kernel():
    x = _stack(8, 1000)
    ref = np.asarray(jkernel.masked_krum_d2_fwd(jnp.asarray(x), block_d=256,
                                                interpret=True))
    out = tmagg.masked_krum_d2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("mask_name", MASKS)
def test_krum_scores_from_d2_match(mask_name):
    """Same d2 in, same scores out (sums of at most N sorted values:
    1e-6 relative)."""
    d2 = np.abs(_stack(9, 9, seed=4)) * 100
    d2 = (d2 + d2.T).astype(np.float32)
    m = _mask(mask_name, 9)
    ref = np.asarray(jagg._krum_scores_from_d2(jnp.asarray(d2), jnp.asarray(m), 2))
    out = tagg._krum_scores_from_d2(torch.from_numpy(d2), torch.from_numpy(m), 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


# ============================ mean / decode ===================================
def _payload_pair(n: int, size: int, levels: int, bucket: int, seed: int = 7):
    """One node-batched payload, encoded by JAX and handed to both sides."""
    xs = jnp.asarray(_stack(n, size, seed))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jpay = jax.vmap(lambda k, x: jqdec.wire_encode(k, x, levels=levels,
                                                   bucket_size=bucket))(keys, xs)
    tpay = tqdec.QsgdPayload(torch.from_numpy(np.array(jpay.codes)),
                             torch.from_numpy(np.array(jpay.norms)),
                             levels=levels, size=size, bucket_size=bucket)
    return jpay, tpay


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("size,levels,bucket", [(5000, 16, 1024), (257, 127, 128),
                                                (3000, 64, 512)])
def test_masked_mean_on_payload_matches_reference(mask_name, size, levels, bucket):
    n = 8
    jpay, tpay = _payload_pair(n, size, levels, bucket)
    m = _mask(mask_name, n)
    ref = np.asarray(jmagg.masked_mean_fused(jpay, jnp.asarray(m), use_kernel=False))
    out = tmagg.masked_mean_fused(tpay, torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    dense = tagg.masked_mean(tqdec.wire_decode(tpay), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(dense, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [8, 3])
def test_decode_accumulate_matches_pallas_kernel(n):
    size, bucket = 4096, 512
    jpay, tpay = _payload_pair(n, size, 64, bucket, seed=n)
    w = np.linspace(0.0, 1.5, n).astype(np.float32)
    nb = size // bucket
    ref = np.asarray(jqkernel.qsgd_decode_accumulate_fwd(
        jpay.codes.reshape(n, size), jpay.norms.reshape(n, nb), jnp.asarray(w),
        levels=64, bucket_size=bucket, block_d=2048, interpret=True))
    out = tqdec.decode_accumulate(tpay, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_decode_accumulate_rejects_ragged_buckets():
    """The kernel reads 16 codes of one bucket at a time: buckets must be a
    multiple of 16 codes, on the CPU too."""
    pay = tqdec.QsgdPayload(torch.zeros((2, 1, 100), dtype=torch.int8),
                            torch.ones((2, 1, 1)), levels=16, size=100,
                            bucket_size=100)
    with pytest.raises(ValueError, match="whole buckets"):
        tqdec.decode_accumulate(pay, torch.ones(2))


# ============================== registry ======================================
def test_aggregator_registry_and_breakdown_points():
    for name in ("mean", "krum", "centered_clip"):
        assert callable(tmagg.get_fused_aggregator(name))
    assert set(tagg.MASKED_AGGREGATORS) == set(jagg.MASKED_AGGREGATORS)
    assert set(tagg.AGGREGATORS) == set(jagg.AGGREGATORS)
    for name in tagg.MASKED_AGGREGATORS:
        assert callable(tagg.get_masked_aggregator(name))
        assert callable(tagg.get_aggregator(name))
    with pytest.raises(KeyError):
        tagg.get_masked_aggregator("geometric_median")
    with pytest.raises(KeyError):
        tmagg.get_fused_aggregator("trimmed_mean")
    for name in ("mean", "median", "trimmed_mean", "krum", "multi_krum",
                 "centered_clip"):
        for n in (4, 10, 16):
            assert tagg.breakdown_point(name, n) == jagg.breakdown_point(name, n)
    assert tmagg.FUSED_MIN_BYTES == jmagg.FUSED_MIN_BYTES
