"""The port's QSGD wire and audits against the JAX reference.

The reference keys its draws with threefry; the port takes the draws
themselves, so each test draws JAX's uniforms / normals and hands the same
numbers to both sides.  Tolerances:

- codes are exact given the same bucket norms and uniforms (the quantize
  expressions are the reference's, op for op, in float32);
- the bucket norms themselves are float sums in another order: 1e-6
  relative;
- decode is exact given the same codes and norms, against the compiled
  reference (``jax.jit``), whose XLA rewrites (q / levels) · norm into
  q · (norm · (1/levels)), the port's association;
- audit decisions are exact (mismatches are compared at 1e-5 relative; the
  cases sit far from the tolerance boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import verification as jver
from repro.kernels.qsgd_decode import ops as jqdec
from repro_torch.core import compression as tcomp
from repro_torch.core import verification as tver
from repro_torch.kernels.qsgd_decode import ops as tqdec

CASES = [(100, 16, 1024), (5000, 16, 1024), (3000, 127, 256), (128, 15, 128),
         (4099, 127, 512), (2048, 64, 512)]


def _x(size: int) -> np.ndarray:
    return (np.random.default_rng(size).normal(size=(size,)) * 2).astype(np.float32)


def _jax_side(size, levels, bucket):
    x = jnp.asarray(_x(size))
    key = jax.random.PRNGKey(size + 1)
    c = jcomp.qsgd_compress(key, x, levels=levels, bucket_size=bucket)
    u = np.array(jax.random.uniform(key, c.payload["q"].shape))
    return x, key, c, u


@pytest.mark.parametrize("size,levels,bucket", CASES)
def test_quantize_exact_given_reference_norms_and_uniforms(size, levels, bucket):
    _, _, c, u = _jax_side(size, levels, bucket)
    padded = tcomp.pad_buckets(torch.from_numpy(_x(size)), bucket)
    norms = torch.from_numpy(np.array(c.payload["norms"]))
    q, sign = tcomp.quantize(padded, norms, torch.from_numpy(u), levels)
    np.testing.assert_array_equal(q.numpy(), np.asarray(c.payload["q"]))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(c.payload["sign"]))
    np.testing.assert_allclose(tcomp.bucket_norms(padded).numpy(),
                               np.asarray(c.payload["norms"]), rtol=1e-6)


@pytest.mark.parametrize("size,levels,bucket", CASES)
def test_wire_encode_codes_exact_given_reference_norms(size, levels, bucket):
    """``wire_encode`` folds the sign into int8 codes like the reference's;
    with the reference's norms its quantizer gives the reference's codes."""
    x, key, c, u = _jax_side(size, levels, bucket)
    jpay = jqdec.wire_encode(key, x, levels=levels, bucket_size=bucket)
    tpay = tqdec.wire_encode(torch.from_numpy(_x(size)), torch.from_numpy(u),
                             levels=levels, bucket_size=bucket)
    assert tpay.codes.dtype == torch.int8 and tpay.codes.shape == jpay.codes.shape
    padded = tcomp.pad_buckets(torch.from_numpy(_x(size)), bucket)
    q, sign = tcomp.quantize(padded, torch.from_numpy(np.array(jpay.norms)),
                             torch.from_numpy(u), levels)
    folded = torch.where(sign, -q, q).to(torch.int8)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jpay.codes))
    # with its own norms, a code moves by at most one level where a norm's
    # last bit differs
    diff = np.abs(tpay.codes.numpy().astype(int) - np.asarray(jpay.codes).astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("size,levels,bucket", CASES)
def test_decode_exact_given_reference_payload(size, levels, bucket):
    x, key, c, u = _jax_side(size, levels, bucket)
    jpay = jqdec.wire_encode(key, x, levels=levels, bucket_size=bucket)
    tpay = tqdec.QsgdPayload(torch.from_numpy(np.array(jpay.codes)),
                             torch.from_numpy(np.array(jpay.norms)),
                             levels=levels, size=size, bucket_size=bucket)
    np.testing.assert_array_equal(tqdec.wire_decode(tpay).numpy(),
                                  np.asarray(jax.jit(jqdec.wire_decode)(jpay)))
    # the port's own round trip equals its int8 payload's decode
    tx, tu = torch.from_numpy(_x(size)), torch.from_numpy(u)
    np.testing.assert_array_equal(
        tcomp.roundtrip("qsgd", tu, tx, levels=levels, bucket_size=bucket).numpy(),
        tqdec.wire_decode(tqdec.wire_encode(tx, tu, levels=levels,
                                            bucket_size=bucket)).numpy())


@pytest.mark.parametrize("size,levels,bucket", CASES)
def test_wire_bits_match_reference(size, levels, bucket):
    x, key, c, u = _jax_side(size, levels, bucket)
    jpay = jqdec.wire_encode(key, x, levels=levels, bucket_size=bucket)
    tx, tu = torch.from_numpy(_x(size)), torch.from_numpy(u)
    tc = tcomp.qsgd_compress(tx, tu, levels=levels, bucket_size=bucket)
    tpay = tqdec.wire_encode(tx, tu, levels=levels, bucket_size=bucket)
    assert tc.bits == c.bits and tc.orig_bits == c.orig_bits
    assert tpay.wire_bits() == jpay.wire_bits() == c.bits
    assert tcomp.compression_ratio(tc) == pytest.approx(jcomp.compression_ratio(c))


def test_wire_encode_rejects_wide_levels_and_unported_codecs():
    with pytest.raises(ValueError, match="int8"):
        tqdec.wire_encode(torch.ones(8), torch.zeros(1, 1024), levels=200)
    with pytest.raises(ValueError, match="unknown wire codec"):
        tcomp.roundtrip("fp8", None, torch.ones(8))
    assert tcomp.roundtrip(None, None, torch.ones(3)).tolist() == [1.0, 1.0, 1.0]


def _audit_case(n=6, d=3000, seed=0):
    """Honest rows (claimed == recomputed), a slightly-off row well inside
    the tolerance, and cheaters far outside it."""
    rng = np.random.default_rng(seed)
    rec = rng.normal(size=(n, d)).astype(np.float32)
    claimed = rec.copy()
    claimed[1] += 1e-5 * rng.normal(size=d).astype(np.float32)
    claimed[3] = -claimed[3]
    claimed[4] *= 1.5
    claimed[5] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    noise = np.stack([np.array(jax.random.normal(k, (d,), jnp.float32)) for k in keys])
    return claimed, rec, keys, noise


@pytest.mark.parametrize("numeric_noise,tolerance", [(1e-5, 1e-3), (1e-3, 1e-3),
                                                     (0.0, 1e-4)])
def test_audit_batch_decisions_match_reference(numeric_noise, tolerance):
    claimed, rec, keys, noise = _audit_case()
    jcfg = jver.VerificationConfig(numeric_noise=numeric_noise, tolerance=tolerance)
    tcfg = tver.VerificationConfig(numeric_noise=numeric_noise, tolerance=tolerance)
    jp, jm = jver.audit_batch(jnp.asarray(claimed), jnp.asarray(rec), keys, jcfg)
    tp, tm = tver.audit_batch(torch.from_numpy(claimed), torch.from_numpy(rec),
                              torch.from_numpy(noise), tcfg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-12)
    assert not tp.numpy()[3:].any()


@pytest.mark.parametrize("gain,stake", [(0.5, 10.0), (3.0, 1.0), (0.0, 1.0),
                                        (1e-3, 7.0)])
def test_economics_helpers_match_reference(gain, stake):
    j = jver.VerificationConfig(p_check=0.2, stake=stake)
    t = tver.VerificationConfig(p_check=0.2, stake=stake)
    assert tver.expected_cheat_value(gain, t) == jver.expected_cheat_value(gain, j)
    assert tver.honest_value(gain, t) == jver.honest_value(gain, j)
    assert tver.cheating_irrational(gain, t) == jver.cheating_irrational(gain, j)
    assert tver.validator_ev(0.3, 0.1, t) == jver.validator_ev(0.3, 0.1, j)
    assert tver.min_p_check(gain, stake) == jver.min_p_check(gain, stake)


def test_min_p_check_holds_where_the_quotient_underflows():
    """The reference returns 0.0 when gain/stake underflows (ROADMAP queue
    3); the port keeps the documented contract p·stake >= gain."""
    p = tver.min_p_check(5e-324, 1e6)
    assert p > 0.0 and p * 1e6 >= 5e-324
    assert tver.cheating_irrational(
        5e-324, tver.VerificationConfig(p_check=p, stake=1e6))
