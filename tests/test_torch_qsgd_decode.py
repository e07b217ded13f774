"""The port's QSGD decode against the compiled JAX reference.

Every reference round runs under ``jax.jit``, where XLA rewrites the
decode ``q / levels * norm`` into ``q * (norm * r)``, r the float32
1/levels.  The port computes that form (``compression.dequantize``), so
given the reference's codes and norms:

- ``wire_decode``, ``qsgd_decompress`` and the global-norm
  ``qsgd_decode`` equal ``jax.jit`` of their reference counterparts bit for
  bit at every levels; the eager reference, which divides, differs by an
  ulp where levels is not a power of two;
- the round trip equals the jitted reference's bit for bit on inputs whose
  bucket norms are exact in float32 (multiples of 1/4, so no summation
  order rounds);
- ``decode_accumulate_plain``, the decode kernel's plain version, adds
  ``wire_decode(payloadᵢ) · wᵢ`` in node order, bit for bit; the reference
  has no exact compiled target for that sum (XLA orders the node sum its own
  way), so it is held within 1e-6 of the jitted reference and of the
  Pallas kernel in interpret mode.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels.qsgd import ops as jqops
from repro.kernels.qsgd_decode import kernel as jqkernel
from repro.kernels.qsgd_decode import ops as jqdec
from repro_torch.core import compression as tcomp
from repro_torch.kernels.qsgd import ops as tq
from repro_torch.kernels.qsgd_decode import ops as tqdec

LEVELS = [15, 16, 64, 100, 127]
SHAPES = [(4096, 512), (3000, 256)]


def _x(size: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(size + seed).normal(size=(size,)) * 2).astype(np.float32)


def _payloads(n: int, size: int, levels: int, bucket: int, seed: int = 5):
    """A node-batched payload encoded by JAX, and the same codes and norms
    handed to the port."""
    xs = jnp.asarray(np.stack([_x(size, seed + i) for i in range(n)]))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jpay = jax.vmap(lambda k, x: jqdec.wire_encode(k, x, levels=levels,
                                                   bucket_size=bucket))(keys, xs)
    tpay = tqdec.QsgdPayload(torch.from_numpy(np.array(jpay.codes)),
                             torch.from_numpy(np.array(jpay.norms)),
                             levels=levels, size=size, bucket_size=bucket)
    return jpay, tpay


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("size,bucket", SHAPES)
@pytest.mark.parametrize("levels", LEVELS)
def test_wire_decode_equals_jitted_reference(levels, size, bucket):
    jpay, tpay = _payloads(3, size, levels, bucket)
    ref = jax.jit(jqdec.wire_decode)(jpay)
    np.testing.assert_array_equal(_bits(tqdec.wire_decode(tpay)), _bits(ref))
    # one node's payload (codes (nb, B)) decodes to that row
    one = tqdec.QsgdPayload(tpay.codes[1], tpay.norms[1], levels=levels, size=size,
                            bucket_size=bucket)
    np.testing.assert_array_equal(_bits(tqdec.wire_decode(one)), _bits(ref[1]))


def test_eager_reference_differs_from_the_compiled_one_at_127():
    """The target is the compiled reference: eager JAX divides by levels
    and lands an ulp away on part of the elements at 127 levels; at 64
    (a power of two) the two forms agree."""
    for levels, differ in ((127, True), (64, False)):
        jpay, tpay = _payloads(2, 4096, levels, 512)
        eager = _bits(jqdec.wire_decode(jpay))
        jitted = _bits(jax.jit(jqdec.wire_decode)(jpay))
        assert bool((eager != jitted).any()) is differ
        np.testing.assert_array_equal(_bits(tqdec.wire_decode(tpay)), jitted)


@pytest.mark.parametrize("size,bucket", SHAPES)
@pytest.mark.parametrize("levels", LEVELS)
def test_qsgd_decompress_equals_jitted_reference(levels, size, bucket):
    """The unfused wire's decode, given the reference's codes, signs and
    norms."""
    key = jax.random.PRNGKey(size + levels)
    c = jcomp.qsgd_compress(key, jnp.asarray(_x(size)), levels=levels, bucket_size=bucket)
    p = c.payload

    def decompress(q, sign, norms):
        return jcomp.qsgd_decompress(jcomp.Compressed(
            "qsgd", {"q": q, "sign": sign, "norms": norms, "levels": levels, "size": size},
            c.bits, c.orig_shape, c.orig_bits))

    ref = jax.jit(decompress)(p["q"], p["sign"], p["norms"])
    tc = tcomp.Compressed("qsgd", {"q": torch.from_numpy(np.array(p["q"])),
                                   "sign": torch.from_numpy(np.array(p["sign"])),
                                   "norms": torch.from_numpy(np.array(p["norms"])),
                                   "levels": levels, "size": size},
                          c.bits, tuple(c.orig_shape), c.orig_bits)
    np.testing.assert_array_equal(_bits(tcomp.qsgd_decompress(tc)), _bits(ref))


@pytest.mark.parametrize("levels", LEVELS)
def test_roundtrip_equals_jitted_reference_on_exact_norms(levels):
    """Multiples of 1/4 in [-8, 8]: every square and partial sum of a
    bucket is exact in float32, so both sides' norms are the same number
    and, with the reference's uniforms, the whole round trip is equal."""
    size, bucket = 3000, 256
    x = (np.random.default_rng(levels).integers(-32, 33, size) / 4).astype(np.float32)
    key = jax.random.PRNGKey(levels)
    ref = jax.jit(functools.partial(jcomp.roundtrip, "qsgd", levels=levels,
                                    bucket_size=bucket))(key, jnp.asarray(x))
    u = np.array(jax.random.uniform(key, (-(-size // bucket), bucket)))
    out = tcomp.roundtrip("qsgd", torch.from_numpy(u), torch.from_numpy(x), levels=levels,
                          bucket_size=bucket)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    # the int8 wire round trip decodes to the same values (signed zeros aside)
    wire = tqdec.wire_decode(tqdec.wire_encode(torch.from_numpy(x), torch.from_numpy(u),
                                               levels=levels, bucket_size=bucket))
    np.testing.assert_array_equal(wire.numpy(), out.numpy())


@pytest.mark.parametrize("levels", LEVELS)
def test_global_norm_decode_equals_jitted_reference(levels):
    """``kernels/qsgd/ops.qsgd_decode`` (one norm for the whole tensor)
    given the reference's codes and norm; the reference's is jitted."""
    shape = (7, 150)
    x = jax.random.normal(jax.random.PRNGKey(1), shape) * 3
    q, norm = jqops.qsgd_encode(jax.random.PRNGKey(levels), x, levels=levels, interpret=True)
    ref = jqops.qsgd_decode(q, norm, levels=levels, shape=shape)
    out = tq.qsgd_decode(torch.from_numpy(np.array(q)), torch.tensor(float(norm)),
                         levels=levels, shape=shape)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("n", [1, 3, 10])
@pytest.mark.parametrize("levels", LEVELS)
def test_decode_accumulate_plain_is_the_node_sum_of_wire_decode(levels, n):
    """Each node's term is ``wire_decode``'s value times its weight, added
    in node order from zero: bit for bit."""
    size, bucket = 4096, 512
    _, tpay = _payloads(n, size, levels, bucket, seed=n)
    w = torch.linspace(-0.5, 1.5, n)
    out = tqdec.decode_accumulate(tpay, w)
    dec = tqdec.wire_decode(tpay)
    acc = torch.zeros(size)
    for i in range(n):
        acc = acc + dec[i] * w[i]
    np.testing.assert_array_equal(_bits(out), _bits(acc))


@pytest.mark.parametrize("levels", LEVELS)
def test_decode_accumulate_near_jitted_reference_and_pallas_kernel(levels):
    n, size, bucket = 8, 4096, 512
    jpay, tpay = _payloads(n, size, levels, bucket, seed=levels)
    w = np.linspace(0.0, 1.5, n).astype(np.float32)
    out = tqdec.decode_accumulate(tpay, torch.from_numpy(w)).numpy()
    jitted = jax.jit(functools.partial(jqdec.decode_accumulate, use_kernel=False))(
        jpay, jnp.asarray(w))
    pallas = jqkernel.qsgd_decode_accumulate_fwd(
        jpay.codes.reshape(n, size), jpay.norms.reshape(n, size // bucket), jnp.asarray(w),
        levels=levels, bucket_size=bucket, block_d=2048, interpret=True)
    for ref in (jitted, pallas):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-6)
