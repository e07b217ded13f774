"""The port's dense means, its CenteredClip iteration and its global-norm
clip, bit for bit against the JAX reference.

The reference's compiled ``jnp.mean`` multiplies the sum by a float32 1/k
(XLA folds the division by a constant into a multiply); its masked means
divide by a traced count.  The inputs make every partial sum exact
(integers in ±2^20 times 2^-8, at most 10 rows), so the sum order cannot
differ and the one step where the two sides could part is Σ/k against
Σ·(1/k).  ``clip_by_global_norm`` takes one-element trees, whose norm is
exact on both sides, so only max_norm / norm is compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.optim import optimizer as jopt
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.centered_clip import ops as tcc
from repro_torch.optim import optimizer as topt

KS = [3, 7, 10]


def _exact_stack(k, d=4096, seed=0):
    """(k, d) float32: integers in ±2^20 times 2^-8, so sums of up to 16 rows
    are exact."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-2**20, 2**20, size=(k, d)) * 2.0**-8).astype(np.float32)


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("k", KS)
def test_mean_bit_equal(k):
    x = _exact_stack(k, seed=k)
    assert _bits_equal(tagg.mean(torch.from_numpy(x)).numpy(), jagg.mean(jnp.asarray(x)))


@pytest.mark.parametrize("k", KS)
def test_trimmed_mean_bit_equal(k):
    x = _exact_stack(k, seed=10 + k)
    assert _bits_equal(tagg.trimmed_mean(torch.from_numpy(x), trim=1).numpy(),
                       jagg.trimmed_mean(jnp.asarray(x), trim=1))


@pytest.mark.parametrize("k", KS)
def test_multi_krum_bit_equal(k):
    x = _exact_stack(k, seed=20 + k)
    assert _bits_equal(tagg.multi_krum(torch.from_numpy(x), f=1).numpy(),
                       jagg.multi_krum(jnp.asarray(x), f=1))


@pytest.mark.parametrize("k", KS)
def test_masked_multi_krum_still_divides(k):
    """The masked twin divides by its traced count, as its reference does;
    the dense path's multiply must not leak into it."""
    x = _exact_stack(k, seed=30 + k)
    mask = np.arange(k) != 1
    out = tagg.masked_multi_krum(torch.from_numpy(x), torch.from_numpy(mask), f=1)
    ref = jagg.masked_multi_krum(jnp.asarray(x), jnp.asarray(mask), f=1)
    assert _bits_equal(out.numpy(), ref)


@pytest.mark.parametrize("k", KS)
def test_cc_iter_plain_bit_equal(k):
    """One iteration of the reference's centered_clip body from v0, with τ
    far above every row distance, so every scale is exactly 1 and the sum
    is exact."""
    x = _exact_stack(k, seed=40 + k)
    v = _exact_stack(1, seed=50 + k)[0]
    out = tcc.cc_iter_plain(torch.from_numpy(x), torch.from_numpy(v), 1e30)
    ref = jagg.centered_clip(jnp.asarray(x), clip_tau=1e30, iters=1, v0=jnp.asarray(v))
    assert _bits_equal(out.numpy(), ref)


def test_clip_by_global_norm_bit_equal_at_0p7():
    """1,000 seeded norms, log-uniform over [1e-2, 1e2] (both sides of 0.7),
    each a one-element tree: the clipped gradients bit-equal."""
    rng = np.random.default_rng(7)
    g = (np.exp(rng.uniform(np.log(1e-2), np.log(1e2), size=1000))
         * rng.choice([-1.0, 1.0], size=1000)).astype(np.float32)
    ref = jax.vmap(lambda x: jopt.clip_by_global_norm({"w": x[None]}, 0.7)["w"][0])(
        jnp.asarray(g))
    out = np.array([topt.clip_by_global_norm({"w": torch.from_numpy(g[i:i + 1])}, 0.7)["w"][0]
                    for i in range(g.size)], dtype=np.float32)
    assert _bits_equal(out, ref)
