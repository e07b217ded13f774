"""The streaming median and krum d2 of ``kernels/masked_agg``: their
networks and decomposition on the CPU, against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU the wrappers run their plain versions, which follow the kernels: the
median runs Knuth's merge exchange over the K kept rows for K <= 16
(pruned to what the two middle ranks need) and the padded odd-even network
above; d2 sums each thread's columns of the kernel's grid, then the threads
and the blocks.  Tolerances:

- networks: exact (the 0-1 principle over every 0-1 input);
- median: equal values to the reference's nanmedian and its Pallas kernel
  in interpret mode (``assert_array_equal`` holds +0.0 and -0.0 equal, the
  only bits that may differ), and bit-equal to the network run on scalars;
- krum d2: 2e-5 relative / 2e-3 absolute against the Pallas kernel, the
  bound the reference pins its own gram-form kernel to, and within 1e-5 of
  the squared norms of a float64 Gram (chip_smoke's bound at full width);
- krum: the selected row equal (the score gaps of random stacks are far
  above d2's ~1e-6 relative rounding).
"""
import functools
import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.masked_agg import kernel as jkernel
from repro_torch.kernels.masked_agg import ops as tmagg

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
KS = list(range(1, 17))
NS = [3, 10, 16, 17]


def _stack(n, d, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * 2 + 0.5).astype(np.float32)


def _zero_one_inputs(k):
    """Every 0-1 vector of length k, one a row: (2^k, k)."""
    return (np.arange(1 << k)[:, None] >> np.arange(k)[None, :]) & 1


def _run(pairs, v):
    v = v.copy()
    for i, j in pairs:
        a, b = v[:, i].copy(), v[:, j].copy()
        swap = b < a
        v[:, i], v[:, j] = np.where(swap, b, a), np.where(swap, a, b)
    return v


# ============================ the networks =====================================
@pytest.mark.parametrize("k", KS)
def test_merge_exchange_sorts_every_zero_one_input(k):
    """By the 0-1 principle a comparator network that sorts every 0-1 input
    sorts every input."""
    v = _zero_one_inputs(k)
    np.testing.assert_array_equal(_run(tmagg.merge_exchange_pairs(k), v), np.sort(v, axis=1))


@pytest.mark.parametrize("k", KS)
def test_median_pairs_give_the_middle_ranks(k):
    """The pruned network leaves ranks (k-1)//2 and k//2 as the whole
    network does, on every 0-1 input (the 0-1 principle holds for a rank's
    selection too) and on random permutations of distinct floats."""
    lo, hi = (k - 1) // 2, k // 2
    v = _zero_one_inputs(k)
    out = _run(tmagg.median_pairs(k), v)
    s = np.sort(v, axis=1)
    np.testing.assert_array_equal(out[:, [lo, hi]], s[:, [lo, hi]])
    rng = np.random.default_rng(k)
    f = rng.permuted(np.tile(rng.normal(size=k), (200, 1)), axis=1)
    out = _run(tmagg.median_pairs(k), f)
    s = np.sort(f, axis=1)
    np.testing.assert_array_equal(out[:, [lo, hi]], s[:, [lo, hi]])


def test_network_sizes():
    """Batcher's merge exchange has the comparator counts of Knuth's table
    (TAOCP vol. 3, §5.3.4) for k = 1..16; pruning keeps 29 of 31 at k = 10;
    the pruned network is a subsequence of the whole one."""
    sizes = [0, 1, 3, 5, 9, 12, 16, 19, 26, 31, 37, 41, 48, 53, 59, 63]
    assert [len(tmagg.merge_exchange_pairs(k)) for k in KS] == sizes
    assert len(tmagg.median_pairs(10)) == 29
    assert len(tmagg.oddeven_merge_pairs(16)) == 63
    for k in KS:
        whole, kept = iter(tmagg.merge_exchange_pairs(k)), tmagg.median_pairs(k)
        assert all(pair in whole for pair in kept)


def test_constants_match_the_cuda_source():
    """MAX_EXACT and THREADS are the kernel's kMaxExact and kThreads."""
    src = (CSRC / "masked_agg.cu").read_text()
    common = (CSRC / "agg_common.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxExact = (\d+);", src).group(1)) == tmagg.MAX_EXACT
    assert int(re.search(r"constexpr int kThreads = (\d+);", common).group(1)) == tmagg.THREADS


# ============================ the grid =========================================
@pytest.mark.parametrize("d,aligned,sms,want", [
    (162_417_408, True, 132, (528, 4)),        # the round's stack on an H100
    (162_417_408, False, 132, (528, 1)),       # a base off a 16-byte boundary
    (162_417_409, True, 132, (528, 1)),        # d % 4 != 0
    (162_417_408, True, 66, (264, 4)),         # half the SMs
    (1000, True, 132, (1, 4)),                 # less than a step for each block
    (100_003, True, 132, (391, 1)),
    (0, True, 132, (1, 4)),
])
def test_stream_grid(d, aligned, sms, want):
    assert tuple(tmagg.stream_grid(d, aligned, sms)) == want


# ============================ median ===========================================
@functools.lru_cache(maxsize=None)
def _pallas_median():
    return jax.jit(functools.partial(jkernel.masked_median_fwd, block_d=256, interpret=True))


def _masks(n, seed):
    """A mask for every kept count K = 0..n, the kept rows a random subset."""
    rng = np.random.default_rng(seed)
    for k in range(n + 1):
        m = np.zeros(n, bool)
        m[rng.permutation(n)[:k]] = True
        yield k, m


@pytest.mark.parametrize("n", NS)
def test_median_every_k_equals_reference(n):
    x = _stack(n, 300, seed=n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for k, m in _masks(n, seed=n):
        out = tmagg.masked_median(tx, torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(out, np.asarray(jagg._masked_median(jx, jnp.asarray(m))),
                                      err_msg=f"K={k}")
        if k:       # the Pallas kernel's all-masked columns are left to the caller
            np.testing.assert_array_equal(out, np.asarray(_pallas_median()(jx, jnp.asarray(m))),
                                          err_msg=f"K={k}")
        else:
            assert np.isnan(out).all()


def _ties_and_infs(n, seed):
    """Columns of +0.0/-0.0 ties, of +-inf, and of both among finite values."""
    rng = np.random.default_rng(seed)
    zeros = np.where(rng.random((n, 40)) < 0.5, 0.0, -0.0)
    infs = np.where(rng.random((n, 40)) < 0.5, np.inf, -np.inf)
    mixed = _stack(n, 40, seed)
    mixed[rng.random((n, 40)) < 0.3] = -0.0
    mixed[rng.random((n, 40)) < 0.2] = np.inf
    mixed[rng.random((n, 40)) < 0.2] = -np.inf
    return np.concatenate([zeros, infs, mixed], axis=1).astype(np.float32)


def _scalar_median(col, m):
    """The kernel's network on one column of Python floats."""
    kept = [float(v) for v, keep in zip(col, m) if keep]
    k = len(kept)
    if k == 0:
        return float("nan")
    if k > tmagg.MAX_EXACT:
        v = [float(v) if keep else float("inf") for v, keep in zip(col, m)]
        v += [float("inf")] * (tmagg._next_pow2(len(v)) - len(v))
        pairs = tmagg.oddeven_merge_pairs(len(v))
    else:
        v, pairs = kept, tmagg.median_pairs(k)
    for i, j in pairs:
        if v[j] < v[i]:
            v[i], v[j] = v[j], v[i]
    with np.errstate(invalid="ignore"):         # +inf + -inf is NaN, as on the card
        return (np.float32(v[(k - 1) // 2]) + np.float32(v[k // 2])) * np.float32(0.5)


@pytest.mark.parametrize("n", NS)
def test_median_ties_and_infs(n):
    """Equal values to the reference, and to its Pallas kernel on the
    columns of ties; the signs of zeros and the NaNs of +inf + -inf
    exactly as the network leaves them."""
    x = _ties_and_infs(n, seed=n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for k, m in _masks(n, seed=n + 1):
        out = tmagg.masked_median(tx, torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(out, np.asarray(jagg._masked_median(jx, jnp.asarray(m))),
                                      err_msg=f"K={k}")
        if k:       # the ties: the Pallas kernel's sums start from its lowest row
            # times 0.0, NaN where that row is infinite
            pallas = np.asarray(_pallas_median()(jx, jnp.asarray(m)))
            np.testing.assert_array_equal(out[:40], pallas[:40], err_msg=f"K={k}")
        want = np.array([_scalar_median(x[:, c], m) for c in range(x.shape[1])], np.float32)
        same = (out.view(np.int32) == want.view(np.int32)) | (np.isnan(out) & np.isnan(want))
        assert same.all(), f"K={k}"


# ============================ krum =============================================
@functools.lru_cache(maxsize=None)
def _pallas_d2():
    return jax.jit(functools.partial(jkernel.masked_krum_d2_fwd, block_d=256, interpret=True))


def _float64_d2(x):
    g = x.astype(np.float64) @ x.astype(np.float64).T
    q = np.diag(g)
    return q[:, None] + q[None, :] - 2.0 * g, q[:, None] + q[None, :]


@pytest.mark.parametrize("n,d,offset", [
    (10, 4096, 0),        # VEC = 4
    (10, 4099, 0),        # d % 4 != 0: VEC = 1
    (10, 4096, 1),        # a base off a 16-byte boundary: VEC = 1
    (16, 3000, 0), (1, 1000, 0), (17, 1000, 0), (3, 257, 0),
])
def test_krum_d2_plain_against_pallas_and_float64(n, d, offset):
    x = _stack(n, d, seed=n + d)
    buf = torch.empty(n * d + offset)
    tx = buf[offset:].view(n, d)
    tx.copy_(torch.from_numpy(x))
    assert tmagg.grid_for(tx).vec == (4 if d % 4 == 0 and offset == 0 else 1)
    out = tmagg.masked_krum_d2(tx).numpy()
    np.testing.assert_allclose(out, np.asarray(_pallas_d2()(jnp.asarray(x))),
                               rtol=2e-5, atol=2e-3)
    d64, scale = _float64_d2(x)
    assert float(np.max(np.abs(out - d64) / scale)) <= 1e-5
    np.testing.assert_array_equal(out, out.T)


def test_krum_d2_plain_follows_the_grid():
    """On the full grid of an H100 (528 blocks) with three steps a thread,
    the last one ragged, the per-thread sums stay within 1e-6 of the
    squared norms of a float64 Gram."""
    d = 2 * 528 * tmagg.THREADS * 4 + 12
    x = _stack(10, d, seed=3)
    assert tuple(tmagg.grid_for(torch.from_numpy(x))) == (528, 4)
    out = tmagg.masked_krum_d2_plain(torch.from_numpy(x)).numpy()
    d64, scale = _float64_d2(x)
    assert float(np.max(np.abs(out - d64) / scale)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _reference_krum(f):
    return jax.jit(functools.partial(jagg.masked_krum, f=f))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("f", [1, 2])
def test_krum_selection_equal_every_mask(n, f):
    x = _stack(n, 500, seed=n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for k, m in itertools.chain(_masks(n, seed=f), [(n, np.ones(n, bool))]):
        ref = np.asarray(_reference_krum(f)(jx, jnp.asarray(m)))
        out = tmagg.masked_krum_fused(tx, torch.from_numpy(m), f=f).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=f"K={k}")
