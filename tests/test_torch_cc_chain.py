"""The CenteredClip chains (``masked_cc_chain``, ``cc_chain``) on the CPU,
and the aggregators built on them against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU a chain runs ``iters`` calls of its kernel's plain version, so it is
held bit-equal to a hand loop of them; the aggregators are held within
3e-5 of the reference's Pallas kernels in interpret mode (the bound of the
reference's own kernel tests, ``docs/kernels.md``: per-node norms are float
sums in another order), or of its jnp ``centered_clip`` where its Pallas
route takes no adaptive τ.  ``cc_chain.chain_plan`` is the kernels' column
layout, checked here for every shape class the card will see.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.centered_clip import ops as jcc_ops
from repro.kernels.masked_agg import ops as jmagg
from repro_torch.kernels import cc_chain
from repro_torch.kernels.centered_clip import ops as tcc
from repro_torch.kernels.masked_agg import ops as tmagg

NS = [1, 3, 10]
DS = [255, 1000, 4096]


def _stack(n, d, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * 2 + 0.5).astype(np.float32)


def _mask(kind, n):
    i = np.arange(n)
    return {"all": np.ones(n, bool), "some": i % 3 != 0, "none": np.zeros(n, bool)}[kind]


def _bits(t):
    return t.view(torch.int32)


# one shape per mask (and per case of the dense chain), each under both τ
CHAIN_SHAPES = list(zip(NS, DS, ["all", "some", "none"]))


@pytest.mark.parametrize("clip_tau", [None, 0.7])
@pytest.mark.parametrize("n,d,mask_kind", CHAIN_SHAPES)
def test_masked_chain_is_the_plain_loop(n, d, clip_tau, mask_kind):
    x = torch.from_numpy(_stack(n, d, seed=n + d))
    v0 = torch.from_numpy(_stack(1, d, seed=1)[0] * 0.1)
    m = torch.from_numpy(_mask(mask_kind, n))
    v = v0
    for iters in range(5):
        out = tmagg.masked_cc_chain(x, v0, m, iters=iters, clip_tau=clip_tau)
        assert torch.equal(_bits(out), _bits(v))
        assert torch.equal(_bits(tmagg.masked_cc_iter(x, v, m, clip_tau=clip_tau)),
                           _bits(tmagg.masked_cc_iter_plain(x, v, m, clip_tau)))
        v = tmagg.masked_cc_iter_plain(x, v, m, clip_tau)
    assert tmagg.masked_cc_chain(x, v0, m, iters=0, clip_tau=clip_tau) is v0
    assert tmagg.LAUNCHES["masked_cc_iter"] == 0                 # the CPU never launches


@pytest.mark.parametrize("clip_tau", [None, 0.7])
@pytest.mark.parametrize("n,d,_", CHAIN_SHAPES)
def test_dense_chain_is_the_plain_loop(n, d, clip_tau, _):
    x = torch.from_numpy(_stack(n, d, seed=n + d))
    v0 = torch.from_numpy(_stack(1, d, seed=1)[0] * 0.1)
    v = v0
    for iters in range(5):
        out = tcc.cc_chain(x, v0, iters=iters, clip_tau=clip_tau)
        assert torch.equal(_bits(out), _bits(v))
        assert torch.equal(_bits(tcc.cc_iter(x, v, clip_tau=clip_tau)),
                           _bits(tcc.cc_iter_plain(x, v, clip_tau)))
        v = tcc.cc_iter_plain(x, v, clip_tau)
    assert tcc.cc_chain(x, v0, iters=0, clip_tau=clip_tau) is v0
    assert tcc.LAUNCHES["cc_iter"] == 0


@pytest.mark.parametrize("n,d", [(3, 255), (10, 1000)])
@pytest.mark.parametrize("clip_tau", [None, 0.7])
@pytest.mark.parametrize("mask_kind", ["all", "some", "none"])
def test_masked_centered_clip_fused_matches_reference(n, d, clip_tau, mask_kind):
    """Median warm start and three chained iterations against the
    reference's jnp ``masked_centered_clip`` and, at one shape and mask,
    its Pallas median and iterations in interpret mode; zeros where no row
    is kept."""
    x, m = _stack(n, d, seed=7), _mask(mask_kind, n)
    out = tmagg.masked_centered_clip_fused(torch.from_numpy(x), torch.from_numpy(m),
                                           clip_tau=clip_tau, iters=3).numpy()
    refs = [jagg.masked_centered_clip(jnp.asarray(x), jnp.asarray(m), clip_tau=clip_tau,
                                      iters=3)]
    if (n, mask_kind) == (10, "some"):
        refs.append(jmagg.masked_centered_clip_fused(
            jnp.asarray(x), jnp.asarray(m), clip_tau=clip_tau, iters=3, use_kernel=True,
            block_d=1024, interpret=True))
    for ref in refs:
        np.testing.assert_allclose(out, np.asarray(ref), rtol=3e-5, atol=3e-5)
    if mask_kind == "none":
        assert not out.any()
    assert tmagg.LAUNCHES["masked_cc_iter"] == 0 and tmagg.LAUNCHES["masked_median"] == 0


@pytest.mark.parametrize("n,d", [(3, 255), (10, 1000)])
@pytest.mark.parametrize("clip_tau", [None, 0.7])
def test_centered_clip_matches_reference(n, d, clip_tau):
    """Dense median warm start and three chained iterations: a fixed τ
    against the reference's Pallas ``centered_clip`` in interpret mode, an
    adaptive one against its jnp ``aggregation.centered_clip``."""
    x = _stack(n, d, seed=8)
    if clip_tau is None:
        ref = jagg.centered_clip(jnp.asarray(x), clip_tau=None, iters=3)
    else:
        ref = jcc_ops.centered_clip(jnp.asarray(x), clip_tau=clip_tau, iters=3,
                                    interpret=True)
    out = tcc.centered_clip(torch.from_numpy(x), clip_tau=clip_tau, iters=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5, atol=3e-5)
    assert tcc.LAUNCHES["cc_iter"] == 0


@pytest.mark.parametrize("d", [1, 3, 4, 255, 1000, 4096, 100_003, 162_417_408])
def test_chain_plan_covers_the_columns_once(d):
    """Every run a multiple of 4 columns but the last, none empty, together
    [0, d) once; at most ``WAVES`` waves of blocks; 16-byte loads only where
    the stack allows them."""
    for n in (1, 2, 3, 10, 16, 17, 32, 33, 64):
        for aligned in (True, False):
            for sms in (132, 114, 1):
                plan = cc_chain.chain_plan(n, d, aligned, sms)
                runs = plan.runs
                assert len(runs) == plan.nblk >= 1
                assert runs[0][0] == 0 and runs[-1][1] == d
                assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
                assert all(e > s for s, e in runs)
                assert all((e - s) % 4 == 0 for s, e in runs[:-1])
                assert plan.chunk % 4 == 0
                npow = max(2, 1 << (n - 1).bit_length())
                assert plan.nblk <= sms * cc_chain.BLOCKS_PER_SM[npow] * cc_chain.WAVES
                assert plan.vec == (4 if aligned and d % 4 == 0 and n <= 32 else 1)


def test_chain_plan_blocks_are_the_kernels_launch_bound():
    """The resident blocks an SM that the plan sizes its grid by are the
    passes' ``__launch_bounds__`` minimum, ``kChainMinBlocks`` of
    ``csrc/agg_common.cuh`` (NP = 2, 4, ..., 64)."""
    src = (Path(cc_chain.__file__).parent.parent / "csrc" / "agg_common.cuh").read_text()
    found = re.search(r"constexpr int kChainMinBlocks\[6\] = \{([^}]*)\};", src)
    assert found, "kChainMinBlocks not found in agg_common.cuh"
    table = [int(t) for t in found.group(1).split(",")]
    assert dict(zip((2, 4, 8, 16, 32, 64), table)) == cc_chain.BLOCKS_PER_SM


@pytest.mark.parametrize("chain", ["masked", "dense"])
def test_chain_arguments_are_checked(chain):
    def call(x, v0, iters):
        if chain == "masked":
            return tmagg.masked_cc_chain(x, v0, torch.ones(x.shape[0], dtype=torch.bool),
                                         iters=iters)
        return tcc.cc_chain(x, v0, iters=iters)

    x, v0 = torch.ones(3, 8), torch.ones(8)
    for bad in (-1, 1.0, True):
        with pytest.raises(ValueError, match="iters must be"):
            call(x, v0, bad)
    with pytest.raises(ValueError, match="1..64"):
        call(torch.ones(65, 8), v0, 1)
    with pytest.raises(ValueError, match="v must be"):
        call(x, torch.ones(7), 1)
    with pytest.raises(ValueError, match="v must be"):
        call(x, torch.ones(8, dtype=torch.float64), 1)
    with pytest.raises(TypeError, match="float32"):
        call(x.double(), v0, 1)
