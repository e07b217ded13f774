"""The port's sliding-window attention against the JAX reference.

Inputs are drawn with numpy from a seed and handed to both sides.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it.
Tolerances (those of ``tests/test_kernels.py``): 2e-4 in float32 and 2e-2
in bfloat16 for the kernel's function (float sums in another order, and in
bfloat16 one rounding of the output); 1e-5 for ``_swa`` against the JAX
``_swa`` (the same banded float32 math).

The CUDA kernel is held against its plain version on the card in
``tests/test_torch_package.py`` (which imports no JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.ops import swa_attention as jswa_kernel
from repro.models import attention as jattn
from repro_torch.kernels.swa_attention import ops
from repro_torch.models import attention as tattn

# tests/test_kernels.py's grid: (b, s, hq, hkv, hd, window, the TPU's block_q)
GRID = [
    (1, 256, 4, 2, 32, 64, 64),
    (2, 128, 2, 1, 64, 32, 64),      # window < block
    (1, 256, 4, 4, 32, 96, 64),      # window not a multiple of the block
    (1, 512, 8, 2, 64, 128, 128),
    (2, 128, 8, 8, 16, 128, 64),     # window == seq
    # hd 128, the head dim of the kernel's two-box TMA path on the card
    (1, 256, 4, 2, 128, 100, 64),    # a band
    (1, 192, 4, 1, 128, 192, 64),    # window == seq, MQA
]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(b, s, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, hd), dtype=np.float32),
            rng.standard_normal((b, s, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, s, hkv, hd), dtype=np.float32))


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,bq", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_plain_matches_jax_kernel_and_reference(b, s, hq, hkv, hd, window, bq, dtype):
    arrays = _qkv(b, s, hq, hkv, hd)
    jq, jk, jv = (_to_jax(a, dtype) for a in arrays)
    tq, tk, tv = (_to_torch(a, dtype) for a in arrays)
    jkern = jswa_kernel(jq, jk, jv, window=window, block_q=bq, interpret=True)
    jref = jattn.reference_attention(jq, jk, jv, causal=True, window=window)
    plain = ops.swa_attention_plain(tq, tk, tv, window=window, block_q=bq)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    tol = TOL[dtype]
    for want in (jkern, jref):
        np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol, atol=tol)
    # the wrapper on CPU tensors is the plain version, for any block size
    np.testing.assert_array_equal(_f32(ops.swa_attention(tq, tk, tv, window=window)),
                                  _f32(ops.swa_attention_plain(tq, tk, tv, window=window)))


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,q_block", [
    (1, 256, 4, 2, 32, 64, 64),
    (2, 96, 4, 1, 16, 40, 32),
    (1, 64, 2, 2, 32, 200, 64),
])
def test_swa_twin_matches_jax(b, s, hq, hkv, hd, window, q_block):
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=1)
    jout = jattn._swa(jattn._grouped(jnp.asarray(q), hkv), jnp.asarray(k), jnp.asarray(v),
                      window=window, q_block=q_block, scale=hd ** -0.5)
    tout = tattn._swa(tattn._grouped(torch.from_numpy(q), hkv), torch.from_numpy(k),
                      torch.from_numpy(v), window=window, q_block=q_block, scale=hd ** -0.5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    # attention() dispatch: the kernel route needs the flag and Sq == Skv
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(
        tattn.attention(tq, tk, tv, window=window, q_block=q_block).numpy(),
        np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tattn.attention(tq, tk, tv, window=window, use_pallas=True).numpy(),
        np.asarray(jout), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [None, 24])
def test_reference_attention_and_decode_match_jax(window):
    q, k, v = _qkv(2, 40, 4, 2, 16, seed=2)
    jout = jattn.reference_attention(*(jnp.asarray(a) for a in (q, k, v)), window=window)
    tout = tattn.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     window=window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    # one decode step against a cache, ring and not, before and after a wrap
    ring = window is not None
    length = tattn.cache_length(40, window)
    assert length == jattn.cache_length(40, window)
    for pos in (5, length - 1, 37):
        if not ring and pos >= length:
            continue
        kc, vc = k[:, :length].copy(), v[:, :length].copy()
        jk, jv = jattn.cache_insert(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(k[:, :1]),
                                    jnp.asarray(v[:, :1]), jnp.int32(pos), ring=ring)
        tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
        tattn.cache_insert(tk, tv, torch.from_numpy(k[:, :1]), torch.from_numpy(v[:, :1]),
                           pos, ring=ring)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jo = jattn.decode_attention(jnp.asarray(q[:, :1]), jk, jv, jnp.int32(pos), ring=ring)
        to = tattn.decode_attention(torch.from_numpy(q[:, :1]), tk, tv, pos, ring=ring)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)


def test_wrapper_checks_its_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.swa_attention(q[..., :12], k[..., :12], v[..., :12], window=4)
    with pytest.raises(ValueError, match="window"):
        ops.swa_attention(q, k, v, window=0)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ops.swa_attention(q.half(), k.half(), v.half(), window=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.swa_attention_kernel(q, k, v, window=4)
