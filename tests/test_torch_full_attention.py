"""The port's full causal attention on the kernel route against the JAX
reference.

With ``use_pallas`` set, causal attention with no window and Sq == Skv
goes through ``kernels/swa_attention`` at window = S (the same function);
on CPU tensors that is ``swa_attention_plain``, float32 inside.  Inputs
are drawn with numpy from a seed and handed to both sides.  Tolerances:
1e-5 in float32 against the reference's blockwise attention (the same
float32 softmax, summed in another order), 5e-4 relative L2 in bfloat16
(one rounding of the output on each side reads up to 3e-5; the same
softmax with p rounded to bf16 before p.v, a control the test also
computes, reads 2.4e-3 and must exceed the bound); 2e-4 and 2e-2 against
the reference's Pallas kernel in interpret mode (``tests/test_kernels.py``'s
bounds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.ops import swa_attention as jswa_kernel
from repro.models import attention as jattn
from repro_torch.kernels.swa_attention import ops
from repro_torch.models import attention as tattn

# (b, s, hq, hkv, hd): MHA and GQA, hd 64 and 80, S ragged and not
SHAPES = [
    (1, 64, 4, 4, 64),
    (2, 45, 4, 2, 80),
    (1, 130, 8, 2, 64),
    (1, 130, 2, 2, 80),
]


def _qkv(b, s, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, hd), dtype=np.float32),
            rng.standard_normal((b, s, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, s, hkv, hd), dtype=np.float32))


BF16_REL_L2 = 5e-4


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _causal_bf16_p(q, k, v):
    """Causal attention, float32 inside but for p, rounded to bf16 before
    p.v: the control that the bf16 bound must catch."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, hd)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    i = torch.arange(s)
    p = torch.softmax(sc.masked_fill(i[None, :] > i[:, None], -1e30), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.bfloat16().float(), v.float())
    return o.reshape(b, s, hq, hd).to(q.dtype)


@pytest.mark.parametrize("b,s,hq,hkv,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_blockwise_reference(b, s, hq, hkv, hd, dtype):
    arrays = _qkv(b, s, hq, hkv, hd)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays)
    out = tattn.attention(tq, tk, tv, causal=True, window=None, use_pallas=True)
    ref = jattn.attention(jq, jk, jv, causal=True, window=None)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    got = out.float().numpy()
    want = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2
        assert _rel_l2(_causal_bf16_p(tq, tk, tv).float().numpy(), want) > BF16_REL_L2


@pytest.mark.parametrize("b,s,hq,hkv,hd,bq", [
    (1, 128, 4, 4, 64, 64),
    (1, 256, 4, 2, 80, 128),
    (2, 64, 2, 1, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_full_window_matches_jax_kernel(b, s, hq, hkv, hd, bq, dtype):
    """``swa_attention_plain`` at window = S against the reference's Pallas
    kernel in interpret mode at window = S."""
    arrays = _qkv(b, s, hq, hkv, hd, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    jout = jswa_kernel(jq, jk, jv, window=s, block_q=bq, interpret=True)
    plain = ops.swa_attention_plain(tq, tk, tv, window=s)
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(jnp.asarray(jout).astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case,taken", [
    (dict(use_pallas=True), True),
    (dict(use_pallas=False), False),
    (dict(use_pallas=True, causal=False), False),
    (dict(use_pallas=True, kv_len=96), False),        # Sq != Skv
])
def test_route_is_taken_only_where_it_computes_the_same_function(monkeypatch, case, taken):
    calls = []

    def counting(q, k, v, *, window):
        calls.append(window)
        return ops.swa_attention(q, k, v, window=window)

    monkeypatch.setattr(tattn, "swa_attention", counting)
    case = dict(case)
    kv_len = case.pop("kv_len", 64)
    q, k, v = _qkv(1, 64, 4, 2, 64, seed=2)
    if kv_len != 64:
        _, k, v = _qkv(1, kv_len, 4, 2, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = tattn.attention(tq, tk, tv, window=None, **case)
    assert calls == ([64] if taken else [])
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=None,
                          causal=case.get("causal", True))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
