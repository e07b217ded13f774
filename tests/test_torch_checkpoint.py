"""Checkpoints (``repro_torch.checkpoint.checkpoint``) against the JAX
reference's ``repro/checkpoint/checkpoint.py``, on the reference's on-disk
format.

- ``save`` / ``restore`` round-trip a param dict (float32 and bfloat16
  leaves) and a nested optimizer state bit for bit; a shape or dtype that
  differs from the template raises, naming the key; ``load_step`` reads
  the step; the two sides' full checkpoints of float32 params are
  byte-equal and each restores the other's, and the port restores the
  reference's bfloat16 leaves;
- ``save_custody``: the port's shard files and ``custody.json`` byte-equal
  to the reference's for the same converted params (the zip members'
  timestamps pinned on both sides: ``np.savez`` stamps the wall clock);
- the port restores a custody checkpoint that the reference wrote, equal
  to ``params_from_jax`` of the reference's params, and the reference
  restores the port's;
- a partial coalition raises ``PermissionError`` on both sides.
"""
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core.unextractable import ShardCustody as JCustody
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core.unextractable import ShardCustody as TCustody
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.optimizer import AdamW

NODES = [f"n{i}" for i in range(6)]


def _tree():
    """A nested param tree of float32 and bfloat16 leaves (1,517 values)."""
    rng = np.random.default_rng(11)
    return {"embed": rng.standard_normal((37, 8)).astype(np.float32),
            "layers": {"attn": {"wq": rng.standard_normal((3, 8, 16)).astype(
                                    ml_dtypes.bfloat16),
                                "wo": rng.standard_normal((16, 19)).astype(np.float32)},
                       "ln": rng.standard_normal((3, 8)).astype(ml_dtypes.bfloat16)},
            "ln_f": rng.standard_normal(29).astype(np.float32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


def _same(a, b) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(_bits(a[k]), _bits(b[k])) for k in a)


@pytest.fixture
def pinned_clock(monkeypatch):
    """``np.savez`` stamps each zip member with the wall clock; pin it so
    that two writes of the same bytes are the same file."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def test_save_restore_round_trip_and_errors(tmp_path):
    params = params_from_jax(_tree(), device="cpu")
    tckpt.save(str(tmp_path / "p"), params, step=7)
    assert tckpt.load_step(str(tmp_path / "p")) == 7
    assert _same(tckpt.restore(str(tmp_path / "p"), params), params)
    opt = AdamW().init(params)
    opt = opt._replace(m={k: v + 1.5 for k, v in opt.m.items()})
    tckpt.save(str(tmp_path / "o"), opt, step=3)
    back = tckpt.restore(str(tmp_path / "o"), opt)
    assert type(back) is type(opt) and torch.equal(back.step, opt.step)
    assert _same(back.m, opt.m) and _same(back.v, opt.v)
    bad = dict(params, **{"ln_f": torch.zeros(30)})
    with pytest.raises(ValueError, match="shape mismatch for ln_f"):
        tckpt.restore(str(tmp_path / "p"), bad)
    bad = dict(params, **{"layers.ln": params["layers.ln"].float()})
    with pytest.raises(ValueError, match="dtype mismatch for layers/ln"):
        tckpt.restore(str(tmp_path / "p"), bad)


def test_full_checkpoints_cross_read(tmp_path, pinned_clock):
    """Of float32 params the two sides write the same bytes and each
    restores the other's checkpoint; the port restores the reference's
    bfloat16 leaves too, whose 2-byte items it writes as numpy's plain
    void type (``|V2`` in the ``.npy`` header where the reference's
    ``ml_dtypes`` type writes ``<V2``; the same item bytes).  The reference
    restores no bfloat16 leaf, its own included: ``jnp.asarray`` of the
    stored void items has no cast (ROADMAP queue 3)."""
    tree = _tree()
    f32 = {k: v for k, v in tree.items() if k != "layers"}
    for name, sub in (("f32", f32), ("all", tree)):
        jckpt.save(str(tmp_path / f"j{name}"), jax.tree.map(jnp.asarray, sub), step=5)
        tckpt.save(str(tmp_path / f"t{name}"), params_from_jax(sub, device="cpu"), step=5)
        assert (tmp_path / f"j{name}" / "manifest.json").read_bytes() == \
            (tmp_path / f"t{name}" / "manifest.json").read_bytes()
    assert (tmp_path / "jf32" / "arrays.npz").read_bytes() == \
        (tmp_path / "tf32" / "arrays.npz").read_bytes()
    params = params_from_jax(tree, device="cpu")
    assert _same(tckpt.restore(str(tmp_path / "jall"), params), params)
    back = jckpt.restore(str(tmp_path / "tf32"), jax.tree.map(jnp.asarray, f32))
    assert _same(params_from_jax(jax.tree.map(np.asarray, back), device="cpu"),
                 params_from_jax(f32, device="cpu"))
    with np.load(tmp_path / "jall" / "arrays.npz") as j, \
            np.load(tmp_path / "tall" / "arrays.npz") as t:
        assert j.files == t.files
        for k in j.files:
            assert j[k].tobytes() == t[k].tobytes(), k


def test_custody_shards_byte_equal_and_cross_restore(tmp_path, pinned_clock):
    tree = _tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, device="cpu")
    jc = JCustody.assign(NODES, num_shards=7, redundancy=2, seed=3, max_fraction=0.5)
    tc = TCustody.assign(NODES, num_shards=7, redundancy=2, seed=3, max_fraction=0.5)
    assert jc.assignment == tc.assignment
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jckpt.save_custody(str(jdir), jtree, jc, step=9)
    tckpt.save_custody(str(tdir), params, tc, step=9)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 7 * 2 + 1
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    # each side restores the other's checkpoint from every holder
    got = tckpt.restore_custody(str(jdir), params, holders=NODES)
    assert _same(got, params)
    back = jckpt.restore_custody(str(tdir), jtree, holders=NODES)
    assert _same(params_from_jax(jax.tree.map(np.asarray, back), device="cpu"), params)
    # a coalition that covers every shard is enough; one that does not is refused
    cover = sorted({holders[-1] for holders in tc.assignment.values()})
    assert tc.can_extract(cover) and len(cover) < len(NODES)
    assert _same(tckpt.restore_custody(str(jdir), params, holders=cover), params)
    for partial in (NODES[:2], [], ["nobody"]):
        assert not tc.can_extract(partial)
        with pytest.raises(PermissionError, match="cannot restore"):
            tckpt.restore_custody(str(jdir), params, holders=partial)
        with pytest.raises(PermissionError, match="cannot restore"):
            jckpt.restore_custody(str(tdir), jtree, holders=partial)
