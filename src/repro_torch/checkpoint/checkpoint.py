"""Sharded checkpointing with a custody manifest (twin of
``repro/checkpoint/checkpoint.py``, on its on-disk format).

A checkpoint is a directory of ``.npz`` files and a JSON manifest:

- ``save`` / ``restore``: a whole tree, ``arrays.npz`` beside
  ``manifest.json`` (step, keys, shapes, dtypes);
- ``save_custody`` / ``restore_custody``: a Protocol-Model checkpoint, the
  flat parameter stream cut into custody shards (``core.unextractable``),
  each written once per holder as ``shard_{sid}_{holder}.npz`` beside
  ``custody.json``, so that no single node ever holds all of it.

Keys are the reference's: the path of a leaf joined with ``/``, a dotted
param name read as its path (``layers.attn.wq`` is ``layers/attn/wq``).
A bfloat16 leaf is stored as the reference stores one, as 2-byte void
items under the dtype name ``bfloat16``.  The two packages read each
other's checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.core.unextractable import ShardCustody, reconstruct_params, shard_params
from repro_torch.models.convert import layout_of


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.float32`` -> ``float32``)."""
    return str(dtype).removeprefix("torch.")


def _leaves_with_paths(tree, prefix: str = ""):
    """``(key, tensor)`` for every leaf, in the reference's leaf order."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}{str(k).replace('.', '/')}/")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves_with_paths(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def save(path: str, tree, *, step: int = 0) -> None:
    """Write every leaf of ``tree`` (nested dicts, tuples and lists of
    tensors) to ``path/arrays.npz`` and its manifest."""
    os.makedirs(path, exist_ok=True)
    leaves = dict(_leaves_with_paths(tree))
    arrays = {k: _to_numpy(t) for k, t in leaves.items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(t.shape) for k, t in leaves.items()},
        "dtypes": {k: _dtype_name(t.dtype) for k, t in leaves.items()},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _rebuild(template, fn, prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(template, Mapping):
        return {k: _rebuild(v, fn, f"{prefix}{str(k).replace('.', '/')}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        items = [_rebuild(x, fn, f"{prefix}{i}/") for i, x in enumerate(template)]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    return fn(prefix[:-1], template)


def restore(path: str, template):
    """Restore into the structure of ``template``, each leaf on its
    template leaf's device.  Shapes and dtypes are held to the template's
    (the manifest records both): an error names the key."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    saved_dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}

    def leaf(key: str, t: torch.Tensor) -> torch.Tensor:
        if key not in arrays:
            raise KeyError(f"checkpoint has no array for {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(t.shape)}")
        saved, want = saved_dtypes.get(key, str(arr.dtype)), _dtype_name(t.dtype)
        if saved != want:
            raise ValueError(f"dtype mismatch for {key}: checkpoint has "
                             f"{saved}, template wants {want}")
        return _to_torch(arr, t.dtype, t.device)

    return _rebuild(template, leaf)


def load_step(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["step"]


# -- custody checkpoints (Protocol Models) ---------------------------------------
def save_custody(path: str, params: Mapping[str, torch.Tensor], custody: ShardCustody,
                 *, step: int = 0) -> None:
    """Cut ``params`` into ``custody.num_shards`` flat float32 shards and
    write shard s once for each of its holders."""
    os.makedirs(path, exist_ok=True)
    shards, true_size = shard_params(params, custody.num_shards)
    assignment = custody.assignment
    for sid, holders in assignment.items():
        data = shards[sid].cpu().numpy()
        for holder in holders:
            np.savez(os.path.join(path, f"shard_{sid}_{holder}.npz"), data=data)
    manifest = {
        "step": step,
        "num_shards": custody.num_shards,
        "redundancy": custody.redundancy,
        "true_size": true_size,
        "assignment": {str(k): v for k, v in assignment.items()},
    }
    with open(os.path.join(path, "custody.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def restore_custody(path: str, template: Mapping[str, torch.Tensor], *,
                    holders: List[str]) -> Dict[str, torch.Tensor]:
    """Reassemble the params from the shards that ``holders`` hold, on the
    template's device and in its dtypes.  Raises ``PermissionError`` when
    the coalition does not cover every shard (the unextractability
    property)."""
    with open(os.path.join(path, "custody.json")) as f:
        manifest = json.load(f)
    num_shards = manifest["num_shards"]
    device = next(iter(template.values())).device
    gathered: Dict[int, Any] = {}
    for sid_s, shard_holders in manifest["assignment"].items():
        for h in shard_holders:
            if h in holders:
                with np.load(os.path.join(path, f"shard_{int(sid_s)}_{h}.npz")) as z:
                    gathered[int(sid_s)] = torch.from_numpy(z["data"]).to(device)
                break
    if len(gathered) < num_shards:
        raise PermissionError(
            f"coalition holds {len(gathered)}/{num_shards} shards — cannot restore")
    return reconstruct_params(gathered, layout_of(template), num_shards,
                              manifest["true_size"], device=device)
