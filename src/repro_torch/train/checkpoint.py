"""Sharded, atomic, async checkpoints with elastic restore.

The port of ``repro.train.checkpoint``, in its format, so that each
package reads the other's checkpoints:

* a checkpoint is a directory ``step_<N>/`` holding ``shard_<s>.npz``
  files and a ``meta.json`` (leaf keys, shapes, dtypes, shard count);
  a leaf's key is its JAX tree path (``repro_torch.train.tree``), an
  array of one or more rows is split over the shards along its first
  axis, and shard 0 carries the rest;
* a bf16 leaf is stored as the reference stores one: its 16-bit
  patterns as numpy dtype ``|V2``, ``"bfloat16"`` in ``meta.json``
  (numpy has no bf16; the port views the bits as ``int16`` both ways);
* writes go to ``step_<N>.tmp/`` and are renamed into place, so a crash
  mid-write never corrupts the latest complete checkpoint;
* ``save_async`` copies every leaf to the host before it returns (so an
  in-place optimizer step after it cannot race the write) and writes in a
  background thread;
* ``restore`` reads any shard count into the structure of ``like``,
  checking each leaf's shape and casting it to ``like``'s dtype, on
  ``like``'s device (the elastic path).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import flatten_with_paths, unflatten

PyTree = Any

_BF16_BITS = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (bf16 as ``|V2`` bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # a snapshot, never a view
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _flatten(tree: PyTree) -> List[Tuple[str, np.ndarray, str]]:
    out = []
    for key, leaf in flatten_with_paths(tree):
        arr = _host(leaf)
        out.append((key, arr, _dtype_name(leaf, arr)))
    return out


def checkpoint_paths(root: str) -> List[Tuple[int, str]]:
    """(step, path) of complete checkpoints, ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            full = os.path.join(root, name)
            if os.path.exists(os.path.join(full, "meta.json")):
                out.append((int(name.split("_")[1]), full))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    cps = checkpoint_paths(root)
    return cps[-1][0] if cps else None


def _write(root: str, step: int, flat, shards: int, keep: int,
           extra_meta: Optional[Dict]) -> str:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"step_{step}.tmp")
    final = os.path.join(root, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {
        "step": step,
        "shards": shards,
        "keys": [k for k, _, _ in flat],
        "shapes": {k: list(v.shape) for k, v, _ in flat},
        "dtypes": {k: d for k, _, d in flat},
    }
    if extra_meta:
        meta["extra"] = extra_meta
    # shard along the leading axis where possible; shard 0 carries scalars
    for s in range(shards):
        payload = {}
        for k, v, _ in flat:
            if v.ndim >= 1 and v.shape[0] >= shards:
                payload[k] = np.array_split(v, shards, axis=0)[s]
            elif s == 0:
                payload[k] = v
        np.savez(os.path.join(tmp, f"shard_{s}.npz"), **payload)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    os.replace(tmp, final)
    _gc(root, keep)
    return final


def save(
    root: str,
    step: int,
    tree: PyTree,
    shards: int = 1,
    keep: int = 3,
    extra_meta: Optional[Dict] = None,
) -> str:
    """Synchronous sharded save with atomic rename; returns its path."""
    return _write(root, step, _flatten(tree), shards, keep, extra_meta)


_PENDING: List[threading.Thread] = []


def save_async(
    root: str, step: int, tree: PyTree, shards: int = 1, keep: int = 3,
    extra_meta: Optional[Dict] = None,
) -> threading.Thread:
    """Copy every leaf to the host now, write in the background."""
    flat = _flatten(tree)
    t = threading.Thread(
        target=_write, args=(root, step, flat, shards, keep, extra_meta),
        daemon=True,
    )
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def _leaf(arr: np.ndarray, stored: str, like) -> torch.Tensor:
    """One stored array as a tensor of ``like``'s dtype on its device."""
    if not isinstance(like, torch.Tensor):
        like = torch.as_tensor(np.asarray(like))
    arr = np.asarray(arr, order="C")          # keeps 0-d leaves 0-d
    if stored == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(
    root: str,
    like: PyTree,
    step: Optional[int] = None,
) -> Tuple[PyTree, int]:
    """Restore into the structure of ``like`` (elastic: the shard count
    may differ from the saving run's)."""
    cps = checkpoint_paths(root)
    if not cps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    if step is None:
        step, path = cps[-1]
    else:
        match = [p for s, p in cps if s == step]
        if not match:
            raise FileNotFoundError(f"step {step} not found under {root}")
        path = match[0]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    buf: Dict[str, List[np.ndarray]] = {k: [] for k in meta["keys"]}
    for s in range(meta["shards"]):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
            for k in z.files:
                buf[k].append(z[k])
    full = {
        k: (np.concatenate(v, axis=0) if len(v) > 1 else v[0])
        for k, v in buf.items()
    }
    out = []
    for key, leaf in flatten_with_paths(like):
        if key not in full:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = full[key]
        want = tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
        out.append(_leaf(arr, meta["dtypes"][key], leaf))
    return unflatten(like, out), step


def _gc(root: str, keep: int) -> None:
    cps = checkpoint_paths(root)
    for _, path in cps[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)
