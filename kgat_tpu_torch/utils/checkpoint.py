"""Checkpoints in the ``kgat_tpu`` format: params only, or the full
training state that ``--resume`` restores.

A checkpoint is ``<path>.npz`` plus a ``<path>.json`` sidecar. The npz
holds the params pytree flattened to ``p/<key>/<key>...`` entries (list
indices as path components, e.g. ``p/layers/0/w1``); a full-state
checkpoint adds optax.adam's state as ``kgat_tpu.utils.checkpoint``
flattens it, ``o/0/.count`` (int32) and ``o/0/.mu/<key>...``,
``o/0/.nu/<key>...``, and ``rng``, a JAX threefry key's data ((2,)
uint32). The sidecar holds ``epoch``, ``best_metric`` and ``bad_evals``
(full state), ``model`` (hyperparameters) and ``dataset``. Each package
reads the other's checkpoints: serving reads only the params, so a
JAX-trained model serves on the GPU, and ``kgat_tpu``'s loader ignores the
keys of the port's own state (``torch/...``). numpy only.

Under a process group, every process writes its shard
(:func:`save_checkpoint_sharded`, ``kgat_tpu/utils/checkpoint.py:
77-183``): ``<path>.shard{i}of{n}.npz`` holds process i's ceil-split row
slice of every leaf with at least n rows; process 0's also holds the
small leaves and ``rng``, and process 0 writes ``<path>.json`` (with
``n_shards``). Each process adds its own generator states under
``torch/``. :func:`load_checkpoint_sharded` reassembles the shards, or
reads the single-file form; each package reads the other's shards.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

# The optax.adam state's entries, as kgat_tpu's checkpoints name them.
COUNT, MU, NU = "o/0/.count", "o/0/.mu", "o/0/.nu"
OWN = "torch/"   # the port's own entries, which kgat_tpu does not read


def _unflatten(arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    """The pytree under ``prefix/``: dict levels are path components;
    all-digit components become list indices."""
    root: Dict[str, Any] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore the params pytree (numpy arrays) and the JSON meta from
    ``<path>.npz`` / ``<path>.json``."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files if k.startswith("p/")}
    with open(path + ".json") as f:
        meta = json.load(f)
    return _unflatten(arrays, "p"), meta


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{key}"))
    return flat


def _write(path: str, arrays: Dict[str, np.ndarray],
           meta: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path + ".npz")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def save_params(path: str, params: Dict[str, Any],
                meta: Dict[str, Any]) -> None:
    """Write a params-only checkpoint that :func:`load_params` and
    ``kgat_tpu.utils.checkpoint.load_params`` read: ``<path>.npz`` with
    ``p/...`` entries and ``<path>.json`` with ``meta``."""
    _write(path, _flatten(params, "p"), meta)


def save_checkpoint(path: str, params: Dict[str, Any], mu: Dict[str, Any],
                    nu: Dict[str, Any], count: int, *, epoch: int,
                    rng: np.ndarray, best_metric: float, bad_evals: int,
                    own: Optional[Dict[str, np.ndarray]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the full training state in ``kgat_tpu``'s format, which
    :func:`load_checkpoint` and ``kgat_tpu.utils.checkpoint.
    load_checkpoint`` read: the params, Adam's moments ``mu`` and ``nu``
    (pytrees shaped like the params) and step ``count``, ``rng`` (JAX key
    data, (2,) uint32), the counters, and ``own``, the port's entries
    (written under ``torch/``). ``extra`` joins the sidecar."""
    rng = np.asarray(rng)
    if rng.shape != (2,) or rng.dtype != np.uint32:
        raise ValueError(f"rng must be (2,) uint32 key data, got "
                         f"{rng.shape} {rng.dtype}")
    arrays = {**_flatten(params, "p"), **_flatten(mu, MU),
              **_flatten(nu, NU), COUNT: np.asarray(count, np.int32),
              "rng": rng}
    arrays.update({OWN + k: np.asarray(v) for k, v in (own or {}).items()})
    _write(path, arrays, {"epoch": int(epoch),
                          "best_metric": float(best_metric),
                          "bad_evals": int(bad_evals), **(extra or {})})


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a full-state checkpoint, the port's or ``kgat_tpu``'s:
    ``{"params", "mu", "nu"}`` (numpy pytrees), ``"count"`` (int),
    ``"rng"`` ((2,) uint32), ``"own"`` (the port's entries, {} in one
    ``kgat_tpu`` wrote) and ``"meta"`` (the sidecar). Raises
    FileNotFoundError without ``<path>.npz``, and KeyError for a
    params-only checkpoint."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        meta = json.load(f)
    if COUNT not in arrays:
        raise KeyError(f"{path}.npz holds no optimizer state ({COUNT}): "
                       f"a params-only checkpoint cannot be resumed")
    return {"params": _unflatten(arrays, "p"), "mu": _unflatten(arrays, MU),
            "nu": _unflatten(arrays, NU), "count": int(arrays[COUNT]),
            "rng": arrays["rng"], "meta": meta,
            "own": {k[len(OWN):]: v for k, v in arrays.items()
                    if k.startswith(OWN)}}


def _row_slice(n_rows: int, idx: int, count: int) -> Tuple[int, int]:
    """Process idx's rows of a leaf: ceil-split, every row once."""
    per = -(-n_rows // count)
    return min(idx * per, n_rows), min((idx + 1) * per, n_rows)


def save_checkpoint_sharded(path: str, params: Dict[str, Any],
                            mu: Dict[str, Any], nu: Dict[str, Any],
                            count: int, *, epoch: int, rng: np.ndarray,
                            best_metric: float, bad_evals: int,
                            process_index: int, process_count: int,
                            own: Optional[Dict[str, np.ndarray]] = None,
                            extra: Optional[Dict[str, Any]] = None) -> str:
    """Write this process's shard of the full training state, in
    ``kgat_tpu``'s sharded format (``save_checkpoint_sharded``): leaves
    with at least ``process_count`` rows are cut into ceil-split row
    slices and this process writes slice ``process_index``; process 0
    writes the small leaves, ``rng`` and the sidecar. ``own`` (this
    process's entries, under ``torch/``) goes into its shard whole: keys
    of different processes must differ. Returns the shard's path."""
    pi, pc = process_index, process_count
    rng = np.asarray(rng)
    if rng.shape != (2,) or rng.dtype != np.uint32:
        raise ValueError(f"rng must be (2,) uint32 key data, got "
                         f"{rng.shape} {rng.dtype}")
    arrays = {**_flatten(params, "p"), **_flatten(mu, MU),
              **_flatten(nu, NU), COUNT: np.asarray(count, np.int32)}
    shard = {}
    for k, v in arrays.items():
        if v.ndim >= 1 and v.shape[0] >= pc:
            lo, hi = _row_slice(v.shape[0], pi, pc)
            shard[k] = v[lo:hi]
        elif pi == 0:
            shard[k] = v
    shard.update({OWN + k: np.asarray(v) for k, v in (own or {}).items()})
    if pi == 0:
        shard["rng"] = rng
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ".json", "w") as f:
            json.dump({"epoch": int(epoch), "best_metric": float(best_metric),
                       "bad_evals": int(bad_evals), "n_shards": int(pc),
                       **(extra or {})}, f)
    out = f"{path}.shard{pi}of{pc}.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **shard)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_checkpoint_sharded(path: str) -> Dict[str, Any]:
    """Read a full-state checkpoint written in shards, the port's or
    ``kgat_tpu``'s, into :func:`load_checkpoint`'s dict; reads the
    single-file form where ``<path>.npz`` exists. A leaf that every shard
    holds is the concatenation of their slices; a ``torch/`` entry is
    taken from the shard that holds it. Raises FileNotFoundError when
    neither form is there, or a shard is missing."""
    if os.path.exists(path + ".npz"):
        return load_checkpoint(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    pc = int(meta.get("n_shards", 1))
    shards = []
    for i in range(pc):
        with np.load(f"{path}.shard{i}of{pc}.npz") as z:
            shards.append({k: z[k] for k in z.files})
    arrays = {}
    for k in {k for s in shards for k in s}:
        parts = [s[k] for s in shards if k in s]
        if k.startswith(OWN) or k == "rng" or len(parts) < pc:
            arrays[k] = parts[0]
        else:
            arrays[k] = np.concatenate(parts, axis=0)
    if COUNT not in arrays:
        raise KeyError(f"{path}: the shards hold no optimizer state "
                       f"({COUNT})")
    return {"params": _unflatten(arrays, "p"), "mu": _unflatten(arrays, MU),
            "nu": _unflatten(arrays, NU), "count": int(arrays[COUNT]),
            "rng": arrays["rng"], "meta": meta,
            "own": {k[len(OWN):]: v for k, v in arrays.items()
                    if k.startswith(OWN)}}
