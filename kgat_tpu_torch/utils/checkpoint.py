"""Read and write model params in the ``kgat_tpu`` checkpoint format.

A checkpoint is ``<path>.npz`` with the params pytree flattened to
``p/<key>/<key>...`` entries (list indices as path components, e.g.
``p/layers/0/w1``) plus a ``<path>.json`` sidecar holding ``"model"``
(hyperparameters) and ``"dataset"``. The JAX trainer's checkpoints also
hold optimizer state (``o/...``) and an ``rng`` entry; serving reads only
the params, so a JAX-trained model serves on the GPU. numpy only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np


def load_params(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore the params pytree (numpy arrays) and the JSON meta from
    ``<path>.npz`` / ``<path>.json``. Dict levels are path components;
    all-digit components become list indices."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files if k.startswith("p/")}
    with open(path + ".json") as f:
        meta = json.load(f)

    root: Dict[str, Any] = {}
    for key, arr in arrays.items():
        parts = key[2:].split("/")
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

    return listify(root), meta


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


def save_params(path: str, params: Dict[str, Any],
                meta: Dict[str, Any]) -> None:
    """Write a params-only checkpoint that :func:`load_params` and
    ``kgat_tpu.utils.checkpoint.load_params`` read: ``<path>.npz`` with
    ``p/...`` entries and ``<path>.json`` with ``meta``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **_flatten(params, "p"))
        os.replace(tmp, path + ".npz")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
