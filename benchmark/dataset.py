"""The benchmark's data: generated from the configuration's data seed by
the frozen generator (``synthetic.py``), cached in ``benchmark/cache``,
and the benchmark's own view of it (the CKG's edges, each user's train
items, the sizes the yardstick counts), which the reference and the
checks read. The program gets the same arrays as a
``kgat_tpu_torch.data.Dataset`` and builds its own graph from them.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Dict

import numpy as np

from benchmark import synthetic

# Bump when synthetic.py's output changes, so a stale cache is not read.
GENERATOR_VERSION = 1
_DATA_KEYS = ("n_users", "n_items", "n_entities", "n_relations_kg",
              "n_interactions", "n_triples", "test_frac")


class Data:
    """The arrays of one configuration's data and what follows from them."""

    def __init__(self, name: str, params: dict, arrays: Dict[str, np.ndarray]):
        self.name = name
        self.cf_train = arrays["cf_train"]
        self.cf_test = arrays["cf_test"]
        self.kg_triples = arrays["kg_triples"]
        self.n_users = int(params["n_users"])
        self.n_items = int(params["n_items"])
        self.n_entities = int(params["n_entities"])
        self.n_relations_kg = int(params["n_relations_kg"])
        self.n_nodes = self.n_users + self.n_entities
        self.n_relations = 2 * self.n_relations_kg + 2

    def program_dataset(self):
        """The same arrays as the program's ``Dataset``."""
        from kgat_tpu_torch.data import Dataset
        return Dataset(name=self.name, cf_train=self.cf_train,
                       cf_test=self.cf_test, kg_triples=self.kg_triples,
                       n_users=self.n_users, n_items=self.n_items,
                       n_entities=self.n_entities,
                       n_relations_kg=self.n_relations_kg)

    @functools.cached_property
    def ckg(self):
        """(src, dst, etype) int64 of the collaborative knowledge graph, as
        KGAT defines it: a triple (h, r, t) is the message edge t -> h with
        relation r and its inverse h -> t with r + R; an interaction
        (u, i) is i -> u with relation 2R and u -> i with 2R + 1; user u
        is node n_entities + u. Edges in this concatenated order."""
        R = self.n_relations_kg
        h, r, t = self.kg_triples.T
        u = self.n_entities + self.cf_train[:, 0]
        i = self.cf_train[:, 1]
        src = np.concatenate([t, h, i, u])
        dst = np.concatenate([h, t, u, i])
        ety = np.concatenate([r, r + R, np.full(len(u), 2 * R),
                              np.full(len(u), 2 * R + 1)])
        return src, dst, ety

    @functools.cached_property
    def train_items(self):
        """(ptr, items): user u's train items, sorted, are
        items[ptr[u]:ptr[u + 1]]."""
        pairs = self.cf_train[np.lexsort((self.cf_train[:, 1],
                                          self.cf_train[:, 0]))]
        counts = np.bincount(pairs[:, 0], minlength=self.n_users)
        return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
                pairs[:, 1].copy())

    def user_activity(self) -> np.ndarray:
        """Each user's number of train interactions."""
        ptr, _ = self.train_items
        return np.diff(ptr)

    @functools.cached_property
    def sizes(self) -> dict:
        """What the yardstick counts from the data: nodes, edges, the
        distinct (dst, src) pairs the SpMM must read once each, and the
        distinct (node, relation) pairs the attention must project."""
        src, dst, ety = self.ckg
        n = self.n_nodes
        pairs = np.unique(dst * n + src).size
        node_rel = np.unique(np.concatenate([src, dst]) * self.n_relations
                             + np.concatenate([ety, ety])).size
        return {"n_nodes": n, "n_edges": int(src.size), "n_pairs": int(pairs),
                "n_node_rel": int(node_rel), "n_relations": self.n_relations,
                "n_users": self.n_users, "n_items": self.n_items,
                "n_entities": self.n_entities,
                "n_train": int(len(self.cf_train))}


def load(name: str, params: dict, cache_dir: str) -> Data:
    """The configuration's data: from ``cache_dir`` when it holds these
    parameters' arrays, else generated and written there."""
    key = {k: params[k] for k in _DATA_KEYS}
    key.update(seed=params["seed"], version=GENERATOR_VERSION)
    tag = hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()
    path = os.path.join(cache_dir, f"data-{name}-{tag[:16]}.npz")
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in ("cf_train", "cf_test", "kg_triples")}
    except (OSError, KeyError, ValueError):
        arrays = synthetic.generate(
            seed=int(params["seed"]),
            **{k: params[k] for k in _DATA_KEYS})
        os.makedirs(cache_dir, exist_ok=True)
        # Written under a name of this process, then renamed: processes of
        # one cell may generate at once, and none reads a partial file.
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    return Data(name, params, arrays)
