"""Graph core: dst-sorted COO + CSR of the collaborative knowledge graph.

Port of the parts of ``kgat_tpu/graph.py`` the serving forward needs
(``CKGMeta``, ``build_ckg``, ``build_graph``). The JAX graph pads edges to
TPU block sizes and carries block-aligned layouts; here the graph holds
the real edges only, in the shape a Hopper kernel walks:

* **Canonical edge order = destination-sorted** (stable, so edges of one
  destination keep their input order). ``row_offsets`` is the CSR over
  destinations: the in-edges of node v are ``[row_offsets[v],
  row_offsets[v+1])``. The per-dst softmax and the SpMM are one pass over
  each row.
* **Relation tiles** for the TransR attention SDDMM: ``rel_perm`` lists the
  canonical edge ids grouped by relation (stable within a relation), and
  ``tiles`` is an ``(n_tiles, 3)`` table of ``(relation, start, count)``
  ranges of ``rel_perm`` with ``count <= rel_tile``. No tile spans two
  relations, so a thread block stages one relation's W_r once. Nothing is
  padded.
* **The reverse CSR**, for the SpMM's gradient w.r.t. its features:
  ``rev_perm`` lists the canonical edge ids sorted stably by src,
  ``rev_row_offsets`` is the CSR over sources and ``rev_dst`` is
  ``dst[rev_perm]``. The out-edges of node u are ``rev_perm[
  rev_row_offsets[u]:rev_row_offsets[u+1]]``, so the backward is the same
  row-wise SpMM, reading ``g`` at each edge's dst (the counterpart of
  ``kgat_tpu.graph``'s ``rev_layout``).
* **Row splits**: the work units the row-reduction kernels walk, built
  once for each CSR (``split``, ``rev_split``; ``ops/row_split.py``).

:func:`save_graph` and :func:`load_graph` round-trip a built graph, its
row splits and its :class:`CKGMeta` through one ``.npz`` file, the
port's counterpart of ``kgat_tpu.graph``'s graph cache
(``Dataset.build(cache_dir=...)``).

Edge orientation and relation numbering are those of ``kgat_tpu``: a
triple (h, r, t) is the message edge t -> h; its inverse has relation
r + R; user-item interactions add relations 2R (item -> user) and 2R + 1
(user -> item). User u is node ``n_entities + u``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from kgat_tpu_torch import native
from kgat_tpu_torch.ops.row_split import RowSplit, build_row_split

# Edges per attention tile. One thread block of the SDDMM kernel handles
# one tile, so this trades W_r staging per edge against the tail effect.
REL_TILE = 256

# The layout of a graph cache file (save_graph). A file of another version
# is rebuilt, never read.
GRAPH_CACHE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Graph:
    """Dst-sorted COO + CSR graph of real edges, plus relation tiles.

    Index tensors are int32 (the kernels read 4-byte indices); all live on
    one device. ``rel_offsets`` stays a host tuple: the plain attention
    path loops over relations in Python.
    """

    src: torch.Tensor          # (E,) int32 tail of each edge (message source)
    dst: torch.Tensor          # (E,) int32 head of each edge, non-decreasing
    etype: torch.Tensor        # (E,) int32 relation id
    row_offsets: torch.Tensor  # (n_nodes + 1,) int32 CSR offsets over dst
    rel_perm: torch.Tensor     # (E,) int32 canonical edge ids grouped by relation
    tiles: torch.Tensor        # (n_tiles, 3) int32 (relation, start, count) in rel_perm
    rel_offsets: Tuple[int, ...]  # (n_relations + 1,) rel_perm range per relation
    rev_perm: torch.Tensor     # (E,) int32 canonical edge ids sorted by src
    rev_row_offsets: torch.Tensor  # (n_nodes + 1,) int32 CSR offsets over src
    rev_dst: torch.Tensor      # (E,) int32 dst[rev_perm]
    split: RowSplit            # work units of the forward CSR
    rev_split: RowSplit        # work units of the reverse CSR
    n_nodes: int
    n_relations: int

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "Graph":
        """A copy with every tensor (and the row splits) on ``device``."""
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name),
                                   (torch.Tensor, RowSplit))})


def _relation_tiles(rel_offsets: np.ndarray, rel_tile: int) -> np.ndarray:
    """(n_tiles, 3) int32 (relation, start, count): each relation's range
    of ``rel_perm`` cut into pieces of at most ``rel_tile`` edges."""
    parts = []
    for r in range(len(rel_offsets) - 1):
        lo, hi = int(rel_offsets[r]), int(rel_offsets[r + 1])
        starts = np.arange(lo, hi, rel_tile, dtype=np.int64)
        counts = np.minimum(starts + rel_tile, hi) - starts
        parts.append(np.stack([np.full_like(starts, r), starts, counts], 1))
    tiles = np.concatenate(parts) if parts else np.zeros((0, 3), np.int64)
    return tiles.astype(np.int32)


def build_graph(src: np.ndarray, dst: np.ndarray, etype: np.ndarray,
                n_nodes: int, n_relations: int, *,
                rel_tile: int = REL_TILE) -> Graph:
    """Build a :class:`Graph` on the CPU from host-side COO arrays.

    The canonical order is the stable counting sort by dst
    (``native.sort_perm``, as ``kgat_tpu.graph.build_graph`` sorts), which
    is numpy's stable argsort, so edge ids agree between the two packages.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    etype = np.asarray(etype, dtype=np.int64)
    if not (src.shape == dst.shape == etype.shape and src.ndim == 1):
        raise ValueError("src, dst and etype must be 1-D and equally long")
    if len(src) >= 2 ** 31:
        raise ValueError("more edges than int32 indices can address")
    if ((dst < 0) | (dst >= n_nodes)).any():
        raise ValueError("dst out of range")
    if ((src < 0) | (src >= n_nodes)).any():
        raise ValueError("src out of range")
    if ((etype < 0) | (etype >= n_relations)).any():
        raise ValueError("etype out of range")
    if rel_tile < 1:
        raise ValueError("rel_tile must be positive")

    order = native.sort_perm(dst, n_nodes)
    src, dst, etype = src[order], dst[order], etype[order]
    row_offsets = native.csr_offsets(dst, n_nodes)

    rel_perm = native.sort_perm(etype, n_relations)
    rel_offsets = native.csr_offsets(etype[rel_perm], n_relations)
    rev_perm = native.sort_perm(src, n_nodes)
    rev_row_offsets = native.csr_offsets(src[rev_perm], n_nodes)
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    row_offsets, rev_row_offsets = as32(row_offsets), as32(rev_row_offsets)
    return Graph(
        src=as32(src), dst=as32(dst), etype=as32(etype),
        row_offsets=row_offsets, rel_perm=as32(rel_perm),
        tiles=torch.from_numpy(_relation_tiles(rel_offsets, rel_tile)),
        rel_offsets=tuple(int(x) for x in rel_offsets),
        rev_perm=as32(rev_perm), rev_row_offsets=rev_row_offsets,
        rev_dst=as32(dst[rev_perm]), split=build_row_split(row_offsets),
        rev_split=build_row_split(rev_row_offsets),
        n_nodes=int(n_nodes), n_relations=int(n_relations))


@dataclasses.dataclass(frozen=True)
class EdgeWeights:
    """Edge weights staged for the SpMM and its backward: ``fwd`` in
    canonical order and ``rev`` = ``fwd[graph.rev_perm]``, the order of
    the reverse CSR. Made once per attention recompute (the counterpart
    of ``kgat_tpu.ops.pallas_backend.EdgeWeights``)."""

    fwd: torch.Tensor
    rev: torch.Tensor

    @staticmethod
    def stage(graph: Graph, w: torch.Tensor) -> "EdgeWeights":
        return EdgeWeights(fwd=w, rev=w[graph.rev_perm.long()].contiguous())


def _weight_leaves(staged) -> list:
    """The tensors of :class:`EdgeWeights` or nested lists of them, in
    order (None, another process's partition, holds none)."""
    if staged is None:
        return []
    if isinstance(staged, EdgeWeights):
        return [staged.fwd, staged.rev]
    return [t for w in staged for t in _weight_leaves(w)]


def clone_weights(staged):
    """A copy of staged weights (:class:`EdgeWeights`, or nested lists of
    them as the partitioned attention stages them) in new buffers; a
    tensor that appears twice (dp rows sharing a card) is cloned once."""
    memo = {}

    def clone(w):
        if w is None:
            return None
        if isinstance(w, EdgeWeights):
            return EdgeWeights(fwd=clone(w.fwd), rev=clone(w.rev))
        if isinstance(w, torch.Tensor):
            if id(w) not in memo:
                memo[id(w)] = w.clone()
            return memo[id(w)]
        return [clone(x) for x in w]
    return clone(staged)


def copy_weights_(dst, src) -> None:
    """Copies staged weights into the buffers of :func:`clone_weights`,
    in place: a captured step keeps reading them at their addresses."""
    done = set()
    for d, s in zip(_weight_leaves(dst), _weight_leaves(src), strict=True):
        if id(d) not in done:
            d.copy_(s)
            done.add(id(d))


@dataclasses.dataclass(frozen=True)
class CKGMeta:
    """Static description of a collaborative knowledge graph's id spaces."""

    n_users: int
    n_entities: int   # includes items: item ids are entity ids [0, n_items)
    n_items: int
    n_relations_kg: int   # original KG relations, before inverses/interact
    n_relations: int      # total relation ids in the CKG (2*kg + 2)
    rel_interact: int     # etype of the user<-item "interact" edges (dst=user)
    rel_interacted_by: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_entities

    def user_node(self, uid):
        """Map a user id to its CKG node id (users sit after entities)."""
        return self.n_entities + uid


def build_ckg(cf_pairs: np.ndarray, kg_triples: np.ndarray, n_users: int,
              n_entities: int, n_items: int, n_relations_kg: int, *,
              rel_tile: int = REL_TILE) -> Tuple[Graph, CKGMeta]:
    """Construct the collaborative knowledge graph.

    ``cf_pairs``: (n_inter, 2) int array of (user, item).
    ``kg_triples``: (n_trip, 3) int array of (h, r, t).

    Every triple (h, r, t) becomes a message edge t -> h (src=t, dst=h), so
    the per-dst softmax normalizes over the triples headed by h. Relations:
    r in [0, R) original; r+R the inverse triple; 2R = interact (edge
    item -> user); 2R+1 = interacted-by (edge user -> item).
    """
    cf_pairs = np.asarray(cf_pairs, dtype=np.int64).reshape(-1, 2)
    kg_triples = np.asarray(kg_triples, dtype=np.int64).reshape(-1, 3)
    R = int(n_relations_kg)
    meta = CKGMeta(
        n_users=int(n_users), n_entities=int(n_entities),
        n_items=int(n_items), n_relations_kg=R, n_relations=2 * R + 2,
        rel_interact=2 * R, rel_interacted_by=2 * R + 1)

    h, r, t = kg_triples[:, 0], kg_triples[:, 1], kg_triples[:, 2]
    u = meta.user_node(cf_pairs[:, 0])
    i = cf_pairs[:, 1]
    src = np.concatenate([t, h, i, u])
    dst = np.concatenate([h, t, u, i])
    ety = np.concatenate([r, r + R, np.full(len(u), 2 * R),
                          np.full(len(u), 2 * R + 1)])
    g = build_graph(src, dst, ety, n_nodes=meta.n_nodes,
                    n_relations=meta.n_relations, rel_tile=rel_tile)
    return g, meta


# Graph fields saved as arrays, besides the row splits' and rel_offsets.
_CACHED = ("src", "dst", "etype", "row_offsets", "rel_perm", "tiles",
           "rev_perm", "rev_row_offsets", "rev_dst")
_SPLITS = ("split", "rev_split")
_SPLIT_ARRAYS = ("units", "split_rows", "slot_offsets")
_SPLIT_STATICS = ("n_rows", "n_edges", "n_slots", "chunk")


def save_graph(path: str, g: Graph, meta: Optional[CKGMeta] = None) -> str:
    """Write a built :class:`Graph` (on the CPU), both its row splits and
    ``meta`` to one ``.npz`` file at ``path``, through a temporary file of
    this writer's own and ``os.replace``: processes that build the same
    graph at once each write a whole file, and the last one stays
    (``kgat_tpu/graph.py:728-736``)."""
    statics = {"version": GRAPH_CACHE_VERSION, "n_nodes": g.n_nodes,
               "n_relations": g.n_relations,
               "meta": None if meta is None else dataclasses.asdict(meta)}
    arrays = {k: getattr(g, k).numpy() for k in _CACHED}
    arrays["rel_offsets"] = np.asarray(g.rel_offsets, np.int64)
    for name in _SPLITS:
        split = getattr(g, name)
        arrays.update({f"{name}/{k}": getattr(split, k).numpy()
                       for k in _SPLIT_ARRAYS})
        statics[name] = {k: getattr(split, k) for k in _SPLIT_STATICS}
    arrays["statics_json"] = np.frombuffer(json.dumps(statics).encode(),
                                           np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_graph(path: str) -> Tuple[Graph, Optional[CKGMeta]]:
    """The :class:`Graph` (on the CPU, with both row splits) and the
    :class:`CKGMeta` that :func:`save_graph` wrote to ``path``. Raises
    ValueError for a file of another :data:`GRAPH_CACHE_VERSION`, and
    whatever ``np.load`` raises for a damaged one."""
    with np.load(path) as z:
        statics = json.loads(bytes(z["statics_json"]).decode())
        if statics.get("version") != GRAPH_CACHE_VERSION:
            raise ValueError(f"graph cache version {statics.get('version')}"
                             f" != {GRAPH_CACHE_VERSION}")
        fields = {k: torch.from_numpy(z[k]) for k in _CACHED}
        for name in _SPLITS:
            fields[name] = RowSplit(
                **{k: torch.from_numpy(z[f"{name}/{k}"])
                   for k in _SPLIT_ARRAYS},
                **{k: int(v) for k, v in statics[name].items()})
        rel_offsets = tuple(int(x) for x in z["rel_offsets"])
    g = Graph(**fields, rel_offsets=rel_offsets,
              n_nodes=int(statics["n_nodes"]),
              n_relations=int(statics["n_relations"]))
    meta = statics["meta"]
    return g, (None if meta is None else CKGMeta(**meta))
