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
* **Coalesced CSRs** (``co``, :class:`Coalesced`, built on first use by
  :func:`coalesced`): the multi-edges of one (dst, src) pair collapse
  into one group whose weight is the sum of its members', so the SpMM
  gathers each distinct source row once per destination
  (``kgat_tpu.graph``'s ``CoalescedLayouts``, its default training path).

:func:`save_graph` and :func:`load_graph` round-trip a built graph, its
row splits, its coalesced CSRs and its :class:`CKGMeta` through one
``.npz`` file, the port's counterpart of ``kgat_tpu.graph``'s graph cache
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
# is rebuilt, never read. Version 2 carries the coalesced CSRs.
GRAPH_CACHE_VERSION = 2

# Most members of a coalesced group (kgat_tpu's KGATConfig.coalesce_cap):
# a longer run of one (dst, src) pair splits into several groups.
COALESCE_CAP = 8


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
    co: Optional[Coalesced] = None  # coalesced CSRs, once built (coalesced())

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "Graph":
        """A copy with every tensor (and the row splits and coalesced
        CSRs) on ``device``."""
        return _to(self, device)


def _to(obj, device):
    """A copy of dataclass ``obj`` with every tensor, row split and
    coalesced CSR among its fields on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name),
                      (torch.Tensor, RowSplit, Coalesced))})


@dataclasses.dataclass(frozen=True)
class Coalesced:
    """The multi-edge-coalesced CSRs of a :class:`Graph` and what staging
    its weights needs: the port's ``kgat_tpu.graph.CoalescedLayouts``.

    A group is a run of the canonical edges of one (dst, src) pair, taken
    in ``kgat_tpu``'s within-segment order (stable by src within each
    dst, so a group's members keep their canonical order); a run longer
    than ``cap`` splits into consecutive groups of at most ``cap``
    members. The CSR fields carry :class:`Graph`'s names, over groups in
    place of edges, so the SpMM walks either the same way:

    * forward: ``row_offsets`` over the graph's dst rows, ``src`` and
      ``dst`` of each group (dst-major, src within);
    * reverse: ``rev_perm`` the group ids sorted stably by src,
      ``rev_row_offsets`` over the graph's source rows and ``rev_dst``
      = ``dst[rev_perm]``;
    * ``split`` / ``rev_split``: their row splits;
    * staging (:func:`coalesce_weights`): ``order`` the canonical edge
      ids in group order (group after group), ``within`` each one's index
      in its group, and ``last`` each group's last position in ``order``.

    Index tensors are int32, as the graph's.
    """

    row_offsets: torch.Tensor      # (n_rows + 1,)
    src: torch.Tensor              # (G,)
    dst: torch.Tensor              # (G,)
    rev_perm: torch.Tensor         # (G,)
    rev_row_offsets: torch.Tensor  # (n_src_rows + 1,)
    rev_dst: torch.Tensor          # (G,)
    order: torch.Tensor            # (E,)
    within: torch.Tensor           # (E,)
    last: torch.Tensor             # (G,)
    split: RowSplit
    rev_split: RowSplit
    cap: int

    @property
    def n_pairs(self) -> int:
        """The number of groups (distinct pairs, and the runs split at
        the cap)."""
        return int(self.src.shape[0])

    def to(self, device) -> "Coalesced":
        return _to(self, device)


def build_coalesced(g: Graph, cap: int = COALESCE_CAP) -> Coalesced:
    """The :class:`Coalesced` CSRs of ``g``, built on the host and placed
    on ``g``'s device (``kgat_tpu.graph.build_coalesced_layouts``). The
    rows are those of ``g``'s two CSRs: for a partition's shard, local dst
    rows forward and global source rows in reverse, as there."""
    if cap < 1:
        raise ValueError(f"coalesce cap must be positive, got {cap}")
    src = g.src.cpu().numpy().astype(np.int64)
    dst = g.dst.cpu().numpy().astype(np.int64)
    n_fwd = int(g.row_offsets.shape[0]) - 1
    n_rev = int(g.rev_row_offsets.shape[0]) - 1
    # kgat_tpu's within-segment order: stable by src, then stable by dst.
    by_src = native.sort_perm(src, n_rev)
    order = by_src[native.sort_perm(dst[by_src], n_fwd)]
    s, d = src[order], dst[order]
    n = len(order)
    starts = np.ones(n, bool)
    starts[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    pos = np.arange(n, dtype=np.int64)
    within = (pos - np.maximum.accumulate(np.where(starts, pos, 0))) % cap
    first = np.nonzero(within == 0)[0]
    last = np.append(first[1:], n)[:len(first)] - 1
    g_src, g_dst = s[first], d[first]
    rev_perm = native.sort_perm(g_src, n_rev)
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    ro = as32(native.csr_offsets(g_dst, n_fwd))
    rev_ro = as32(native.csr_offsets(g_src[rev_perm], n_rev))
    co = Coalesced(
        row_offsets=ro, src=as32(g_src), dst=as32(g_dst),
        rev_perm=as32(rev_perm), rev_row_offsets=rev_ro,
        rev_dst=as32(g_dst[rev_perm]), order=as32(order),
        within=as32(within), last=as32(last), split=build_row_split(ro),
        rev_split=build_row_split(rev_ro), cap=int(cap))
    return co.to(g.src.device)


def coalesced(g: Graph, cap: int = COALESCE_CAP) -> Coalesced:
    """``g``'s coalesced CSRs at ``cap``: ``g.co`` when it was built at
    that cap (by an earlier call, or loaded from the graph cache), else
    built now and kept on ``g``, as ``kgat_tpu.graph.build_coalesced``
    keeps them on its graph. Build them before a CUDA graph capture."""
    if g.co is None or g.co.cap != cap:
        object.__setattr__(g, "co", build_coalesced(g, cap))
    return g.co


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
    the reverse CSR; or, when ``coalesced``, one weight per group of the
    graph's :class:`Coalesced` CSRs built at ``cap``, in their forward
    and reverse orders. Made once per attention recompute (the
    counterpart of ``kgat_tpu.ops.pallas_backend.EdgeWeights``)."""

    fwd: torch.Tensor
    rev: torch.Tensor
    coalesced: bool = False
    cap: int = COALESCE_CAP

    @staticmethod
    def stage(graph: Graph, w: torch.Tensor) -> "EdgeWeights":
        return EdgeWeights(fwd=w, rev=w[graph.rev_perm.long()].contiguous())

    def with_tensors(self, fwd: torch.Tensor,
                     rev: torch.Tensor) -> "EdgeWeights":
        """The same staging (coalesced or not) over other tensors."""
        return dataclasses.replace(self, fwd=fwd, rev=rev)


def round_weights(w: torch.Tensor,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``w`` rounded to ``dtype`` (None: as it is), kept in ``w``'s dtype.

    ``kgat_tpu`` stages its SpMM weights in the value stream's dtype
    (``pallas_backend.py:144-145, :194-195, :455-456``): under bf16 its
    kernel multiplies bf16 features by bf16 weights. K1 reads float32
    weights; a bf16-rounded one times a bf16 feature is exact in float32,
    so it computes the same products."""
    return w if dtype is None else w.to(dtype).to(w.dtype)


def coalesce_weights(co: Coalesced, w: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> EdgeWeights:
    """Canonical (E,) weights staged onto the coalesced CSRs: each group's
    float32 sum of its members' weights, rounded to ``dtype`` after the
    sum, in the forward and reverse orders
    (``pallas_backend.coalesce_weights_from``). Differentiable in ``w``.

    The sums run in ``kgat_tpu``'s order, so float32 sums (and their bf16
    roundings) agree: over the group-ordered stream, ``cap - 1`` shifted
    copies, each masked to the members it reaches, added in turn; a
    group's last position then holds its last member plus the ones before
    it, nearest first. No ``index_add_``: its atomics have no order."""
    stream = w.float()[co.order.long()]
    n, acc = stream.shape[0], stream
    for j in range(1, co.cap):
        shifted = torch.cat([stream.new_zeros(j), stream])[:n]
        acc = acc + torch.where(co.within >= j, shifted, 0.0)
    fwd = round_weights(acc[co.last.long()], dtype)
    return EdgeWeights(fwd=fwd, rev=fwd[co.rev_perm.long()], coalesced=True,
                       cap=co.cap)


def stage_weights(graph: Graph, w: torch.Tensor, *,
                  dtype: Optional[torch.dtype] = None, coalesce: bool = False,
                  cap: int = COALESCE_CAP) -> EdgeWeights:
    """Canonical weights staged for the SpMM, as ``kgat_tpu``'s pallas
    backend stages them: summed over the coalesced groups when
    ``coalesce`` (:func:`coalesce_weights`), rounded to ``dtype``."""
    if coalesce:
        return coalesce_weights(coalesced(graph, cap), w, dtype)
    return EdgeWeights.stage(graph, round_weights(w, dtype))


def spmm_csr_of(graph: Graph, edge_w):
    """The CSRs an SpMM with ``edge_w`` walks: ``graph``'s own, or its
    coalesced ones for coalesced :class:`EdgeWeights` (which must have
    been built at their cap)."""
    if not (isinstance(edge_w, EdgeWeights) and edge_w.coalesced):
        return graph
    if graph.co is None or graph.co.cap != edge_w.cap:
        raise ValueError(f"weights coalesced at cap {edge_w.cap}, and the "
                         f"graph has no coalesced CSRs at that cap")
    return graph.co


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
            return w.with_tensors(clone(w.fwd), clone(w.rev))
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


# Graph fields saved as arrays, besides the row splits' and rel_offsets;
# and those of its coalesced CSRs, under "co/".
_CACHED = ("src", "dst", "etype", "row_offsets", "rel_perm", "tiles",
           "rev_perm", "rev_row_offsets", "rev_dst")
_CO_CACHED = ("row_offsets", "src", "dst", "rev_perm", "rev_row_offsets",
              "rev_dst", "order", "within", "last")
_SPLITS = ("split", "rev_split")
_SPLIT_ARRAYS = ("units", "split_rows", "slot_offsets")
_SPLIT_STATICS = ("n_rows", "n_edges", "n_slots", "chunk")


def _save_splits(obj, prefix: str, arrays: dict, statics: dict) -> None:
    for name in _SPLITS:
        split = getattr(obj, name)
        arrays.update({f"{prefix}{name}/{k}": getattr(split, k).numpy()
                       for k in _SPLIT_ARRAYS})
        statics[f"{prefix}{name}"] = {k: getattr(split, k)
                                      for k in _SPLIT_STATICS}


def _load_splits(z, prefix: str, statics: dict) -> dict:
    return {name: RowSplit(
        **{k: torch.from_numpy(z[f"{prefix}{name}/{k}"])
           for k in _SPLIT_ARRAYS},
        **{k: int(v) for k, v in statics[f"{prefix}{name}"].items()})
        for name in _SPLITS}


def save_graph(path: str, g: Graph, meta: Optional[CKGMeta] = None) -> str:
    """Write a built :class:`Graph` (on the CPU), both its row splits, its
    coalesced CSRs when built and ``meta`` to one ``.npz`` file at
    ``path``, through a temporary file of this writer's own and
    ``os.replace``: processes that build the same graph at once each
    write a whole file, and the last one stays
    (``kgat_tpu/graph.py:728-736``)."""
    statics = {"version": GRAPH_CACHE_VERSION, "n_nodes": g.n_nodes,
               "n_relations": g.n_relations,
               "meta": None if meta is None else dataclasses.asdict(meta),
               "co_cap": None if g.co is None else g.co.cap}
    arrays = {k: getattr(g, k).numpy() for k in _CACHED}
    arrays["rel_offsets"] = np.asarray(g.rel_offsets, np.int64)
    _save_splits(g, "", arrays, statics)
    if g.co is not None:
        arrays.update({f"co/{k}": getattr(g.co, k).numpy()
                       for k in _CO_CACHED})
        _save_splits(g.co, "co/", arrays, statics)
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
    """The :class:`Graph` (on the CPU, with both row splits and, when they
    were saved, its coalesced CSRs) and the :class:`CKGMeta` that
    :func:`save_graph` wrote to ``path``. Raises ValueError for a file of
    another :data:`GRAPH_CACHE_VERSION` (a file of version 1 has no
    coalesced CSRs), and whatever ``np.load`` raises for a damaged one."""
    with np.load(path) as z:
        statics = json.loads(bytes(z["statics_json"]).decode())
        if statics.get("version") != GRAPH_CACHE_VERSION:
            raise ValueError(f"graph cache version {statics.get('version')}"
                             f" != {GRAPH_CACHE_VERSION}")
        fields = {k: torch.from_numpy(z[k]) for k in _CACHED}
        fields.update(_load_splits(z, "", statics))
        rel_offsets = tuple(int(x) for x in z["rel_offsets"])
        co = None
        if statics["co_cap"] is not None:
            co = Coalesced(**{k: torch.from_numpy(z[f"co/{k}"])
                              for k in _CO_CACHED},
                           **_load_splits(z, "co/", statics),
                           cap=int(statics["co_cap"]))
    g = Graph(**fields, rel_offsets=rel_offsets,
              n_nodes=int(statics["n_nodes"]),
              n_relations=int(statics["n_relations"]), co=co)
    meta = statics["meta"]
    return g, (None if meta is None else CKGMeta(**meta))
