"""Edge partitioning of the CKG into destination blocks.

Port of ``kgat_tpu/parallel/partition.py``'s ``partition_graph``,
``build_ring_buckets`` and ``build_selective_halo``. Partition p owns the
destination rows [p R, (p + 1) R) and every edge that points into them,
so the attention (SDDMM and the per-dst softmax) needs no communication,
and the SpMM's output rows are owned; only the source rows of the
features are exchanged (an all-gather per layer, a ring of chunks, or
the selective halo all-to-all of exactly the rows a peer's edges read).
R is a multiple of 128 as in the JAX package, so both split the rows the
same way.

The TPU layouts (aligned chunks, block bounds, forced shard-uniform
shapes, halo blocks rounded to 128 rows) are not carried over: a shard, a
ring bucket and a halo's edges are plain CSRs of their real edges, of
whatever length they have.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from kgat_tpu_torch import native
from kgat_tpu_torch.graph import REL_TILE, Graph, build_graph
from kgat_tpu_torch.ops.row_split import RowSplit, build_row_split

ROW_ALIGN = 128   # rows per partition are a multiple of this (JAX's block)


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    n_parts: int
    rows_per_part: int       # multiple of 128; partition p owns rows [p*R, (p+1)*R)
    n_nodes_global: int
    n_nodes_pad: int         # rows_per_part * n_parts


def partition_info(n_nodes: int, n_parts: int) -> PartitionInfo:
    """R = round_up(ceil(n_nodes / P), 128), as ``kgat_tpu`` cuts rows."""
    if n_parts < 1:
        raise ValueError(f"n_parts must be positive, got {n_parts}")
    per = -(-n_nodes // n_parts)
    R = -(-per // ROW_ALIGN) * ROW_ALIGN
    return PartitionInfo(n_parts=n_parts, rows_per_part=R,
                         n_nodes_global=n_nodes, n_nodes_pad=R * n_parts)


def _tensors_to(obj, device):
    """A copy of dataclass ``obj`` with every tensor field (and graph and
    row split) on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), (torch.Tensor, Graph, RowSplit))})


@dataclasses.dataclass(frozen=True)
class Shard:
    """Partition p's edges in mixed coordinates (``partition.py:353-359``):

    * ``graph``: a :class:`Graph` of the shard's edges whose ``src`` and
      relation tiles are global, whose ``dst``, ``row_offsets`` (the
      forward CSR, R + 1 offsets) and ``rev_dst`` are LOCAL rows (0..R),
      and whose reverse CSR (``rev_perm``, ``rev_row_offsets``) runs over
      the GLOBAL source rows (n_pad + 1 offsets): the SpMM's feature
      gradient is a partial over the whole table. ``n_nodes`` is R.
    * ``dst_global``: the same edges' global dst, for the attention
      gathers (:meth:`att_graph`).
    * ``edge_ids``: each shard edge's position in the edge arrays given to
      :func:`partition_graph`.
    """

    graph: Graph
    dst_global: torch.Tensor
    edge_ids: torch.Tensor

    @property
    def n_edges(self) -> int:
        return self.graph.n_edges

    def att_graph(self) -> Graph:
        """The shard's graph with global dst: the attention logits gather
        the head rows of the full embedding table through it."""
        return dataclasses.replace(self.graph, dst=self.dst_global)

    def to(self, device) -> "Shard":
        return _tensors_to(self, device)


def _shard_edges(dst: np.ndarray, info: PartitionInfo, p: int) -> np.ndarray:
    """Ids of partition p's edges in shard-canonical order: stably sorted
    by local dst, as ``kgat_tpu``'s shard build orders them."""
    R = info.rows_per_part
    sel = np.nonzero((dst >= p * R) & (dst < (p + 1) * R))[0]
    return sel[native.sort_perm(dst[sel] - p * R, R)]


def partition_graph(src: np.ndarray, dst: np.ndarray, etype: np.ndarray,
                    n_nodes: int, n_relations: int, n_parts: int, *,
                    rel_tile: int = REL_TILE
                    ) -> Tuple[List[Shard], PartitionInfo]:
    """Edges go to the partition that owns their dst row. Returns one
    :class:`Shard` per partition, on the CPU, and the row split."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    etype = np.asarray(etype, np.int64)
    info = partition_info(n_nodes, n_parts)
    R, n_pad = info.rows_per_part, info.n_nodes_pad
    shards = []
    for p in range(n_parts):
        ids = _shard_edges(dst, info, p)
        # build_graph sorts stably by (local) dst: the ids are in that
        # order already. Its node space is the padded global one, so the
        # reverse CSR spans every source row; the forward CSR keeps R + 1.
        g = build_graph(src[ids], dst[ids] - p * R, etype[ids],
                        n_nodes=n_pad, n_relations=n_relations,
                        rel_tile=rel_tile)
        row_offsets = g.row_offsets[:R + 1]
        g = dataclasses.replace(g, row_offsets=row_offsets,
                                split=build_row_split(row_offsets), n_nodes=R)
        shards.append(Shard(
            graph=g, dst_global=torch.from_numpy(
                (dst[ids]).astype(np.int32)),
            edge_ids=torch.from_numpy(ids)))
    return shards, info


@dataclasses.dataclass(frozen=True)
class Bucket:
    """The edges of partition p whose source lies in partition q's rows,
    q = (p - s) mod P: what p reduces at ring step s, when it holds q's
    activation chunk (``partition.py:52-58``). Plain CSRs:

    * forward: ``row_offsets`` over p's local dst rows (R + 1), ``src``
      each edge's source as a row of the chunk, ``dst`` its local dst;
    * reverse: ``rev_row_offsets`` over the chunk's rows (R + 1),
      ``rev_dst`` the local dst of each edge in that order;
    * ``gather`` / ``rev_gather``: each forward / reverse position's slot
      in the shard's canonical edge order, for staging weights;
    * ``split`` / ``rev_split``: the work units of the forward / reverse
      CSR (``ops/row_split.py``), for K6 and K8.
    """

    row_offsets: torch.Tensor      # (R + 1,) int32
    src: torch.Tensor              # (E_b,) int32 chunk rows
    dst: torch.Tensor              # (E_b,) int32 local dst rows
    rev_row_offsets: torch.Tensor  # (R + 1,) int32
    rev_dst: torch.Tensor          # (E_b,) int32
    gather: torch.Tensor           # (E_b,) int64 shard edge slots
    rev_gather: torch.Tensor       # (E_b,) int64
    split: RowSplit
    rev_split: RowSplit

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def to(self, device) -> "Bucket":
        return _tensors_to(self, device)


def build_ring_buckets(src: np.ndarray, dst: np.ndarray,
                       info: PartitionInfo) -> List[List[Bucket]]:
    """``buckets[p][s]``: partition p's bucket of ring step s, on the CPU.
    Must be given the same (src, dst) arrays as :func:`partition_graph`:
    the gathers index each shard's canonical edge order."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    P, R = info.n_parts, info.rows_per_part
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    out = []
    for p in range(P):
        ids = _shard_edges(dst, info, p)
        s_src, s_dst = src[ids], dst[ids] - p * R
        steps = []
        for s in range(P):
            q = (p - s) % P
            slots = np.nonzero(s_src // R == q)[0]   # ascending: dst-sorted
            b_src, b_dst = s_src[slots] - q * R, s_dst[slots]
            rev = native.sort_perm(b_src, R)
            ro = as32(native.csr_offsets(b_dst, R))
            rev_ro = as32(native.csr_offsets(b_src[rev], R))
            steps.append(Bucket(
                row_offsets=ro, src=as32(b_src), dst=as32(b_dst),
                rev_row_offsets=rev_ro, rev_dst=as32(b_dst[rev]),
                gather=torch.from_numpy(slots),
                rev_gather=torch.from_numpy(slots[rev]),
                split=build_row_split(ro), rev_split=build_row_split(rev_ro)))
        out.append(steps)
    return out


@dataclasses.dataclass(frozen=True)
class SelectiveHalo:
    """Partition p's data for the selective halo all-to-all
    (``partition.py:176-207``): its activations live in a local table of
    T = R + P H rows, ``[own R rows | H halo rows from each peer q]``,
    never in the replicated (n_pad, d) one.

    * ``graph``: the shard's :class:`Graph` (canonical edge order, forward
      CSR over the R local dst rows, its row split) with ``src`` remapped
      to local-table slots, and the reverse CSR (``rev_perm``,
      ``rev_row_offsets``, ``rev_dst``, ``rev_split``) over the T table
      rows: the shard's attention stages onto it with
      ``EdgeWeights.stage``, and K1 runs on it both ways.
    * ``send_idx``: (P, H) int64, row q the own (local) rows that peer q's
      edges read, padded with 0 (no edge reads a padded slot); row p is
      all padding.
    * ``local_ids``: (T,) int64, the global row of each table slot; the
      unfilled halo slots hold ``n_nodes_global``, a sentinel.
    """

    graph: Graph
    send_idx: torch.Tensor
    local_ids: torch.Tensor
    halo_rows: int       # H: the most rows one partition needs of one peer
    table_rows: int      # T = R + P H

    def to(self, device) -> "SelectiveHalo":
        return _tensors_to(self, device)


def build_selective_halo(shards: List[Shard],
                         info: PartitionInfo) -> List[SelectiveHalo]:
    """One :class:`SelectiveHalo` per partition, on the CPU, from the
    shards of :func:`partition_graph` (``partition.py:210-301``, without
    its padding: H is the largest need, unrounded, and the edges keep the
    shard's order)."""
    P, R, N = info.n_parts, info.rows_per_part, info.n_nodes_global
    srcs = [s.graph.src.numpy().astype(np.int64) for s in shards]
    # need[p][q]: the sorted global rows of peer q that p's edges read.
    need = [[np.unique(s[s // R == q]) if q != p else np.zeros(0, np.int64)
             for q in range(P)] for p, s in enumerate(srcs)]
    H = max(len(rows) for per in need for rows in per)
    T = R + P * H
    out = []
    for p, (shard, s_src) in enumerate(zip(shards, srcs)):
        slots = s_src - p * R               # own rows: their local row
        local_ids = np.full(T, N, np.int64)
        local_ids[:R] = np.arange(p * R, (p + 1) * R)
        send_idx = np.zeros((P, H), np.int64)
        for q in range(P):
            rows = need[p][q]
            local_ids[R + q * H:R + q * H + len(rows)] = rows
            m = s_src // R == q
            if q != p:
                slots[m] = R + q * H + np.searchsorted(rows, s_src[m])
            sent = need[q][p]               # p's rows that q reads
            send_idx[q, :len(sent)] = sent - p * R
        rev = np.argsort(slots, kind="stable")
        rev_ro = torch.from_numpy(np.searchsorted(
            slots[rev], np.arange(T + 1)).astype(np.int32))
        g = dataclasses.replace(
            shard.graph, src=torch.from_numpy(slots.astype(np.int32)),
            rev_perm=torch.from_numpy(rev.astype(np.int32)),
            rev_row_offsets=rev_ro,
            rev_dst=shard.graph.dst[torch.from_numpy(rev)].contiguous(),
            rev_split=build_row_split(rev_ro), co=None)
        out.append(SelectiveHalo(
            graph=g, send_idx=torch.from_numpy(send_idx),
            local_ids=torch.from_numpy(local_ids), halo_rows=H,
            table_rows=T))
    return out
