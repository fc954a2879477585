"""The unit schedule of the CSR row kernels: the row reduction that K1,
K6, K8 and K4's fold share, and K3's softmax and K5, its backward.

One row of a power-law graph can hold thousands of times the mean number
of edges (the yelp2018-scale hub: 70,884 in-edges and as many out-edges,
against a mean of 33), so the kernels (``ops/hopper/csrc/row_reduce.cuh``,
``csrc/softmax.cu``) do not take a row as their unit of work. Every CSR
row is cut into units of at most ``chunk`` consecutive edges, in edge
order:

* a row of at most ``chunk`` edges is one unit, which writes its output
  row (an empty row is one unit that writes 0);
* a longer row's units each write a float32 partial row (K3: a (max,
  sum) pair; K5: a sum) into a slot of a scratch buffer, the slots of one row
  consecutive and in unit order; a second pass combines each such row's
  slots in that order.

Nothing is summed with atomics, so two calls give the same bits. The
schedule depends on the CSR offsets alone: it is built once per CSR (by
``graph.build_graph`` and ``parallel.partition``) and carried with it,
never by a kernel's wrapper.
"""

from __future__ import annotations

import dataclasses

import torch

# Edges per unit, chosen on an H100 (tools/bench_row_reduce.py; PERF.md):
# short enough that a hub row's units spread over many warps and none
# outlasts the launch's last wave, long enough that few rows need the
# second pass. K1 at d = 64 took 0.152, 0.138, 0.142, 0.170 and 0.257 ms
# per launch at 128, 256, 512, 1,024 and 2,048 edges.
CHUNK = 256


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The units of one CSR, all tensors int32 on one device."""

    units: torch.Tensor         # (U, 4) (row, lo, hi, slot); slot -1: the unit writes its row
    split_rows: torch.Tensor    # (S,) rows of more than one unit, ascending
    slot_offsets: torch.Tensor  # (S + 1,) split_rows[s]'s slots: [slot_offsets[s], slot_offsets[s+1])
    n_rows: int
    n_edges: int
    n_slots: int                # partial rows in the scratch buffer: the units of split rows
    chunk: int

    @property
    def n_units(self) -> int:
        return int(self.units.shape[0])

    @property
    def n_split(self) -> int:
        return int(self.split_rows.shape[0])

    @property
    def cuda_launches(self) -> int:
        """Kernel launches per reduction: the units, then the second pass
        when a row was split."""
        return 1 + (self.n_split > 0)

    @property
    def tensors(self):
        return self.units, self.split_rows, self.slot_offsets

    def to(self, device) -> "RowSplit":
        return dataclasses.replace(self, units=self.units.to(device),
                                   split_rows=self.split_rows.to(device),
                                   slot_offsets=self.slot_offsets.to(device))


def build_row_split(row_offsets: torch.Tensor,
                    chunk: int = CHUNK) -> RowSplit:
    """The :class:`RowSplit` of the CSR ``row_offsets`` ((n_rows + 1,)
    non-decreasing, from 0), on its device: units in row order, a row's
    units in edge order."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if row_offsets.dim() != 1 or row_offsets.numel() < 1:
        raise ValueError("row_offsets must be 1-D with n_rows + 1 entries")
    ro = row_offsets.long()
    dev = ro.device
    n_rows = ro.numel() - 1
    lens = ro[1:] - ro[:-1]
    per_row = ((lens + chunk - 1) // chunk).clamp(min=1)
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev), per_row)
    first = torch.cumsum(per_row, 0) - per_row
    k = torch.arange(row.numel(), device=dev) - first[row]
    lo = ro[row] + k * chunk
    hi = torch.minimum(lo + chunk, ro[row + 1])
    multi = per_row > 1
    in_split = multi[row]
    slot = torch.full_like(row, -1)
    slot[in_split] = torch.arange(int(in_split.sum()), device=dev)
    split_rows = multi.nonzero().flatten()
    slot_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                              torch.cumsum(per_row[split_rows], 0)])
    as32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return RowSplit(units=as32(torch.stack([row, lo, hi, slot], 1)),
                    split_rows=as32(split_rows),
                    slot_offsets=as32(slot_offsets), n_rows=n_rows,
                    n_edges=int(ro[-1]), n_slots=int(slot_offsets[-1]),
                    chunk=chunk)


def require(name: str, split, n_rows: int, n_edges: int) -> RowSplit:
    """``split`` checked against the CSR a wrapper was given: it raises
    when there is none (a kernel launch never builds one) or when its row
    or edge count differs."""
    if split is None:
        raise ValueError(f"{name}: a kernel launch needs the CSR's RowSplit "
                         f"(built once per CSR: Graph.split, Bucket.split, "
                         f"ops.row_split.build_row_split)")
    if (split.n_rows, split.n_edges) != (n_rows, n_edges):
        raise ValueError(f"{name}: RowSplit of {split.n_rows} rows and "
                         f"{split.n_edges} edges for a CSR of {n_rows} rows "
                         f"and {n_edges} edges")
    return split
