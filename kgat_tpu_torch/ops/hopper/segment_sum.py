"""K1 and K6 wrappers (``csrc/segment_sum.cu``): the weighted CSR SpMM,
the SpMM with a backward, and the segment sum of a value stream.

K1 replaces ``kgat_tpu/ops/pallas/segment_sum.py::_kernel_w``. A CF
training step launches it six times for the reference recipe: once per
layer in the forward (d = 64, 64, 32) on the dst-sorted CSR, and once per
layer in the backward on the src-sorted (reverse) CSR, for the gradient
w.r.t. the features (``pallas_backend._spmm_bwd``'s ``d_x``). The serving
forward launches the first three. The partitioned trainer's all-gather
exchange launches it on each shard's CSRs (``parallel/halo.py``).

K6 (:func:`segment_sum_csr`) replaces ``segment_sum.py::accum_step``: the
partitioned ring exchange reduces each bucket's pre-gathered value stream
with it, forward and backward.

A CUDA launch walks the CSR's work units (``ops/row_split.py``), which
the caller passes with the CSR (``Graph.split``, ``Bucket.split`` and
their ``rev_split``): one CUDA launch per call, two where a row is longer
than the schedule's chunk.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from kgat_tpu_torch.graph import EdgeWeights, Graph
from kgat_tpu_torch.ops import ref, row_split
from kgat_tpu_torch.ops.hopper import build

MAX_DIM = 256


def spmm_csr_plain(row_offsets: torch.Tensor, src: torch.Tensor,
                   w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_csr` (gather + ``index_add_``),
    in float64 when ``w`` or ``x`` is."""
    return ref.spmm_coo(src, ref.offsets_to_dst(row_offsets), w, x,
                        row_offsets.numel() - 1)


def _split_tensors(split: Optional[row_split.RowSplit]) -> tuple:
    return () if split is None else split.tensors


def split_args(split: row_split.RowSplit) -> tuple:
    """The RowSplit arguments that open each row reduction's C entry point:
    units, n_units, split_rows, slot_offsets, n_split."""
    return (split.units.data_ptr(), split.n_units,
            split.split_rows.data_ptr(), split.slot_offsets.data_ptr(),
            split.n_split)


def partials(split: row_split.RowSplit, d: int,
             device: torch.device) -> torch.Tensor:
    """The scratch rows the split rows' units write: (n_slots, d) f32."""
    return torch.empty((split.n_slots, d), dtype=torch.float32,
                       device=device)


def _launch(name: str, row_offsets: torch.Tensor, src: torch.Tensor,
            w: torch.Tensor, x: torch.Tensor,
            split: Optional[row_split.RowSplit]) -> torch.Tensor:
    if not build.use_kernel(name, row_offsets, src, w, x,
                            *_split_tensors(split)):
        return spmm_csr_plain(row_offsets, src, w, x)
    build.check_tensor("row_offsets", row_offsets, (torch.int32,), 1)
    build.check_tensor("src", src, (torch.int32,), 1)
    build.check_tensor("w", w, (torch.float32,), 1)
    build.check_tensor("x", x, (torch.float32, torch.bfloat16), 2)
    n_rows, d = row_offsets.numel() - 1, x.shape[1]
    if w.shape != src.shape:
        raise ValueError(f"w {tuple(w.shape)} != src {tuple(src.shape)}")
    if not 0 < d <= MAX_DIM:
        raise ValueError(f"feature dim {d} not in (0, {MAX_DIM}]")
    split = row_split.require(name, split, n_rows, src.numel())
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return out
    scratch = partials(split, d, x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.kgat_spmm_csr(
            *split_args(split), src.data_ptr(), w.data_ptr(), x.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), d,
            int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(build.stream_ptr(x.device)))
    build.check_launch(lib, code, name)
    build.launch_counts[name] += 1
    return out


def spmm_csr(row_offsets: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor,
             split: Optional[row_split.RowSplit] = None) -> torch.Tensor:
    """out[v] = sum over e in [row_offsets[v], row_offsets[v+1]) of
    w[e] * x[src[e]] -> (n_rows, d) float32. Forward only: :func:`spmm`
    is the same product with a backward.

    row_offsets: (n_rows + 1,) int32 CSR offsets over destinations, from 0
    to E; src: (E,) int32 rows of ``x``; w: (E,) float32; x: (n, d)
    float32 or bfloat16 (the bf16 value stream), accumulated in float32;
    split: the CSR's :class:`~kgat_tpu_torch.ops.row_split.RowSplit`
    (``Graph.split``). CPU tensors take :func:`spmm_csr_plain`; CUDA
    tensors launch the kernel, and raise without ``split``.
    """
    return _launch("spmm_csr", row_offsets, src, w, x, split)


def spmm_csr_rev(rev_row_offsets: torch.Tensor, rev_dst: torch.Tensor,
                 w_rev: torch.Tensor, g: torch.Tensor,
                 split: Optional[row_split.RowSplit] = None) -> torch.Tensor:
    """The SpMM's gradient w.r.t. its features: K1 launched on the reverse
    CSR, d_x[u] = sum over edges e with src u of w[e] * g[dst[e]], with
    ``Graph.rev_row_offsets``, ``Graph.rev_dst``, ``w_rev = w[rev_perm]``
    and ``Graph.rev_split``. Counted apart from the forward launches
    (``spmm_csr_rev``)."""
    return _launch("spmm_csr_rev", rev_row_offsets, rev_dst, w_rev, g, split)


def segment_sum_csr(row_offsets: torch.Tensor, vals: torch.Tensor,
                    split: Optional[row_split.RowSplit] = None
                    ) -> torch.Tensor:
    """K6: out[r] = sum over e in [row_offsets[r], row_offsets[r+1]) of
    vals[e] -> (n_rows, d) float32, every row written (an empty row as 0).

    Replaces ``kgat_tpu/ops/pallas/segment_sum.py::accum_step`` (the
    ``_kernel`` of ``segment_sum_aligned``), the reduce of every ring
    bucket. row_offsets: (n_rows + 1,) int32 CSR offsets from 0 to E;
    vals: (E, d) float32 or bfloat16 pre-gathered values in CSR order,
    accumulated in float32; E may be 0; split: the CSR's RowSplit
    (``Bucket.split``, ``Bucket.rev_split``). It shares its row reduction
    with K1 and K8 (``csrc/row_reduce.cuh``). CPU tensors take
    ``ref.segment_sum_csr``; CUDA tensors launch the kernel, and raise
    without ``split``."""
    name = "segment_sum_csr"
    if not build.use_kernel(name, row_offsets, vals, *_split_tensors(split)):
        return ref.segment_sum_csr(row_offsets, vals)
    build.check_tensor("row_offsets", row_offsets, (torch.int32,), 1)
    build.check_tensor("vals", vals, (torch.float32, torch.bfloat16), 2)
    n_rows, d = row_offsets.numel() - 1, vals.shape[1]
    if not 0 < d <= MAX_DIM:
        raise ValueError(f"feature dim {d} not in (0, {MAX_DIM}]")
    split = row_split.require(name, split, n_rows, vals.shape[0])
    out = torch.empty((n_rows, d), dtype=torch.float32, device=vals.device)
    if n_rows == 0:
        return out
    scratch = partials(split, d, vals.device)
    lib = build.library()
    with torch.cuda.device(vals.device):
        code = lib.kgat_segment_sum_csr(
            *split_args(split), vals.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), d,
            int(vals.dtype == torch.bfloat16),
            ctypes.c_void_p(build.stream_ptr(vals.device)))
    build.check_launch(lib, code, name)
    build.launch_counts[name] += 1
    return out


def edge_dot(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """The SpMM's gradient w.r.t. its weights: <x[src_e], g[dst_e]> per
    edge, in plain torch (XLA computes it in ``_spmm_bwd`` too)."""
    return (x.index_select(0, src.long()).to(g.dtype)
            * g.index_select(0, dst.long())).sum(-1)


class _Spmm(torch.autograd.Function):
    """K1 forward on the dst-sorted CSR; backward: d_x by K1 on the
    reverse CSR, d_w by :func:`edge_dot` only when it is asked for."""

    @staticmethod
    def forward(ctx, w, x, w_rev, graph):
        ctx.graph = graph
        ctx.save_for_backward(w, x, w_rev)
        return spmm_csr(graph.row_offsets, graph.src, w, x, graph.split)

    @staticmethod
    def backward(ctx, g):
        w, x, w_rev = ctx.saved_tensors
        graph = ctx.graph
        d_w = d_x = None
        g = g.contiguous()
        if ctx.needs_input_grad[1]:
            if w_rev is None:
                w_rev = w[graph.rev_perm.long()].contiguous()
            d_x = spmm_csr_rev(graph.rev_row_offsets, graph.rev_dst, w_rev,
                               g.to(x.dtype), graph.rev_split).to(x.dtype)
        if ctx.needs_input_grad[0]:
            d_w = edge_dot(graph.src, graph.dst, x, g).to(w.dtype)
        return d_w, d_x, None, None


def bucket_vals(bucket, w: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """A ring bucket's value stream chunk[src] * w in forward-CSR order,
    gathered in torch (as XLA does at ``pallas_backend.py:227``)."""
    return (chunk.index_select(0, bucket.src.long())
            * w.to(chunk.dtype)[:, None]).contiguous()


def bucket_cotangent(bucket, w_rev: torch.Tensor, g: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """A bucket SpMM's gradient w.r.t. its chunk: K6 on the bucket's
    reverse CSR over g[dst] * w, reduced at the chunk's dtype (the
    single-device dual of ``pallas_backend._spmm_bwd``)."""
    vals = (g.to(dtype).index_select(0, bucket.rev_dst.long())
            * w_rev.to(dtype)[:, None]).contiguous()
    return segment_sum_csr(bucket.rev_row_offsets, vals,
                           bucket.rev_split).to(dtype)


class _BucketSpmm(torch.autograd.Function):
    """A ring bucket's SpMM: the value stream chunk[src] * w gathered in
    torch, then K6 on the bucket's forward CSR; backward: K6 on its
    reverse CSR for d_chunk (``halo.py:83-84``), the per-edge dot for
    d_w only when it is asked for."""

    @staticmethod
    def forward(ctx, w, chunk, w_rev, bucket):
        ctx.bucket = bucket
        ctx.save_for_backward(chunk, w_rev)
        return segment_sum_csr(bucket.row_offsets,
                               bucket_vals(bucket, w, chunk), bucket.split)

    @staticmethod
    def backward(ctx, g):
        chunk, w_rev = ctx.saved_tensors
        b = ctx.bucket
        g = g.contiguous()
        d_chunk = (bucket_cotangent(b, w_rev, g, chunk.dtype)
                   if ctx.needs_input_grad[1] else None)
        d_w = (edge_dot(b.src, b.dst, chunk, g)
               if ctx.needs_input_grad[0] else None)
        return d_w, d_chunk, None, None


def bucket_spmm(bucket, edge_w: EdgeWeights,
                chunk: torch.Tensor) -> torch.Tensor:
    """One ring bucket's partial: out[r] = sum over the bucket's edges
    (u -> r) of w * chunk[u] -> (R, d) float32, differentiable in the
    chunk and the forward weights. ``bucket`` is a
    ``parallel.partition.Bucket``, ``edge_w`` its staged weights."""
    return _BucketSpmm.apply(edge_w.fwd, chunk, edge_w.rev, bucket)


def spmm(graph: Graph, edge_w: Union[torch.Tensor, EdgeWeights],
         x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of w[e] * x[u], differentiable in
    ``x`` and in canonical weights. ``edge_w`` is the canonical (E,)
    weights or :class:`EdgeWeights` staged once per attention recompute,
    which saves the backward its gather of ``w[rev_perm]``."""
    if isinstance(edge_w, EdgeWeights):
        return _Spmm.apply(edge_w.fwd, x, edge_w.rev, graph)
    return _Spmm.apply(edge_w, x, None, graph)
