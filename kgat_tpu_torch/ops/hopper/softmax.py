"""K3 and K5 wrappers: per-destination segment softmax over the CSR and
its backward (``csrc/softmax.cu``).

K3 replaces ``kgat_tpu/ops/pallas/softmax.py::_max_kernel``,
``_expsum_kernel`` and ``_norm_kernel``; K5 replaces ``_wsum_kernel`` and
``_dlogit_kernel`` (``segment_softmax_aligned_bwd``). The serving forward
and each attention recompute call K3 once; K5 runs where the attention
itself is differentiated (:func:`segment_softmax`). K3 and K5 walk the
CSR's work units (``ops/row_split.py``, ``Graph.split``): one CUDA launch
per call, two where a row is longer than the schedule's chunk.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kgat_tpu_torch.graph import Graph
from kgat_tpu_torch.ops import ref, row_split
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.segment_sum import split_args


def segment_softmax_csr_plain(row_offsets: torch.Tensor,
                              logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_softmax_csr`."""
    return ref.segment_softmax_coo(ref.offsets_to_dst(row_offsets), logits,
                                   row_offsets.numel() - 1)


def segment_softmax_csr(row_offsets: torch.Tensor, logits: torch.Tensor,
                        split: Optional[row_split.RowSplit] = None
                        ) -> torch.Tensor:
    """Softmax of ``logits`` within each CSR row -> (E,) float32 weights.
    Forward only: :func:`segment_softmax` has the backward.

    row_offsets: (n_rows + 1,) int32 offsets, from 0 to E; logits: (E,)
    float32 in CSR (canonical) order; split: the CSR's
    :class:`~kgat_tpu_torch.ops.row_split.RowSplit` (``Graph.split``).
    CPU tensors take :func:`segment_softmax_csr_plain`; CUDA tensors
    launch the kernel, and raise without ``split``.
    """
    tensors = () if split is None else split.tensors
    if not build.use_kernel("segment_softmax_csr", row_offsets, logits,
                            *tensors):
        return segment_softmax_csr_plain(row_offsets, logits)
    build.check_tensor("row_offsets", row_offsets, (torch.int32,), 1)
    build.check_tensor("logits", logits, (torch.float32,), 1)
    n_rows = row_offsets.numel() - 1
    split = row_split.require("segment_softmax_csr", split, n_rows,
                              logits.numel())
    out = torch.empty_like(logits)
    if n_rows == 0 or logits.numel() == 0:
        return out
    partials = torch.empty((split.n_slots, 2), dtype=torch.float32,
                           device=logits.device)
    lib = build.library()
    with torch.cuda.device(logits.device):
        code = lib.kgat_segment_softmax_csr(
            *split_args(split), split.n_slots, split.chunk,
            row_offsets.data_ptr(), logits.data_ptr(), out.data_ptr(),
            partials.data_ptr(),
            ctypes.c_void_p(build.stream_ptr(logits.device)))
    build.check_launch(lib, code, "segment_softmax_csr")
    build.launch_counts["segment_softmax_csr"] += 1
    return out


def segment_softmax_csr_bwd_plain(row_offsets: torch.Tensor, w: torch.Tensor,
                                  g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_softmax_csr_bwd` (in
    float64 when the inputs are)."""
    return ref.segment_softmax_coo_bwd(ref.offsets_to_dst(row_offsets), w, g,
                                       row_offsets.numel() - 1)


def segment_softmax_csr_bwd(row_offsets: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor,
                            split: Optional[row_split.RowSplit] = None
                            ) -> torch.Tensor:
    """K5: d_logit = w * (g - sum over the row of w * g) -> (E,) float32.

    w: (E,) float32 softmax output (from :func:`segment_softmax_csr`); g:
    (E,) float32 cotangent of ``w``; both in CSR order; split: the CSR's
    :class:`~kgat_tpu_torch.ops.row_split.RowSplit`, as for K3. CPU
    tensors take :func:`segment_softmax_csr_bwd_plain`; CUDA tensors
    launch the kernel, and raise without ``split``.
    """
    tensors = () if split is None else split.tensors
    if not build.use_kernel("segment_softmax_csr_bwd", row_offsets, w, g,
                            *tensors):
        return segment_softmax_csr_bwd_plain(row_offsets, w, g)
    build.check_tensor("row_offsets", row_offsets, (torch.int32,), 1)
    build.check_tensor("w", w, (torch.float32,), 1)
    build.check_tensor("g", g, (torch.float32,), 1)
    if w.shape != g.shape:
        raise ValueError(f"w {tuple(w.shape)} != g {tuple(g.shape)}")
    n_rows = row_offsets.numel() - 1
    split = row_split.require("segment_softmax_csr_bwd", split, n_rows,
                              w.numel())
    out = torch.empty_like(w)
    if n_rows == 0 or w.numel() == 0:
        return out
    partials = torch.empty(split.n_slots, dtype=torch.float32,
                           device=w.device)
    lib = build.library()
    with torch.cuda.device(w.device):
        code = lib.kgat_segment_softmax_csr_bwd(
            *split_args(split), split.n_slots, split.chunk,
            row_offsets.data_ptr(), w.data_ptr(), g.data_ptr(),
            out.data_ptr(), partials.data_ptr(),
            ctypes.c_void_p(build.stream_ptr(w.device)))
    build.check_launch(lib, code, "segment_softmax_csr_bwd")
    build.launch_counts["segment_softmax_csr_bwd"] += 1
    return out


class _SegmentSoftmax(torch.autograd.Function):
    """K3 forward, K5 backward."""

    @staticmethod
    def forward(ctx, logits, graph):
        w = segment_softmax_csr(graph.row_offsets, logits, graph.split)
        ctx.save_for_backward(graph.row_offsets, w)
        ctx.split = graph.split
        return w

    @staticmethod
    def backward(ctx, g):
        row_offsets, w = ctx.saved_tensors
        return segment_softmax_csr_bwd(row_offsets, w, g.contiguous(),
                                       ctx.split), None


def segment_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    """Per-dst softmax of canonical-order logits, differentiable."""
    return _SegmentSoftmax.apply(logits, graph)
