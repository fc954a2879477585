"""K1 wrapper: weighted CSR SpMM (``csrc/segment_sum.cu``), and the SpMM
with a backward.

Replaces ``kgat_tpu/ops/pallas/segment_sum.py::_kernel_w``. A CF training
step launches it six times for the reference recipe: once per layer in the
forward (d = 64, 64, 32) on the dst-sorted CSR, and once per layer in the
backward on the src-sorted (reverse) CSR, for the gradient w.r.t. the
features (``pallas_backend._spmm_bwd``'s ``d_x``). The serving forward
launches the first three.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from kgat_tpu_torch.graph import EdgeWeights, Graph
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build

MAX_DIM = 256


def spmm_csr_plain(row_offsets: torch.Tensor, src: torch.Tensor,
                   w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_csr` (gather + ``index_add_``),
    in float64 when ``w`` or ``x`` is."""
    return ref.spmm_coo(src, ref.offsets_to_dst(row_offsets), w, x,
                        row_offsets.numel() - 1)


def _launch(name: str, row_offsets: torch.Tensor, src: torch.Tensor,
            w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if not build.use_kernel(name, row_offsets, src, w, x):
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
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return out
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.kgat_spmm_csr(
            row_offsets.data_ptr(), src.data_ptr(), w.data_ptr(),
            x.data_ptr(), out.data_ptr(), n_rows, d,
            int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(build.stream_ptr(x.device)))
    build.check_launch(lib, code, name)
    build.launch_counts[name] += 1
    return out


def spmm_csr(row_offsets: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over e in [row_offsets[v], row_offsets[v+1]) of
    w[e] * x[src[e]] -> (n_rows, d) float32. Forward only: :func:`spmm`
    is the same product with a backward.

    row_offsets: (n_rows + 1,) int32 CSR offsets over destinations, from 0
    to E; src: (E,) int32 rows of ``x``; w: (E,) float32; x: (n, d)
    float32 or bfloat16 (the bf16 value stream), accumulated in float32.
    CPU tensors take :func:`spmm_csr_plain`; CUDA tensors launch the kernel.
    """
    return _launch("spmm_csr", row_offsets, src, w, x)


def spmm_csr_rev(rev_row_offsets: torch.Tensor, rev_dst: torch.Tensor,
                 w_rev: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The SpMM's gradient w.r.t. its features: K1 launched on the reverse
    CSR, d_x[u] = sum over edges e with src u of w[e] * g[dst[e]], with
    ``Graph.rev_row_offsets``, ``Graph.rev_dst`` and ``w_rev = w[rev_perm]``.
    Counted apart from the forward launches (``spmm_csr_rev``)."""
    return _launch("spmm_csr_rev", rev_row_offsets, rev_dst, w_rev, g)


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
        return spmm_csr(graph.row_offsets, graph.src, w, x)

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
                               g.to(x.dtype)).to(x.dtype)
        if ctx.needs_input_grad[0]:
            d_w = edge_dot(graph.src, graph.dst, x, g).to(w.dtype)
        return d_w, d_x, None, None


def spmm(graph: Graph, edge_w: Union[torch.Tensor, EdgeWeights],
         x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of w[e] * x[u], differentiable in
    ``x`` and in canonical weights. ``edge_w`` is the canonical (E,)
    weights or :class:`EdgeWeights` staged once per attention recompute,
    which saves the backward its gather of ``w[rev_perm]``."""
    if isinstance(edge_w, EdgeWeights):
        return _Spmm.apply(edge_w.fwd, x, edge_w.rev, graph)
    return _Spmm.apply(edge_w, x, None, graph)
