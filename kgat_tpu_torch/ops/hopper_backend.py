"""`hopper` ops backend: the Hopper kernels behind the ref-path surface.

Port of the serving half of ``kgat_tpu/ops/pallas_backend.py`` (``spmm``
and ``attention_logits``). The TPU backend re-lays edges into padded
block-aligned orders and routes results back with permutations; here all
three kernels read the graph's own CSR and relation tiles and write in
canonical edge order, so no layout or routing step exists.

Unlike the JAX backend, whose serving path left the softmax to XLA, the
per-dst softmax is a kernel here too (one pass per CSR row).
"""

from __future__ import annotations

import torch

from kgat_tpu_torch.graph import Graph
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr
from kgat_tpu_torch.ops.hopper.sddmm import sddmm_transr
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax_csr


def spmm(graph: Graph, edge_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of edge_w[e] * x[u] (kernel K1)."""
    return spmm_csr(graph.row_offsets, graph.src, edge_w, x)


def segment_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    """Per-dst softmax of canonical-order logits (kernel K3)."""
    return segment_softmax_csr(graph.row_offsets, logits)


def attention_logits(graph: Graph, emb: torch.Tensor, w_rel: torch.Tensor,
                     rel_embed: torch.Tensor) -> torch.Tensor:
    """Canonical-order TransR logits (kernel K2)."""
    return sddmm_transr(graph.rel_perm, graph.tiles, graph.src, graph.dst,
                        emb, w_rel, rel_embed)
