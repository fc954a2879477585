"""Plain PyTorch message-passing ops: the CPU path and the oracle.

Port of ``kgat_tpu/ops/ref.py`` for the serving forward. Each op is
written the straightforward way, with gathers and ``index_add_`` /
``scatter_reduce_`` over the edges' destinations, on any device. The
Hopper kernels (``ops/hopper``) are held against these functions; their
wrappers call them for tensors that lie on the CPU.

The port's graph has no pad edges, so nothing here needs an edge mask.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from kgat_tpu_torch.graph import Graph


def offsets_to_dst(row_offsets: torch.Tensor) -> torch.Tensor:
    """(E,) int64 destination of each edge of a CSR, from its offsets."""
    counts = (row_offsets[1:] - row_offsets[:-1]).long()
    rows = torch.arange(counts.numel(), device=row_offsets.device)
    return torch.repeat_interleave(rows, counts)


def segment_sum_coo(dst: torch.Tensor, vals: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Sum edge values into their dst rows. Returns (n_nodes, ...)."""
    out = vals.new_zeros((n_nodes,) + tuple(vals.shape[1:]))
    return out.index_add_(0, dst, vals)


def spmm_coo(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of w[e] * x[u], in float32.

    A bfloat16 ``x`` is widened to float32 before the multiply, as the
    kernel does, so the two see the same products.
    """
    msgs = x.index_select(0, src).float() * w.float()[:, None]
    return segment_sum_coo(dst, msgs, n_nodes)


def segment_softmax_coo(dst: torch.Tensor, logits: torch.Tensor,
                        n_nodes: int) -> torch.Tensor:
    """Per-dst softmax of edge logits: subtract the row max, exp, divide by
    the row sum. The row max starts at the dtype's lowest value, the clamp
    ``kgat_tpu.ops.ref.segment_softmax`` applies for empty rows."""
    neg = torch.finfo(logits.dtype).min
    maxes = torch.full((n_nodes,), neg, dtype=logits.dtype,
                       device=logits.device)
    maxes.scatter_reduce_(0, dst.long(), logits, "amax", include_self=True)
    shifted = torch.exp(logits - maxes[dst.long()])
    denom = segment_sum_coo(dst, shifted, n_nodes)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return shifted / denom[dst.long()]


def transr_logits(rel_perm: torch.Tensor,
                  rel_ranges: Iterable[Tuple[int, int, int]],
                  src: torch.Tensor, dst: torch.Tensor, emb: torch.Tensor,
                  w_rel: torch.Tensor, rel_embed: torch.Tensor
                  ) -> torch.Tensor:
    """TransR attention logits in canonical edge order:
    pi(h, r, t) = (W_r e_t) . tanh(W_r e_h + e_r), head = dst, tail = src.

    Loops over relations as ``kgat_tpu.models.kgat.attention_logits``
    does: each ``(r, lo, hi)`` range of ``rel_perm`` holds relation r's
    edges, which share one W_r. (A per-edge ``w_rel[etype]`` gather would
    be an (E, d, k) tensor: 73 GB at yelp2018 scale.)
    """
    out = torch.empty(rel_perm.shape[0], dtype=torch.float32,
                      device=emb.device)
    for r, lo, hi in rel_ranges:
        if hi <= lo:
            continue
        idx = rel_perm[lo:hi].long()
        w_r = w_rel[r]
        ph = emb[dst[idx].long()] @ w_r
        pt = emb[src[idx].long()] @ w_r
        out[idx] = (pt * torch.tanh(ph + rel_embed[r])).sum(-1)
    return out


# --- graph-level API (the ``ref`` backend) ---------------------------------

def segment_sum(graph: Graph, edge_vals: torch.Tensor) -> torch.Tensor:
    return segment_sum_coo(graph.dst, edge_vals, graph.n_nodes)


def spmm(graph: Graph, edge_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of edge_w[e] * x[u]."""
    return spmm_coo(graph.src, graph.dst, edge_w, x, graph.n_nodes)


def segment_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    return segment_softmax_coo(graph.dst, logits, graph.n_nodes)


def attention_logits(graph: Graph, emb: torch.Tensor, w_rel: torch.Tensor,
                     rel_embed: torch.Tensor) -> torch.Tensor:
    off = graph.rel_offsets
    ranges = [(r, off[r], off[r + 1]) for r in range(graph.n_relations)]
    return transr_logits(graph.rel_perm, ranges, graph.src, graph.dst, emb,
                         w_rel, rel_embed)
