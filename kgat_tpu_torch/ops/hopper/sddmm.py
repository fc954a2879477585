"""K2 and K4 wrappers: TransR attention SDDMM over relation tiles
(``csrc/sddmm.cu``) and its backward (``csrc/sddmm_bwd.cu``).

K2 replaces ``kgat_tpu/ops/pallas/sddmm.py::_kernel``; the serving forward
and each attention recompute call it once. K4 replaces ``_bwd_kernel``
(``sddmm_transr_bwd``); it runs where the attention itself is
differentiated (:func:`attention_logits`), as in ``sddmm_transr_ad``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from kgat_tpu_torch.graph import Graph
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build

MAX_EMBED_DIM = 256
MAX_RELATION_DIM = 128
MAX_BWD_WEIGHTS = 8192   # d * k: K4 keeps a block's share of d_W in registers


def _relation_ranges(tiles: torch.Tensor):
    """[(r, lo, hi)] ranges of rel_perm per relation, from the tile table
    (tiles of one relation are consecutive and contiguous)."""
    ranges = {}
    for r, start, count in tiles.tolist():
        lo, hi = ranges.get(r, (start, start))
        ranges[r] = (min(lo, start), max(hi, start + count))
    return [(r, lo, hi) for r, (lo, hi) in sorted(ranges.items())]


def sddmm_transr_plain(rel_perm, tiles, src, dst, entity_embed, w_rel,
                       rel_embed) -> torch.Tensor:
    """Plain PyTorch version of :func:`sddmm_transr`: one pair of matmuls
    per relation, as ``kgat_tpu.models.kgat.attention_logits`` does."""
    return ref.transr_logits(rel_perm, _relation_ranges(tiles), src, dst,
                             entity_embed, w_rel, rel_embed)


def _check_weights(entity_embed, w_rel, rel_embed):
    build.check_tensor("entity_embed", entity_embed, (torch.float32,), 2)
    build.check_tensor("w_rel", w_rel, (torch.float32,), 3)
    build.check_tensor("rel_embed", rel_embed, (torch.float32,), 2)
    n_rel, d, k = w_rel.shape
    if entity_embed.shape[1] != d or rel_embed.shape != (n_rel, k):
        raise ValueError(f"entity_embed {tuple(entity_embed.shape)}, "
                         f"w_rel {tuple(w_rel.shape)} and rel_embed "
                         f"{tuple(rel_embed.shape)} disagree")
    if not (0 < d <= MAX_EMBED_DIM and 0 < k <= MAX_RELATION_DIM):
        raise ValueError(f"d={d} or k={k} beyond the kernel's "
                         f"{MAX_EMBED_DIM}/{MAX_RELATION_DIM}")
    return n_rel, d, k


def sddmm_transr(rel_perm: torch.Tensor, tiles: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor,
                 entity_embed: torch.Tensor, w_rel: torch.Tensor,
                 rel_embed: torch.Tensor) -> torch.Tensor:
    """Per-edge TransR logits (W_r e_t) . tanh(W_r e_h + e_r) -> (E,)
    float32 in canonical edge order; head = dst, tail = src. Forward only:
    :func:`attention_logits` has the backward.

    rel_perm: (E,) int32 canonical edge ids grouped by relation; tiles:
    (n_tiles, 3) int32 (relation, start, count) ranges of rel_perm that
    together cover it once, each within one relation (``Graph.tiles``);
    src/dst: (E,) int32; entity_embed: (n_nodes, d), w_rel: (R, d, k),
    rel_embed: (R, k), all float32. CPU tensors take
    :func:`sddmm_transr_plain`; CUDA tensors launch the kernel.
    """
    args = (rel_perm, tiles, src, dst, entity_embed, w_rel, rel_embed)
    if not build.use_kernel("sddmm_transr", *args):
        return sddmm_transr_plain(*args)
    for name, t in (("rel_perm", rel_perm), ("src", src), ("dst", dst)):
        build.check_tensor(name, t, (torch.int32,), 1)
    build.check_tensor("tiles", tiles, (torch.int32,), 2)
    _, d, k = _check_weights(entity_embed, w_rel, rel_embed)
    if not (rel_perm.shape == src.shape == dst.shape):
        raise ValueError("rel_perm, src and dst must be equally long")
    if tiles.shape[1] != 3:
        raise ValueError(f"tiles {tuple(tiles.shape)} must be (n_tiles, 3)")
    out = torch.empty(rel_perm.shape, dtype=torch.float32,
                      device=entity_embed.device)
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        return out
    lib = build.library()
    with torch.cuda.device(entity_embed.device):
        code = lib.kgat_sddmm_transr(
            *(t.data_ptr() for t in args), out.data_ptr(), n_tiles, d, k,
            ctypes.c_void_p(build.stream_ptr(entity_embed.device)))
    build.check_launch(lib, code, "sddmm_transr")
    build.launch_counts["sddmm_transr"] += 1
    return out


def sddmm_transr_bwd_plain(graph: Graph, g: torch.Tensor,
                           entity_embed: torch.Tensor, w_rel: torch.Tensor,
                           rel_embed: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`sddmm_transr_bwd` (in float64 when
    the weights are)."""
    off = graph.rel_offsets
    ranges = [(r, off[r], off[r + 1]) for r in range(graph.n_relations)]
    return ref.transr_logits_bwd(g, graph.rel_perm, ranges, graph.src,
                                 graph.dst, entity_embed, w_rel, rel_embed)


def sddmm_transr_bwd(graph: Graph, g: torch.Tensor,
                     entity_embed: torch.Tensor, w_rel: torch.Tensor,
                     rel_embed: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: gradients of :func:`sddmm_transr` over ``graph``'s edges w.r.t.
    (entity_embed, w_rel, rel_embed), given the logits' cotangent ``g``
    (E,) float32 in canonical order.

    Deterministic: the entity gradient sums each node's head edges over
    its CSR row and its tail edges over its reverse CSR row, d_W and d_e_r
    sum per-tile partials in tile order; no atomics. A relation without
    edges gets zeros. CPU tensors take :func:`sddmm_transr_bwd_plain`;
    CUDA tensors launch the kernels (three, counted as one launch).
    """
    args = (g, graph.rel_perm, graph.tiles, graph.src, graph.dst,
            graph.row_offsets, graph.rev_row_offsets, graph.rev_perm,
            entity_embed, w_rel, rel_embed)
    if not build.use_kernel("sddmm_transr_bwd", *args):
        return sddmm_transr_bwd_plain(graph, g, entity_embed, w_rel,
                                      rel_embed)
    build.check_tensor("g", g, (torch.float32,), 1)
    n_rel, d, k = _check_weights(entity_embed, w_rel, rel_embed)
    if d * k > MAX_BWD_WEIGHTS:
        raise ValueError(f"d * k = {d * k} beyond the backward kernel's "
                         f"{MAX_BWD_WEIGHTS}")
    if g.shape != (graph.n_edges,) or n_rel != graph.n_relations:
        raise ValueError(f"g {tuple(g.shape)} or w_rel {tuple(w_rel.shape)} "
                         f"do not fit the graph")
    n_nodes, n_tiles = entity_embed.shape[0], graph.tiles.shape[0]
    if n_nodes != graph.n_nodes:
        raise ValueError(f"entity_embed has {n_nodes} rows, the graph "
                         f"{graph.n_nodes} nodes")
    dev = entity_embed.device
    rel_ids = torch.arange(n_rel + 1, dtype=torch.int32, device=dev)
    tile_offsets = torch.searchsorted(graph.tiles[:, 0].contiguous(),
                                      rel_ids, out_int32=True)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                       device=dev)
    deh, det = empty(graph.n_edges, d), empty(graph.n_edges, d)
    part_w, part_er = empty(n_tiles, d, k), empty(n_tiles, k)
    d_emb, d_w, d_er = empty(n_nodes, d), empty(n_rel, d, k), empty(n_rel, k)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_sddmm_transr_bwd(
            graph.rel_perm.data_ptr(), graph.tiles.data_ptr(),
            tile_offsets.data_ptr(), graph.src.data_ptr(),
            graph.dst.data_ptr(), graph.row_offsets.data_ptr(),
            graph.rev_row_offsets.data_ptr(), graph.rev_perm.data_ptr(),
            entity_embed.data_ptr(), w_rel.data_ptr(), rel_embed.data_ptr(),
            g.data_ptr(), deh.data_ptr(), det.data_ptr(), part_w.data_ptr(),
            part_er.data_ptr(), d_emb.data_ptr(), d_w.data_ptr(),
            d_er.data_ptr(), n_tiles, n_rel, n_nodes, d, k,
            ctypes.c_void_p(build.stream_ptr(dev)))
    build.check_launch(lib, code, "sddmm_transr_bwd")
    build.launch_counts["sddmm_transr_bwd"] += 1
    return d_emb, d_w, d_er


class _SddmmTransR(torch.autograd.Function):
    """K2 forward, K4 backward (``sddmm_transr_ad``'s counterpart)."""

    @staticmethod
    def forward(ctx, entity_embed, w_rel, rel_embed, graph):
        ctx.graph = graph
        ctx.save_for_backward(entity_embed, w_rel, rel_embed)
        return sddmm_transr(graph.rel_perm, graph.tiles, graph.src, graph.dst,
                            entity_embed, w_rel, rel_embed)

    @staticmethod
    def backward(ctx, g):
        grads = sddmm_transr_bwd(ctx.graph, g.contiguous(), *ctx.saved_tensors)
        return (*grads, None)


def attention_logits(graph: Graph, entity_embed: torch.Tensor,
                     w_rel: torch.Tensor, rel_embed: torch.Tensor
                     ) -> torch.Tensor:
    """Canonical-order TransR logits, differentiable in the three weights."""
    return _SddmmTransR.apply(entity_embed, w_rel, rel_embed, graph)
