"""`hopper` ops backend: the Hopper kernels behind the ref-path surface.

Port of ``kgat_tpu/ops/pallas_backend.py``'s ``spmm`` and attention. The
TPU backend re-lays edges into padded block-aligned orders and routes
results back with permutations; here the kernels read the graph's own
CSR, reverse CSR and relation tiles and write in canonical edge order, so
no layout or routing step exists.

Every op is differentiable, each through its kernel's backward: ``spmm``
(K1 forward, K1 on the reverse CSR for d_x), ``segment_softmax`` (K3, K5)
and ``attention_logits`` (K2, K4). Unlike the JAX backend, whose serving
path left the softmax to XLA, the per-dst softmax is a kernel here too.

The partitioned ring exchange (``parallel/halo.py``) adds three:
``bucket_spmm`` (a ring bucket's reduce, K6 forward and K6 on the
bucket's reverse CSR backward), ``ring_send`` (K7, its transpose the
shift the other way) and ``bucket_spmm_send`` (K8 forward; K6 and K7
backward).

The training attention may take the dense-projection route instead of
K2 (:func:`use_dense_attention`, :func:`attention_logits_dense`), as
``kgat_tpu``'s pallas backend does: plain torch, as it is XLA there.

DGL's op surface (``kgat_tpu/ops/pallas_backend.py:32-61``): :func:`gspmm`
sends the weighted sum and mean, and ``copy_u`` with either, through K1;
every other case, and the segment reductions, ``gsddmm`` and
``sddmm_dot``, are the plain ops of ``ops/ref.py``, which JAX leaves to
XLA too.
"""

from typing import Optional

import torch

from kgat_tpu_torch.graph import Graph
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper.remote_ring import (  # noqa: F401
    bucket_spmm_send, ring_send)
from kgat_tpu_torch.ops.hopper.segment_sum import bucket_spmm, spmm  # noqa: F401
from kgat_tpu_torch.ops.hopper.sddmm import attention_logits  # noqa: F401
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax  # noqa: F401
from kgat_tpu_torch.ops.ref import (  # noqa: F401
    MSG_OPS, REDUCE_OPS, gsddmm, sddmm_dot, segment_max, segment_mean,
    segment_min, segment_sum)


def gspmm(graph: Graph, msg: str, reduce: str,
          x: Optional[torch.Tensor] = None,
          edge_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DGL's ``update_all(fn.<msg>, fn.<reduce>)`` (``ref.gspmm``'s
    surface). ``u_mul_e`` with a sum or mean and (E,) weights is K1 (its
    backward K1 on the reverse CSR), mean divided by the in-degree clamped
    at 1; ``copy_u`` with a sum or mean is the same with unit weights.
    Every other case is ``ref.gspmm``."""
    if (msg == "u_mul_e" and reduce in ("sum", "mean")
            and edge_w is not None and edge_w.dim() == 1):
        s = spmm(graph, edge_w, x)
        if reduce == "sum":
            return s
        return s / ref.in_degree(graph).clamp(min=1).to(s.dtype)[:, None]
    if msg == "copy_u" and reduce in ("sum", "mean"):
        ones = torch.ones(graph.n_edges, dtype=torch.float32,
                          device=x.device)
        return gspmm(graph, "u_mul_e", reduce, x, ones)
    return ref.gspmm(graph, msg, reduce, x, edge_w)


# The dense route's bound on its two projected tables' bytes, kgat_tpu's
# (pallas_backend.ATT_DENSE_MAX_BYTES): measured on a TPU, kept so that
# both packages take the same route (and its numbers) on the same graph.
ATT_DENSE_MAX_BYTES = 1.5e8
# Edges gathered at once by the dense route: bounds its two (chunk, k)
# gathers beside the tables.
DENSE_CHUNK_EDGES = 1 << 20


def use_dense_attention(graph: Graph, cfg) -> bool:
    """``kgat_tpu``'s route rule (``pallas_backend.use_dense_attention``):
    'relblock' never takes the dense route; 'dense' always, and raises
    unless ``relation_dim`` is at most 128 and divides it; 'auto' when it
    does and the two (R, N, k) tables fit in
    :data:`ATT_DENSE_MAX_BYTES`."""
    if cfg.att_impl == "relblock":
        return False
    k = cfg.relation_dim
    fits = k <= 128 and 128 % k == 0
    nbytes = 2 if cfg.att_table_dtype == torch.bfloat16 else 4
    size_ok = (2 * graph.n_relations * graph.n_nodes * k * nbytes
               <= ATT_DENSE_MAX_BYTES)
    if cfg.att_impl == "dense":
        if not fits:
            raise ValueError(f"att_impl='dense' needs relation_dim {k} "
                             f"to divide 128")
        return True
    return fits and size_ok


def attention_logits_dense(graph: Graph, emb: torch.Tensor,
                           w_rel: torch.Tensor, rel_embed: torch.Tensor,
                           table_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """(E,) TransR logits in canonical edge order by the dense-projection
    route (``pallas_backend._attention_logits_fwd_dense``): every node
    projected by every relation once, Q[n, r] = emb[n] @ W_r in float32
    with TF32 off, and T = tanh(Q + e_r), both optionally rounded to
    ``table_dtype``; then per edge the float32 row dot
    Q[src, r] . T[dst, r], gathered in chunks of
    :data:`DENSE_CHUNK_EDGES` edges. The tables are laid out (N, R, k):
    one (N, d) x (d, R k) product."""
    n, d = emb.shape
    r, _, k = w_rel.shape
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q = emb @ w_rel.permute(1, 0, 2).reshape(d, r * k)   # (N, R k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t = q + rel_embed.reshape(1, r * k)
    t.tanh_()
    if table_dtype is not None:
        q, t = q.to(table_dtype), t.to(table_dtype)
    q, t = q.view(n * r, k), t.view(n * r, k)
    out = torch.empty(graph.n_edges, dtype=torch.float32, device=emb.device)
    for lo in range(0, graph.n_edges, DENSE_CHUNK_EDGES):
        hi = min(lo + DENSE_CHUNK_EDGES, graph.n_edges)
        ety = graph.etype[lo:hi].long()
        rows_t = graph.src[lo:hi].long() * r + ety
        rows_h = graph.dst[lo:hi].long() * r + ety
        out[lo:hi] = (q.index_select(0, rows_t).float()
                      * t.index_select(0, rows_h).float()).sum(-1)
    return out
