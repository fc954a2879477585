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

The model's ops (``ops/__init__.py``) take two hand-written ops that
replace no TPU kernel: :func:`layer` and :func:`representation_rows` the
bi-interaction layer op (``ops/hopper/bi_layer.py``) for CUDA tensors,
:func:`kg_projection` the TransR op (``ops/hopper/transr.py``), whose
wrappers take their plain versions for CPU tensors, as every op here.

DGL's op surface (``kgat_tpu/ops/pallas_backend.py:32-61``): :func:`gspmm`
sends the weighted sum and mean, and ``copy_u`` with either, through K1;
every other case, and the segment reductions, ``gsddmm`` and
``sddmm_dot``, are the plain ops of ``ops/ref.py``, which JAX leaves to
XLA too.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kgat_tpu_torch.graph import Graph
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import bi_layer, transr
from kgat_tpu_torch.ops.hopper.remote_ring import (  # noqa: F401
    bucket_spmm_send, ring_send)
from kgat_tpu_torch.ops.hopper.segment_sum import bucket_spmm, spmm  # noqa: F401
from kgat_tpu_torch.ops.hopper.sddmm import attention_logits  # noqa: F401
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax  # noqa: F401
from kgat_tpu_torch.ops.ref import (  # noqa: F401
    MSG_OPS, REDUCE_OPS, gsddmm, sddmm_dot, segment_max, segment_mean,
    segment_min, segment_sum)

# As kgat_tpu's pallas backend, the SpMM reads the value stream in the
# config's compute_dtype and, on one device and the all-gather's shards,
# reduces over the coalesced CSRs when the config coalesces
# (models.kgat.KGATConfig).
PALLAS_STAGING = True


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


def training_logits(graph: Graph, emb: torch.Tensor, w_rel: torch.Tensor,
                    rel_embed: torch.Tensor, cfg) -> torch.Tensor:
    """The per-epoch training attention's logits, as ``kgat_tpu``'s pallas
    backend takes them (``pallas_backend.attention_prepared``): by the
    dense route where :func:`use_dense_attention` says so, else by K2."""
    if use_dense_attention(graph, cfg):
        return attention_logits_dense(graph, emb, w_rel, rel_embed,
                                      cfg.att_table_dtype)
    return attention_logits(graph, emb, w_rel, rel_embed)


def _layer_op(cfg, t: torch.Tensor) -> bool:
    """Whether the layer op computes the layers over ``t``: bi-interaction
    on CUDA tensors. Else ``ref``'s layers through autograd, the path that
    ``benchmark/tests/test_bench_reference.py`` holds to the benchmark's
    reference at rtol 1e-4 on the CPU (the op's written-out plain backward
    rounds other float32 sums to the bf16 stream and misses it)."""
    return cfg.aggregator == "bi-interaction" and t.is_cuda


def layer(x: torch.Tensor, side: torch.Tensor, params,
          mask: Optional[torch.Tensor], rate: float, cfg,
          copy_dtype: Optional[torch.dtype] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ref.layer``'s surface: by the layer op (``bi_layer.bi_layer``)
    where :func:`_layer_op` says so, else by ``ref.layer``."""
    if not _layer_op(cfg, x):
        return ref.layer(x, side, params, mask, rate, cfg, copy_dtype)
    out = bi_layer.bi_layer(x, side, mask, params, rate,
                            cfg.leaky_relu_slope, copy_dtype)
    return out if copy_dtype is not None else (out, out)


def representation_rows(model, graph: Graph, edge_w, cfg,
                        masks: Sequence[Optional[torch.Tensor]],
                        ids: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, ...]:
    """``ref.representation_rows``'s surface: where :func:`_layer_op` says
    so, the whole propagation as one op, K1 inside, normalised at the
    rows alone (``bi_layer.propagate_rows``); else
    ``ref.representation_rows`` over this backend's SpMM."""
    if not _layer_op(cfg, model.entity_embed):
        return ref.representation_rows(model, graph, edge_w, cfg, masks, ids)
    return bi_layer.propagate_rows(model, graph, edge_w, cfg, masks, ids)


def gather_rows(table: torch.Tensor, ids: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
    """The rows of ``table`` at each index tensor of ``ids``, gathered at
    once. Their gradient reaches ``table`` as a sparse COO tensor of the
    gathered rows, duplicate ids left unsummed, which autograd adds into a
    dense ``.grad`` in place, row by row (an ``index_add_``): no (rows, d)
    temporary, no whole-table add, and ``.grad`` keeps its address.
    Without a ``.grad`` to add into, ``table.grad`` (or
    ``torch.autograd.grad``'s result) is that sparse tensor."""
    rows = F.embedding(torch.cat(list(ids)), table, sparse=True)
    return rows.split([i.numel() for i in ids])


def kg_projection(emb: torch.Tensor, rel_embed: torch.Tensor,
                  w_rel: torch.Tensor, h: torch.Tensor, r: torch.Tensor,
                  t_pos: torch.Tensor, t_neg: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """``ref.kg_projection``'s surface by the TransR op (its kernels on
    CUDA, float32 alone). CUDA tensors gather the 3B entity rows at once
    with a sparse gradient (:func:`gather_rows`, so ``torch.autograd.grad``
    returns ``emb``'s gradient sparse); CPU tensors as ``ref``, one index
    tensor at a time (``tests/test_torch_transr.py``: the same bits)."""
    rows = (gather_rows(emb, (h, t_pos, t_neg)) if emb.is_cuda
            else (emb[h], emb[t_pos], emb[t_neg]))
    return transr.transr_project(*rows, rel_embed, w_rel, r)
