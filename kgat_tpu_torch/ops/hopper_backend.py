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
