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
"""

from kgat_tpu_torch.ops.hopper.remote_ring import (  # noqa: F401
    bucket_spmm_send, ring_send)
from kgat_tpu_torch.ops.hopper.segment_sum import bucket_spmm, spmm  # noqa: F401
from kgat_tpu_torch.ops.hopper.sddmm import attention_logits  # noqa: F401
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax  # noqa: F401
