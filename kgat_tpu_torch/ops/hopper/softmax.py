"""K3 wrapper: per-destination segment softmax over the CSR
(``csrc/softmax.cu``).

Replaces ``kgat_tpu/ops/pallas/softmax.py::_max_kernel``,
``_expsum_kernel`` and ``_norm_kernel``. The serving forward calls it once,
to normalise the attention logits.
"""

from __future__ import annotations

import ctypes

import torch

from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build


def segment_softmax_csr_plain(row_offsets: torch.Tensor,
                              logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_softmax_csr`."""
    return ref.segment_softmax_coo(ref.offsets_to_dst(row_offsets), logits,
                                   row_offsets.numel() - 1)


def segment_softmax_csr(row_offsets: torch.Tensor,
                        logits: torch.Tensor) -> torch.Tensor:
    """Softmax of ``logits`` within each CSR row -> (E,) float32 weights.

    row_offsets: (n_rows + 1,) int32 offsets, from 0 to E; logits: (E,)
    float32 in CSR (canonical) order. CPU tensors take
    :func:`segment_softmax_csr_plain`; CUDA tensors launch the kernel.
    """
    if not build.use_kernel("segment_softmax_csr", row_offsets, logits):
        return segment_softmax_csr_plain(row_offsets, logits)
    build.check_tensor("row_offsets", row_offsets, (torch.int32,), 1)
    build.check_tensor("logits", logits, (torch.float32,), 1)
    out = torch.empty_like(logits)
    n_rows = row_offsets.numel() - 1
    if n_rows == 0 or logits.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(logits.device):
        code = lib.kgat_segment_softmax_csr(
            row_offsets.data_ptr(), logits.data_ptr(), out.data_ptr(), n_rows,
            ctypes.c_void_p(build.stream_ptr(logits.device)))
    build.check_launch(lib, code, "segment_softmax_csr")
    build.launch_counts["segment_softmax_csr"] += 1
    return out
