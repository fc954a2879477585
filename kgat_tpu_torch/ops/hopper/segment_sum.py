"""K1 wrapper: weighted CSR SpMM (``csrc/segment_sum.cu``).

Replaces ``kgat_tpu/ops/pallas/segment_sum.py::_kernel_w``. The serving
forward calls it once per layer, at d = 64, 64, 32 for the reference
recipe.
"""

from __future__ import annotations

import ctypes

import torch

from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build

MAX_DIM = 256


def spmm_csr_plain(row_offsets: torch.Tensor, src: torch.Tensor,
                   w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_csr` (gather + ``index_add_``)."""
    return ref.spmm_coo(src, ref.offsets_to_dst(row_offsets), w, x,
                        row_offsets.numel() - 1)


def spmm_csr(row_offsets: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over e in [row_offsets[v], row_offsets[v+1]) of
    w[e] * x[src[e]] -> (n_rows, d) float32.

    row_offsets: (n_rows + 1,) int32 CSR offsets over destinations, from 0
    to E; src: (E,) int32 rows of ``x``; w: (E,) float32; x: (n, d)
    float32 or bfloat16 (the bf16 value stream), accumulated in float32.
    CPU tensors take :func:`spmm_csr_plain`; CUDA tensors launch the kernel.
    """
    if not build.use_kernel("spmm_csr", row_offsets, src, w, x):
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
    build.check_launch(lib, code, "spmm_csr")
    build.launch_counts["spmm_csr"] += 1
    return out
