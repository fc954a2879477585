"""Build and load the Hopper kernel library; checks shared by the wrappers.

The kernels are CUDA C++ in ``csrc/*.cu`` with a plain C interface. At
first use they are compiled with nvcc for sm_90a into one shared library
under ``build/`` (gitignored) and loaded with ``ctypes``; the library is
rebuilt when a source is newer than it. Nothing is compiled at import:
this module, like every wrapper, imports on a machine without CUDA.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check_launch` raises on a non-zero code.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libkgat_hopper.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper, counted where each wrapper launches its
# kernel. Callers clear it to see which kernels a run went through.
launch_counts: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as c_void_p, sizes as
# c_int). Each returns a cudaError_t as int.
_SIGNATURES = {
    # row_offsets, src, w, x, out, n_rows, d, x_is_bf16, stream
    "kgat_spmm_csr": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rel_perm, tiles, src, dst, emb, w_rel, rel_embed, out, n_tiles, d, k, stream
    "kgat_sddmm_transr": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # row_offsets, logits, out, n_rows, stream
    "kgat_segment_softmax_csr": (_P, _P, _P, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    # Last, the CUDA toolkit's default install prefix.
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the Hopper kernels")


def build(force: bool = False) -> tuple:
    """Compile ``csrc/*.cu`` into the kernel library if it is missing or
    older than a source. Returns (library path, build seconds, nvcc log);
    seconds is 0.0 and the log empty when the library was up to date.
    Raises RuntimeError when nvcc fails."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = sources + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if (not force and os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(p) for p in deps)):
        return LIB_PATH, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH, time.perf_counter() - t0, proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kgat_error_string.argtypes = (ctypes.c_int,)
    lib.kgat_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.kgat_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def use_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """Route a wrapper call: False when every input lies on the CPU (the
    wrapper takes the plain version), True when all lie on one CUDA device
    (it launches the kernel). Raises for mixed or other devices, and for an
    input that would need a gradient: the kernels have no backward yet."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           f"under torch.no_grad()")
    return True


def check_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` has one of ``dtypes``, ``ndim`` dims and is
    contiguous."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
