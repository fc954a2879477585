"""Build and load the Hopper kernel library; checks shared by the wrappers.

The kernels are CUDA C++ in ``csrc/*.cu`` with a plain C interface. At
first use they are compiled with nvcc for sm_90a, one process per source
in parallel, and linked into one shared library under ``build/``
(gitignored), loaded with ``ctypes``; the library is rebuilt when a source
is newer than it. Nothing is compiled at import:
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-ldl")

# Kernel launches per wrapper, counted where each wrapper launches its
# kernel. Callers clear it to see which kernels a run went through.
launch_counts: collections.Counter = collections.Counter()

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_SPLIT = (_P, _I, _P, _P, _I)
# C entry point -> argtypes (pointers and the stream as c_void_p, sizes as
# c_int, byte counts as c_size_t). Each returns a cudaError_t as int.
_SIGNATURES = {
    # The row reductions (K1, K6, K8), K3 and K5 begin with a CSR's RowSplit:
    # units, n_units, split_rows, slot_offsets, n_split.
    # ..., src, w, x, out, partials, d, x_is_bf16, stream
    "kgat_spmm_csr": _SPLIT + (_P, _P, _P, _P, _P, _I, _I, _P),
    # ..., vals, out, partials, d, vals_is_bf16, stream
    "kgat_segment_sum_csr": _SPLIT + (_P, _P, _P, _I, _I, _P),
    # src, dst, nbytes, stream
    "kgat_ring_shift": (_P, _P, _S, _P),
    # ..., vals, sums, partials, d, vals_is_bf16, chunk, next, nbytes, stream
    "kgat_reduce_send": _SPLIT + (_P, _P, _P, _I, _I, _P, _P, _S, _P),
    # device, peer
    "kgat_enable_peer_access": (_I, _I),
    # Across processes: nbytes, ptr (out); ptr
    "kgat_ipc_alloc": (_S, ctypes.POINTER(_P)),
    "kgat_ipc_free": (_P,),
    # ptr, handle (64 bytes out)
    "kgat_ipc_export": (_P, _P),
    # handle, base (out); base
    "kgat_ipc_open": (_P, ctypes.POINTER(_P)),
    "kgat_ipc_close": (_P,),
    # flag, stream; flag, timeout in ns, stream
    "kgat_signal": (_P, _P),
    "kgat_wait": (_P, ctypes.c_ulonglong, _P),
    # rel_perm, tiles, src, dst, emb, w_rel, rel_embed, out, n_tiles, d, k, stream
    "kgat_sddmm_transr": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ..., n_slots, chunk, row_offsets, logits, out, partials, stream
    "kgat_segment_softmax_csr": _SPLIT + (_I, _I, _P, _P, _P, _P, _P),
    # ..., n_slots, chunk, row_offsets, w, g, out, partials, stream
    "kgat_segment_softmax_csr_bwd": _SPLIT + (_I, _I, _P, _P, _P, _P, _P, _P),
    # rel_perm, tiles, tile_offsets, src, dst, the forward and the reverse
    # CSR's RowSplit, rev_perm, emb, w_rel, rel_embed, g, deh, det, part_w,
    # part_er, partials, d_emb, d_w, d_er, n_tiles, n_rel, d, k, stream
    "kgat_sddmm_transr_bwd": ((_P,) * 5 + _SPLIT * 2 + (_P,) * 13
                              + (_I,) * 4 + (_P,)),
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


def _run(cmds) -> str:
    """Run the commands all at once; return their joined stderr, or raise
    RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{err}")
    return "".join(err for _, err in outs)


def build(force: bool = False) -> tuple:
    """Compile ``csrc/*.cu`` into the kernel library if it is missing or
    older than a source: one nvcc per source, all started together, then
    one link. Returns (library path, build seconds, nvcc log); seconds is
    0.0 and the log empty when the library was up to date. Raises
    RuntimeError when nvcc fails."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = sources + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if (not force and os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH)
            >= max(os.path.getmtime(p) for p in deps)):
        return LIB_PATH, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in sources]
    tmp = f"{LIB_PATH}.{tag}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(sources, objs)])
        _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.unlink(path)
    return LIB_PATH, time.perf_counter() - t0, log


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


# Codes from this one up carry a libcuda result (CUresult), less it.
CU_ERROR = 10000


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code >= CU_ERROR:
        raise RuntimeError(f"{name}: libcuda error {code - CU_ERROR} "
                           f"(CUresult)")
    if code != 0:
        msg = lib.kgat_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def use_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """Route a wrapper call: False when every input lies on the CPU (the
    wrapper takes the plain version), True when all lie on one CUDA device
    (it launches the kernel). Raises for mixed or other devices, and for an
    input that would need a gradient: a launch wrapper records nothing for
    autograd. The differentiable ops (``segment_sum.spmm``,
    ``sddmm.attention_logits``, ``softmax.segment_softmax``) call the
    wrappers inside their ``autograd.Function``s, where grad mode is off,
    and give the gradient by their backward kernels. (The ring wrappers of
    ``remote_ring``, whose source and destination may lie on two peer
    cards, route with :func:`use_ring_kernel` instead.)"""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {devices}")
    return _use_device(name, devices.pop(), tensors)


def _use_device(name: str, device: torch.device, tensors) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the launch wrapper has no backward; "
                           f"call it under torch.no_grad() or differentiate "
                           f"through kgat_tpu_torch.ops.hopper_backend")
    return True


def use_ring_kernel(name: str, dest: torch.device,
                    *tensors: torch.Tensor) -> bool:
    """Route one partition's launch of a ring wrapper (K7, K8): its inputs
    lie on one device, the source partition's, and the buffer it stores
    into on ``dest``, which may be a peer card. False when both are the
    CPU, True for CUDA devices once the source card may store into the
    destination's memory. Raises for a CPU/CUDA mix, for a card that
    cannot reach the other (``torch.cuda.can_device_access_peer``), and
    as :func:`use_kernel` does."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices {devices}")
    src = devices.pop()
    if (src.type == "cpu") != (dest.type == "cpu"):
        raise ValueError(f"{name}: source on {src}, destination on {dest}")
    use = _use_device(name, src, tensors)
    if use and src != dest:
        enable_peer_access(src, dest)
    return use


_PEERS: set = set()


def enable_peer_access(src: torch.device, dest: torch.device) -> None:
    """Let kernels on card ``src`` store into card ``dest``'s memory."""
    if (src.index, dest.index) in _PEERS:
        return
    if not torch.cuda.can_device_access_peer(src.index, dest.index):
        raise RuntimeError(f"{src} cannot access {dest}: the ring kernels "
                           f"need peer access between the cards")
    lib = library()
    check_launch(lib, lib.kgat_enable_peer_access(src.index, dest.index),
                 "enable_peer_access")
    _PEERS.add((src.index, dest.index))


def check_disjoint(name: str, outs, ins) -> None:
    """Raise unless every output buffer's memory is apart from every
    input's and from the other outputs': a ring kernel must never store
    into a buffer that a launch of the same step reads."""
    def span(t):
        return t.device, t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()

    outs = [span(t) for t in outs]
    for i, (dev, lo, hi) in enumerate(outs):
        for other in [*outs[:i], *(span(t) for t in ins)]:
            if other[0] == dev and lo < other[2] and other[1] < hi:
                raise ValueError(f"{name}: an output buffer aliases a buffer "
                                 f"of the same step; give each partition a "
                                 f"receive buffer of its own")


def check_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` has one of ``dtypes``, ``ndim`` dims and is
    contiguous."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
