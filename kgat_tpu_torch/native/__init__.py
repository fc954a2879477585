"""The native host layer: the text parsers and the graph's counting sort.

``graph_builder.cpp`` holds the port's copy of the parse and index
functions of ``kgat_tpu/native`` (its TPU layout fill is not ported). At
first use it is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``build/`` (gitignored) and loaded with ``ctypes``; it is rebuilt when the
source is newer than the library. Nothing is compiled at import. A failed
build or load raises with the compiler's message: no caller falls back to
a Python path.

* :func:`parse_user_items`: ``uid iid iid ...`` lines -> (n, 2) int64
  pairs, as ``kgat_tpu.native.parse_user_items``;
* :func:`parse_triples`: the file's integer tokens, three at a time ->
  (n, 3) int64, as ``kgat_tpu.native.parse_triples``. On a well-formed
  file that is ``np.loadtxt``'s array; a line of two tokens takes the
  first token of the next line, and a token that is not a number drops
  the triple begun so far;
* :func:`sort_perm`: the stable counting sort,
  ``np.argsort(keys, kind="stable")`` for keys in ``[0, n_keys)``;
* :func:`csr_offsets`: ``np.searchsorted(sorted_keys,
  np.arange(n_segments + 1))``.

:func:`sort_perm_plain` and :func:`csr_offsets_plain` are the numpy
versions of the last two, which the tests and ``chip_smoke.py`` hold them
to.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "graph_builder.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_NAME = "libkgat_torch_native.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
# C entry point -> (restype, argtypes).
_SIGNATURES = {
    "kgat_count_pairs": (ctypes.c_int64, (ctypes.c_char_p,)),
    "kgat_parse_pairs": (ctypes.c_int64,
                         (ctypes.c_char_p, _I64P, _I64P, ctypes.c_int64)),
    "kgat_count_triples": (ctypes.c_int64, (ctypes.c_char_p,)),
    "kgat_parse_triples": (ctypes.c_int64,
                           (ctypes.c_char_p, _I64P, ctypes.c_int64)),
    "kgat_sort_perm": (None, (_I32P, ctypes.c_int64, ctypes.c_int32, _I64P)),
    "kgat_csr_offsets": (None,
                         (_I32P, ctypes.c_int64, ctypes.c_int32, _I64P)),
}


def build(force: bool = False) -> tuple:
    """Compile :data:`SOURCE` into ``BUILD_DIR/LIB_NAME`` with :data:`CXX`
    if the library is missing or older than the source. Returns (library
    path, build seconds), 0.0 when it was up to date. Raises RuntimeError
    naming the compiler, with its stderr, when the build fails."""
    lib = os.path.join(BUILD_DIR, LIB_NAME)
    if (not force and os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(SOURCE)):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"   # processes may build at once
    cmd = [CXX, *CXX_FLAGS, SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to build "
                           f"{SOURCE}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"the C++ compiler {CXX!r} failed with code "
                           f"{proc.returncode}:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once a process)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _path(path) -> bytes:
    path = os.fspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such file: {path}")
    return path.encode()


def parse_user_items(path) -> np.ndarray:
    """``uid iid iid ...`` lines -> (n, 2) int64 (user, item) pairs, in
    file order; a line with a user and no items gives none."""
    lib, p = library(), _path(path)
    n = lib.kgat_count_pairs(p)
    if n < 0:
        raise OSError(f"cannot read {path}")
    u = np.empty(n, np.int64)
    i = np.empty(n, np.int64)
    got = lib.kgat_parse_pairs(p, _i64p(u), _i64p(i), n)
    if got != n:
        raise RuntimeError(f"{path} changed while it was parsed: "
                           f"{got} pairs against {n}")
    return np.stack([u, i], axis=1)


def parse_triples(path) -> np.ndarray:
    """The file's integer tokens, three at a time -> (n, 3) int64."""
    lib, p = library(), _path(path)
    cap = lib.kgat_count_triples(p)
    if cap < 0:
        raise OSError(f"cannot read {path}")
    out = np.empty((cap, 3), np.int64)
    got = lib.kgat_parse_triples(p, _i64p(out), cap)
    if got < 0:
        raise RuntimeError(f"{path} changed while it was parsed")
    return out[:got]


def sort_perm(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """Stable counting-sort permutation (int64) of integer keys in
    ``[0, n_keys)``: ``np.argsort(keys, kind="stable")``."""
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {keys.shape}")
    if not 0 <= n_keys < 2 ** 31:
        raise ValueError(f"n_keys {n_keys} out of the int32 range")
    if len(keys) and (keys.min() < 0 or keys.max() >= n_keys):
        raise ValueError(f"keys must lie in [0, {n_keys})")
    keys = np.ascontiguousarray(keys, np.int32)
    perm = np.empty(len(keys), np.int64)
    library().kgat_sort_perm(_i32p(keys), len(keys), n_keys, _i64p(perm))
    return perm


def csr_offsets(sorted_keys: np.ndarray, n_segments: int) -> np.ndarray:
    """(n_segments + 1,) int64: offsets[k] is the first index whose key is
    >= k, ``np.searchsorted(sorted_keys, np.arange(n_segments + 1))``.
    The keys must be non-decreasing int32 values."""
    sorted_keys = np.asarray(sorted_keys)
    if sorted_keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {sorted_keys.shape}")
    if not 0 <= n_segments < 2 ** 31 - 1:
        raise ValueError(f"n_segments {n_segments} out of the int32 range")
    if len(sorted_keys) and (sorted_keys.min() < -2 ** 31
                             or sorted_keys.max() >= 2 ** 31):
        raise ValueError("keys out of the int32 range")
    sorted_keys = np.ascontiguousarray(sorted_keys, np.int32)
    out = np.empty(n_segments + 1, np.int64)
    library().kgat_csr_offsets(_i32p(sorted_keys), len(sorted_keys),
                               n_segments, _i64p(out))
    return out


def sort_perm_plain(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """The plain version of :func:`sort_perm`: numpy's stable argsort."""
    return np.argsort(np.asarray(keys), kind="stable")


def csr_offsets_plain(sorted_keys: np.ndarray, n_segments: int
                      ) -> np.ndarray:
    """The plain version of :func:`csr_offsets`: numpy's searchsorted."""
    return np.searchsorted(sorted_keys, np.arange(n_segments + 1),
                           side="left")
