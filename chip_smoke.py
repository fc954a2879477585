#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (kgat_tpu_torch): serving and training.

Run from the repository root on a machine with one NVIDIA GPU (built for
an H100, sm_90a):

    python3 chip_smoke.py

Phases, each announced by a line ``[n/8] ...``:
  1. device   — requires CUDA; prints nvidia-smi's name and power limit.
  2. build    — compiles the kernels from kgat_tpu_torch/ops/hopper/csrc.
  3. forward kernels (K1 SpMM, K2 SDDMM, K3 softmax) against their plain
               PyTorch versions on the card: hand-made rows (empty, one
               edge, a hub, rows at the row split's chunk boundaries) and
               the yelp2018-scale graph, with times; K2 also against a
               float64 plain version, within twice the plain float32
               path's error; each CSR's row split and its build time.
  4. serving  — a random full-width model (d = k = 64, layers 64/32/16,
               bi-interaction) written as a checkpoint, served through
               ``kgat_tpu_torch.recommend.main`` for 1,024 users at k = 20.
  5. backward kernels (K1 on the reverse CSR, K4 SDDMM backward, K5
               softmax backward) against float64 plain versions, each held
               to a bound that grows with its reduction, and K4 within
               twice the plain float32 path's error against float64 (it
               multiplies in three TF32 passes); a second call must be
               bit-identical; K5 beside its library call; times; then the
               attention gradient driven through the model (K2 -> K3 ->
               K5 -> K4).
  6. training steps at yelp2018 scale and full width: the first CF and KG
               steps' losses and gradients on the kernel path against the
               plain path in float64 (same params, batch and dropout mask);
               more steps on a fixed batch, whose loss must fall; an
               attention recompute; evaluate(); ms per step and launch
               counts.
  7. the trainer CLI — ``kgat_tpu_torch.train.main`` for one epoch, then
               its best checkpoint served for the users of phase 4.
  8. the edge-partitioned trainer, P = 4 partitions on the card: the
               ring kernels (K6 segment sum, K7 ring shift, K8 fused
               reduce + send) against their plain versions on the real
               ring buckets and on hand-made ones (K6 and K8's sums under
               a float64 bound, K7 and K8's send bit-exact), with times
               (K7 and copy_ also on chunks fresh from memory);
               attention and all_embed of every exchange against the
               single-device paths; the first CF step of every exchange
               (loss and gradients) and a KG step; the launch counts each
               exchange predicts; then the trainer CLI for one epoch with
               ``--n-devices 4 --halo-exchange ring --ring-transport fused``.
Then a JSON line of per-kernel results (each kernel's launches on its
path, error, time beside its plain version, the library call that
computes the same function where there is one, and the bound: the least
time the card could take for the same bytes or operations) and, last,
the device JSON line. Kernels whose call may take less time on the card
than on the host (K6-K8 and K7's copies) are timed by their device
duration, in a CUDA graph replay; the others with CUDA events around
back-to-back calls.
A failure prints ``chip_smoke: FAILED in phase n: ...`` and re-raises: the
exit code is non-zero and the last line is not printed.

``run()`` takes the device, the sizes and the timer, so the phases after
the build also run on the CPU at a tiny size with the plain versions
(tests/test_torch_chip_smoke.py); ``main()`` refuses to run without CUDA.
The rates behind the bounds are the H100 SXM's published peaks: 3.35 TB/s
of HBM3, 67 TFLOP/s of float32 outside the tensor cores and 495 TFLOP/s of
dense TF32 on them (K2's and K4's three TF32 passes).
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kgat_tpu_torch import recommend as rec
from kgat_tpu_torch import train
from kgat_tpu_torch.data import (load_dataset, save_dataset,
                                 synthetic_dataset)
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.row_split import CHUNK, build_row_split
from kgat_tpu_torch.ops.hopper.remote_ring import reduce_send, ring_shift
from kgat_tpu_torch.ops.hopper import sddmm
from kgat_tpu_torch.ops.hopper.sddmm import (sddmm_transr, sddmm_transr_bwd,
                                             sddmm_transr_bwd_plain,
                                             sddmm_transr_plain)
from kgat_tpu_torch.ops.hopper.segment_sum import (segment_sum_csr, spmm_csr,
                                                   spmm_csr_plain,
                                                   spmm_csr_rev)
from kgat_tpu_torch.ops.hopper.softmax import (segment_softmax_csr,
                                               segment_softmax_csr_bwd,
                                               segment_softmax_csr_bwd_plain,
                                               segment_softmax_csr_plain)
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               partition_graph)
from kgat_tpu_torch.sampler import (CFSampleTable, KGSampleTable,
                                    sample_cf_batch, sample_kg_batch)
from kgat_tpu_torch.utils.checkpoint import save_params
from kgat_tpu_torch.utils.config import TrainConfig

# yelp2018 at published scale, as the repo's `make datasets` generates it.
YELP2018 = dict(n_users=45919, n_items=45538, n_entities=90961,
                n_relations_kg=42, n_interactions=1185068,
                n_triples=1853704)
TOP_K = 20
RTOL = ATOL = 1e-4          # forward kernel vs plain, f32 (sum order differs)
# The backward kernels sum up to 10^5 terms per output and are held to a
# float64 reference under a bound that grows with the reduction (U is the
# float32 unit roundoff, 2^-24):
#  * sum_bound, where the terms' magnitudes are at hand (K1 on the reverse
#    CSR, K5, a training step's layer-weight gradients): n * 2^-23 *
#    sum|terms| for a sum of n terms. It holds for any summation order
#    (Higham's gamma_n), so it cannot flake; a sum whose terms repeat one
#    sign (a node's cotangent met by many of its edges), or cancel (a
#    weight's gradient over 136,880 nodes), does exceed a fixed multiple
#    of sqrt(n) roundings of its result.
#  * stat_bound, where they are not (K4, the other gradients):
#    C_STAT * U * sqrt(L) * max|reference| over the tensor, L the longest
#    reduction. That is the size of rounding errors of random sign, as the
#    random per-edge cotangents here give; it is not a worst case.
U = 2.0 ** -24
C_STAT = 8.0
LOSS_RTOL = 1e-5            # first-step losses, kernel path vs plain path


@dataclasses.dataclass(frozen=True)
class Sizes:
    """How large a run is: the card's run uses :data:`YELP_SIZES`."""

    dataset: dict         # synthetic_dataset arguments (besides seed, name)
    hub: int              # in-degree of the hand-made graph's hub row
    users: int            # users served in phases 4 and 7
    steps: int = 5        # extra CF and KG steps in phase 6
    cf_batch: int = 1024  # the reference recipe's batch sizes
    kg_batch: int = 2048
    chunk: int = CHUNK    # the row split of the hand-made rows


# The largest in-degree of the yelp-scale graph is 70,884.
YELP_SIZES = Sizes(dataset=YELP2018, hub=70884, users=1024)

KERNELS = {
    "spmm_csr": ("kgat_tpu_torch/ops/hopper/csrc/segment_sum.cu",
                 "kgat_tpu/ops/pallas/segment_sum.py:119"),
    "spmm_csr_rev": ("kgat_tpu_torch/ops/hopper/csrc/segment_sum.cu",
                     "kgat_tpu/ops/pallas/segment_sum.py:119"),
    "sddmm_transr": ("kgat_tpu_torch/ops/hopper/csrc/sddmm.cu",
                     "kgat_tpu/ops/pallas/sddmm.py:30"),
    "segment_softmax_csr": ("kgat_tpu_torch/ops/hopper/csrc/softmax.cu",
                            "kgat_tpu/ops/pallas/softmax.py:60"),
    "sddmm_transr_bwd": ("kgat_tpu_torch/ops/hopper/csrc/sddmm_bwd.cu",
                         "kgat_tpu/ops/pallas/sddmm.py:98"),
    "segment_softmax_csr_bwd": ("kgat_tpu_torch/ops/hopper/csrc/softmax.cu",
                                "kgat_tpu/ops/pallas/softmax.py:180"),
    "segment_sum_csr": ("kgat_tpu_torch/ops/hopper/csrc/segment_sum.cu",
                        "kgat_tpu/ops/pallas/segment_sum.py:45"),
    "ring_shift": ("kgat_tpu_torch/ops/hopper/csrc/remote_ring.cu",
                   "kgat_tpu/ops/pallas/remote_ring.py:52"),
    "reduce_send": ("kgat_tpu_torch/ops/hopper/csrc/remote_ring.cu",
                    "kgat_tpu/ops/pallas/remote_ring.py:102"),
}

# The H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bandwidth,
# float32 outside the tensor cores (every kernel but K2's and K4's
# products) and dense TF32 on them (their three passes).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
FRESH_CHUNKS = 8            # K7's fresh-chunk timing: 8 x 8.8 MB, past L2
P_PARTS = 4                 # phase 8's partitions, all on the one card


def own_kernels() -> set:
    """The names of the ``__global__`` functions of the port's CUDA
    sources."""
    names = set()
    for f in sorted(os.listdir(build.CSRC_DIR)):
        with open(os.path.join(build.CSRC_DIR, f)) as src:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", src.read()))
    return names


def graph_kernel_names(graph: int) -> list:
    """The mangled names of the kernel nodes of a captured CUDA graph
    (a ``cudaGraph_t``), read through libcuda."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{fn.__name__} returned CUresult {code}")

    handle = ctypes.c_void_p(graph)
    n = ctypes.c_size_t(0)
    call(cu.cuGraphGetNodes, handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(cu.cuGraphGetNodes, handle, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call(cu.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:               # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at word 0, kern at word 7.
        params = (ctypes.c_void_p * 16)()
        call(cu.cuGraphKernelNodeGetParams_v2, ctypes.c_void_p(node), params)
        name = ctypes.c_char_p()
        if params[0]:
            call(cu.cuFuncGetName, ctypes.byref(name),
                 ctypes.c_void_p(params[0]))
        else:
            call(cu.cuKernelGetName, ctypes.byref(name),
                 ctypes.c_void_p(params[7]))
        names.append(name.value.decode())
    return names


class Times:
    """Per-kernel numbers of the JSON line, for one unit of work each
    (K1: a forward's three launches; K1 rev: a CF step's backward; the
    others: one launch): device ms of the kernel, its plain version and
    the one PyTorch call that computes the same function (None where
    there is none), and the bytes and operations that work needs, each
    input read once and each output written once: float32 operations, and
    TF32 ones on the tensor cores, which run beside them."""

    def __init__(self):
        self.rows = {}
        # CUDA launches of one wrapper call, counted on the card (None
        # where nothing launches, on the CPU).
        self.per_call = {}

    def add(self, name, ms, plain_ms, library_ms=None, nbytes=0, flops=0,
            n=1, tf32_flops=0):
        r = self.rows.setdefault(name, dict(ms=0.0, plain_ms=0.0,
                                            library_ms=None, bytes=0,
                                            flops=0, tf32_flops=0))
        r["ms"] += n * ms
        r["plain_ms"] += n * plain_ms
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + n * library_ms
        r["bytes"] += n * nbytes
        r["flops"] += n * flops
        r["tf32_flops"] += n * tf32_flops

    def count_launches(self, name, measured, expected):
        """Records the CUDA launches that one call of ``name``'s wrapper
        made (``measured``; None where none could be counted), and fails
        where they are not ``expected``: the count its row splits give (K1,
        K3, K6 and K8 two where their CSR has a split row, K4 the tile
        kernel, the reduce and two such row reductions), else one."""
        if measured is not None and measured != expected:
            raise AssertionError(f"{name}: {measured} CUDA launches in one "
                                 f"call, {expected} expected")
        self.per_call[name] = measured

    def bound(self, name):
        """(least ms on the card, "bytes" or "operations")."""
        r = self.rows[name]
        t_b = r["bytes"] / HBM_BYTES_PER_S
        t_o = max(r["flops"] / F32_FLOPS, r["tf32_flops"] / TF32_FLOPS)
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def line(self, name):
        r = self.rows[name]
        bound_ms, by = self.bound(name)
        share = f", {bound_ms / r['ms']:.3f} of the bound" if r["ms"] else ""
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        return (f"{name} kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
                f"ms, library {lib}, bound {bound_ms:.4f} ms by {by}{share}")


def spmm_bytes(n_rows, n_edges, n_in, d, elt=4):
    """K1: x (n_in, d) read once, (src, w) per edge, the offsets, and the
    (n_rows, d) f32 output."""
    return n_in * d * elt + n_edges * 8 + (n_rows + 1) * 4 + n_rows * d * 4


def csr_lengths(row_offsets):
    return (row_offsets[1:] - row_offsets[:-1]).double()


class CudaTimer:
    """Device and host timing on the card."""

    @staticmethod
    def sync():
        torch.cuda.synchronize()

    def device_ms(self, fn, reps: int) -> float:
        """Mean device milliseconds per call of ``fn`` (CUDA events, after
        one warm-up call)."""
        fn()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        self.sync()
        return start.elapsed_time(end) / reps

    def replay_ms(self, fn, reps: int) -> float:
        """Mean device milliseconds per call of ``fn``, by its device
        duration alone: ``reps`` calls captured in one CUDA graph, the
        graph replayed three times between CUDA events after a warm
        replay. For calls whose host work (checks, routing, the ctypes
        call) could outlast the kernel, which events around calls made
        from Python would time instead."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        self.sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        self.sync()
        return start.elapsed_time(end) / (3 * reps)

    def kernel_launches(self, fn) -> int:
        """CUDA launches of the port's own kernels in one call of ``fn``:
        the kernel nodes of a CUDA graph captured from one call (after a
        warm call) whose mangled names hold the name of a ``__global__``
        function of the port's sources (PyTorch's fills and copies in the
        call not counted)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            fn()
        own = [f"{len(n)}{n}" for n in own_kernels()]  # as mangled
        return sum(any(o in name for o in own)
                   for name in graph_kernel_names(graph.raw_cuda_graph()))

    def host_ms(self, fn, reps: int) -> float:
        """Median wall milliseconds of ``fn`` ending in a synchronize."""
        fn()
        self.sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))


class Progress:
    """The phase being run, for the failure line."""

    def __init__(self):
        self.n = 0

    def phase(self, n: int, what: str):
        self.n = n
        print(f"[{n}/8] {what} ...", flush=True)


class Check:
    """Kernel-vs-plain comparisons, with the worst error per kernel and,
    for the bounded ones, the worst error as a share of its bound."""

    def __init__(self, timer):
        self.timer = timer
        self.max_err = {name: 0.0 for name in KERNELS}
        self.share = {}

    def _err(self, name, label, got, want):
        self.timer.sync()
        if got.shape != want.shape:
            raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        err = (got.double() - want.double()).abs()
        if name in self.max_err and err.numel():
            self.max_err[name] = max(self.max_err[name], float(err.max()))
        return err

    def __call__(self, name, label, got, want, rtol=RTOL, atol=ATOL):
        """|got - want| <= atol + rtol |want|, against a float32 plain."""
        err = self._err(name, label, got, want)
        worst = float(err.max()) if err.numel() else 0.0
        if not torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol):
            raise AssertionError(f"{name} {label}: max abs err {worst:.3e} "
                                 f"beyond rtol {rtol} atol {atol}")
        return worst

    def bounded(self, name, label, got, want64, bound64):
        """|got - want64| <= bound64 elementwise (see sum_bound and
        stat_bound); returns (max abs err, the bound where the error is
        largest against it, that share of the bound)."""
        err = self._err(name, label, got, want64)
        if not err.numel():
            return 0.0, 0.0, 0.0
        ratio = (err / bound64.clamp(min=1e-300)).flatten()
        at = int(ratio.argmax())
        share, bound = float(ratio[at]), float(bound64.flatten()[at])
        if name in KERNELS:
            self.share[name] = max(self.share.get(name, 0.0), share)
        worst = float(err.max())
        if share > 1.0:
            raise AssertionError(
                f"{name} {label}: abs err {float(err.flatten()[at]):.3e} "
                f"beyond its bound {bound:.3e} ({share:.2f}x)")
        return worst, bound, share


def sum_bound(want64, abs_sum64, n_terms):
    """n * 2^-23 * sum|terms| + U |reference|: a float32 sum of n terms,
    in any order, is within it. ``n_terms`` broadcasts against the
    output (a row's length)."""
    return 2 * U * n_terms * abs_sum64 + U * want64.abs()


def stat_bound(want64, length: int):
    """C_STAT * U * sqrt(L) * max|reference| + U |reference|, for
    reductions of at most L terms of random sign whose magnitudes are not
    at hand."""
    return (C_STAT * U * math.sqrt(max(length, 1)) * want64.abs().max()
            + U * want64.abs())


def random_inputs(n_nodes, n_rel, d, k, gen, dev):
    """Embedding table and TransR weights at the Xavier scale."""
    def u(*shape, fan):
        lim = (6.0 / fan) ** 0.5
        return ((torch.rand(shape, generator=gen) * 2 - 1) * lim).to(dev)
    return (u(n_nodes, d, fan=n_nodes + d), u(n_rel, d, k, fan=d + k),
            u(n_rel, k, fan=n_rel + k))


def row_coo(g, vals):
    """A coalesced sparse COO tensor of per-edge ``vals`` at (dst,
    position in the row): torch.sparse.softmax over its dim 1, and its
    backward, compute K3's and K5's functions (its indices are unique
    and already sorted, so coalescing changes nothing)."""
    dst = ref.offsets_to_dst(g.row_offsets)
    pos = torch.arange(g.n_edges, device=vals.device) \
        - g.row_offsets.long()[dst]
    return torch.sparse_coo_tensor(
        torch.stack([dst, pos]), vals,
        (g.n_nodes, max(int(csr_lengths(g.row_offsets).max()), 1))
    ).coalesce()


def check_kernels(g, label, check, gen, dev, timer, times=None):
    """K2 -> K3 -> K1 on graph ``g`` against the plain versions. With
    ``times`` (a dict), also records per-forward kernel and plain ms.
    Returns the errors (K2's as (against the plain version, against
    float64, the plain version's against float64)) and the attention
    weights."""
    d = k = 64
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, d, k,
                                          gen, dev)
    a2 = (g.rel_perm, g.tiles, g.src, g.dst, emb, w_rel, rel_embed)
    logits = sddmm_transr_plain(*a2)
    got2 = sddmm_transr(*a2)
    e2 = check("sddmm_transr", label, got2, logits)
    # K2 multiplies on the tensor cores in three TF32 passes: against
    # float64 it must be as close as float32 is (within twice the plain
    # float32 path's worst error); a single TF32 pass would be ~1000x
    # further off, which the 1e-4 tolerance above cannot tell.
    want64 = sddmm_transr_plain(*a2[:4], emb.double(), w_rel.double(),
                                rel_embed.double())
    e64 = float((got2.double() - want64).abs().max())
    p64 = float((logits.double() - want64).abs().max())
    del got2, want64
    if e64 > 2 * p64:
        raise AssertionError(f"sddmm_transr {label}: max abs err {e64:.3e} "
                             f"against float64, over twice the plain "
                             f"float32 path's {p64:.3e}")
    att = segment_softmax_csr_plain(g.row_offsets, logits)
    w3 = segment_softmax_csr(g.row_offsets, logits, g.split)
    e3 = check("segment_softmax_csr", label, w3, att, atol=1e-6)
    check_identical("segment_softmax_csr", w3,
                    segment_softmax_csr(g.row_offsets, logits, g.split))
    del w3
    # K3's library call: torch.sparse.softmax over the logits' COO tensor.
    coo = row_coo(g, logits)
    check("K3's library call", label,
          torch.sparse.softmax(coo, 1).values(), att, atol=1e-6)
    errs = []
    for dd, dt in ((64, torch.float32), (32, torch.float32),
                   (64, torch.bfloat16)):
        x = (torch.randn(g.n_nodes, dd, generator=gen) * 0.1).to(dev, dt)
        a1 = (g.row_offsets, g.src, att, x)
        out = spmm_csr(*a1, g.split)
        errs.append(check("spmm_csr", f"{label} d={dd} {dt}", out,
                          spmm_csr_plain(*a1)))
        check_identical("spmm_csr", out, spmm_csr(*a1, g.split))
        empty = (g.row_offsets[1:] == g.row_offsets[:-1])
        if empty.any() and out[empty].abs().max() != 0:
            raise AssertionError("spmm_csr: an empty row is not 0")
        if times is not None:
            ms = timer.device_ms(lambda: spmm_csr(*a1, g.split), 20)
            plain_ms = timer.device_ms(lambda: spmm_csr_plain(*a1), 5)
            print(f"[3/8] spmm_csr per call at d={dd} {dt}: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if dt == torch.float32:
                # A forward runs K1 at d = 64, 64, 32.
                csr = torch.sparse_csr_tensor(g.row_offsets, g.src, att,
                                              (g.n_nodes, g.n_nodes))
                lib_ms = timer.device_ms(lambda: torch.sparse.mm(csr, x), 5)
                times.add("spmm_csr", ms, plain_ms, lib_ms,
                          spmm_bytes(g.n_nodes, g.n_edges, g.n_nodes, dd),
                          2 * g.n_edges * dd, n=2 if dd == 64 else 1)
                if dd == 64:
                    times.count_launches("spmm_csr", timer.kernel_launches(
                        lambda: spmm_csr(*a1, g.split)),
                        g.split.cuda_launches)
    if times is not None:
        n_rel = g.n_relations
        times.add("sddmm_transr",
                  timer.device_ms(lambda: sddmm_transr(*a2), 20),
                  timer.device_ms(lambda: sddmm_transr_plain(*a2), 5),
                  nbytes=(g.n_nodes * d + n_rel * (d * k + k)
                          + 4 * g.n_edges) * 4 + g.tiles.numel() * 4,
                  flops=g.n_edges * 3 * k,
                  tf32_flops=3 * g.n_edges * 4 * d * k)
        times.add("segment_softmax_csr",
                  timer.device_ms(lambda: segment_softmax_csr(
                      g.row_offsets, logits, g.split), 20),
                  timer.device_ms(lambda: segment_softmax_csr_plain(
                      g.row_offsets, logits), 5),
                  timer.device_ms(lambda: torch.sparse.softmax(coo, 1), 5),
                  nbytes=2 * g.n_edges * 4 + (g.n_nodes + 1) * 4,
                  flops=5 * g.n_edges)
        times.count_launches("sddmm_transr", timer.kernel_launches(
            lambda: sddmm_transr(*a2)), int(g.tiles.shape[0] > 0))
        times.count_launches("segment_softmax_csr", timer.kernel_launches(
            lambda: segment_softmax_csr(g.row_offsets, logits, g.split)),
            g.split.cuda_launches)
    return (e2, e64, p64), e3, errs, att


def check_backward_kernels(g, att, label, check, gen, dev, timer,
                           times=None):
    """K1 on the reverse CSR, K4 and K5 on graph ``g`` against float64
    plain versions, each twice (bit-identical). With ``times``, records
    kernel and plain ms: K1's per CF-step backward (d = 64, 64, 32), K4's
    and K5's per call."""
    shares = {}
    rev_w = att[g.rev_perm.long()].contiguous()
    rev_len = (g.rev_row_offsets[1:] - g.rev_row_offsets[:-1]).double()
    for dd in (64, 32):
        cot = torch.randn(g.n_nodes, dd, generator=gen).to(dev)
        a1 = (g.rev_row_offsets, g.rev_dst, rev_w, cot)
        got = spmm_csr_rev(*a1, g.rev_split)
        again = spmm_csr_rev(*a1, g.rev_split)
        want = spmm_csr_plain(g.rev_row_offsets, g.rev_dst, rev_w.double(),
                              cot.double())
        terms = spmm_csr_plain(g.rev_row_offsets, g.rev_dst,
                               rev_w.double().abs(), cot.double().abs())
        shares[f"K1 rev d={dd}"] = check.bounded(
            "spmm_csr_rev", f"{label} d={dd}", got, want,
            sum_bound(want, terms, rev_len[:, None]))
        check_identical("spmm_csr_rev", got, again)
        del want, terms
        if times is not None:
            csr = torch.sparse_csr_tensor(g.rev_row_offsets, g.rev_dst,
                                          rev_w, (g.n_nodes, g.n_nodes))
            times.add("spmm_csr_rev",
                      timer.device_ms(lambda: spmm_csr_rev(*a1, g.rev_split),
                                      20),
                      timer.device_ms(lambda: spmm_csr_plain(*a1), 5),
                      timer.device_ms(lambda: torch.sparse.mm(csr, cot), 5),
                      spmm_bytes(g.n_nodes, g.n_edges, g.n_nodes, dd),
                      2 * g.n_edges * dd, n=2 if dd == 64 else 1)
            if dd == 64:
                times.count_launches("spmm_csr_rev", timer.kernel_launches(
                    lambda: spmm_csr_rev(*a1, g.rev_split)),
                    g.rev_split.cuda_launches)

    d = k = 64
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, d, k,
                                          gen, dev)
    cot = torch.randn(g.n_edges, generator=gen).to(dev)
    a4 = (g, cot, emb, w_rel, rel_embed)
    got = sddmm_transr_bwd(*a4)
    again = sddmm_transr_bwd(*a4)
    want = sddmm_transr_bwd_plain(g, cot.double(), emb.double(),
                                  w_rel.double(), rel_embed.double())
    plain = sddmm_transr_bwd_plain(*a4)
    length = k4_length(g, k)
    k4_errs = []
    for name, a, b, c, p in zip(("d_emb", "d_w_rel", "d_rel_embed"), got,
                                want, again, plain):
        shares[f"K4 {name}"] = check.bounded(
            "sddmm_transr_bwd", f"{label} {name}", a, b,
            stat_bound(b, length))
        check_identical(f"sddmm_transr_bwd {name}", a, c)
        # K4 multiplies on the tensor cores in three TF32 passes: against
        # float64 each output must be as close as the plain float32 path's
        # (within twice its worst error); one TF32 pass would be ~1000x
        # further off.
        e64 = float((a.double() - b).abs().max())
        p64 = float((p.double() - b).abs().max())
        k4_errs.append(f"{name} {e64:.2e} (plain {p64:.2e})")
        if e64 > 2 * p64:
            raise AssertionError(f"sddmm_transr_bwd {label} {name}: max abs "
                                 f"err {e64:.3e} against float64, over "
                                 f"twice the plain float32 path's "
                                 f"{p64:.3e}")
    del got, again, want, plain
    if times is not None:
        n_rel = g.n_relations
        # Operations: the six d x k products an edge in three TF32 passes
        # on the tensor cores, and the epilogue's float32 work (tanh and
        # five multiplies a column).
        times.add("sddmm_transr_bwd",
                  timer.device_ms(lambda: sddmm_transr_bwd(*a4), 5),
                  timer.device_ms(lambda: sddmm_transr_bwd_plain(*a4), 2),
                  nbytes=(2 * g.n_nodes * d + 2 * n_rel * (d * k + k)
                          + 5 * g.n_edges + 2 * (g.n_nodes + 1)) * 4
                  + g.tiles.numel() * 4,
                  flops=6 * k * g.n_edges,
                  tf32_flops=3 * 12 * d * k * g.n_edges)
        times.count_launches("sddmm_transr_bwd", timer.kernel_launches(
            lambda: sddmm_transr_bwd(*a4)), sddmm.cuda_launches(g))

    cot = torch.randn(g.n_edges, generator=gen).to(dev)
    got = segment_softmax_csr_bwd(g.row_offsets, att, cot)
    again = segment_softmax_csr_bwd(g.row_offsets, att, cot)
    want = segment_softmax_csr_bwd_plain(g.row_offsets, att.double(),
                                         cot.double())
    dst = ref.offsets_to_dst(g.row_offsets)
    row_len = (g.row_offsets[1:] - g.row_offsets[:-1]).double()
    row_abs = ref.segment_sum_coo(dst, (att.double() * cot.double()).abs(),
                                  g.n_nodes)
    # s = sum over the row of w g takes row length + 5 roundings (lanes,
    # then the shuffle tree), g - s and w (g - s) one each.
    w64 = att.double()
    bound = (2 * U * w64 * ((row_len[dst] + 5) * row_abs[dst]
                            + cot.double().abs())
             + 2 * U * want.abs())
    shares["K5"] = check.bounded("segment_softmax_csr_bwd", label, got, want,
                                 bound)
    check_identical("segment_softmax_csr_bwd", got, again)
    # K5's library call: torch.sparse.softmax's backward on the COO
    # tensors of the weights and the cotangent (one call; the input
    # argument gives it only the indices and shape), against K5's plain
    # version.
    w_coo, g_coo = row_coo(g, att), row_coo(g, cot)

    def library_k5():
        return torch._sparse_softmax_backward_data(g_coo, w_coo, 1, w_coo)
    check("K5's library call", label, library_k5().values(),
          segment_softmax_csr_bwd_plain(g.row_offsets, att, cot),
          rtol=1e-5, atol=1e-6)
    if times is not None:
        times.add("segment_softmax_csr_bwd",
                  timer.device_ms(lambda: segment_softmax_csr_bwd(
                      g.row_offsets, att, cot), 20),
                  timer.device_ms(lambda: segment_softmax_csr_bwd_plain(
                      g.row_offsets, att, cot), 5),
                  timer.device_ms(library_k5, 5),
                  nbytes=3 * g.n_edges * 4 + (g.n_nodes + 1) * 4,
                  flops=4 * g.n_edges)
        times.count_launches("segment_softmax_csr_bwd", timer.kernel_launches(
            lambda: segment_softmax_csr_bwd(g.row_offsets, att, cot)), 1)
    return shares, ", ".join(k4_errs)


def k2_errs(errs) -> str:
    e2, e64, p64 = errs
    return (f"{e2:.2e} (against float64 {e64:.2e}, the plain float32 "
            f"path's {p64:.2e})")


def k4_length(g, k: int) -> int:
    """K4's longest reduction: a node's head and tail edges, k terms each,
    or twice a relation's edges (for d_W)."""
    deg = (g.row_offsets[1:] - g.row_offsets[:-1]
           + g.rev_row_offsets[1:] - g.rev_row_offsets[:-1])
    rel = max((b - a for a, b in zip(g.rel_offsets, g.rel_offsets[1:])),
              default=0)
    return max(int(deg.max()) * k, 2 * rel)


def check_identical(name, a, b):
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: a second call is not bit-identical")


def boundary_rows(chunk: int):
    """Row lengths at the row split's chunk boundaries: one unit of C - 1
    and of C edges, two units of C + 1, four of 3C + 5."""
    return [chunk - 1, chunk, chunk + 1, 3 * chunk + 5]


def handmade_graph(gen, hub: int, chunk: int):
    """100 nodes: node 0 has no in-edge, node 1 one, node 2 is a hub of
    ``hub`` in-edges, nodes 3-6 sit at the boundaries of the row split of
    ``chunk`` edges (which both CSRs' splits use), the rest 0-40;
    relation 4 has a single edge."""
    rs = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                 generator=gen)))
    n = 100
    deg = np.concatenate([[0, 1, hub], boundary_rows(chunk),
                          rs.integers(0, 41, n - 7)])
    dst = np.repeat(np.arange(n), deg)
    src = rs.integers(0, n, len(dst))
    ety = rs.integers(0, 4, len(dst))
    ety[len(dst) // 2] = 4
    g = build_graph(src, dst, ety, n_nodes=n, n_relations=5)
    return dataclasses.replace(
        g, split=build_row_split(g.row_offsets, chunk),
        rev_split=build_row_split(g.rev_row_offsets, chunk))


def expect_launches(dev, launches, want, what):
    """On the card, ``launches`` must hold at least the counts in ``want``
    (or exactly, for the entries given as a tuple (n,)). The plain
    versions on the CPU launch nothing."""
    if dev.type != "cuda":
        return
    for name, n in want.items():
        got = launches.get(name, 0)
        if (got != n[0]) if isinstance(n, tuple) else (got < n):
            raise AssertionError(f"{what}: {name} launched {got} times, "
                                 f"expected {n}: {launches}")


def check_lists(lines, users, train_user_dict, what):
    if [ln["user"] for ln in lines] != list(users):
        raise AssertionError(f"{what}: output users differ from the request")
    for ln in lines:
        s = np.asarray(ln["scores"])
        seen = set(train_user_dict.get(ln["user"], np.zeros(0)).tolist())
        if (len(ln["items"]) != TOP_K or not np.isfinite(s).all()
                or (np.diff(s) > 0).any() or seen & set(ln["items"])):
            raise AssertionError(f"{what}: bad list for user {ln['user']}: "
                                 f"{ln}")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(f"[1/8] device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    print(line, flush=True)
    return line


def phase_build():
    _, seconds, log = build.build(force=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    build.library()
    print(f"[2/8] build: nvcc sm_90a {seconds:.1f} s (one nvcc per source, "
          f"in parallel), {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers, {spills} spill-store bytes", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    progress = Progress()
    try:
        rec.disable_tf32()
        progress.phase(1, "device")
        smi_line = phase_device()
        progress.phase(2, "build")
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            rc = run(tmp, torch.device("cuda"), torch.Generator().manual_seed(0),
                     smi_line, progress=progress)
    except Exception as e:
        print(f"chip_smoke: FAILED in phase {progress.n}: "
              f"{type(e).__name__}: {e}", flush=True)
        raise
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return rc


def run(tmp: str, dev: torch.device, gen: torch.Generator, smi_line: str,
        sizes: Sizes = YELP_SIZES, timer=None, progress=None) -> int:
    """Phases 3-7 in ``tmp``, on ``dev``; prints the kernels' JSON line."""
    timer = timer or CudaTimer()
    progress = progress or Progress()
    check = Check(timer)

    # --- 3. forward kernels against their plain versions -------------------
    progress.phase(3, "forward kernels against their plain versions")
    # The graph is built from the dataset as written and read back, as the
    # CLIs build it, so all see one canonical edge order.
    t0 = time.perf_counter()
    save_dataset(synthetic_dataset(seed=0, name="yelp2018", **sizes.dataset),
                 tmp)
    ds = load_dataset(tmp, "yelp2018")
    g_host, meta = ds.build()
    gen_s = time.perf_counter() - t0
    deg = (g_host.row_offsets[1:] - g_host.row_offsets[:-1])
    print(f"[3/8] yelp2018-scale graph: {g_host.n_edges} edges, "
          f"{g_host.n_nodes} nodes, {g_host.n_relations} relations, "
          f"max in-degree {int(deg.max())}, {int((deg == 0).sum())} empty "
          f"rows, {g_host.tiles.shape[0]} tiles (generated, written, read "
          f"and built in {gen_s:.1f} s on the host)", flush=True)
    hand = handmade_graph(gen, sizes.hub, sizes.chunk).to(dev)
    e2, e3, e1, hand_att = check_kernels(hand, "hand-made", check, gen, dev,
                                         timer)
    print(f"[3/8] hand-made rows (empty, one edge, hub of {sizes.hub}, "
          f"{boundary_rows(sizes.chunk)} at the chunk boundaries): "
          f"max abs err sddmm {k2_errs(e2)}, softmax {e3:.2e}, spmm "
          f"{', '.join(f'{e:.2e}' for e in e1)} (d64, d32, d64 bf16)",
          flush=True)
    g = g_host.to(dev)
    # The work units of K1's two CSRs, built once per CSR at start-up
    # (build_graph builds them on the host; timed here again, and on the
    # card).
    lines = []
    for what, ro, sp in (("forward", g_host.row_offsets, g.split),
                         ("reverse", g_host.rev_row_offsets, g.rev_split)):
        host = timer.host_ms(lambda: build_row_split(ro), 3)
        card = timer.host_ms(lambda: build_row_split(ro.to(dev)), 3)
        lines.append(f"{what} CSR {sp.n_units} units, {sp.n_split} rows "
                     f"split into {sp.n_slots} partials, built in "
                     f"{host:.1f} ms on the host ({card:.1f} ms on the "
                     f"card), {sp.cuda_launches} CUDA launches per K1 call by "
                     f"the split")
    print(f"[3/8] row split (chunk {CHUNK} edges), once per CSR at "
          f"start-up: " + "; ".join(lines), flush=True)
    times = Times()
    e2, e3, e1, att = check_kernels(g, "yelp2018", check, gen, dev, timer,
                                    times)
    print(f"[3/8] yelp2018 shapes: max abs err sddmm {k2_errs(e2)}, softmax "
          f"{e3:.2e}, spmm {', '.join(f'{e:.2e}' for e in e1)} "
          f"(d64, d32, d64 bf16)", flush=True)
    for name in ("spmm_csr", "sddmm_transr", "segment_softmax_csr"):
        print(f"[3/8] time per {'forward' if name == 'spmm_csr' else 'call'}"
              f" ({smi_line}): {times.line(name)}", flush=True)
    fma_ms = g.n_edges * 4 * 64 * 64 / F32_FLOPS * 1e3
    print(f"[3/8] sddmm_transr's bound on the float32 FMA units, for the "
          f"same products without tensor cores: {fma_ms:.4f} ms", flush=True)

    # --- 4. serving at full width ------------------------------------------
    progress.phase(4, "serving CLI")
    cfg = KGATConfig(ops_backend="hopper")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=gen)
    users = np.asarray(sorted(ds.test_user_dict)[:sizes.users])
    ckpt = os.path.join(tmp, "yelp2018_random")
    save_params(ckpt, kgat.numpy_params(model), {
        "dataset": "yelp2018",
        "model": {"embed_dim": cfg.embed_dim,
                  "relation_dim": cfg.relation_dim,
                  "conv_dims": list(cfg.conv_dims),
                  "aggregator": cfg.aggregator}})
    out_path = os.path.join(tmp, "recs.jsonl")
    build.launch_counts.clear()
    t0 = time.perf_counter()
    rc = rec.main(["--ckpt", ckpt, "--data-root", tmp, "--device", str(dev),
                   "--users", ",".join(str(u) for u in users),
                   "--k", str(TOP_K), "--out", out_path])
    timer.sync()
    cli_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    with open(out_path) as f:
        lines = [json.loads(ln) for ln in f]
    if rc != 0:
        raise AssertionError(f"recommend.main returned {rc}")
    expect_launches(dev, launches, {"sddmm_transr": 1,
                                    "segment_softmax_csr": 1, "spmm_csr": 3},
                    "serving")
    check_lists(lines, users.tolist(), ds.train_user_dict, "serving CLI")
    print(f"[4/8] serving CLI: {len(lines)} users x top-{TOP_K} valid in "
          f"{cli_s:.1f} s (load, build, forward, score); launches {launches}",
          flush=True)

    model = model.to(dev)
    cfg_plain = dataclasses.replace(cfg, ops_backend="ref")
    emb_k = rec._forward(cfg, model, g)
    emb_p = rec._forward(cfg_plain, model, g)
    timer.sync()
    if emb_k.shape != (meta.n_nodes, cfg.out_dim):
        raise AssertionError(f"all_embed shape {tuple(emb_k.shape)}")
    if not torch.isfinite(emb_k).all():
        raise AssertionError("all_embed has non-finite values")
    err = float((emb_k - emb_p).abs().max())
    if not torch.allclose(emb_k, emb_p, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"all_embed kernel vs plain: max err {err:.3e}")
    items_k, scores_k = rec._blocked_topk(emb_k, meta, users, TOP_K + 1,
                                          ds.train_user_dict, 2048)
    items_p, scores_p = rec._blocked_topk(emb_p, meta, users, TOP_K + 1,
                                          ds.train_user_dict, 2048)
    np.testing.assert_allclose(scores_k[:, :TOP_K], scores_p[:, :TOP_K],
                               rtol=RTOL, atol=1e-6)
    # Item sets must agree where the K-th and (K+1)-th plain scores are
    # apart by more than the tolerance, and the order too where every
    # adjacent pair of the top K+1 is.
    gaps = -np.diff(scores_p, axis=1)
    clear = gaps[:, TOP_K - 1] > 1e-4
    ordered = (gaps > 1e-4).all(axis=1)
    for i in np.nonzero(clear)[0]:
        if set(items_k[i, :TOP_K]) != set(items_p[i, :TOP_K]):
            raise AssertionError(f"user {users[i]}: top-{TOP_K} items differ")
    for i in np.nonzero(ordered)[0]:
        if (items_k[i, :TOP_K] != items_p[i, :TOP_K]).any():
            raise AssertionError(f"user {users[i]}: top-{TOP_K} order differs")
    # The CLI's lists against the same path's top-K here: equal scores, and
    # equal item sets wherever the K-th and (K+1)-th scores differ.
    repeat = torch.equal(emb_k, rec._forward(cfg, model, g))
    cli_items = np.asarray([ln["items"] for ln in lines])
    cli_scores = np.asarray([ln["scores"] for ln in lines])
    np.testing.assert_allclose(cli_scores, scores_k[:, :TOP_K], rtol=0,
                               atol=1e-6)
    gap_k = (scores_k[:, TOP_K - 1] - scores_k[:, TOP_K]) > 1e-6
    for i in np.nonzero(gap_k)[0]:
        if set(cli_items[i]) != set(items_k[i, :TOP_K]):
            raise AssertionError(
                f"user {users[i]}: CLI items {cli_items[i].tolist()} != "
                f"kernel path {items_k[i, :TOP_K].tolist()}")
    same_order = int((cli_items == items_k[:, :TOP_K]).all(axis=1).sum())
    fwd_ms = timer.host_ms(lambda: rec._forward(cfg, model, g), 5)
    fwd_plain_ms = timer.host_ms(lambda: rec._forward(cfg_plain, model, g), 3)
    server = rec.Recommender(model, g, meta, cfg,
                             train_user_dict=ds.train_user_dict)
    serve_ms = timer.host_ms(lambda: server.recommend(users, k=TOP_K), 5)
    print(f"[4/8] kernel path vs plain path on the card: all_embed max abs "
          f"err {err:.2e}; top-{TOP_K} scores within rtol {RTOL}; item sets "
          f"equal for {int(clear.sum())}/{len(users)} users with a "
          f"20th/21st gap > 1e-4, same order for {int(ordered.sum())} with "
          f"every gap > 1e-4; CLI lists in the same order for "
          f"{same_order}/{len(users)} users; a second kernel forward is "
          f"{'bit-identical' if repeat else 'NOT bit-identical'}", flush=True)
    print(f"[4/8] forward {fwd_ms:.2f} ms (plain path {fwd_plain_ms:.2f} "
          f"ms); serve {len(users)} users top-{TOP_K} from the cached "
          f"forward {serve_ms:.2f} ms ({smi_line})", flush=True)
    del emb_k, emb_p, server

    # --- 5. backward kernels against float64 plain versions ---------------
    progress.phase(5, "backward kernels against float64 plain versions")
    for label, graph, w, t in (("hand-made", hand, hand_att, None),
                               ("yelp2018", g, att, times)):
        shares, k4_errs = check_backward_kernels(graph, w, label, check,
                                                 gen, dev, timer, t)
        print(f"[5/8] {label}: max abs err, and the bound where the error "
              f"is largest against it: "
              + ", ".join(f"{k} {e:.2e} (bound {b:.2e}, {s:.3f} of it)"
                          for k, (e, b, s) in shares.items())
              + f"; K4 against float64 {k4_errs}; second calls "
              f"bit-identical", flush=True)
    for name in ("spmm_csr_rev", "sddmm_transr_bwd",
                 "segment_softmax_csr_bwd"):
        per = "per CF-step backward (d = 64, 64, 32)" if name == \
            "spmm_csr_rev" else "per call"
        print(f"[5/8] {per} ({smi_line}): {times.line(name)}", flush=True)
    row_gb = 4 * g.n_edges * 64 * 4 / 1e9
    print(f"[5/8] sddmm_transr_bwd: {times.per_call['sddmm_transr_bwd']} "
          f"CUDA launches per call (counted); bound on the float32 FMA units, for the "
          f"same products without tensor cores, "
          f"{12 * 64 * 64 * g.n_edges / F32_FLOPS * 1e3:.4f} ms; its d_eh "
          f"and d_et rows, written and read back ({row_gb:.2f} GB), take "
          f"{row_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.4f} ms of HBM time, the "
          f"design's own cost beside the bound", flush=True)
    del att, hand_att

    # The attention gradient through the model: logits -> softmax -> a
    # random linear functional (K2, K3 forward; K5, K4 backward), against
    # autograd of the plain path in float64.
    cot = torch.randn(g.n_edges, generator=gen).to(dev)
    grads = {}
    build.launch_counts.clear()
    for path, mcfg in (("kernel", cfg), ("plain", cfg_plain)):
        m = model if path == "kernel" else copy.deepcopy(model).double()
        m.zero_grad(set_to_none=True)
        (kgat.compute_attention(m, g, mcfg)
         * cot.to(m.entity_embed.dtype)).sum().backward()
        grads[path] = [m.entity_embed.grad, m.w_rel.grad, m.rel_embed.grad]
        if path == "kernel":
            att_launches = dict(build.launch_counts)
    expect_launches(dev, att_launches, {
        "sddmm_transr": (1,), "segment_softmax_csr": (1,),
        "sddmm_transr_bwd": (1,), "segment_softmax_csr_bwd": (1,)},
        "attention gradient")
    length = k4_length(g, cfg.relation_dim)
    errs = [check.bounded("attention gradient", name, a, b,
                          stat_bound(b, length))
            for name, a, b in zip(("d_entity_embed", "d_w_rel",
                                   "d_rel_embed"), *grads.values())]
    print(f"[5/8] attention gradient through compute_attention, kernel path "
          f"vs float64 plain path: "
          + ", ".join(f"{n} {e:.2e} (bound {b:.2e}, {s:.3f} of it)"
                      for n, (e, b, s) in zip(
                          ("d_entity_embed", "d_w_rel", "d_rel_embed"), errs))
          + f"; launches {att_launches}", flush=True)
    del grads, cot
    model.zero_grad(set_to_none=True)

    # --- 6. training steps at full width -----------------------------------
    progress.phase(6, "training steps, kernel path against plain path")
    t0 = time.perf_counter()
    tcfg = TrainConfig(dataset="yelp2018", data_root=tmp, device=str(dev),
                       log_dir=None, cf_batch_size=sizes.cf_batch,
                       kg_batch_size=sizes.kg_batch, seed=0)
    trainer = train.Trainer(tcfg, dataset=ds)
    build_s = time.perf_counter() - t0
    train_stats = phase_train_steps(trainer, sizes, check, timer, dev)
    print(f"[6/8] trainer built in {build_s:.1f} s ({trainer.n_cf_batches} "
          f"CF and {trainer.n_kg_batches} KG batches an epoch); "
          + train_stats, flush=True)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- 7. the trainer CLI, then serving its checkpoint -------------------
    progress.phase(7, "trainer CLI for one epoch, then serving its "
                      "best checkpoint")
    log_dir = os.path.join(tmp, "runs")
    build.launch_counts.clear()
    t0 = time.perf_counter()
    train.main(["--dataset", "yelp2018", "--data-root", tmp, "--epochs", "1",
                "--eval-every", "1", "--device", str(dev), "--log-dir",
                log_dir, "--run-name", "smoke", "--seed", "0",
                "--cf-batch-size", str(sizes.cf_batch),
                "--kg-batch-size", str(sizes.kg_batch)])
    timer.sync()
    cli_s = time.perf_counter() - t0
    main_launches = dict(build.launch_counts)
    with open(os.path.join(log_dir, "smoke.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    check_events(events)
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    n_cf = next(e for e in events if e["event"] == "start")["cf_batches"]
    # Per CF step: K1 three times forward, three times on the reverse CSR;
    # K2 and K3 once per attention recompute (epoch start and end).
    expect_launches(dev, main_launches, {
        "spmm_csr": 3 * n_cf, "spmm_csr_rev": (3 * n_cf,),
        "sddmm_transr": (2,), "segment_softmax_csr": (2,)}, "trainer CLI")
    best = os.path.join(log_dir, "smoke_best")
    with open(best + ".json") as f:
        side = json.load(f)
    if side.get("dataset") != "yelp2018" or side["model"]["conv_dims"] != [
            64, 32, 16]:
        raise AssertionError(f"best checkpoint sidecar: {side}")
    out_path = os.path.join(tmp, "recs_trained.jsonl")
    rc = rec.main(["--ckpt", best, "--data-root", tmp, "--device", str(dev),
                   "--users", ",".join(str(u) for u in users),
                   "--k", str(TOP_K), "--out", out_path])
    with open(out_path) as f:
        lines = [json.loads(ln) for ln in f]
    if rc != 0:
        raise AssertionError(f"recommend.main returned {rc}")
    check_lists(lines, users.tolist(), ds.train_user_dict,
                "serving the trained checkpoint")
    print(f"[7/8] trainer CLI: 1 epoch in {epoch['secs']:.1f} s "
          f"({cli_s:.1f} s with data load, build, eval and checkpoints), "
          f"cf_loss {epoch['cf_loss']:.4f}, kg_loss {epoch['kg_loss']:.4f}, "
          f"recall@20 {ev['recall']:.4f}, ndcg@20 {ev['ndcg']:.4f}; events "
          f"{[e['event'] for e in events]}; served {len(lines)} users "
          f"top-{TOP_K} from smoke_best; launches {main_launches} "
          f"({smi_line})", flush=True)

    # --- 8. the edge-partitioned trainer, P = 4 on the card -----------------
    progress.phase(8, f"edge-partitioned trainer, {P_PARTS} partitions on "
                      f"the card")
    part_launches = phase_partitioned(tmp, ds, g_host, g, meta, sizes, check,
                                      times, gen, dev, timer, smi_line)

    paths = {"sddmm_transr_bwd": ("attention gradient", att_launches),
             "segment_softmax_csr_bwd": ("attention gradient", att_launches),
             "segment_sum_csr": ("partitioned train CLI", part_launches),
             "ring_shift": ("partitioned train CLI", part_launches),
             "reduce_send": ("partitioned train CLI", part_launches)}
    rows = []
    for name, (src, tpu) in KERNELS.items():
        path, launches = paths.get(name, ("train CLI", main_launches))
        bound_ms, bound_by = times.bound(name)
        r = times.rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches.get(name, 0),
                     "path": path, "max_abs_err": check.max_err[name],
                     "share_of_bound": check.share.get(name),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": r["library_ms"],
                     "cuda_launches_per_call": times.per_call[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# JSONL keys of kgat_tpu's trainer, per event.
EVENT_KEYS = {
    "start": {"event", "t", "dataset", "n_nodes", "n_edges", "n_relations",
              "cf_batches", "kg_batches", "aggregator", "backend",
              "sampler"},
    "epoch": {"event", "t", "epoch", "cf_loss", "kg_loss", "secs",
              "edges_per_s"},
    "eval": {"event", "t", "epoch", "recall", "ndcg", "precision", "hit"},
    "done": {"event", "t", "best_recall"},
}


def check_events(events):
    names = [e["event"] for e in events]
    if names != ["start", "epoch", "eval", "done"]:
        raise AssertionError(f"trainer events {names}")
    for e in events:
        if set(e) != EVENT_KEYS[e["event"]]:
            raise AssertionError(f"{e['event']} keys {sorted(e)}")
    epoch = events[1]
    if not (math.isfinite(epoch["cf_loss"]) and math.isfinite(
            epoch["kg_loss"])):
        raise AssertionError(f"non-finite losses {epoch}")
    for key in ("recall", "ndcg", "precision", "hit"):
        if not 0.0 <= events[2][key] <= 1.0:
            raise AssertionError(f"eval {key} = {events[2][key]}")


def _grads(params):
    return [p.grad.detach().clone() for p in params]


def plain_grads(model, loss_fn):
    """Loss and gradients of the plain path in float64, from a copy of
    ``model``'s current parameters, and the term magnitudes of the layer
    weights' gradients. (A float32 plain path would sum with atomics in a
    new order each run, and two float32 paths can then differ by far more
    than either differs from the exact value.)"""
    model64 = copy.deepcopy(model).double()
    params64 = dict(model64.named_parameters())
    with LayerProducts(params64) as products:
        loss = loss_fn(model64)
    outs = [z for _, _, z in products.found]
    grads = torch.autograd.grad(loss, [*params64.values(), *outs],
                                allow_unused=True)
    return (loss.item(),
            [torch.zeros_like(p) if gp is None else gp
             for p, gp in zip(params64.values(), grads)],
            products.term_magnitudes(grads[len(params64):]))


def phase_train_steps(trainer, sizes, check, timer, dev) -> str:
    """The first CF and KG steps on the kernel and the plain path, more
    steps on a fixed batch, a recompute and an evaluate(); returns the
    summary line."""
    model, mcfg = trainer.model, trainer.cfg.model
    plain = dataclasses.replace(mcfg, ops_backend="ref")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    mask_gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    # The longest reduction of a gradient: a CSR row, or every node for a
    # layer weight.
    g = trainer.graph
    length = max(int((g.row_offsets[1:] - g.row_offsets[:-1]).max()),
                 g.n_nodes)

    # The first CF step: one batch, one dropout mask, both paths.
    att = trainer.attention()
    cf_batch = trainer.sample_cf()
    loss_k = float(trainer.cf_grad(att, *cf_batch, generator=mask_gen()))
    loss_p, grads_p, terms = plain_grads(model, lambda m: kgat.cf_loss(
        m, g, kgat.attention_for_training(m, g, plain), trainer.meta,
        *cf_batch[:3], plain, generator=mask_gen(), train=True,
        weight=cf_batch[3]))
    cf_errs = compare_step("CF", loss_k, loss_p, names, _grads(params),
                           grads_p, terms, check, length)
    trainer.opt.step()
    del grads_p, terms

    # The first KG step (no graph op: the two paths run the same code).
    kg_batch = trainer.sample_kg()
    kg_loss_k = float(trainer.kg_grad(*kg_batch))
    kg_loss_p, grads_p, terms = plain_grads(model, lambda m: kgat.kg_loss(
        m, *kg_batch[:4], plain, weight=kg_batch[4]))
    kg_errs = compare_step("KG", kg_loss_k, kg_loss_p, names, _grads(params),
                           grads_p, terms, check, length)
    trainer.opt.step()
    del grads_p, terms

    # More steps on one fixed batch and dropout mask: the loss on it falls.
    build.launch_counts.clear()
    cf_losses = [float(trainer.cf_step(att, *cf_batch, generator=mask_gen()))
                 for _ in range(sizes.steps)]
    cf_losses.append(float(trainer.cf_grad(att, *cf_batch,
                                           generator=mask_gen())))
    step_launches = dict(build.launch_counts)
    kg_losses = [float(trainer.kg_step(*kg_batch)) for _ in range(sizes.steps)]
    kg_losses.append(float(trainer.kg_grad(*kg_batch)))
    for what, losses in (("CF", cf_losses), ("KG", kg_losses)):
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what} losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{what} loss on a fixed batch did not fall "
                                 f"over {sizes.steps} steps: {losses}")
    expect_launches(dev, step_launches, {
        "spmm_csr": (3 * (sizes.steps + 1),),
        "spmm_csr_rev": (3 * (sizes.steps + 1),)}, "CF steps")

    cf_ms = timer.host_ms(lambda: trainer.cf_step(att, *trainer.sample_cf()),
                          5)

    def plain_cf_step():
        """The same step on the plain path: sample, loss, backward, Adam."""
        u, i_pos, i_neg, weight = trainer.sample_cf()
        trainer.opt.zero_grad(set_to_none=False)
        kgat.cf_loss(model, trainer.graph, att, trainer.meta, u, i_pos,
                     i_neg, plain, generator=trainer.generator,
                     weight=weight).backward()
        trainer.opt.step()
    cf_plain_ms = timer.host_ms(plain_cf_step, 3)
    kg_ms = timer.host_ms(lambda: trainer.kg_step(*trainer.sample_kg()), 10)
    build.launch_counts.clear()
    trainer._att = trainer.attention()
    recompute_launches = dict(build.launch_counts)
    expect_launches(dev, recompute_launches, {"sddmm_transr": (1,),
                                              "segment_softmax_csr": (1,)},
                    "attention recompute")
    att_ms = timer.host_ms(trainer.attention, 5)
    t0 = time.perf_counter()
    metrics = trainer.evaluate()
    eval_s = time.perf_counter() - t0
    for key in ("recall", "ndcg"):
        if not 0.0 <= metrics[key] <= 1.0:
            raise AssertionError(f"{key}@20 = {metrics[key]}")
    return (f"first CF step, kernel path vs float64 plain path: {cf_errs}; "
            f"first KG step: "
            f"{kg_errs}; {sizes.steps} CF steps on a fixed batch, loss "
            f"{cf_losses[0]:.5f} -> {cf_losses[-1]:.5f}, launches "
            f"{step_launches}; {sizes.steps} KG steps, loss "
            f"{kg_losses[0]:.5f} -> {kg_losses[-1]:.5f}; CF step (sample + "
            f"step) median {cf_ms:.2f} ms (plain path {cf_plain_ms:.2f} ms), "
            f"KG step {kg_ms:.2f} ms, attention "
            f"recompute {att_ms:.2f} ms (launches {recompute_launches}), "
            f"evaluate {eval_s:.2f} s: recall@20 {metrics['recall']:.4f}, "
            f"ndcg@20 {metrics['ndcg']:.4f}")


class LayerProducts(torch.overrides.TorchFunctionMode):
    """Records each product Z = X @ W of a layer weight W made inside it,
    so that the magnitudes of the terms W's gradient sums over the nodes
    (|X|^T |dZ|), and the bias added to Z sums (the column sums of
    |dZ|), are at hand once dZ is."""

    def __init__(self, params: dict):
        super().__init__()
        self.names = {id(p): n for n, p in params.items()
                      if n.rsplit(".", 1)[-1].startswith("w")
                      and n.startswith("layers.")}
        self.found = []   # (weight name, X, Z)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # ``x @ w`` arrives as Tensor.matmul or __matmul__ by torch version.
        if (getattr(func, "__name__", "") in ("matmul", "__matmul__")
                and len(args) == 2 and id(args[1]) in self.names):
            self.found.append((self.names[id(args[1])], args[0].detach(),
                               out))
        return out

    def term_magnitudes(self, d_outs) -> dict:
        terms = {}
        for (name, x, _), dz in zip(self.found, d_outs):
            if dz is None:
                continue
            head, leaf = name.rsplit(".", 1)
            bias = f"{head}.b{leaf[1:]}"
            terms[name] = terms.get(name, 0) + x.abs().T @ dz.abs()
            terms[bias] = terms.get(bias, 0) + dz.abs().sum(0)
        return terms


def compare_step(what, loss_k, loss_p, names, grads_k, grads_p, terms,
                 check, length) -> str:
    """Losses to LOSS_RTOL; each parameter's gradient against the float64
    plain path's. A layer weight's or bias's gradient is a sum over the
    nodes whose term magnitudes ``terms`` holds: it is held to
    :func:`sum_bound` with twice ``length`` roundings (the sum, and as many
    again for its inputs, themselves sums); the rest to :func:`stat_bound`."""
    if not math.isfinite(loss_k) or abs(loss_k - loss_p) > LOSS_RTOL * abs(
            loss_p):
        raise AssertionError(f"{what} loss kernel {loss_k} vs plain {loss_p}")
    worst = (0.0, -1.0, "")
    for name, a, b in zip(names, grads_k, grads_p):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what} gradient of {name} not finite")
        bound = (sum_bound(b, terms[name], 2 * length) if name in terms
                 else stat_bound(b, length))
        _, _, share = check.bounded(f"{what} step", name, a, b, bound)
        if share > worst[1]:
            worst = (float((a.double() - b).abs().max()), share, name)
    return (f"loss {loss_k:.6f} vs {loss_p:.6f}, worst gradient {worst[2]} "
            f"max abs err {worst[0]:.2e} ({worst[1]:.3f} of its bound)")


# ---------------------------------------------------------------------------
# Phase 8: the edge-partitioned trainer.
# ---------------------------------------------------------------------------

EXCHANGES = (("allgather", "ppermute"), ("ring", "ppermute"), ("ring", "dma"),
             ("ring", "fused"))


def partitioned_launches(exchange, transport, n_layers, n_parts,
                         backward=True):
    """The launches one forward (and its backward) of an exchange makes,
    each wrapper launching once per partition and ring step: K1 per
    shard and layer on the all-gather (K1 on the reverse CSR backward);
    on the ring a bucket reduce per partition, step and layer, K6 or,
    at the P - 1 steps that send under 'fused', K8; the sends of the
    P - 1 steps by K7 under 'dma'; backward, K6 on every bucket's reverse
    CSR and (under 'dma' and 'fused') K7 the other way at every send."""
    L, P = n_layers, n_parts
    sends = L * P * (P - 1)
    if exchange == "allgather":
        fwd, bwd = {"spmm_csr": L * P}, {"spmm_csr_rev": L * P}
    else:
        if transport == "fused":
            fwd = {"reduce_send": sends, "segment_sum_csr": L * P}
        else:
            fwd = {"segment_sum_csr": L * P * P}
            if transport == "dma":
                fwd["ring_shift"] = sends
        bwd = {"segment_sum_csr": L * P * P}
        if transport != "ppermute":
            bwd["ring_shift"] = sends
    if not backward:
        return fwd
    return {k: fwd.get(k, 0) + bwd.get(k, 0) for k in {*fwd, *bwd}}


def expect_exact(dev, launches, want, what):
    """On the card, ``launches`` must be exactly ``want`` (no kernel
    missing, none extra)."""
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"{what}: launches {launches}, predicted "
                             f"{want}")


def check_k6(label, ro, vals, split, check):
    """K6 against float64 under sum_bound, and a second call identical."""
    got = segment_sum_csr(ro, vals, split)
    again = segment_sum_csr(ro, vals, split)
    want = ref.segment_sum_csr(ro, vals.double())
    terms = ref.segment_sum_csr(ro, vals.double().abs())
    share = check.bounded("segment_sum_csr", label, got, want, sum_bound(
        want, terms, csr_lengths(ro)[:, None]))
    check_identical("segment_sum_csr", got, again)
    return share


def check_ring_kernels(buckets, info, sizes, check, times, gen, dev, timer):
    """K6, K7 and K8 against their plain versions on the real buckets and
    on hand-made ones; times at d = 64 f32 (K6 and K8 also at d = 32) on
    the largest bucket. Returns the summary."""
    P, R, hub = info.n_parts, info.rows_per_part, sizes.hub
    rs = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                 generator=gen)))
    deg = np.concatenate([[0, 1, max(hub // P, 1)],
                          boundary_rows(sizes.chunk),
                          rs.integers(0, 21, R - 7)])
    hand = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32)).to(dev)
    empty = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    hand_split = build_row_split(hand, sizes.chunk)
    empty_split = build_row_split(empty)
    flat = [(f"bucket ({p},{s})", b) for p, row in enumerate(buckets)
            for s, b in enumerate(row)]
    big_label, big = max(flat, key=lambda lb: lb[1].n_edges)

    def stream(ro, d, dt, bucket=None):
        """A value stream: chunk[src] * w for a real bucket (w an
        attention-like weight in [0, 1)), else random values."""
        n = int(ro[-1])
        if bucket is None:
            return torch.randn(n, d, generator=gen).to(dev, dt)
        chunk = torch.randn(R, d, generator=gen).to(dev)
        w = torch.rand(n, generator=gen).to(dev)
        return (chunk[bucket.src.long()] * w[:, None]).to(dt)

    configs = ((64, torch.float32), (32, torch.float32),
               (16, torch.float32), (64, torch.bfloat16),
               (16, torch.bfloat16), (33, torch.float32))
    worst6 = (0.0, 0.0, 0.0)
    for d, dt in configs:
        cases = [("hand-made", hand, hand_split, None),
                 ("empty bucket", empty, empty_split, None)]
        cases += [(lb, b.row_offsets, b.split, b) for lb, b in flat]
        cases += [(f"{lb} reverse", b.rev_row_offsets, b.rev_split, None)
                  for lb, b in flat[:P]]
        for label, ro, sp, b in cases:
            e = check_k6(f"{label} d={d} {dt}", ro, stream(ro, d, dt, b), sp,
                         check)
            worst6 = max(worst6, e, key=lambda t: t[2])

    # K7: both directions bit-exact, and aliased receive buffers refused.
    for d, dt in configs:
        parts = [torch.randn(R, d, generator=gen).to(dev, dt)
                 for _ in range(P)]
        for step in (1, -1):
            for j, (a, b) in enumerate(zip(ring_shift(parts, step),
                                           ref.ring_shift(parts, step))):
                if not torch.equal(a, b):
                    raise AssertionError(f"ring_shift d={d} {dt} step "
                                         f"{step}: partition {j} differs")
    try:
        ring_shift(parts, 1, out=parts[-1:] + parts[:-1])
    except ValueError:
        pass
    else:
        raise AssertionError("ring_shift took aliased receive buffers")

    # K8: every sending step's buckets (and a ring of hand-made ones).
    worst8 = (0.0, 0.0, 0.0)
    rings = [(f"step {s}", [row[s].row_offsets for row in buckets],
              [row[s].split for row in buckets],
              [row[s] for row in buckets]) for s in range(P - 1)]
    rings.append(("hand-made ring", [empty, hand] + [buckets[p][0].row_offsets
                                                     for p in range(2, P)],
                  [empty_split, hand_split] + [buckets[p][0].split
                                               for p in range(2, P)],
                  [None, None] + [buckets[p][0] for p in range(2, P)]))
    for d, dt in ((64, torch.float32), (32, torch.bfloat16),
                  (16, torch.float32), (33, torch.float32)):
        for label, ros, sps, bks in rings:
            vals = [stream(ro, d, dt, b) for ro, b in zip(ros, bks)]
            chunks = [torch.randn(R, d, generator=gen).to(dev, dt)
                      for _ in range(P)]
            sums, nxt = reduce_send(ros, vals, chunks, splits=sps)
            again, _ = reduce_send(ros, vals, chunks, splits=sps)
            for p, (ro, v, got, a) in enumerate(zip(ros, vals, sums, again)):
                check_identical("reduce_send", got, a)
                want = ref.segment_sum_csr(ro, v.double())
                terms = ref.segment_sum_csr(ro, v.double().abs())
                e = check.bounded("reduce_send", f"{label} p={p} d={d} {dt}",
                                  got, want, sum_bound(
                                      want, terms, csr_lengths(ro)[:, None]))
                worst8 = max(worst8, e, key=lambda t: t[2])
            for j, (a, b) in enumerate(zip(nxt, ref.ring_shift(chunks, 1))):
                if not torch.equal(a, b):
                    raise AssertionError(f"reduce_send {label} d={d} {dt}: "
                                         f"partition {j}'s chunk differs")

    # Times on the largest bucket, one launch each (a ring of one
    # partition for K7 and K8), by device duration (CUDA-graph replay)
    # for the kernels and K7's copies; K6 and K8 at the trainer's widest
    # layer, d = 64 f32 (the JSON line), and at d = 32.
    e_b, per = big.n_edges, {}
    for d in (64, 32):
        vals = stream(big.row_offsets, d, torch.float32, big)
        chunk = torch.randn(R, d, generator=gen).to(dev)
        buf = torch.empty_like(chunk)
        offsets = big.row_offsets.long()
        k6_bytes = e_b * d * 4 + (R + 1) * 4 + R * d * 4
        k7_bytes = 2 * R * d * 4
        if d == 64:
            times.count_launches("segment_sum_csr", timer.kernel_launches(
                lambda: segment_sum_csr(big.row_offsets, vals, big.split)),
                big.split.cuda_launches)
            times.count_launches("reduce_send", timer.kernel_launches(
                lambda: reduce_send([big.row_offsets], [vals], [chunk],
                                    out=[buf], splits=[big.split])),
                big.split.cuda_launches)
            times.count_launches("ring_shift", timer.kernel_launches(
                lambda: ring_shift([chunk], 1, out=[buf])), 1)
        k6 = timer.replay_ms(lambda: segment_sum_csr(
            big.row_offsets, vals, big.split), 20)
        k8 = timer.replay_ms(lambda: reduce_send(
            [big.row_offsets], [vals], [chunk], out=[buf],
            splits=[big.split]), 20)
        per[d] = (k6, k8)
        if d != 64:
            continue

        def library_k8():
            torch.segment_reduce(vals, "sum", offsets=offsets, unsafe=True)
            buf.copy_(chunk)

        times.add("segment_sum_csr", k6,
                  timer.device_ms(lambda: ref.segment_sum_csr(
                      big.row_offsets, vals), 5),
                  timer.device_ms(lambda: torch.segment_reduce(
                      vals, "sum", offsets=offsets, unsafe=True), 5),
                  k6_bytes, e_b * d)
        times.add("ring_shift",
                  timer.replay_ms(lambda: ring_shift([chunk], 1, out=[buf]),
                                  20),
                  timer.replay_ms(lambda: ref.ring_shift([chunk], 1), 20),
                  timer.replay_ms(lambda: buf.copy_(chunk), 20), k7_bytes, 0)
        # Fresh: the calls cycle over FRESH_CHUNKS chunks (70 MB at yelp2018
        # scale, past the 50 MB L2), as a ring CF step finds them.
        srcs = [torch.randn(R, d, generator=gen).to(dev)
                for _ in range(FRESH_CHUNKS)]
        dsts = [torch.empty_like(c) for c in srcs]
        turn = itertools.count()

        def k7_fresh():
            i = next(turn) % FRESH_CHUNKS
            ring_shift([srcs[i]], 1, out=[dsts[i]])

        def copy_fresh():
            i = next(turn) % FRESH_CHUNKS
            dsts[i].copy_(srcs[i])
        fresh = (timer.replay_ms(k7_fresh, 20), timer.replay_ms(copy_fresh, 20))
        del srcs, dsts
        times.add("reduce_send", k8,
                  timer.device_ms(lambda: ref.reduce_send(
                      [big.row_offsets], [vals], [chunk]), 5),
                  timer.device_ms(library_k8, 5), k6_bytes + k7_bytes,
                  e_b * d)
    return (f"K6 on {len(flat)} real buckets (and {P} of them reversed), a "
            f"hand-made one (rows empty, one edge, {max(hub // P, 1)} edges, "
            f"{boundary_rows(sizes.chunk)} at the chunk boundaries) and an "
            f"empty one at "
            f"d = 64/32/16/33 f32 and 64/16 bf16: worst {worst6[2]:.3f} of "
            f"its float64 bound (abs err {worst6[0]:.2e}); K7 bit-exact both "
            f"ways at the same widths, aliased buffers refused; K8 on the "
            f"{P - 1} sending steps and a hand-made ring at d = 64/16/33 f32 "
            f"and 32 bf16: sums worst {worst8[2]:.3f} of the bound, sends "
            f"bit-exact; second calls bit-identical. Times on the largest "
            f"bucket, {big_label} ({e_b} edges, {big.split.n_units} units, "
            f"{big.split.n_split} rows split, "
            f"{times.per_call['segment_sum_csr']} CUDA launches per K6 or K8 "
            f"call, counted), by device duration, per launch: "
            + "; ".join(times.line(n) for n in ("segment_sum_csr",
                                                "ring_shift", "reduce_send"))
            + f"; K7 on {FRESH_CHUNKS} chunks in turn (fresh from memory) "
            f"{fresh[0]:.5f} ms, copy_ {fresh[1]:.5f} ms"
            + f"; at d = 32 f32: K6 {per[32][0]:.4f} ms, K8 {per[32][1]:.4f}"
            f" ms (d = 64: {per[64][0]:.4f}, {per[64][1]:.4f})")


def phase_partitioned(tmp, ds, g_host, g, meta, sizes, check, times, gen,
                      dev, timer, smi_line):
    """Phase 8; returns the launch counts of the partitioned CLI epoch."""
    P, L = P_PARTS, 3
    t0 = time.perf_counter()
    src, dst = g_host.src.numpy(), g_host.dst.numpy()
    shards, info = partition_graph(src, dst, g_host.etype.numpy(),
                                   meta.n_nodes, meta.n_relations, P)
    buckets = build_ring_buckets(src, dst, info)
    host_s = time.perf_counter() - t0
    csrs = [ro for row in buckets for b in row
            for ro in (b.row_offsets, b.rev_row_offsets)]
    split_ms = timer.host_ms(lambda: [build_row_split(ro) for ro in csrs],
                             3) / len(csrs)
    shards = [s.to(dev) for s in shards]
    buckets = [[b.to(dev) for b in row] for row in buckets]
    b_edges = [[b.n_edges for b in row] for row in buckets]
    b_launches = [[(b.split.cuda_launches, b.rev_split.cuda_launches)
                   for b in row] for row in buckets]
    print(f"[8/8] partitioned on the host in {host_s:.1f} s (row splits "
          f"of the {len(csrs)} bucket CSRs included, {split_ms:.2f} ms per "
          f"CSR): R = {info.rows_per_part}, n_pad = {info.n_nodes_pad}, "
          f"shard edges {[s.n_edges for s in shards]}, ring bucket edges "
          f"per (p, s) {b_edges}, CUDA launches per K6/K8 call by the "
          f"splits (forward, reverse) {b_launches}", flush=True)
    summary = check_ring_kernels(buckets, info, sizes, check, times, gen,
                                 dev, timer)
    print(f"[8/8] ring kernels ({smi_line}): {summary}", flush=True)

    # Attention and all_embed of every exchange against the single-device
    # paths, on one random full-width model.
    cfg = KGATConfig(ops_backend="hopper", mess_dropout=(0.0,) * L)
    plain = dataclasses.replace(cfg, ops_backend="ref")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=gen, device=dev)
    mesh = dp.make_mesh(P, dev)
    parts = {key: halo.Partitioned(
        mesh, shards, info, meta, cfg, exchange=key[0],
        ring_buckets=buckets if key[0] == "ring" else None,
        ring_transport=key[1]) for key in EXCHANGES}
    with torch.no_grad():
        att_single = kgat.compute_attention(model, g, cfg)
        model64 = copy.deepcopy(model).double()
        want = kgat.propagate(model64, g, kgat.compute_attention(
            model64, g, plain), plain)
        del model64
    staged, lines = {}, []
    for key, part in parts.items():
        build.launch_counts.clear()
        atts, staged[key] = part.attention(model)
        att_launches = dict(build.launch_counts)
        expect_exact(dev, att_launches, {"sddmm_transr": P,
                                         "segment_softmax_csr": P},
                     f"{key} attention")
        att_err = max(check("partitioned attention", f"{key} p={p}", a,
                            att_single[s.edge_ids.to(dev)], atol=1e-6)
                      for p, (a, s) in enumerate(zip(atts, shards)))
        build.launch_counts.clear()
        got = part.propagate_eval(model, staged[key])
        timer.sync()
        fwd_launches = dict(build.launch_counts)
        expect_exact(dev, fwd_launches, partitioned_launches(
            *key, L, P, backward=False), f"{key} eval forward")
        err = check("partitioned all_embed", "/".join(key), got, want)
        ms = timer.host_ms(lambda: part.propagate_eval(model, staged[key]),
                           3)
        lines.append(f"{'/'.join(key)}: attention max abs err {att_err:.2e}"
                     f" vs single-device kernels (launches {att_launches}), "
                     f"all_embed {err:.2e} vs float64 plain, eval forward "
                     f"{ms:.2f} ms (launches {fwd_launches})")
    del want, att_single
    print(f"[8/8] partitioned forward against single-device ("
          f"{smi_line}): " + "; ".join(lines), flush=True)

    # The first CF step of every exchange (dropout 0): the loss against
    # the single-device kernel path's, the gradients against float64.
    cf_table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items,
                                   device=dev)
    samp = torch.Generator(device=dev).manual_seed(0)
    u, ip, ineg, w = sample_cf_batch(cf_table, samp,
                                     dp.round_batch(sizes.cf_batch, P))
    if not bool((w == 1).all()):
        raise AssertionError("a CF row without an allowed negative")
    with torch.no_grad():
        loss_single = float(kgat.cf_loss(
            model, g, kgat.attention_for_training(model, g, cfg), meta, u,
            ip, ineg, cfg, train=True, weight=w))
    loss_p, grads_p, terms = plain_grads(model, lambda m: kgat.cf_loss(
        m, g, kgat.attention_for_training(m, g, plain), meta, u, ip, ineg,
        plain, train=True, weight=w))
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    length = max(int(csr_lengths(g.row_offsets).max()), g.n_nodes)

    def cf_grads(part, st):
        loss = part.cf_loss(model, st, u, ip, ineg, weight=w)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.item(), [torch.zeros_like(p) if gp is None else gp
                             for p, gp in zip(params, grads)]

    lines = []
    for key, part in parts.items():
        build.launch_counts.clear()
        loss_k, grads_k = cf_grads(part, staged[key])
        timer.sync()
        step_launches = dict(build.launch_counts)
        expect_exact(dev, step_launches, partitioned_launches(*key, L, P),
                     f"{key} CF step")
        if abs(loss_k - loss_single) > LOSS_RTOL * abs(loss_single):
            raise AssertionError(f"{key} CF loss {loss_k} vs single-device "
                                 f"kernel path {loss_single}")
        errs = compare_step(f"CF {'/'.join(key)}", loss_k, loss_p, names,
                            grads_k, grads_p, terms, check, length)
        del grads_k
        ms = timer.host_ms(lambda: cf_grads(part, staged[key]), 3)
        lines.append(f"{'/'.join(key)}: {errs}; forward + backward {ms:.2f}"
                     f" ms (launches {step_launches})")
    del grads_p, terms
    print(f"[8/8] first CF step (batch {u.numel()}, dropout 0) against the "
          f"single-device kernel path ({loss_single:.6f}) and the float64 "
          f"plain path ({smi_line}): " + "; ".join(lines), flush=True)

    # The KG step: the same TransR step on the global batch for every
    # exchange (the data-parallel loss in one process).
    kg_table = KGSampleTable.build(
        np.stack([dst, g_host.etype.numpy(), src], axis=1),
        n_entities=meta.n_nodes, n_relations=meta.n_relations, device=dev)
    kg_batch = sample_kg_batch(kg_table, samp,
                               dp.round_batch(sizes.kg_batch, P))
    kg_loss = kgat.kg_loss(model, *kg_batch[:4], cfg, weight=kg_batch[4])
    kg_grads = torch.autograd.grad(kg_loss, params, allow_unused=True)
    kg_loss_p, grads_p, terms = plain_grads(model, lambda m: kgat.kg_loss(
        m, *kg_batch[:4], plain, weight=kg_batch[4]))
    kg_errs = compare_step("KG partitioned", kg_loss.item(), kg_loss_p,
                           names, [torch.zeros_like(p) if gp is None else gp
                                   for p, gp in zip(params, kg_grads)],
                           grads_p, terms, check, length)
    print(f"[8/8] KG step (batch {kg_batch[0].numel()}) against the float64 "
          f"plain path: {kg_errs}", flush=True)
    del grads_p, terms, kg_grads, parts, staged, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The trainer CLI, one epoch, ring exchange with the fused transport.
    log_dir = os.path.join(tmp, "runs_partitioned")
    argv = ["--dataset", "yelp2018", "--data-root", tmp, "--epochs", "1",
            "--eval-every", "1", "--device", str(dev), "--log-dir", log_dir,
            "--run-name", "part", "--seed", "0", "--cf-batch-size",
            str(sizes.cf_batch), "--kg-batch-size", str(sizes.kg_batch),
            "--n-devices", str(P), "--halo-exchange", "ring",
            "--ring-transport", "fused"]
    build.launch_counts.clear()
    t0 = time.perf_counter()
    train.main(argv)
    timer.sync()
    cli_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    with open(os.path.join(log_dir, "part.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    check_events(events)
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    n_cf = next(e for e in events if e["event"] == "start")["cf_batches"]
    step = partitioned_launches("ring", "fused", L, P)
    evalf = partitioned_launches("ring", "fused", L, P, backward=False)
    # Per CF step a forward and backward; the eval forward once; K2 and K3
    # on every shard at the epoch's two attention recomputes.
    want_launches = {k: n_cf * step.get(k, 0) + evalf.get(k, 0)
                     for k in {*step, *evalf}}
    want_launches.update(sddmm_transr=2 * P, segment_softmax_csr=2 * P)
    expect_exact(dev, launches, want_launches, "partitioned trainer CLI")
    print(f"[8/8] partitioned trainer CLI (python -m kgat_tpu_torch.train "
          f"{' '.join(argv[argv.index('--n-devices'):])}): 1 epoch in "
          f"{epoch['secs']:.1f} s ({cli_s:.1f} s with data load, partition, "
          f"eval and checkpoints), cf_loss {epoch['cf_loss']:.4f}, kg_loss "
          f"{epoch['kg_loss']:.4f}, recall@20 {ev['recall']:.4f}, ndcg@20 "
          f"{ev['ndcg']:.4f}; events {[e['event'] for e in events]}; "
          f"launches {launches} ({n_cf} CF steps; predicted per step "
          f"{step}) ({smi_line})", flush=True)
    return launches


if __name__ == "__main__":
    sys.exit(main())
