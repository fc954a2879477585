#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (kgat_tpu_torch): serving and training.

Run from the repository root on a machine with one NVIDIA GPU (built for
an H100, sm_90a):

    python3 chip_smoke.py

Phases, each announced by a line ``[n/14] ...``:
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
               steps, eager on the kernel path and replayed from the
               trainer's CUDA graphs, each against the plain path in
               float64 (its losses and gradients; same params, and the
               batch and dropout masks the replay drew); two replays must
               draw different batches; more steps on a fixed batch, whose
               loss must fall; an attention recompute; evaluate(); ms per
               step, eager and replayed, and launch counts.
  7. the trainer CLI — ``kgat_tpu_torch.train`` for one epoch of replayed
               steps (the launches of its K1 calls counted from the
               graphs' kernel nodes times the replays), its losses within
               1% of an epoch of eager steps from the same seed, then its
               best checkpoint served for the users of phase 4.
  8. the edge-partitioned trainer, P = 4 partitions on the card: the
               ring kernels (K6 segment sum, K7 ring shift, K8 fused
               reduce + send) against their plain versions on the real
               ring buckets and on hand-made ones (K6 and K8's sums under
               a float64 bound, K7 and K8's send bit-exact), with times
               (K7 and copy_ also on chunks fresh from memory);
               the selective halo's H, T, build time and table bytes
               against the all-gather's; attention and all_embed of every
               exchange (a2a too) and of a (2, 2) (dp, ep) mesh against
               the single-device paths; the first CF step of each (loss
               and gradients) against float64, and a KG step; the launch
               counts each predicts; ring/fused and a2a trainers' steps
               replayed from their CUDA graphs against eager steps from
               the same generator states, with each graph's kernel nodes
               against its captured calls; then the trainer CLI for one
               epoch of replayed steps with ``--n-devices 4
               --halo-exchange ring --ring-transport fused``.
  9. the rest of the trainer at phase 7's scale: ``--resume`` of phase 7's
               run for a second epoch; the BPR-MF CLI for one epoch and a
               trainer epoch with ``--use-pretrain`` on its npz; a
               replayed ``--sparse-adam`` epoch, its first KG step held
               against the float64 dense-state oracle; host-sampled CF and
               KG steps (``--sampler host``).
 10. one process per card (``parallel/multihost.py``): a process group of
               one rank (NCCL) holding phase 8's P = 4 slots, its
               ring/fused steps captured with the gradient all-reduce
               inside the graphs, replayed against eager steps and held
               to phase 8's replayed losses. With two or more cards, W =
               min(4, cards) worker processes of this script
               (``--process-worker``), one per card on NCCL, P = W,
               running allgather, ring/dma, ring/fused and a2a in turn
               (each trainer closed before the next, so ring/fused
               registers its ring buffers after ring/dma's are freed):
               the first CF step of each and a KG step against the
               one-process engine's; K7
               and K8 storing into the neighbour process's registered
               buffer against their plain versions (sends bit-exact);
               10 replayed ring/fused steps against 10 eager ones; each
               process's replayed CF and KG step (50 and 100 replays
               from a barrier), wall and device busy, K7's and K8's
               device time a launch, and the replays' cross-process
               launches, checked against the graph's kernel nodes; one
               epoch of the trainer CLI's ring/fused path on W
               processes. On one card it says that these need two or
               more. ``chip_smoke.py --across-processes`` runs phases 1,
               2 and this multi-process part alone.
  11. the last modules at yelp2018 scale: the graph cache
               (``Dataset.build(cache_dir=...)``) built cold and loaded
               warm, every array and both row splits equal to phase 3's
               build, K3, K1 and K1 rev on the loaded graph bit-identical
               to the built graph's, with the seconds and the file's
               bytes; hopper ``gspmm`` (u_mul_e sum and mean, copy_u sum)
               through K1 at d = 64, and the sum's gradients, against
               float64 plain under the row bound, its max and ``gsddmm``'s
               dot against CPU copies, with times beside the plain path
               and ``torch.sparse.mm``; the explain CLI (``python -m
               kgat_tpu_torch.explain``) on phase 7's best checkpoint,
               with ``--item`` (cache cold, then warm) and without, each
               hop an edge with the card's attention, strengths the
               products of their hops', and the attention index's build
               seconds.
  12. the native host loaders and a bf16 trainer epoch: phase 3's
               yelp2018-scale export parsed by ``kgat_tpu_torch.native``
               (C++) and by the plain Python / numpy parsers, the arrays
               equal; the CKG built with the native counting sort and with
               numpy's stable argsort, every array equal (and equal to
               phase 3's graph); the parse, ``np.unique`` and build
               seconds of each, and ``load_dataset``'s whole seconds
               with each parser, beside the card and the host's CPU
               model;
               then one replayed CLI epoch of ``tools/campaigns.md``'s
               mid-plateau recipe (``--ops-backend pallas --compute-dtype
               bf16 --lr 1e-3``) and the same epoch in float32 from the
               same seed, both finite, the bf16 losses within
               :data:`BF16_RTOL` of the float32 ones, each trainer's
               replayed CF and KG step times, and the bf16 epoch's K1
               launches from its graphs.
  13. ``kgat_tpu``'s default training arithmetic at yelp2018 scale
               (which phases 6-9 and 12 run too: coalesced on one
               device and under the all-gather, the dense route where
               auto picks it): the coalesced CSRs built on the host,
               with their seconds and group count; K1 on them forward
               and on their reverse CSR against float64 under the row
               bound, and against K1 on the full CSRs, both timed; the
               coalesced staging against a float64 group sum, and in
               bf16 equal bit for bit to the float32 sums rounded; a
               replayed coalesced CF step, the attention refreshed and
               replayed again, each held to eager coalesced and
               uncoalesced steps within :data:`LOSS_RTOL`; the dense
               route, which auto picks at mid-plateau scale and which
               is forced at yelp2018 scale, against K2's logits, with
               its device ms beside K2 + K3's and its peak memory.
  14. the port's bench (``kgat_tpu_torch.bench``, ``python -m
               kgat_tpu_torch.bench``'s ``run``) in this process at the
               ``yelp2018`` preset: ``--compare`` (the ref path in the
               same process, its CF step's peak memory), ``--serving``
               and P = 1 ring/fused, its JSON line printed; P = 4
               ring/fused on the card (``bench_partitioned``); the
               roofline; every time finite and positive, every
               efficiency at most 1.05, K1-K3, K6 and K8 launched on
               the bench's path (their counts in the JSON line's
               ``bench_launches``, a captured call once per replay), the
               hopper path's payloads (attention weights, all_embed,
               first CF loss) held to the ref path's within bf16's
               rounding, a replayed CF step's loss equal to an eager
               step's from the same state within 1e-6, and the bench's
               ring/fused engine at P = 1 and 4 held to the
               single-device kernel path.
Then a JSON line of per-kernel results (each kernel's launches on its
path and on the bench's, error, time beside its plain version, the library call that
computes the same function where there is one, and the bound: the least
time the card could take for the same bytes or operations) and, last,
the device JSON line. Kernels whose call may take less time on the card
than on the host (K6-K8 and K7's copies) are timed by their device
duration, in a CUDA graph replay; the others with CUDA events around
back-to-back calls (K5 also by replay, its row's ``replay_ms``).
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

import contextlib
import copy
import ctypes
import dataclasses
import itertools
import json
import math
import os
import platform
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from kgat_tpu_torch import bench, explain, native
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import recommend as rec
from kgat_tpu_torch import optim, train
from kgat_tpu_torch.data import (load_dataset, save_dataset,
                                 synthetic_dataset)
from kgat_tpu_torch.graph import (build_ckg, build_coalesced, build_graph,
                                  coalesce_weights, spmm_csr_of)
from kgat_tpu_torch.models import bprmf, kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops import get_backend, hopper_backend, ref
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.row_split import CHUNK, build_row_split
from kgat_tpu_torch.ops.hopper import remote_ring
from kgat_tpu_torch.ops.hopper.remote_ring import reduce_send, ring_shift
from kgat_tpu_torch.ops.hopper import sddmm
from kgat_tpu_torch.ops.hopper.sddmm import (sddmm_transr, sddmm_transr_bwd,
                                             sddmm_transr_bwd_plain,
                                             sddmm_transr_plain)
from kgat_tpu_torch.ops.hopper.segment_sum import (segment_sum_csr, spmm_bytes,
                                                   spmm_csr, spmm_csr_plain,
                                                   spmm_csr_rev)
from kgat_tpu_torch.ops.hopper.softmax import (segment_softmax_csr,
                                               segment_softmax_csr_bwd,
                                               segment_softmax_csr_bwd_plain,
                                               segment_softmax_csr_plain)
from kgat_tpu_torch.parallel import dp, halo, multihost
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.sampler import (CFSampleTable, KGSampleTable,
                                    sample_cf_batch, sample_kg_batch)
from kgat_tpu_torch.utils.checkpoint import (load_checkpoint, load_params,
                                             save_params)
from kgat_tpu_torch.utils.config import TrainConfig

# yelp2018 at published scale, as the repo's `make datasets` generates it.
YELP2018 = dict(n_users=45919, n_items=45538, n_entities=90961,
                n_relations_kg=42, n_interactions=1185068,
                n_triples=1853704)
# tools/campaigns.md's mid-plateau synthetic dataset (130,498 CKG edges).
MID_PLATEAU = dict(users=3000, items=2000, entities=4000, relations=8,
                   interactions=60000, triples=40000)
# Phase 12: the bf16 epoch's cf_loss and kg_loss against float32's from
# the same seed, relative. Measured on an H100 (700 W): 2.98e-4 and
# 8.38e-4; the bound is six times the larger.
BF16_RTOL = 5e-3
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
    plateau: dict = dataclasses.field(
        default_factory=lambda: dict(MID_PLATEAU))  # phase 12's epochs
    bench_preset: str = "yelp2018"   # phase 14's bench preset
    bench_iters: int = 5             # and its --iters
    # bench.roofline's probe sizes (its defaults, bench.py's, on the card).
    roofline: dict = dataclasses.field(default_factory=dict)


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
            n=1, tf32_flops=0, replay_ms=None):
        r = self.rows.setdefault(name, dict(ms=0.0, plain_ms=0.0,
                                            library_ms=None, bytes=0,
                                            flops=0, tf32_flops=0,
                                            replay_ms=None))
        r["ms"] += n * ms
        if replay_ms is not None:
            # Also timed by CUDA-graph replay where ms comes from events.
            r["replay_ms"] = (r["replay_ms"] or 0.0) + n * replay_ms
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
        K3, K5, K6 and K8 two where their CSR has a split row, K4 the tile
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
        replay = ("" if r["replay_ms"] is None
                  else f" (by CUDA-graph replay {r['replay_ms']:.4f} ms)")
        return (f"{name} kernel {r['ms']:.3f} ms{replay}, plain "
                f"{r['plain_ms']:.3f} ms, library {lib}, bound "
                f"{bound_ms:.4f} ms by {by}{share}")


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
    """The phase being run, for the failure line, and each phase's wall
    seconds, printed as ``[n/14] took ... s`` when it ends: a run cut at a
    time limit shows which phase ran long."""

    def __init__(self):
        self.n = 0
        self.t0 = time.perf_counter()

    def phase(self, n: int, what: str):
        self.end()
        self.n = n
        print(f"[{n}/14] {what} ...", flush=True)

    def end(self):
        """Ends the phase being run."""
        now = time.perf_counter()
        if self.n:
            print(f"[{self.n}/14] took {now - self.t0:.1f} s", flush=True)
        self.t0 = now


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
            print(f"[3/14] spmm_csr per call at d={dd} {dt}: kernel "
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
    a5 = (g.row_offsets, att, cot, g.split)
    got = segment_softmax_csr_bwd(*a5)
    again = segment_softmax_csr_bwd(*a5)
    want = segment_softmax_csr_bwd_plain(g.row_offsets, att.double(),
                                         cot.double())
    dst = ref.offsets_to_dst(g.row_offsets)
    row_len = (g.row_offsets[1:] - g.row_offsets[:-1]).double()
    row_abs = ref.segment_sum_coo(dst, (att.double() * cot.double()).abs(),
                                  g.n_nodes)
    # s = sum over the row of w g takes row length + 5 roundings (lanes,
    # then the shuffle tree; a split row's units, then its slots, fewer),
    # g - s and w (g - s) one each.
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
        # Events around calls, and the device duration alone by CUDA-graph
        # replay: K5's two short launches may take less than its host work.
        times.add("segment_softmax_csr_bwd",
                  timer.device_ms(lambda: segment_softmax_csr_bwd(*a5), 20),
                  timer.device_ms(lambda: segment_softmax_csr_bwd_plain(
                      *a5[:3]), 5),
                  timer.device_ms(library_k5, 5),
                  nbytes=3 * g.n_edges * 4 + (g.n_nodes + 1) * 4,
                  flops=4 * g.n_edges,
                  replay_ms=timer.replay_ms(
                      lambda: segment_softmax_csr_bwd(*a5), 20))
        times.count_launches("segment_softmax_csr_bwd", timer.kernel_launches(
            lambda: segment_softmax_csr_bwd(*a5)), g.split.cuda_launches)
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


def single_device_nodes(graph, staged):
    """The CUDA launches of a single-device step's captured wrapper calls
    (``calls``: name -> count): K1 forward and on the reverse CSR, each
    as many as the row split of the CSR the staged weights ``staged``
    reduce over needs (the graph's, or its coalesced CSRs)."""
    csr = spmm_csr_of(graph, staged)
    per_call = {"spmm_csr": csr.split.cuda_launches,
                "spmm_csr_rev": csr.rev_split.cuda_launches}
    return lambda calls: sum(n * per_call[k] for k, n in calls.items())


def replayed_launches(counts, step_graphs, want_nodes):
    """Wrapper launches of a run whose steps replay CUDA graphs, and each
    graph's kernel nodes. ``build.launch_counts`` counts a wrapper's call
    at capture too, where nothing launches, and a replay launches without
    a call: a captured call is taken out and counted once per replay.
    Each graph's kernel nodes are counted from the graph itself
    (``graph_kernel_names``): all of them, and the port's own, which must
    be ``want_nodes(calls)``, the CUDA launches its captured wrapper calls
    make (each by its CSR's row split). Returns (launches, {step: (kernel
    nodes, own, replays)})."""
    launches, nodes = dict(counts), {}
    own = [f"{len(n)}{n}" for n in own_kernels()]  # as mangled
    for name, steps in zip(("CF", "KG"), step_graphs):
        for k, n in steps.calls.items():
            launches[k] += n * (steps.replays - 1)
        if steps.graph is None:
            continue
        kernels = graph_kernel_names(steps.graph.raw_cuda_graph())
        mine = sum(any(o in k for o in own) for k in kernels)
        want = want_nodes(steps.calls)
        if mine != want:
            raise AssertionError(f"{name} step graph: {mine} kernel nodes of "
                                 f"the port's kernels, {want} expected from "
                                 f"its captured calls {steps.calls}")
        nodes[name] = (len(kernels), mine, steps.replays)
    return launches, nodes


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
    print(f"[1/14] device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    print(line, flush=True)
    return line


def phase_build():
    _, seconds, log = build.build(force=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    build.library()
    _, host_s = native.build(force=True)
    native.library()
    print(f"[2/14] build: nvcc sm_90a {seconds:.1f} s (one nvcc per source, "
          f"in parallel), {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers, {spills} spill-store bytes; the native host layer "
          f"(g++) {host_s:.1f} s", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
            if argv == ["--across-processes"]:
                rc = across_only(tmp, smi_line, progress)
            else:
                rc = run(tmp, torch.device("cuda"),
                         torch.Generator().manual_seed(0), smi_line,
                         progress=progress)
    except Exception as e:
        print(f"chip_smoke: FAILED in phase {progress.n}: "
              f"{type(e).__name__}: {e}", flush=True)
        raise
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return rc


def across_only(tmp, smi_line, progress) -> int:
    """Phase 10's multi-process part alone, at yelp2018 scale on W =
    min(4, cards) processes; prints K7's and K8's cross-process numbers."""
    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--across-processes needs two or more cards, "
                           f"and {n} is visible")
    progress.phase(10, "one process per card")
    save_dataset(synthetic_dataset(seed=0, name="yelp2018",
                                   **YELP_SIZES.dataset), tmp)
    got = across_processes(tmp, load_dataset(tmp, "yelp2018"), YELP_SIZES,
                           torch.device("cuda"), min(4, n), smi_line)
    progress.end()
    print(json.dumps({"across_processes": got}), flush=True)
    return 0


def run(tmp: str, dev: torch.device, gen: torch.Generator, smi_line: str,
        sizes: Sizes = YELP_SIZES, timer=None, progress=None) -> int:
    """Phases 3-14 in ``tmp``, on ``dev``; prints the kernels' JSON line."""
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
    print(f"[3/14] yelp2018-scale graph: {g_host.n_edges} edges, "
          f"{g_host.n_nodes} nodes, {g_host.n_relations} relations, "
          f"max in-degree {int(deg.max())}, {int((deg == 0).sum())} empty "
          f"rows, {g_host.tiles.shape[0]} tiles (generated, written, read "
          f"and built in {gen_s:.1f} s on the host)", flush=True)
    hand = handmade_graph(gen, sizes.hub, sizes.chunk).to(dev)
    e2, e3, e1, hand_att = check_kernels(hand, "hand-made", check, gen, dev,
                                         timer)
    print(f"[3/14] hand-made rows (empty, one edge, hub of {sizes.hub}, "
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
    print(f"[3/14] row split (chunk {CHUNK} edges), once per CSR at "
          f"start-up: " + "; ".join(lines), flush=True)
    times = Times()
    e2, e3, e1, att = check_kernels(g, "yelp2018", check, gen, dev, timer,
                                    times)
    print(f"[3/14] yelp2018 shapes: max abs err sddmm {k2_errs(e2)}, softmax "
          f"{e3:.2e}, spmm {', '.join(f'{e:.2e}' for e in e1)} "
          f"(d64, d32, d64 bf16)", flush=True)
    for name in ("spmm_csr", "sddmm_transr", "segment_softmax_csr"):
        print(f"[3/14] time per {'forward' if name == 'spmm_csr' else 'call'}"
              f" ({smi_line}): {times.line(name)}", flush=True)
    fma_ms = g.n_edges * 4 * 64 * 64 / F32_FLOPS * 1e3
    print(f"[3/14] sddmm_transr's bound on the float32 FMA units, for the "
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
    print(f"[4/14] serving CLI: {len(lines)} users x top-{TOP_K} valid in "
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
    print(f"[4/14] kernel path vs plain path on the card: all_embed max abs "
          f"err {err:.2e}; top-{TOP_K} scores within rtol {RTOL}; item sets "
          f"equal for {int(clear.sum())}/{len(users)} users with a "
          f"20th/21st gap > 1e-4, same order for {int(ordered.sum())} with "
          f"every gap > 1e-4; CLI lists in the same order for "
          f"{same_order}/{len(users)} users; a second kernel forward is "
          f"{'bit-identical' if repeat else 'NOT bit-identical'}", flush=True)
    print(f"[4/14] forward {fwd_ms:.2f} ms (plain path {fwd_plain_ms:.2f} "
          f"ms); serve {len(users)} users top-{TOP_K} from the cached "
          f"forward {serve_ms:.2f} ms ({smi_line})", flush=True)
    del emb_k, emb_p, server

    # --- 5. backward kernels against float64 plain versions ---------------
    progress.phase(5, "backward kernels against float64 plain versions")
    for label, graph, w, t in (("hand-made", hand, hand_att, None),
                               ("yelp2018", g, att, times)):
        shares, k4_errs = check_backward_kernels(graph, w, label, check,
                                                 gen, dev, timer, t)
        print(f"[5/14] {label}: max abs err, and the bound where the error "
              f"is largest against it: "
              + ", ".join(f"{k} {e:.2e} (bound {b:.2e}, {s:.3f} of it)"
                          for k, (e, b, s) in shares.items())
              + f"; K4 against float64 {k4_errs}; second calls "
              f"bit-identical", flush=True)
    for name in ("spmm_csr_rev", "sddmm_transr_bwd",
                 "segment_softmax_csr_bwd"):
        per = "per CF-step backward (d = 64, 64, 32)" if name == \
            "spmm_csr_rev" else "per call"
        print(f"[5/14] {per} ({smi_line}): {times.line(name)}", flush=True)
    row_gb = 4 * g.n_edges * 64 * 4 / 1e9
    print(f"[5/14] sddmm_transr_bwd: {times.per_call['sddmm_transr_bwd']} "
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
    print(f"[5/14] attention gradient through compute_attention, kernel path "
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
    print(f"[6/14] trainer built in {build_s:.1f} s ({trainer.n_cf_batches} "
          f"CF and {trainer.n_kg_batches} KG batches an epoch); "
          + train_stats, flush=True)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- 7. the trainer CLI, then serving its checkpoint -------------------
    progress.phase(7, "trainer CLI for one epoch, then serving its "
                      "best checkpoint")
    log_dir = os.path.join(tmp, "runs")
    argv = ["--dataset", "yelp2018", "--data-root", tmp, "--epochs", "1",
            "--eval-every", "1", "--device", str(dev), "--log-dir", log_dir,
            "--run-name", "smoke", "--seed", "0", "--cf-batch-size",
            str(sizes.cf_batch), "--kg-batch-size", str(sizes.kg_batch)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    # What train.main runs, keeping the trainer for its graphs.
    cli = train.Trainer(train.parse_args(argv))
    cli.train()
    timer.sync()
    cli_s = time.perf_counter() - t0
    main_launches, graph_nodes = replayed_launches(
        dict(build.launch_counts), (cli.cf_steps, cli.kg_steps),
        single_device_nodes(cli.graph, cli._step_att))
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    # The CLI returns nothing: its trainer, graphs and their memory pools
    # go before the phases after it, as main's would.
    del cli
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with open(os.path.join(log_dir, "smoke.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    check_events(events)
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    n_cf = next(e for e in events if e["event"] == "start")["cf_batches"]
    # Per CF step: K1 three times forward, three times on the reverse CSR
    # (captured once, replayed); K2 and K3 once per attention recompute
    # (epoch start and end).
    expect_launches(dev, main_launches, {
        "spmm_csr": 3 * n_cf, "spmm_csr_rev": (3 * n_cf,),
        "sddmm_transr": (2,), "segment_softmax_csr": (2,)}, "trainer CLI")
    # The same epoch of eager steps, from the same seed.
    t0 = time.perf_counter()
    eager = train.Trainer(dataclasses.replace(train.parse_args(argv),
                                              log_dir=None), dataset=ds)
    att = eager.attention()
    cf_sum = kg_sum = torch.zeros((), device=dev)
    for _ in range(eager.n_cf_batches):
        cf_sum = cf_sum + eager.cf_step(att, *eager.sample_cf())
    for _ in range(eager.n_kg_batches):
        kg_sum = kg_sum + eager.kg_step(*eager.sample_kg())
    eager_losses = (float(cf_sum) / eager.n_cf_batches,
                    float(kg_sum) / eager.n_kg_batches)
    eager_s = time.perf_counter() - t0
    for key, want in zip(("cf_loss", "kg_loss"), eager_losses):
        if abs(epoch[key] - want) > 0.01 * abs(want):
            raise AssertionError(f"replayed epoch {key} {epoch[key]} vs "
                                 f"eager {want}: beyond 1%")
    del eager, att
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
    print(f"[7/14] trainer CLI: 1 epoch of replayed steps in "
          f"{epoch['secs']:.1f} s ({cli_s:.1f} s with data load, build, "
          f"eval and checkpoints), cf_loss {epoch['cf_loss']:.4f}, kg_loss "
          f"{epoch['kg_loss']:.4f} (eager steps from the same seed: "
          f"{eager_losses[0]:.4f}, {eager_losses[1]:.4f}, in {eager_s:.1f} "
          f"s with the trainer's build), recall@20 {ev['recall']:.4f}, "
          f"ndcg@20 {ev['ndcg']:.4f}; events {[e['event'] for e in events]};"
          f" served {len(lines)} users top-{TOP_K} from smoke_best; "
          f"launches {main_launches}; CUDA kernel nodes per replayed step "
          f"{graph_nodes}; peak device memory {peak_gb:.2f} GB "
          f"({smi_line})", flush=True)

    # --- 8. the edge-partitioned trainer, P = 4 on the card -----------------
    progress.phase(8, f"edge-partitioned trainer, {P_PARTS} partitions on "
                      f"the card")
    part_launches, ring_losses = phase_partitioned(
        tmp, ds, g_host, g, meta, sizes, check, times, gen, dev, timer,
        smi_line)

    # --- 9. the rest of the trainer -----------------------------------------
    progress.phase(9, "the rest of the trainer: resume, pretrain, sparse "
                      "Adam, host samplers")
    phase_rest(tmp, ds, argv, check, dev, timer, smi_line)

    # --- 10. one process per card --------------------------------------------
    progress.phase(10, "one process per card")
    across = phase_processes(tmp, ds, sizes, dev, timer, smi_line,
                             ring_losses)

    # --- 11. the graph cache, the op surface and explain --------------------
    progress.phase(11, "the graph cache, DGL's op surface and the explain "
                       "CLI")
    gspmm_launches = phase_modules(tmp, ds, g_host, g, meta, users, check,
                                   gen, dev, timer, smi_line)

    # --- 12. the native host loaders and a bf16 trainer epoch --------------
    progress.phase(12, "the native host loaders and a bf16 trainer epoch")
    phase_native(tmp, ds, g_host, meta, sizes, dev, timer, smi_line)

    # --- 13. coalescing, the bf16 staging and the dense route ---------------
    progress.phase(13, "multi-edge coalescing, its replayed steps and the "
                       "dense attention route")
    coalesced_k1 = phase_coalesced(ds, g_host, g, sizes, check, gen, dev,
                                   timer, smi_line)
    del g

    # --- 14. the port's bench ----------------------------------------------
    progress.phase(14, "the port's bench (python -m kgat_tpu_torch.bench)")
    bench_launches = phase_bench(tmp, sizes, dev, smi_line)
    progress.end()

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
                     "cuda_launches_per_call": times.per_call[name],
                     **across.get(name, {}),
                     **({"gspmm_launches": gspmm_launches.get(name, 0)}
                        if name.startswith("spmm_csr") else {}),
                     # K1 on the coalesced CSRs (phase 13).
                     **coalesced_k1.get(name, {}),
                     # Launches on the bench's path (phase 14).
                     "bench_launches": bench_launches.get(name, 0),
                     **({} if r["replay_ms"] is None
                        else {"replay_ms": r["replay_ms"]})})
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


def check_events(events, partitioned=False):
    """The events of a one-epoch run: kgat_tpu's keys, and in the
    partitioned trainer's epoch events whether its steps were captured
    and why."""
    names = [e["event"] for e in events]
    if names != ["start", "epoch", "eval", "done"]:
        raise AssertionError(f"trainer events {names}")
    for e in events:
        want = EVENT_KEYS[e["event"]] | ({"captured", "why"} if partitioned
                                         and e["event"] == "epoch" else set())
        if set(e) != want:
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


def snapshot(trainer):
    """The trainer's parameters and Adam state, copied."""
    return ([p.detach().clone() for p in trainer.model.parameters()],
            [{k: v.clone() for k, v in trainer.opt.state[p].items()}
             for p in trainer.model.parameters()])


def restore(trainer, snap):
    """Copies a :func:`snapshot` back in place (a captured step reads the
    tensors it found at its capture)."""
    with torch.no_grad():
        for p, v, st in zip(trainer.model.parameters(), *snap):
            p.copy_(v)
            for k, t in st.items():
                trainer.opt.state[p][k].copy_(t)


def replayed_step(steps):
    """One step of a StepGraph and its loss: a replay of its graph on the
    card (captured before), its body on the CPU, which cannot capture."""
    return float(steps.run(1))


def phase_train_steps(trainer, sizes, check, timer, dev) -> str:
    """The first CF and KG steps, eager on the kernel path and replayed
    from their CUDA graphs, each against the plain path in float64 on the
    batch and dropout masks the replay drew; two replays draw different
    batches; more steps on a fixed batch, a recompute and an evaluate();
    returns the summary line."""
    model, mcfg = trainer.model, trainer.cfg.model
    plain = dataclasses.replace(mcfg, ops_backend="ref")
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    # The longest reduction of a gradient: a CSR row, or every node for a
    # layer weight.
    g = trainer.graph
    length = max(int((g.row_offsets[1:] - g.row_offsets[:-1]).max()),
                 g.n_nodes)

    # Capture both steps (each capture runs one real step first, its
    # warm-up), then stage the attention of the parameters they left.
    trainer.stage(trainer.attention())
    if dev.type == "cuda":
        trainer.cf_steps.capture()
        trainer.kg_steps.capture()
    att = trainer.attention()
    trainer.stage(att)

    def cf_plain(batch, masks):
        return lambda m: kgat.cf_loss(
            m, g, kgat.attention_for_training(m, g, plain), trainer.meta,
            *batch[:3], plain, masks=masks, train=True, weight=batch[3])

    # The first CF step replayed, then eagerly from the same state on the
    # batch and masks the replay drew; both against the plain path.
    errs = {}
    for what, steps in (("CF", trainer.cf_steps), ("KG", trainer.kg_steps)):
        before = snapshot(trainer)
        loss_r = replayed_step(steps)
        grads_r = _grads(params)
        restore(trainer, before)
        if what == "CF":
            *batch, masks = trainer.cf_drawn
            loss_k = float(trainer.cf_grad(att, *batch, masks=masks))
            plain_loss = cf_plain(batch, masks)
        else:
            batch = trainer.kg_drawn
            loss_k = float(trainer.kg_grad(*batch))
            plain_loss = lambda m, b=batch: kgat.kg_loss(  # noqa: E731
                m, *b[:4], plain, weight=b[4])
        loss_p, grads_p, terms = plain_grads(model, plain_loss)
        errs[what] = compare_step(what, loss_k, loss_p, names,
                                  _grads(params), grads_p, terms, check,
                                  length)
        errs[f"{what} replayed"] = compare_step(
            f"{what} replayed", loss_r, loss_p, names, grads_r, grads_p,
            terms, check, length)
        trainer.opt.step()
        del grads_p, grads_r, terms

    # Two replays in a row draw different batches and masks.
    drawn = []
    for _ in range(2):
        replayed_step(trainer.cf_steps)
        replayed_step(trainer.kg_steps)
        u, _, _, _, masks = trainer.cf_drawn
        drawn.append([t.clone() for t in (u, *masks, trainer.kg_drawn[0])])
    if any(torch.equal(a, b) for a, b in zip(*drawn)):
        raise AssertionError("two replays drew the same batch or masks")

    # More steps on one fixed batch and dropout mask: the loss on it falls.
    att = trainer.attention()
    cf_batch = trainer.sample_cf()
    masks = kgat.dropout_masks(mcfg, trainer.meta.n_nodes, trainer.generator,
                               dev)
    kg_batch = trainer.sample_kg()
    build.launch_counts.clear()
    cf_losses = [float(trainer.cf_step(att, *cf_batch, masks=masks))
                 for _ in range(sizes.steps)]
    cf_losses.append(float(trainer.cf_grad(att, *cf_batch, masks=masks)))
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
    trainer.stage(att)
    cf_replay_ms = timer.host_ms(lambda: replayed_step(trainer.cf_steps), 10)

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
    kg_replay_ms = timer.host_ms(lambda: replayed_step(trainer.kg_steps), 20)
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
    return (f"first CF step, kernel path vs float64 plain path: eager "
            f"{errs['CF']}; replayed {errs['CF replayed']}; first KG step: "
            f"eager {errs['KG']}; replayed {errs['KG replayed']}; two "
            f"replays drew different batches and masks; {sizes.steps} CF "
            f"steps on a fixed batch, loss "
            f"{cf_losses[0]:.5f} -> {cf_losses[-1]:.5f}, launches "
            f"{step_launches}; {sizes.steps} KG steps, loss "
            f"{kg_losses[0]:.5f} -> {kg_losses[-1]:.5f}; CF step (sample + "
            f"step) median {cf_ms:.2f} ms eager, {cf_replay_ms:.2f} ms "
            f"replayed (plain path {cf_plain_ms:.2f} ms), KG step "
            f"{kg_ms:.2f} ms eager, {kg_replay_ms:.2f} ms replayed, "
            f"attention recompute {att_ms:.2f} ms (launches "
            f"{recompute_launches}), evaluate {eval_s:.2f} s: recall@20 "
            f"{metrics['recall']:.4f}, ndcg@20 {metrics['ndcg']:.4f}")


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

# (exchange, transport, dp rows): phase 8's meshes, each of P_PARTS
# partitions in all, D rows of P_PARTS / D.
MESHES = (("allgather", "ppermute", 1), ("ring", "ppermute", 1),
          ("ring", "dma", 1), ("ring", "fused", 1), ("a2a", "ppermute", 1),
          ("ring", "fused", 2))


def mesh_label(key):
    ex, tr, rows = key
    name = ex if ex != "ring" else f"ring/{tr}"
    return name if rows == 1 else f"{name} on a ({rows}, {P_PARTS // rows}) mesh"


def partitioned_launches(exchange, transport, n_layers, n_parts,
                         backward=True, rows=1):
    """The launches one forward (and its backward) of an exchange makes,
    each wrapper launching once per partition and ring step: K1 per
    shard (a2a: per halo CSR) and layer on the all-gather (K1 on the
    reverse CSR backward); on the ring a bucket reduce per partition,
    step and layer, K6 or, at the P - 1 steps that send under 'fused',
    K8; the sends of the P - 1 steps by K7 under 'dma'; backward, K6 on
    every bucket's reverse CSR and (under 'dma' and 'fused') K7 the other
    way at every send. Each of ``rows`` dp rows does all of it."""
    L, P = n_layers, n_parts
    sends = L * P * (P - 1)
    if exchange in ("allgather", "a2a"):
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
        return {k: rows * n for k, n in fwd.items()}
    return {k: rows * (fwd.get(k, 0) + bwd.get(k, 0)) for k in {*fwd, *bwd}}


def partitioned_nodes(part, n_layers):
    """The CUDA launches of one partitioned CF step's wrapper calls, for
    the kernel nodes of its captured graph: each K1, K6 and K8 call as
    many as its CSR's row split needs (the all-gather's: each shard's
    coalesced CSRs when coalescing), each K7 call one (a KG step makes no
    wrapper call)."""
    n, P = 0, part.n_parts
    for d in range(part.n_rows):
        for p in range(P):
            if part.ring:
                for s, b in enumerate(part.buckets[d][p]):
                    n += b.split.cuda_launches + b.rev_split.cuda_launches
                    if s < P - 1:   # K7: forward under dma, backward both
                        n += {"ppermute": 0, "dma": 2,
                              "fused": 1}[part.transport]
            else:
                g = (part.halos if part.a2a else part.shards)[d][p].graph
                g = g.co if part.coalesce else g
                n += g.split.cuda_launches + g.rev_split.cuda_launches
    return lambda calls: n_layers * n if calls else 0


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


def layouts(g_host, meta, n_parts, halos=False):
    """The partitions of the yelp-scale graph on the host: shards, row
    split, ring buckets, and the selective halos with their build time."""
    src, dst = g_host.src.numpy(), g_host.dst.numpy()
    shards, info = partition_graph(src, dst, g_host.etype.numpy(),
                                   meta.n_nodes, meta.n_relations, n_parts)
    buckets = build_ring_buckets(src, dst, info)
    t0 = time.perf_counter()
    sel = build_selective_halo(shards, info) if halos else None
    return shards, info, buckets, sel, time.perf_counter() - t0


def replay_against_eager(tmp, ds, sizes, dev, timer, exchange, transport):
    """A partitioned trainer at full scale, its steps captured: one replay
    of each against the same step run eagerly from the same parameters,
    Adam state and generator states (the trainer's and every
    partition's). The loss within LOSS_RTOL, each gradient within 1e-4 of
    its largest entry (two float32 runs whose gather backwards add with
    atomics), the same batch; the kernel nodes of each graph against its
    captured calls. Returns the summary."""
    L = 3
    tr = train.Trainer(TrainConfig(
        dataset="yelp2018", data_root=tmp, device=str(dev), log_dir=None,
        cf_batch_size=sizes.cf_batch, kg_batch_size=sizes.kg_batch, seed=0,
        n_devices=P_PARTS, halo_exchange=exchange,
        ring_transport=transport), dataset=ds)
    if tr.captured != (dev.type == "cuda"):
        raise AssertionError(f"{exchange}/{transport}: captured "
                             f"{tr.captured} ({tr.capture_why})")
    tr.stage(tr.attention())
    build.launch_counts.clear()
    for steps in (tr.cf_steps, tr.kg_steps):
        steps.run(1)            # the warm-up step, then the capture
    if dev.type == "cuda" and tr.cf_steps.calls != partitioned_launches(
            exchange, transport, L, P_PARTS):
        raise AssertionError(f"{exchange}/{transport}: captured calls "
                             f"{tr.cf_steps.calls}")
    params = list(tr.model.parameters())
    out, losses = [], []
    for name, steps, body, drawn in (
            ("CF", tr.cf_steps, tr._cf_body, "cf_drawn"),
            ("KG", tr.kg_steps, tr._kg_body, "kg_drawn")):
        snap = snapshot(tr)
        states = [g.get_state() for g in steps.generators]
        loss_r = replayed_step(steps)
        batch = [t.clone() for t in getattr(tr, drawn)[:4]]
        grads_r = _grads(params)
        restore(tr, snap)
        for g, st in zip(steps.generators, states):
            g.set_state(st)
        loss_e = float(body())
        timer.sync()
        if not all(torch.equal(a, b)
                   for a, b in zip(batch, getattr(tr, drawn)[:4])):
            raise AssertionError(f"{exchange}/{transport} {name}: the "
                                 f"replay and the eager step drew "
                                 f"different batches")
        if abs(loss_r - loss_e) > LOSS_RTOL * abs(loss_e):
            raise AssertionError(f"{exchange}/{transport} {name} loss: "
                                 f"replayed {loss_r}, eager {loss_e}")
        worst = 0.0
        for (pname, p), gr in zip(tr.model.named_parameters(), grads_r):
            scale = float(p.grad.abs().max())
            err = float((gr - p.grad).abs().max())
            if err > 1e-4 * scale:
                raise AssertionError(f"{exchange}/{transport} {name} "
                                     f"{pname}: replayed against eager "
                                     f"{err:.3e}, largest entry "
                                     f"{scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        out.append(f"{name} loss {loss_r:.6f} (eager {loss_e:.6f}), "
                   f"gradients within {worst:.2e} of their largest entry")
        losses.append(loss_r)
    _, nodes = replayed_launches(dict(build.launch_counts),
                                 (tr.cf_steps, tr.kg_steps),
                                 partitioned_nodes(tr.part, L))
    calls = dict(tr.cf_steps.calls)
    why = tr.capture_why
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return (f"{exchange}/{transport} ({why}): " + "; ".join(out)
            + f"; CUDA kernel nodes per graph (all, the port's, replays) "
            f"{nodes} for the CF graph's captured calls {calls}"), losses


def phase_partitioned(tmp, ds, g_host, g, meta, sizes, check, times, gen,
                      dev, timer, smi_line):
    """Phase 8; returns the launch counts of the partitioned CLI epoch."""
    P, L = P_PARTS, 3
    t0 = time.perf_counter()
    shards, info, buckets, halos, halo_s = layouts(g_host, meta, P, True)
    host_s = time.perf_counter() - t0
    csrs = [ro for row in buckets for b in row
            for ro in (b.row_offsets, b.rev_row_offsets)]
    split_ms = timer.host_ms(lambda: [build_row_split(ro) for ro in csrs],
                             3) / len(csrs)
    shards = [s.to(dev) for s in shards]
    buckets = [[b.to(dev) for b in row] for row in buckets]
    halos = [h.to(dev) for h in halos]
    b_edges = [[b.n_edges for b in row] for row in buckets]
    b_launches = [[(b.split.cuda_launches, b.rev_split.cuda_launches)
                   for b in row] for row in buckets]
    print(f"[8/14] partitioned on the host in {host_s:.1f} s (row splits "
          f"of the {len(csrs)} bucket CSRs included, {split_ms:.2f} ms per "
          f"CSR): R = {info.rows_per_part}, n_pad = {info.n_nodes_pad}, "
          f"shard edges {[s.n_edges for s in shards]}, ring bucket edges "
          f"per (p, s) {b_edges}, CUDA launches per K6/K8 call by the "
          f"splits (forward, reverse) {b_launches}", flush=True)
    H, T, R = halos[0].halo_rows, halos[0].table_rows, info.rows_per_part
    d0 = KGATConfig().embed_dim
    reads = [[int((h.local_ids[R + q * H:R + (q + 1) * H]
                   < info.n_nodes_global).sum()) for q in range(P)]
             for h in halos]
    print(f"[8/14] selective halo (a2a): H = {H} rows a peer, T = {T} "
          f"table rows a partition (R + {P} H), built in {halo_s:.2f} s "
          f"on the host ({halo_s / P:.3f} s a partition; reverse CSR row "
          f"splits included); rows each partition reads of each peer "
          f"{reads}; its layer-0 table {T * d0 * 4 / 1e6:.2f} MB a partition "
          f"({P * T * d0 * 4 / 1e6:.2f} MB for {P}) against the "
          f"all-gather's replicated (n_pad, {d0}) "
          f"{info.n_nodes_pad * d0 * 4 / 1e6:.2f} MB a partition "
          f"({P * info.n_nodes_pad * d0 * 4 / 1e6:.2f} MB for {P}), "
          f"float32", flush=True)
    summary = check_ring_kernels(buckets, info, sizes, check, times, gen,
                                 dev, timer)
    print(f"[8/14] ring kernels ({smi_line}): {summary}", flush=True)

    # Attention and all_embed of every mesh against the single-device
    # paths, on one random full-width model.
    cfg = KGATConfig(ops_backend="hopper", mess_dropout=(0.0,) * L)
    plain = dataclasses.replace(cfg, ops_backend="ref")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=gen, device=dev)
    half = P // 2
    sh2, info2, bk2, _, _ = layouts(g_host, meta, half)
    lay = {P: (shards, info, buckets, halos),
           half: ([s.to(dev) for s in sh2], info2,
                  [[b.to(dev) for b in row] for row in bk2], None)}
    parts = {}
    for key in MESHES:
        ex, tr, rows = key
        sh, inf, bk, hl = lay[P // rows]
        parts[key] = halo.Partitioned(
            dp.make_mesh(P // rows, dev, rows), sh, inf, meta, cfg,
            exchange=ex, ring_buckets=bk if ex == "ring" else None,
            halos=hl if ex == "a2a" else None, ring_transport=tr)
    with torch.no_grad():
        att_single = kgat.compute_attention(model, g, cfg)
        model64 = copy.deepcopy(model).double()
        want = kgat.propagate(model64, g, kgat.compute_attention(
            model64, g, plain), plain)
        del model64
    staged, lines = {}, []
    for key, part in parts.items():
        p_row = part.n_parts
        build.launch_counts.clear()
        atts, staged[key] = part.attention(model)
        att_launches = dict(build.launch_counts)
        expect_exact(dev, att_launches, {"sddmm_transr": p_row,
                                         "segment_softmax_csr": p_row},
                     f"{key} attention")
        att_err = max(check("partitioned attention", f"{key} p={p}", a,
                            att_single[s.edge_ids.to(dev)], atol=1e-6)
                      for p, (a, s) in enumerate(zip(atts, part.shards[0])))
        build.launch_counts.clear()
        got = part.propagate_eval(model, staged[key])
        timer.sync()
        fwd_launches = dict(build.launch_counts)
        expect_exact(dev, fwd_launches, partitioned_launches(
            key[0], key[1], L, p_row, backward=False), f"{key} eval forward")
        err = check("partitioned all_embed", mesh_label(key), got, want)
        ms = timer.host_ms(lambda: part.propagate_eval(model, staged[key]),
                           3)
        lines.append(f"{mesh_label(key)}: attention max abs err "
                     f"{att_err:.2e} vs single-device kernels (launches "
                     f"{att_launches}), all_embed {err:.2e} vs float64 "
                     f"plain, eval forward {ms:.2f} ms (launches "
                     f"{fwd_launches})")
    del want, att_single
    print(f"[8/14] partitioned forward against single-device ("
          f"{smi_line}): " + "; ".join(lines), flush=True)

    # The first CF step of every mesh (dropout 0): the loss against the
    # single-device kernel path's, the gradients against float64.
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
        expect_exact(dev, step_launches, partitioned_launches(
            key[0], key[1], L, part.n_parts, rows=key[2]), f"{key} CF step")
        if abs(loss_k - loss_single) > LOSS_RTOL * abs(loss_single):
            raise AssertionError(f"{key} CF loss {loss_k} vs single-device "
                                 f"kernel path {loss_single}")
        errs = compare_step(f"CF {mesh_label(key)}", loss_k, loss_p, names,
                            grads_k, grads_p, terms, check, length)
        del grads_k
        ms = timer.host_ms(lambda: cf_grads(part, staged[key]), 3)
        lines.append(f"{mesh_label(key)}: {errs}; forward + backward "
                     f"{ms:.2f} ms (launches {step_launches})")
    del grads_p, terms
    print(f"[8/14] first CF step (batch {u.numel()}, dropout 0) against the "
          f"single-device kernel path ({loss_single:.6f}) and the float64 "
          f"plain path ({smi_line}): " + "; ".join(lines), flush=True)

    # The KG step: the same TransR step on the global batch for every
    # mesh (the data-parallel loss in one process).
    src, dst = g_host.src.numpy(), g_host.dst.numpy()
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
    print(f"[8/14] KG step (batch {kg_batch[0].numel()}) against the float64 "
          f"plain path: {kg_errs}", flush=True)
    del grads_p, terms, kg_grads, parts, staged, model, lay, halos
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Captured partitioned steps against eager ones: the preset's
    # exchange, and a2a.
    for ex, tr in (("ring", "fused"), ("a2a", "ppermute")):
        line, losses = replay_against_eager(tmp, ds, sizes, dev, timer, ex,
                                            tr)
        if ex == "ring":
            ring_losses = losses[:2]
        print(f"[8/14] replayed partitioned steps against eager steps from "
              f"the same generator states ({smi_line}): {line}", flush=True)

    # The trainer CLI, one epoch, ring exchange with the fused transport:
    # replayed steps on the one card.
    log_dir = os.path.join(tmp, "runs_partitioned")
    argv = ["--dataset", "yelp2018", "--data-root", tmp, "--epochs", "1",
            "--eval-every", "1", "--device", str(dev), "--log-dir", log_dir,
            "--run-name", "part", "--seed", "0", "--cf-batch-size",
            str(sizes.cf_batch), "--kg-batch-size", str(sizes.kg_batch),
            "--n-devices", str(P), "--halo-exchange", "ring",
            "--ring-transport", "fused"]
    build.launch_counts.clear()
    t0 = time.perf_counter()
    # What train.main runs, keeping the trainer for its graphs.
    cli = train.Trainer(train.parse_args(argv))
    cli.train()
    timer.sync()
    cli_s = time.perf_counter() - t0
    launches, graph_nodes = replayed_launches(
        dict(build.launch_counts), (cli.cf_steps, cli.kg_steps),
        partitioned_nodes(cli.part, L))
    del cli
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with open(os.path.join(log_dir, "part.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    check_events(events, partitioned=True)
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    if epoch["captured"] != (dev.type == "cuda"):
        raise AssertionError(f"partitioned CLI epoch: {epoch}")
    n_cf = next(e for e in events if e["event"] == "start")["cf_batches"]
    step = partitioned_launches("ring", "fused", L, P)
    evalf = partitioned_launches("ring", "fused", L, P, backward=False)
    # Per CF step a forward and backward; the eval forward once; K2 and K3
    # on every shard at the epoch's two attention recomputes.
    want_launches = {k: n_cf * step.get(k, 0) + evalf.get(k, 0)
                     for k in {*step, *evalf}}
    want_launches.update(sddmm_transr=2 * P, segment_softmax_csr=2 * P)
    expect_exact(dev, launches, want_launches, "partitioned trainer CLI")
    print(f"[8/14] partitioned trainer CLI (python -m kgat_tpu_torch.train "
          f"{' '.join(argv[argv.index('--n-devices'):])}): 1 epoch of "
          f"{'replayed' if epoch['captured'] else 'eager'} steps "
          f"({epoch['why']}) in "
          f"{epoch['secs']:.1f} s ({cli_s:.1f} s with data load, partition, "
          f"eval and checkpoints), cf_loss {epoch['cf_loss']:.4f}, kg_loss "
          f"{epoch['kg_loss']:.4f}, recall@20 {ev['recall']:.4f}, ndcg@20 "
          f"{ev['ndcg']:.4f}; events {[e['event'] for e in events]}; "
          f"launches {launches} ({n_cf} CF steps; predicted per step "
          f"{step}); CUDA kernel nodes per replayed step {graph_nodes} "
          f"({smi_line})", flush=True)
    return launches, ring_losses


# ---------------------------------------------------------------------------
# Phase 9: the rest of the single-device trainer.
# ---------------------------------------------------------------------------

def phase_rest(tmp, ds, argv, check, dev, timer, smi_line) -> None:
    """Phase 9 at phase 7's scale and width: ``--resume`` of phase 7's
    run for a second epoch; the BPR-MF CLI for one epoch, then a trainer
    epoch from its npz; a replayed ``--sparse-adam`` epoch whose first KG
    step is held against the float64 dense-state oracle; host-sampled
    steps."""
    log_dir = argv[argv.index("--log-dir") + 1]
    epochs = argv.index("--epochs") + 1

    def with_flags(run, *flags, n_epochs=1):
        a = list(argv)
        a[epochs] = str(n_epochs)
        a[a.index("--run-name") + 1] = run
        return [*a, *flags]

    # Resume phase 7's run for a second epoch.
    last = os.path.join(log_dir, "smoke_best_last")
    count = load_checkpoint(last)["count"]
    t0 = time.perf_counter()
    tr = train.Trainer(train.parse_args(with_flags("smoke", "--resume",
                                                   n_epochs=2)))
    tr.train()
    resume_s = time.perf_counter() - t0
    steps = tr.n_cf_batches + tr.n_kg_batches
    with open(os.path.join(log_dir, "smoke.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    names = [e["event"] for e in events]
    resumed = events[names.index("resume")]
    after = optim.adam_count(tr.opt)
    if (names[-5:] != ["resume", "start", "epoch", "eval", "done"]
            or resumed["epoch"] != 1 or events[-3]["epoch"] != 2
            or count != steps or after != 2 * steps
            or load_checkpoint(last)["count"] != 2 * steps):
        raise AssertionError(f"resume: events {names}, resume {resumed}, "
                             f"count {count} then {after} for {steps} "
                             f"steps an epoch")
    resume_line = (f"--resume: from {os.path.basename(resumed['source'])} "
                   f"at epoch 1, Adam count {count} restored, epoch 2 in "
                   f"{events[-3]['secs']:.1f} s ({resume_s:.1f} s in all), "
                   f"cf_loss {events[-3]['cf_loss']:.4f}, kg_loss "
                   f"{events[-3]['kg_loss']:.4f}")
    del tr

    # BPR-MF for one epoch, then a trainer epoch from its npz.
    npz = os.path.join(tmp, "mf.npz")
    data = argv[argv.index("--data-root") + 1]
    t0 = time.perf_counter()
    if bprmf.main(["--dataset", "yelp2018", "--data-root", data, "--out",
                   npz, "--epochs", "1", "--seed", "0", "--device",
                   str(dev)]) != 0:
        raise AssertionError("the BPR-MF CLI failed")
    mf_s = time.perf_counter() - t0
    with np.load(npz) as z:
        ue, ie = (torch.as_tensor(z[k]) for k in ("user_embed",
                                                   "item_embed"))
    tr = train.Trainer(train.parse_args(with_flags("pretrain",
                                                   "--use-pretrain", npz)))
    emb = tr.model.entity_embed.detach().cpu()
    n_ent = tr.meta.n_entities
    if (ue.shape != (ds.n_users, 64) or ie.shape != (ds.n_items, 64)
            or not torch.equal(emb[:ds.n_items], ie)
            or not torch.equal(emb[n_ent:n_ent + ds.n_users], ue)):
        raise AssertionError("--use-pretrain: rows not placed")
    tr.train()
    with open(os.path.join(log_dir, "pretrain.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    ep = next(e for e in events if e["event"] == "epoch")
    if events[0]["event"] != "pretrain" or not math.isfinite(ep["cf_loss"]):
        raise AssertionError(f"--use-pretrain events {events}")
    pretrain_line = (f"BPR-MF CLI 1 epoch in {mf_s:.1f} s ({ue.shape[0]} x "
                     f"64 users, {ie.shape[0]} x 64 items); --use-pretrain "
                     f"epoch in {ep['secs']:.1f} s, cf_loss "
                     f"{ep['cf_loss']:.4f}, kg_loss {ep['kg_loss']:.4f}")
    del tr, emb

    # --sparse-adam: the first replayed KG step against the float64
    # oracle, then a replayed epoch.
    tr = train.Trainer(train.parse_args(with_flags("sparse",
                                                   "--sparse-adam")))
    tr.stage(tr.attention())
    if dev.type == "cuda":
        tr.kg_steps.capture()
    before = snapshot(tr)
    loss = replayed_step(tr.kg_steps)
    batch = [t.clone() for t in tr.kg_drawn]
    after = snapshot(tr)
    restore(tr, before)
    sparse_line = check_sparse_step(tr, before, after, loss, batch, check)
    restore(tr, after)
    tr.train()
    with open(os.path.join(log_dir, "sparse.jsonl")) as f:
        ep = next(e for e in map(json.loads, f) if e["event"] == "epoch")
    if not (math.isfinite(ep["cf_loss"]) and math.isfinite(ep["kg_loss"])):
        raise AssertionError(f"--sparse-adam epoch {ep}")
    sparse_line += (f"; replayed epoch in {ep['secs']:.1f} s, cf_loss "
                    f"{ep['cf_loss']:.4f}, kg_loss {ep['kg_loss']:.4f}")
    del tr, before, after

    # Host-sampled steps, the batch counts cut in the trainer object.
    t0 = time.perf_counter()
    tr = train.Trainer(dataclasses.replace(
        train.parse_args(argv), sampler="host", log_dir=None), dataset=ds)
    build_s = time.perf_counter() - t0
    tr.n_cf_batches = tr.n_kg_batches = 3
    t0 = time.perf_counter()
    cf, kg = tr.train_one_epoch()
    host_s = time.perf_counter() - t0
    if not (math.isfinite(cf) and math.isfinite(kg)):
        raise AssertionError(f"host-sampled losses {cf}, {kg}")
    print(f"[9/14] {resume_line}; {pretrain_line}; {sparse_line}; "
          f"--sampler host: trainer with the host samplers built in "
          f"{build_s:.1f} s, 3 CF and 3 KG steps (and a recompute) in "
          f"{host_s:.2f} s, cf_loss {cf:.4f}, kg_loss {kg:.4f} ({smi_line})",
          flush=True)


def correction_error(b: float, t: float) -> float:
    """The relative error of Adam's bias correction 1 - b^t in float32:
    b and b^t each rounded (b^t's error grows with t), then a difference
    that cancels where b^t is near 1 (b2 = 0.999 at small t)."""
    return b ** t * (t + 2) * U / (1 - b ** t) + U


def check_sparse_step(tr, before, after, loss, batch, check) -> str:
    """The lazy KG step (``after`` from ``before`` on ``batch``) against
    ``sparse_kg_step_plain`` in float64: the loss to LOSS_RTOL; the
    touched rows' moments (and the relation tables') under stat_bound,
    the longest reduction being the relation width times the most
    repeats of an id; the parameters against the update recomputed in
    float64 from the step's own moments, within 4 roundings; untouched
    rows and the conv weights (values and moments) bit-equal to before;
    every step count advanced by one."""
    loss64, want, touched = optim.sparse_kg_step_plain(
        tr.model, tr.opt, *batch[:4], tr.cfg.model, batch[4])
    if abs(loss - loss64) > LOSS_RTOL * abs(loss64):
        raise AssertionError(f"sparse KG step loss {loss} vs {loss64}")
    lr, (b1, b2), eps = (tr.opt.param_groups[0][k]
                         for k in ("lr", "betas", "eps"))
    count = float(before[1][0]["step"]) + 1
    repeats = int(torch.unique(torch.cat([batch[0], batch[2], batch[3]]),
                               return_counts=True)[1].max())
    length = tr.cfg.model.relation_dim * repeats
    rows = torch.as_tensor(touched, device=batch[0].device)
    idx = {n: i for i, (n, _) in enumerate(tr.model.named_parameters())}
    shares = []
    for name, (p64, m64, v64) in want.items():
        i = idx[name]
        sel = rows if name == "entity_embed" else slice(None)
        p, st, p0 = after[0][i], after[1][i], before[0][i]
        m, v = st["exp_avg"], st["exp_avg_sq"]
        for label, got, ref in (("exp_avg", m, m64), ("exp_avg_sq", v, v64)):
            shares.append(check.bounded("sparse KG step", f"{name} {label}",
                                        got[sel], ref[sel],
                                        stat_bound(ref[sel], length))[2])
        ratio = ((m[sel].double() / (1 - b1 ** count))
                 / ((v[sel].double() / (1 - b2 ** count)).sqrt() + eps))
        expect = p0[sel].double() - lr * ratio
        shares.append(check.bounded(
            "sparse KG step", f"{name} update", p[sel], expect,
            lr * ratio.abs() * (8 * U + correction_error(b1, count)
                                + correction_error(b2, count))
            + 2 * U * expect.abs())[2])
    keep = torch.ones(want["entity_embed"][0].shape[0], dtype=torch.bool,
                      device=batch[0].device)
    keep[rows] = False
    i = idx["entity_embed"]
    frozen = [(after[0][i][keep], before[0][i][keep])] + [
        (after[1][i][k][keep], before[1][i][k][keep])
        for k in ("exp_avg", "exp_avg_sq")]
    for n, j in idx.items():
        if n.startswith("layers."):
            frozen += [(after[0][j], before[0][j])] + [
                (after[1][j][k], before[1][j][k])
                for k in ("exp_avg", "exp_avg_sq")]
    if not all(torch.equal(a, b) for a, b in frozen):
        raise AssertionError("the sparse KG step moved an untouched row or "
                             "a conv weight")
    if {float(st["step"]) for st in after[1]} != {count}:
        raise AssertionError("the sparse KG step did not advance every "
                             "step count")
    return (f"--sparse-adam: first replayed KG step (batch "
            f"{batch[0].numel()}, {len(touched)} rows touched, up to "
            f"{repeats} repeats of an id) against the float64 oracle: loss "
            f"{loss:.6f} vs {loss64:.6f}, moments and update within "
            f"{max(shares):.3f} of their bounds; untouched rows and the "
            f"conv weights unmoved, every step count + 1")



# ---------------------------------------------------------------------------
# Phase 10: one process per card.
# ---------------------------------------------------------------------------

# The exchanges phase 10 runs across processes.
PROCESS_MESHES = (("allgather", "ppermute"), ("ring", "dma"),
                  ("ring", "fused"), ("a2a", "ppermute"))
PROCESS_LIMIT = 420          # seconds, for one group of worker processes


def device_busy_ms(fn, reps: int):
    """Device milliseconds per call of ``fn`` summed over the kernels,
    copies and fills that ``torch.profiler`` traced on the card (each
    event's own device time, not its children's; None where the trace
    holds no device time), and by kernel: name -> (ms, launches) per
    call."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = {e.key: (float(getattr(e, "self_device_time_total", 0.0))
                       / 1e3 / reps, e.count / reps)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host}
    busy = sum(ms for ms, _ in kernels.values())
    return (busy if busy > 0 else None), kernels


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def process_cfg(tmp, sizes, dev, n_parts, exchange, transport):
    """Phase 10's trainer: yelp2018 scale at full width, dropout 0."""
    return TrainConfig(
        dataset="yelp2018", data_root=tmp, device=dev.type, log_dir=None,
        cf_batch_size=sizes.cf_batch, kg_batch_size=sizes.kg_batch, seed=0,
        n_devices=n_parts, halo_exchange=exchange, ring_transport=transport,
        model=KGATConfig(ops_backend="hopper", mess_dropout=(0.0,) * 3))


def phase_processes(tmp, ds, sizes, dev, timer, smi_line, ring_losses):
    """Phase 10; returns the cross-process launches and times of K7 and
    K8 for the kernels' JSON line ({} without two cards)."""
    # A group of one rank holding P_PARTS slots: the trainer sums its
    # gradients with an all-reduce, captured inside its graphs.
    multihost.form_group(f"file://{tmp}/group_of_one", 1, 0, dev.type)
    try:
        line, losses = replay_against_eager(tmp, ds, sizes, dev, timer,
                                            "ring", "fused")
    finally:
        dist.destroy_process_group()
    for what, a, b in zip(("CF", "KG"), losses, ring_losses):
        if abs(a - b) > LOSS_RTOL * abs(b):
            raise AssertionError(f"group of one: replayed {what} loss {a} "
                                 f"vs phase 8's {b}")
    backend = multihost.backend_for(dev)
    print(f"[10/14] a process group of one rank ({backend}) holding "
          f"{P_PARTS} slots, ring/fused, the "
          f"gradient all-reduce inside the captured steps: {line}; replayed "
          f"losses against phase 8's {ring_losses[0]:.6f}, "
          f"{ring_losses[1]:.6f} ({smi_line})", flush=True)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards < 2:
        print(f"[10/14] the cross-process paths (NCCL between processes, K7 "
              f"and K8 storing into another process's buffer, one process "
              f"per card) need two or more cards, and {n_cards} is visible: "
              f"NCCL takes one rank per card", flush=True)
        return {}
    return across_processes(tmp, ds, sizes, dev, min(4, n_cards), smi_line)


def run_processes(cmds, env, limit, what) -> list:
    """Runs the commands at once, from the repository's root; returns
    their outputs. Every process is killed past ``limit`` seconds; a
    process that failed or was killed raises, with the tail of each
    output."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(cmd, cwd=here, env={**os.environ, **e},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd, e in zip(cmds, env)]
    t0, outs = time.perf_counter(), []
    try:
        for proc in procs:
            left = max(1.0, limit - (time.perf_counter() - t0))
            try:
                outs.append(proc.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                proc.kill()
                outs.append(proc.communicate()[0] + "\n<killed: time limit>")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                outs.append(proc.communicate()[0] + "\n<killed>")
    if any(proc.returncode != 0 for proc in procs):
        raise AssertionError(f"{what}: exit codes "
                             f"{[proc.returncode for proc in procs]}\n"
                             + "\n".join(f"--- process {r}:\n{o[-3000:]}"
                                         for r, o in enumerate(outs)))
    return outs


def across_processes(tmp, ds, sizes, dev, world, smi_line) -> dict:
    """Phase 10 on ``world`` worker processes, one per card (NCCL), or on
    the CPU (gloo), where tests/test_torch_chip_smoke.py rehearses it at
    a tiny size. The same workers run every exchange of
    ``PROCESS_MESHES`` in turn, one trainer after the other (each closed
    before the next); their first CF step and a KG step are held to the
    one-process engine's. Then the trainer CLI for one ring/fused epoch on
    ``world`` processes. Returns K7's and K8's cross-process launches (in
    the workers' reported replayed steps) and times."""
    # The one-process engine's first CF step (its partitions over the
    # cards, all-gathered) and a KG step, on batches the workers read: the
    # step every exchange computes (phase 8 holds the exchanges to each
    # other).
    ref_path = os.path.join(tmp, "process_refs.npz")
    tr = train.Trainer(process_cfg(tmp, sizes, dev, world, "allgather",
                                   "ppermute"), dataset=ds)
    batch = [t.cpu().numpy() for t in tr.sample_cf()]
    kg = [t.cpu().numpy() for t in tr.sample_kg()]
    refs = {f"cf_batch/{i}": t for i, t in enumerate(batch)}
    refs.update({f"kg_batch/{i}": t for i, t in enumerate(kg)})
    refs["kg_loss"] = float(tr.kg_grad(*(torch.from_numpy(t).to(dev)
                                         for t in kg)))
    refs.update({f"kg/{k}": p.grad.cpu().numpy().copy()
                 for k, p in tr.model.named_parameters()})
    refs["cf_loss"] = float(tr.cf_grad(tr.attention(), *(
        torch.from_numpy(t).to(dev) for t in batch)))
    refs.update({f"cf/{k}": p.grad.cpu().numpy().copy()
                 for k, p in tr.model.named_parameters()})
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    np.savez(ref_path, **refs)

    outs = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--process-worker",
          dev.type, str(rank), str(world), f"file://{tmp}/processes", tmp,
          str(sizes.cf_batch), str(sizes.kg_batch)]
         for rank in range(world)], [{}] * world, PROCESS_LIMIT,
        "phase 10 workers")
    results = []
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("[10/14]"):
                print(ln, flush=True)
            if ln.startswith("PROCESS_RESULT "):
                results.append(json.loads(ln[len("PROCESS_RESULT "):]))
    if len(results) != world:
        raise AssertionError(f"phase 10 workers: {len(results)} results "
                             f"from {world} processes")
    lines = []
    for exchange, transport in PROCESS_MESHES:
        name = f"{exchange}-{transport}"
        # The steps against the one-process engine's, every process alike.
        worst = 0.0
        for rank in range(world):
            with np.load(os.path.join(tmp, f"process_{name}.{rank}.npz")) \
                    as z:
                got = {k: z[k] for k in z.files}
            for key in [f"{name}/cf_loss"] + (["kg_loss"] if "kg_loss" in got
                                              else []):
                a, b = float(got[key]), float(refs[key.split("/")[-1]])
                if abs(a - b) > LOSS_RTOL * abs(b):
                    raise AssertionError(f"process {rank} {key} {a} vs the "
                                         f"one-process engine's {b}")
            for key, want in refs.items():
                mine = (f"{name}/{key}" if key.startswith("cf/") else key)
                if not (key.startswith(("cf/", "kg/")) and mine in got):
                    continue
                scale = float(np.abs(want).max())
                err = float(np.abs(got[mine] - want).max())
                if err > 1e-4 * scale:
                    raise AssertionError(f"process {rank} {mine}: {err:.3e} "
                                         f"from the one-process engine, "
                                         f"largest entry {scale:.3e}")
                worst = max(worst, err / scale if scale else 0.0)
        lines.append(f"{name}: gradients within {worst:.2e} of their "
                     f"largest entry")
    print(f"[10/14] {world} processes, one per card "
          f"({multihost.backend_for(dev)}), P = {world}, every exchange in "
          f"turn in the same processes: first CF step (batch "
          f"{len(refs['cf_batch/0'])}, dropout 0, loss {refs['cf_loss']:.6f}"
          f" on every process) and KG step (loss {refs['kg_loss']:.6f}, "
          f"batch {len(refs['kg_batch/0'])}) against the one-process "
          f"engine's: " + "; ".join(lines) + f" ({smi_line})",
          flush=True)
    if dev.type == "cuda":
        slow = {k: max(r[k] for r in results)
                for k in ("cf_wall_ms", "kg_wall_ms")}
        print(f"[10/14] replayed ring/fused steps, the slowest process: CF "
              f"{slow['cf_wall_ms']:.3f} ms, KG {slow['kg_wall_ms']:.3f} ms "
              f"(each process: CF "
              f"{[round(r['cf_wall_ms'], 3) for r in results]}, KG "
              f"{[round(r['kg_wall_ms'], 3) for r in results]}) "
              f"({smi_line})", flush=True)
    cli_processes(tmp, sizes, dev, world)
    launches = {k: sum(r["process_launches"][k] for r in results)
                for k in ("ring_shift", "reduce_send")}
    k7 = [r["k7_ms"] for r in results if r.get("k7_ms") is not None]
    k8 = [r["k8_ms"] for r in results if r.get("k8_ms") is not None]
    return {"ring_shift": {"process_launches": launches["ring_shift"],
                           "process_ms": max(k7, default=None)},
            "reduce_send": {"process_launches": launches["reduce_send"],
                            "process_ms": max(k8, default=None)}}


def cli_processes(tmp, sizes, dev, world) -> None:
    """``python -m kgat_tpu_torch.train`` on ``world`` processes (the
    environment of kgat_tpu's multi-host launch) for one ring/fused
    epoch: process 0's event log, every process's checkpoint shard."""
    log_dir = os.path.join(tmp, "runs_processes")
    argv = ["--dataset", "yelp2018", "--data-root", tmp, "--epochs", "1",
            "--eval-every", "1", "--device", dev.type, "--log-dir", log_dir,
            "--run-name", "processes", "--seed", "0", "--cf-batch-size",
            str(sizes.cf_batch), "--kg-batch-size", str(sizes.kg_batch),
            "--n-devices", str(world), "--halo-exchange", "ring",
            "--ring-transport", "fused"]
    env = [{"COORDINATOR_ADDRESS": f"file://{tmp}/processes_cli",
            "NUM_PROCESSES": str(world), "PROCESS_ID": str(rank)}
           for rank in range(world)]
    t0 = time.perf_counter()
    run_processes([[sys.executable, "-m", "kgat_tpu_torch.train", *argv]]
                  * world, env, PROCESS_LIMIT, "phase 10 trainer CLI")
    cli_s = time.perf_counter() - t0
    with open(os.path.join(log_dir, "processes.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    names = [e["event"] for e in events]
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    if not (names.count("start") == names.count("done") == 1
            and epoch["captured"] == (dev.type == "cuda")
            and epoch["processes"] == world and epoch["rank"] == 0
            and math.isfinite(epoch["cf_loss"])
            and math.isfinite(epoch["kg_loss"])):
        raise AssertionError(f"phase 10 trainer CLI: events {events}")
    shards = [os.path.join(log_dir, f"processes_best.shard{r}of{world}.npz")
              for r in range(world)]
    if not all(os.path.exists(p) for p in shards):
        raise AssertionError(f"phase 10 trainer CLI: shards {shards}")
    print(f"[10/14] trainer CLI on {world} processes (python -m "
          f"kgat_tpu_torch.train {' '.join(argv[argv.index('--n-devices'):])}"
          f", NUM_PROCESSES {world}): 1 epoch of "
          f"{'replayed' if epoch['captured'] else 'eager'} steps "
          f"({epoch['why']}) in {epoch['secs']:.1f} s ({cli_s:.1f} s with "
          f"start-up, data load, partition, eval and checkpoints), cf_loss "
          f"{epoch['cf_loss']:.4f}, kg_loss {epoch['kg_loss']:.4f}, "
          f"recall@20 {ev['recall']:.4f}; events {names}; a checkpoint "
          f"shard from every process", flush=True)


def process_worker(argv) -> int:
    """Phase 10's worker ``rank`` of ``world``, one process per card (or
    on the CPU): ``chip_smoke.py --process-worker cuda|cpu rank world url
    tmp cf_batch kg_batch``."""
    device, rank, world = argv[0], int(argv[1]), int(argv[2])
    url, tmp = argv[3], argv[4]
    sizes = dataclasses.replace(YELP_SIZES, cf_batch=int(argv[5]),
                                kg_batch=int(argv[6]))
    if device == "cpu":
        torch.set_num_threads(1)
    rec.disable_tf32()
    multihost.initialize_distributed(url, world, rank, device)
    try:
        return _process_work(rank, world, tmp, sizes,
                             multihost.process_device(device, rank))
    finally:
        dist.destroy_process_group()


def _process_work(rank, world, tmp, sizes, dev) -> int:
    """Every exchange of ``PROCESS_MESHES`` in turn, one trainer each,
    closed before the next: its first CF step on the parent's batch (and,
    under the all-gather, a KG step), saved for the parent; under
    ring/fused also K7 and K8 across processes and the replayed steps,
    printed as this process's result."""
    ds = load_dataset(tmp, "yelp2018")
    with np.load(os.path.join(tmp, "process_refs.npz")) as z:
        batch = [torch.from_numpy(z[f"cf_batch/{i}"]).to(dev)
                 for i in range(4)]
        kg = [torch.from_numpy(z[f"kg_batch/{i}"]).to(dev)
              for i in range(5)]
    out = {}
    for exchange, transport in PROCESS_MESHES:
        name = f"{exchange}-{transport}"
        tr = train.Trainer(process_cfg(tmp, sizes, dev, world, exchange,
                                       transport), dataset=ds)
        if not tr.sync or tr.captured != (dev.type == "cuda"):
            raise AssertionError(f"{name}: sync {tr.sync}, captured "
                                 f"{tr.captured} ({tr.capture_why})")
        got = {f"{name}/cf_loss": float(tr.cf_grad(tr.attention(), *batch))}
        got.update({f"{name}/cf/{k}": p.grad.cpu().numpy().copy()
                    for k, p in tr.model.named_parameters()})
        if exchange == "allgather":
            got["kg_loss"] = float(tr.kg_grad(*kg))
            got.update({f"kg/{k}": p.grad.cpu().numpy().copy()
                        for k, p in tr.model.named_parameters()})
        np.savez(os.path.join(tmp, f"process_{name}.{rank}.npz"), **got)
        if transport == "fused":
            _ring_across_processes(tr, rank, world, dev)
            out = _replayed_steps(tr, rank, world, dev)
        tr.close()
        del tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        multihost.barrier(dev)
    print("PROCESS_RESULT " + json.dumps(out), flush=True)
    return 0


def _ring_across_processes(tr, rank, world, dev) -> None:
    """K7 and K8 storing into the neighbour process's registered buffer
    on the trainer's real shapes: every received chunk bit-exact (the
    chunks drawn from a generator seeded by the sender's rank), K8's sums
    on this process's step-0 bucket within the float32 bound; each round
    ends on every process before the next stores."""
    link = tr.part.links[0]
    p = tr.part.mesh.local_parts(0)[0]
    bucket = tr.part.buckets[0][p][0]
    R, d = tr.part.info.rows_per_part, tr.cfg.model.embed_dim
    prev, nxt = (rank - 1) % world, (rank + 1) % world

    def chunk(r, k):
        g = torch.Generator().manual_seed(100 * r + k)
        return torch.randn(R, d, generator=g)

    att = torch.rand(bucket.n_edges, generator=torch.Generator().manual_seed(
        rank)).to(dev)
    vals = (chunk(rank, 50).to(dev)[bucket.src.long()] * att[:, None])
    want = ref.segment_sum_csr(bucket.row_offsets, vals.double())
    bound = sum_bound(want, ref.segment_sum_csr(
        bucket.row_offsets, vals.double().abs()),
        csr_lengths(bucket.row_offsets)[:, None])
    for k in range(3):
        got_f = link.shift((0, 0, 1), chunk(rank, k).to(dev))
        got_b = link.shift((0, 0, -1), chunk(rank, 10 + k).to(dev))
        # Layer 1's buffer (layer 0's width too): P = 2 has one ring step.
        sums, got_8 = link.reduce_send((1, 0, 1), bucket.row_offsets, vals,
                                       bucket.split, chunk(rank, 20 + k).to(
                                           dev))
        sync(dev)
        for got, want_chunk, what in ((got_f, chunk(prev, k), "K7 forward"),
                                      (got_b, chunk(nxt, 10 + k),
                                       "K7 backward"),
                                      (got_8, chunk(prev, 20 + k), "K8")):
            if not torch.equal(got.cpu(), want_chunk):
                raise AssertionError(f"process {rank}: {what} round {k}: "
                                     f"the received chunk differs")
        err = (sums.double() - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"process {rank}: K8 sums beyond the "
                                 f"float32 bound: {float(err.max()):.3e}")
        multihost.barrier(dev)
    print(f"[10/14] process {rank} on {dev}: K7 and K8 into process "
          f"{nxt}'s registered buffers (K7 backward into process {prev}'s), "
          f"3 rounds bit-exact, K8's sums on its step-0 bucket "
          f"({bucket.n_edges} edges) within the float32 bound", flush=True)


def _replayed_steps(tr, rank, world, dev) -> dict:
    """The steps captured (on the card), then 10 replayed CF and KG steps
    against 10 eager ones from the same state and generators (loss sums
    within 1e-4). Then the reported run: from a barrier, 50 replayed CF
    steps and 100 replayed KG steps, each timed on the host clock to a
    synchronize (this process's wall per step), and 5 of each traced for
    the device busy (torch.profiler) and K7's and K8's device ms a launch
    in the CF step, where each stores into the next process. The run's
    cross-process launches are the CF graph's captured cross-process calls
    times its replays in the run, checked against the graph's kernel
    nodes; no wrapper is called in the run."""
    tr.stage(tr.attention())
    if dev.type == "cuda":
        for steps in (tr.cf_steps, tr.kg_steps):
            steps.capture()
        _check_process_nodes(tr.cf_steps)
    snap = snapshot(tr)
    states = [g.get_state() for g in tr.cf_steps.generators]
    replayed = [float(tr.cf_steps.run(10)), float(tr.kg_steps.run(10))]
    restore(tr, snap)
    for g, st in zip(tr.cf_steps.generators, states):
        g.set_state(st)
    eager = []
    for body in (tr._cf_body, tr._kg_body):
        total = torch.zeros((), device=dev)
        for _ in range(10):
            total += body()
        eager.append(float(total))
    for what, a, b in zip(("CF", "KG"), replayed, eager):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError(f"process {rank}: 10 replayed {what} steps "
                                 f"{a} vs 10 eager {b}")
    res, kernels = {}, {}
    remote_ring.process_launches.clear()
    cf_replays = tr.cf_steps.replays
    for what, steps, n in (("cf", tr.cf_steps, 50), ("kg", tr.kg_steps, 100)):
        step = steps.replay if dev.type == "cuda" else steps.body
        multihost.barrier(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync(dev)
        res[f"{what}_wall_ms"] = (time.perf_counter() - t0) * 1e3 / n
        busy, per_kernel = (device_busy_ms(step, 5) if dev.type == "cuda"
                            else (None, {}))
        res[f"{what}_busy_ms"] = busy
        if what == "cf":
            kernels = per_kernel
    for name, key in (("ring_shift_kernel", "k7_ms"),
                      ("reduce_send_kernel", "k8_ms")):
        rows = [(ms, n) for k, (ms, n) in kernels.items() if name in k]
        n = sum(c for _, c in rows)
        res[key] = sum(ms for ms, _ in rows) / n if n else None
    if remote_ring.process_launches:
        raise AssertionError(f"process {rank}: a wrapper stored into another "
                             f"process in the replayed run: "
                             f"{dict(remote_ring.process_launches)}")
    replays = tr.cf_steps.replays - cf_replays
    res["process_launches"] = {
        k: tr.cf_steps.process_calls.get(k, 0) * replays
        for k in ("ring_shift", "reduce_send")}
    busy = {k: ("not measured" if res[k] is None else f"{res[k]:.3f} ms")
            for k in ("cf_busy_ms", "kg_busy_ms")}
    k78 = ("not measured" if res["k7_ms"] is None else
           f"{res['k7_ms']:.4f} and {res['k8_ms']:.4f} ms a launch")
    print(f"[10/14] process {rank} on {dev}: 10 replayed ring/fused steps "
          f"against 10 eager ones, loss sums CF {replayed[0]:.5f} "
          f"({eager[0]:.5f}), KG {replayed[1]:.5f} ({eager[1]:.5f}); "
          f"replayed CF step wall {res['cf_wall_ms']:.3f} ms (50 from a "
          f"barrier), device busy {busy['cf_busy_ms']}; KG step wall "
          f"{res['kg_wall_ms']:.3f} ms (100), device busy "
          f"{busy['kg_busy_ms']}; K7 and K8 into the next process in the "
          f"replayed CF step: {k78}; cross-process launches in {replays} "
          f"CF replays {res['process_launches']}", flush=True)
    return res


def _check_process_nodes(steps) -> None:
    """The captured CF step's kernel nodes of K7, K8 and the ring's flag
    wait against its captured calls: one node each per K7 and K8 call
    (K8's second launch, for long rows, is the fixup's), and one wait per
    call that stored into another process, every K7 and K8 call here."""
    names = graph_kernel_names(steps.graph.raw_cuda_graph())
    count = {k: sum(k in n for n in names)
             for k in ("ring_shift_kernel", "reduce_send_kernel",
                       "wait_flag_kernel")}
    want = {"ring_shift_kernel": steps.calls.get("ring_shift", 0),
            "reduce_send_kernel": steps.calls.get("reduce_send", 0),
            "wait_flag_kernel": sum(steps.process_calls.values())}
    if count != want or steps.process_calls != {
            k: steps.calls[k] for k in ("ring_shift", "reduce_send")
            if k in steps.calls}:
        raise AssertionError(f"CF step graph: kernel nodes {count}, from its "
                             f"captured calls {want} (cross-process "
                             f"{steps.process_calls} of {steps.calls})")



# ---------------------------------------------------------------------------
# Phase 11: the graph cache, DGL's op surface and the explain CLI.
# ---------------------------------------------------------------------------

def same_graph(a, b) -> bool:
    """Every field of two graphs equal: tensors bit-equal with their
    dtype, both row splits' tensors and statics, the rest by ==."""
    def same(x, y):
        if isinstance(y, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        if dataclasses.is_dataclass(y):
            return all(same(getattr(x, f.name), getattr(y, f.name))
                       for f in dataclasses.fields(y))
        return x == y
    return same(a, b)


def phase_modules(tmp, ds, g_host, g, meta, users, check, gen, dev, timer,
                  smi_line) -> dict:
    """Phase 11 at yelp2018 scale and full width: the graph cache cold and
    warm, hopper ``gspmm`` (K1) and the rest of DGL's op surface against
    the plain path, and the explain CLI on phase 7's best checkpoint.
    Returns the K1 launches of the op surface's calls."""
    # --- the graph cache: cold, then warm, against phase 3's build.
    cache = os.path.join(tmp, "graph_cache")
    t0 = time.perf_counter()
    cold = ds.build(cache_dir=cache)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm, warm_meta = ds.build(cache_dir=cache)
    warm_s = time.perf_counter() - t0
    path = ds.graph_cache_path(cache)
    if os.listdir(cache) != [os.path.basename(path)]:
        raise AssertionError(f"graph cache: {os.listdir(cache)}")
    # The cache carries the coalesced CSRs too (kgat_tpu/data.py:119-123).
    fresh = dataclasses.replace(g_host, co=build_coalesced(g_host))
    if not (same_graph(cold[0], fresh) and same_graph(warm, fresh)
            and cold[1] == warm_meta == meta):
        raise AssertionError("graph cache: a cached graph differs from a "
                             "fresh build")
    # K3, K1 and K1 on the reverse CSR on the loaded graph, against the
    # same calls on the built one: deterministic kernels, equal bits.
    w_g = warm.to(dev)
    logits = torch.randn(g.n_edges, generator=gen).to(dev)
    x = (torch.randn(g.n_nodes, 64, generator=gen) * 0.1).to(dev)
    cot = torch.randn(g.n_nodes, 64, generator=gen).to(dev)
    outs = []
    for gr in (g, w_g):
        w = segment_softmax_csr(gr.row_offsets, logits, gr.split)
        w_rev = w[gr.rev_perm.long()].contiguous()
        outs.append((w, spmm_csr(gr.row_offsets, gr.src, w, x, gr.split),
                     spmm_csr_rev(gr.rev_row_offsets, gr.rev_dst, w_rev, cot,
                                  gr.rev_split)))
    for name, a, b in zip(("segment_softmax_csr", "spmm_csr",
                           "spmm_csr_rev"), *outs):
        check_identical(f"{name} on the cached graph", a, b)
    print(f"[11/14] graph cache (--graph-cache): built and saved cold in "
          f"{cold_s:.2f} s, loaded warm in {warm_s:.2f} s, "
          f"{os.path.getsize(path)} bytes ({os.path.basename(path)}); every "
          f"array, both row splits, the coalesced CSRs ({fresh.co.n_pairs} "
          f"groups) and the meta equal to a fresh build; "
          f"K3, K1 and K1 rev on the loaded graph bit-identical to the "
          f"built graph's", flush=True)
    del w_g, outs, fresh

    # --- DGL's op surface: gspmm's sum and mean through K1.
    hop = get_backend("hopper")
    w = segment_softmax_csr(g.row_offsets, logits, g.split)
    deg = ref.in_degree(g).double()[:, None]
    x64, w64 = x.double(), w.double()
    build.launch_counts.clear()
    got = {case: hop.gspmm(g, msg, red, x, None if msg == "copy_u" else w)
           for case, (msg, red) in (("u_mul_e sum", ("u_mul_e", "sum")),
                                    ("u_mul_e mean", ("u_mul_e", "mean")),
                                    ("copy_u sum", ("copy_u", "sum")))}
    xg = x.clone().requires_grad_()
    wg = w.clone().requires_grad_()
    (hop.gspmm(g, "u_mul_e", "sum", xg, wg) * cot).sum().backward()
    launches = dict(build.launch_counts)
    expect_launches(dev, launches, {"spmm_csr": (4,), "spmm_csr_rev": (1,)},
                    "gspmm")
    one = torch.ones_like(w64)
    terms = ref.gspmm(g, "u_mul_e", "sum", x64.abs(), w64.abs())
    want = ref.gspmm(g, "u_mul_e", "sum", x64, w64)
    lines = [check.bounded("spmm_csr", "gspmm u_mul_e sum",
                           got["u_mul_e sum"], want,
                           sum_bound(want, terms, deg))]
    mean = want / deg.clamp(min=1)
    lines.append(check.bounded(
        "spmm_csr", "gspmm u_mul_e mean", got["u_mul_e mean"], mean,
        sum_bound(mean, terms / deg.clamp(min=1), deg) + U * mean.abs()))
    want = ref.gspmm(g, "u_mul_e", "sum", x64, one)
    lines.append(check.bounded(
        "spmm_csr", "gspmm copy_u sum", got["copy_u sum"], want,
        sum_bound(want, ref.gspmm(g, "u_mul_e", "sum", x64.abs(), one),
                  deg)))
    # The sum's gradients against the float64 plain path: d_x is K1 on the
    # reverse CSR, d_w the per-edge dot.
    x64g, w64g = x64.clone().requires_grad_(), w64.clone().requires_grad_()
    (ref.gspmm(g, "u_mul_e", "sum", x64g, w64g) * cot.double()).sum() \
        .backward()
    rev_len = (g.rev_row_offsets[1:] - g.rev_row_offsets[:-1]).double()[
        :, None]
    d_x_terms = spmm_csr_plain(g.rev_row_offsets, g.rev_dst,
                               w64.abs()[g.rev_perm.long()],
                               cot.double().abs())
    lines.append(check.bounded("spmm_csr_rev", "gspmm sum d_x", xg.grad,
                               x64g.grad, sum_bound(x64g.grad, d_x_terms,
                                                    rev_len)))
    d_w_terms = ref.sddmm_dot(g, x64.abs(), cot.double().abs())
    lines.append(check.bounded("gspmm d_w", "gspmm sum d_w", wg.grad,
                               w64g.grad, sum_bound(w64g.grad, d_w_terms,
                                                    64)))
    del xg, wg, x64g, w64g, d_x_terms, d_w_terms, terms, want, mean
    # max and gsddmm's dot: plain torch on the card, against the same
    # functions on CPU copies.
    mx = hop.gspmm(g, "u_mul_e", "max", x, w)
    if not torch.equal(mx.cpu(), ref.gspmm(g_host, "u_mul_e", "max", x.cpu(),
                                           w.cpu())):
        raise AssertionError("gspmm max on the card differs from the CPU's")
    dot = hop.gsddmm(g, "dot", x, cot)
    check("gsddmm", "dot on the card against the CPU", dot.cpu(),
          ref.gsddmm(g_host, "dot", x.cpu(), cot.cpu()), rtol=1e-5,
          atol=1e-6)
    del mx, dot
    gs_ms = timer.device_ms(lambda: hop.gspmm(g, "u_mul_e", "sum", x, w), 20)
    gs_plain = timer.device_ms(lambda: ref.gspmm(g, "u_mul_e", "sum", x, w),
                               5)
    csr = torch.sparse_csr_tensor(g.row_offsets, g.src, w,
                                  (g.n_nodes, g.n_nodes))
    gs_lib = timer.device_ms(lambda: torch.sparse.mm(csr, x), 5)
    print(f"[11/14] DGL op surface (hopper backend): gspmm u_mul_e sum, "
          f"u_mul_e mean and copy_u sum through K1 at d = 64, and the sum's "
          f"gradients (d_x by K1 on the reverse CSR), against float64 "
          f"plain: " + ", ".join(f"{e:.2e} ({s:.3f} of its bound)"
                                 for e, _, s in lines)
          + f"; gspmm max equal and gsddmm dot within 1e-5 of CPU copies; "
          f"launches {launches}; gspmm u_mul_e sum {gs_ms:.3f} ms, plain "
          f"{gs_plain:.3f} ms, torch.sparse.mm {gs_lib:.3f} ms "
          f"({smi_line})", flush=True)
    del x, cot, w, csr

    # --- the explain CLI on phase 7's best checkpoint.
    best = os.path.join(tmp, "runs", "smoke_best")
    params, meta_json = load_params(best)
    cfg = rec._model_cfg_from_meta(meta_json, "hopper", {})
    model = kgat.params_from_jax(params, cfg, device=dev)
    with torch.no_grad():
        att = kgat.compute_attention(model, g, cfg).cpu().numpy()
    t0 = time.perf_counter()
    index = explain.build_attention_index(g_host, att)
    index_s = time.perf_counter() - t0
    user = int(users[0])
    u_node = meta.user_node(user)
    nbr, rel, _ = index.row(u_node)
    item = int(nbr[rel == meta.rel_interact][0])   # a path exists
    top1 = int(rec.recommend(model, g, meta, cfg, [user], k=1,
                             train_user_dict=ds.train_user_dict)[0][0, 0])
    del model
    here = os.path.dirname(os.path.abspath(__file__))
    base = [sys.executable, "-m", "kgat_tpu_torch.explain", "--ckpt", best,
            "--dataset", "yelp2018", "--data-root", tmp, "--user", str(user),
            "--hops", "2", "--device", dev.type]
    runs = {}
    for what, extra in (
            ("--item, cache cold", ["--item", str(item), "--graph-cache",
                                    os.path.join(tmp, "explain_cache")]),
            ("--item, cache warm", ["--item", str(item), "--graph-cache",
                                    os.path.join(tmp, "explain_cache")]),
            ("no --item, cache warm", ["--graph-cache", cache])):
        t0 = time.perf_counter()
        proc = subprocess.run([*base, *extra], cwd=here, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"explain CLI ({what}): exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        runs[what] = (json.loads(proc.stdout.strip().splitlines()[-1]), wall)
    out = [r for r, _ in runs.values()]
    if out[0] != out[1]:
        raise AssertionError("explain CLI: cold and warm cache outputs "
                             "differ")
    if (out[0]["item"], out[2]["item"]) != (item, top1) or not out[0][
            "paths"]:
        raise AssertionError(f"explain CLI: items {out[0]['item']}, "
                             f"{out[2]['item']} (want {item}, the top "
                             f"recommendation {top1}), paths {out[0]}")
    ro = g_host.row_offsets.numpy()
    src, ety = g_host.src.numpy(), g_host.etype.numpy()
    n_hops = 0
    for res in (out[0], out[2]):
        strengths = [pth["strength"] for pth in res["paths"]]
        if strengths != sorted(strengths, reverse=True):
            raise AssertionError(f"explain CLI: strengths {strengths}")
        for pth in res["paths"]:
            prod = 1.0
            for side in ("user_side", "item_side"):
                for h in pth[side]:
                    lo, hi = ro[h["from"]], ro[h["from"] + 1]
                    e = lo + np.nonzero((src[lo:hi] == h["to"])
                                        & (ety[lo:hi] == h["rel"]))[0]
                    if len(e) != 1 or abs(h["att"] - att[e[0]]) > 1e-6:
                        raise AssertionError(
                            f"explain CLI: hop {h} is not one edge, or its "
                            f"att is not the card's ({att[e]})")
                    prod *= float(att[e[0]])
                    n_hops += 1
            if not math.isclose(pth["strength"], prod, rel_tol=1e-9):
                raise AssertionError(f"explain CLI: strength "
                                     f"{pth['strength']} != {prod}")
    print(f"[11/14] explain CLI (python -m kgat_tpu_torch.explain --hops 2, "
          f"on the card) for user {user} of phase 7's best checkpoint: "
          + "; ".join(f"{what}: item {r['item']}, {len(r['paths'])} paths "
                      f"in {wall:.1f} s" for what, (r, wall) in runs.items())
          + f"; {n_hops} hops, each an edge with the card's attention "
          f"within 1e-6, strengths descending and each the product of its "
          f"hops'; the cold and warm runs equal; attention index of "
          f"{g_host.n_edges} edges ({g_host.n_nodes} nodes, fanout 16) "
          f"built in {index_s:.2f} s on the host ({smi_line})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the native host loaders and a bf16 trainer epoch.
# ---------------------------------------------------------------------------

def host_cpu() -> str:
    """The host's CPU model: /proc/cpuinfo's model name, else lscpu's,
    else the machine's architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        for ln in out.splitlines():
            if ln.startswith("Model name:"):
                return ln.split(":", 1)[1].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"CPU model not reported ({platform.machine()})"


def load_and_build(ddir, ds, parsers, plain_index: bool) -> tuple:
    """Parse ``ddir``'s export with ``parsers`` (user-items, triples),
    deduplicate the triples and build the CKG from them, with numpy's
    sorts when ``plain_index``. Returns (train, test, triples, graph,
    meta, {stage: seconds})."""
    parse_ui, parse_kg = parsers
    t0 = time.perf_counter()
    train_ = parse_ui(os.path.join(ddir, "train.txt"))
    test = parse_ui(os.path.join(ddir, "test.txt"))
    kg = parse_kg(os.path.join(ddir, "kg_final.txt"))
    t1 = time.perf_counter()
    kg = np.unique(kg, axis=0)
    t2 = time.perf_counter()
    index = (mock.patch.multiple(native, sort_perm=native.sort_perm_plain,
                                 csr_offsets=native.csr_offsets_plain)
             if plain_index else contextlib.nullcontext())
    with index:
        g, meta = build_ckg(train_, kg, n_users=ds.n_users,
                            n_entities=ds.n_entities, n_items=ds.n_items,
                            n_relations_kg=ds.n_relations_kg)
    t3 = time.perf_counter()
    return train_, test, kg, g, meta, {"parse": t1 - t0, "unique": t2 - t1,
                                       "build": t3 - t2}


def plateau_argv(sizes, log_dir, run, dev, bf16: bool) -> list:
    """tools/campaigns.md's mid-plateau command line for one epoch (its
    --ops-backend pallas, kgat_tpu's name, selects the Hopper kernels)."""
    argv = ["--dataset", "synthetic"]
    for k, v in sizes.plateau.items():
        argv += [f"--syn-{k}", str(v)]
    argv += ["--ops-backend", "pallas", "--lr", "1e-3", "--epochs", "1",
             "--eval-every", "1", "--run-name", run, "--log-dir", log_dir,
             "--device", str(dev)]
    return argv + (["--compute-dtype", "bf16"] if bf16 else [])


def phase_native(tmp, ds, g_host, meta, sizes, dev, timer, smi_line
                 ) -> None:
    """Phase 12: phase 3's export through the native parsers and the plain
    ones, the CKG through the counting sort and numpy's argsort (all
    equal), with seconds; then one replayed bf16 CLI epoch of the
    mid-plateau recipe against a float32 epoch from the same seed."""
    ddir = os.path.join(tmp, "yelp2018")
    # The whole loader (parse, np.unique of the triples, the per-user
    # dicts), as the CLIs call it, with the native and the plain parsers.
    t0 = time.perf_counter()
    tdata.load_dataset(tmp, "yelp2018")
    load_s = time.perf_counter() - t0
    with mock.patch.multiple(
            native, parse_user_items=tdata._parse_user_items_plain,
            parse_triples=tdata._parse_triples_plain):
        t0 = time.perf_counter()
        tdata.load_dataset(tmp, "yelp2018")
        load_plain_s = time.perf_counter() - t0
    got = load_and_build(ddir, ds, (native.parse_user_items,
                                    native.parse_triples), False)
    plain = load_and_build(ddir, ds, (tdata._parse_user_items_plain,
                                      tdata._parse_triples_plain), True)
    for name, a, b in zip(("train pairs", "test pairs", "triples"), got,
                          plain):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"native parser: {name} differ from the "
                                 f"plain parser's")
    if not (same_graph(got[3], plain[3]) and same_graph(got[3], g_host)
            and got[4] == plain[4] == meta):
        raise AssertionError("native index: the graph built with the "
                             "counting sort differs from numpy's argsort's "
                             "or from phase 3's")
    mb = sum(os.path.getsize(os.path.join(ddir, f)) for f in (
        "train.txt", "test.txt", "kg_final.txt")) / 1e6
    secs = lambda t: ", ".join(f"{k} {v:.3f} s" for k, v in t.items())  # noqa: E731
    print(f"[12/14] host loaders on {mb:.1f} MB of text ({len(got[0])} "
          f"train and {len(got[1])} test pairs, {len(got[2])} distinct "
          f"triples; {got[3].n_edges} CKG edges): native (C++ parse, "
          f"counting sort) {secs(got[5])}; plain (Python and np.loadtxt, "
          f"np.argsort) {secs(plain[5])}; parses and graphs equal; "
          f"load_dataset {load_s:.3f} s native, {load_plain_s:.3f} s with "
          f"the plain parsers ({smi_line}; host {host_cpu()}, "
          f"{os.cpu_count()} cores)", flush=True)
    del got, plain

    # One replayed CLI epoch of the mid-plateau recipe, bf16 and float32.
    log_dir = os.path.join(tmp, "plateau")
    out = {}
    for name, bf16 in (("bf16", True), ("f32", False)):
        build.launch_counts.clear()
        tr = train.Trainer(train.parse_args(plateau_argv(
            sizes, log_dir, f"plateau-{name}", dev, bf16)))
        if tr.cfg.model.ops_backend != "hopper" or (
                (tr.cfg.model.compute_dtype == torch.bfloat16) != bf16):
            raise AssertionError(f"mid-plateau {name}: {tr.cfg.model}")
        tr.train()
        timer.sync()
        launches, _ = replayed_launches(
            dict(build.launch_counts), (tr.cf_steps, tr.kg_steps),
            single_device_nodes(tr.graph, tr._step_att))
        with open(os.path.join(log_dir, f"plateau-{name}.jsonl")) as f:
            events = [json.loads(ln) for ln in f]
        check_events(events)
        epoch = next(e for e in events if e["event"] == "epoch")
        ev = next(e for e in events if e["event"] == "eval")
        if not all(math.isfinite(epoch[k]) for k in ("cf_loss", "kg_loss")):
            raise AssertionError(f"mid-plateau {name} epoch: {epoch}")
        # At this size the training attention takes the dense route
        # (kgat_tpu's auto rule): K3 alone, twice an epoch.
        k2 = 0 if hopper_backend.use_dense_attention(
            tr.graph, tr.cfg.model) else 2
        expect_launches(dev, launches, {
            "spmm_csr": 3 * tr.n_cf_batches,
            "spmm_csr_rev": (3 * tr.n_cf_batches,),
            "sddmm_transr": (k2,), "segment_softmax_csr": (2,)},
            f"mid-plateau {name} epoch")
        reps = 20
        cf_ms = timer.host_ms(lambda: tr.cf_steps.run(reps), 3) / reps
        kg_ms = timer.host_ms(lambda: tr.kg_steps.run(reps), 3) / reps
        out[name] = (epoch, ev, launches, cf_ms, kg_ms, tr.n_cf_batches,
                     tr.n_kg_batches, tr.graph.n_edges)
        del tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    gaps = {k: abs(out["bf16"][0][k] - out["f32"][0][k])
            / abs(out["f32"][0][k]) for k in ("cf_loss", "kg_loss")}
    for name in ("bf16", "f32"):
        epoch, ev, launches, cf_ms, kg_ms, n_cf, n_kg, n_e = out[name]
        how = "replayed" if dev.type == "cuda" else "eager"
        print(f"[12/14] mid-plateau CLI epoch, {name} ({n_e} CKG edges, "
              f"{n_cf} CF and {n_kg} KG steps, {how}): {epoch['secs']:.3f}"
              f" s, cf_loss {epoch['cf_loss']:.6f}, kg_loss "
              f"{epoch['kg_loss']:.6f}, recall@20 {ev['recall']:.4f}; "
              f"{how} CF step {cf_ms:.4f} ms, KG step {kg_ms:.4f} ms "
              f"({smi_line}); launches {launches}", flush=True)
    print(f"[12/14] bf16 against float32 from the same seed: relative gap "
          f"cf_loss {gaps['cf_loss']:.2e}, kg_loss {gaps['kg_loss']:.2e} "
          f"(tolerance {BF16_RTOL})", flush=True)
    if max(gaps.values()) > BF16_RTOL:
        raise AssertionError(f"bf16 epoch: relative loss gaps {gaps} beyond "
                             f"{BF16_RTOL}")


def phase_coalesced(ds, g_host, g, sizes, check, gen, dev, timer,
                    smi_line) -> dict:
    """Phase 13 at yelp2018 scale: the coalesced CSRs built on the host;
    K1 on them forward and on their reverse CSR against float64 under
    the row bound, timed beside the full CSR's; the coalesced staging
    against a float64 group sum (in bf16, bit for bit the float32 sums
    rounded); a replayed coalesced CF step, the attention refreshed and
    replayed again, each against eager coalesced and uncoalesced steps;
    then the dense attention route, chosen by auto at mid-plateau scale
    and forced at yelp2018 scale, against K2, with its device ms beside
    K2 + K3 and its peak memory. Returns K1's coalesced numbers for the
    JSON line."""
    cap = KGATConfig().coalesce_cap
    t0 = time.perf_counter()
    co = build_coalesced(g_host, cap)
    host_s = time.perf_counter() - t0
    co = co.to(dev)
    n_e, n_g, n = g_host.n_edges, co.n_pairs, g_host.n_nodes
    print(f"[13/14] coalesced CSRs (cap {cap}) built on the host in "
          f"{host_s:.2f} s: {n_g} groups of {n_e} edges "
          f"({1 - n_g / n_e:.1%} fewer rows), {co.split.cuda_launches} and "
          f"{co.rev_split.cuda_launches} CUDA launches per K1 call by the "
          f"forward and reverse splits", flush=True)

    # The staging of one attention (K2, K3 on a random full-width model)
    # against a float64 sum of each group's members.
    emb, w_rel, rel_embed = random_inputs(n, g.n_relations, 64, 64, gen, dev)
    att = segment_softmax_csr(g.row_offsets, sddmm_transr(
        g.rel_perm, g.tiles, g.src, g.dst, emb, w_rel, rel_embed), g.split)
    staged = coalesce_weights(co, att)
    group = torch.empty(n_e, dtype=torch.long, device=dev)
    group[co.order.long()] = torch.cumsum((co.within == 0).long(), 0) - 1
    want64 = torch.zeros(n_g, dtype=torch.float64, device=dev).index_add_(
        0, group, att.double())
    members = torch.bincount(group, minlength=n_g).double()
    stage_err = check.bounded("coalesced staging", "group sums",
                              staged.fwd, want64,
                              sum_bound(want64, want64, members))[0]
    check_identical("coalesced staging, reverse order", staged.rev,
                    staged.fwd[co.rev_perm.long()])
    b16 = coalesce_weights(co, att, torch.bfloat16)
    check_identical("bf16 staging", b16.fwd,
                    staged.fwd.to(torch.bfloat16).float())
    check_identical("bf16 staging, reverse order", b16.rev,
                    staged.rev.to(torch.bfloat16).float())
    stage_ms = timer.device_ms(lambda: coalesce_weights(co, att), 10)
    del want64, members, group

    # K1 on the coalesced CSRs, forward and reverse, under the row bound,
    # and against K1 on the full CSRs (the same function).
    errs, out = [], {}
    for name, args, full_args in (
            ("spmm_csr", (co.row_offsets, co.src, staged.fwd, co.split),
             (g.row_offsets, g.src, att, g.split)),
            ("spmm_csr_rev", (co.rev_row_offsets, co.rev_dst, staged.rev,
                              co.rev_split),
             (g.rev_row_offsets, g.rev_dst,
              att[g.rev_perm.long()].contiguous(), g.rev_split))):
        ro, idx, w, split = args
        lens = csr_lengths(ro)
        x = torch.randn(n, 64, generator=gen).to(dev)
        got = spmm_csr(ro, idx, w, x, split)
        want = spmm_csr_plain(ro, idx, w.double(), x.double())
        terms = spmm_csr_plain(ro, idx, w.double().abs(), x.double().abs())
        e, _, share = check.bounded(name, "coalesced d=64", got, want,
                                    sum_bound(want, terms, lens[:, None]))
        check("coalesced K1 against the full CSR's", name, got,
              spmm_csr(full_args[0], full_args[1], full_args[2], x,
                       full_args[3]))
        errs.append(f"{name} {e:.2e} ({share:.3f} of its bound)")
        del want, terms
        # A forward (or a CF step's backward) runs K1 at d = 64, 64, 32.
        ms = full_ms = plain_ms = 0.0
        for dd in (64, 64, 32):
            xd = x[:, :dd].contiguous()
            ms += timer.device_ms(lambda: spmm_csr(ro, idx, w, xd, split),
                                  20)
            full_ms += timer.device_ms(lambda: spmm_csr(
                full_args[0], full_args[1], full_args[2], xd, full_args[3]),
                20)
            plain_ms += timer.device_ms(
                lambda: spmm_csr_plain(ro, idx, w, xd), 3)
        bound_ms = sum(spmm_bytes(n, n_g, n, dd) for dd in (64, 64, 32)) \
            / HBM_BYTES_PER_S * 1e3
        out[name] = {"coalesced_ms": ms, "coalesced_plain_ms": plain_ms,
                     "coalesced_bound_ms": bound_ms,
                     "coalesced_groups": n_g}
        print(f"[13/14] {name} on the coalesced CSRs, per "
              f"{'forward' if name == 'spmm_csr' else 'CF-step backward'} "
              f"(d = 64, 64, 32; {smi_line}): {ms:.4f} ms, on the full "
              f"CSR {full_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms by bytes", flush=True)
    print(f"[13/14] K1 on the coalesced CSRs against float64: "
          f"{', '.join(errs)}; staging (cap - 1 shifted adds, two gathers) "
          f"{stage_ms:.4f} ms, its group sums {stage_err:.2e} from "
          f"float64; in bf16 the float32 sums rounded, bit for bit",
          flush=True)
    del att, staged, b16, emb, w_rel, rel_embed

    # A replayed coalesced CF step, the attention refreshed, replayed
    # again; each against eager steps on the same batch and masks,
    # coalesced and not.
    t0 = time.perf_counter()
    tr = train.Trainer(TrainConfig(
        dataset="yelp2018", device=str(dev), log_dir=None, seed=0,
        cf_batch_size=sizes.cf_batch, kg_batch_size=sizes.kg_batch),
        dataset=ds)
    mcfg = tr.cfg.model
    if not (mcfg.coalesce and mcfg.ops_backend == "hopper"):
        raise AssertionError(f"the trainer's defaults: {mcfg}")
    tr.stage(tr.attention())
    build.launch_counts.clear()
    if dev.type == "cuda":
        tr.cf_steps.capture()
    full = dataclasses.replace(mcfg, coalesce=False)
    losses, prev = [], None
    for _ in range(2):
        att = tr.attention()
        if not att.coalesced or att.fwd.shape != (tr.graph.co.n_pairs,):
            raise AssertionError("the trainer staged no coalesced weights")
        if prev is not None and torch.equal(prev, att.fwd):
            raise AssertionError("the refreshed attention did not change")
        prev = att.fwd.clone()
        tr.stage(att)
        before = snapshot(tr)
        loss_r = replayed_step(tr.cf_steps)
        *batch, masks = tr.cf_drawn
        batch = [t.clone() for t in batch]
        masks = [None if m is None else m.clone() for m in masks]
        restore(tr, before)
        loss_e = float(tr.cf_grad(att, *batch, masks=masks))
        loss_u = float(tr.cf_grad(kgat.attention_for_training(
            tr.model, tr.graph, full), *batch, masks=masks))
        for what, want in (("eager coalesced", loss_e),
                           ("eager uncoalesced", loss_u)):
            if abs(loss_r - want) > LOSS_RTOL * abs(want):
                raise AssertionError(f"replayed coalesced CF step "
                                     f"{loss_r} vs {what} {want}")
        losses.append((loss_r, loss_e, loss_u))
        tr.opt.step()   # new parameters, so the next attention differs
    launches, nodes = replayed_launches(
        dict(build.launch_counts), (tr.cf_steps,),
        single_device_nodes(tr.graph, tr._step_att))
    step_s = time.perf_counter() - t0
    del tr, att, prev, before
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[13/14] replayed coalesced CF steps, the attention refreshed "
          f"between them (replayed, eager coalesced, eager uncoalesced): "
          + "; ".join(f"{a:.6f}, {b:.6f}, {c:.6f}" for a, b, c in losses)
          + f" (within {LOSS_RTOL}); launches {launches}, CUDA kernel "
          f"nodes {nodes} ({step_s:.1f} s with the trainer's build)",
          flush=True)

    # The dense route: auto picks it at mid-plateau scale; forced at
    # yelp2018 scale. Against K2's logits on the same weights.
    p = sizes.plateau
    gm, _ = synthetic_dataset(
        seed=0, n_users=p["users"], n_items=p["items"],
        n_entities=p["entities"], n_relations_kg=p["relations"],
        n_interactions=p["interactions"], n_triples=p["triples"]).build()
    gm = gm.to(dev)
    auto = KGATConfig(ops_backend="hopper")
    forced = dataclasses.replace(auto, att_impl="dense")
    if not hopper_backend.use_dense_attention(gm, auto):
        raise AssertionError("auto: the dense route expected at mid-plateau "
                             "scale")
    if sizes == YELP_SIZES and hopper_backend.use_dense_attention(g, auto):
        raise AssertionError("auto: the relation-tile route expected at "
                             "yelp2018 scale")
    model = kgat.init_params(gm.n_nodes, gm.n_relations, auto, generator=gen,
                             device=dev)
    build.launch_counts.clear()
    kgat.attention_for_training(model, gm, auto)
    expect_launches(dev, dict(build.launch_counts), {
        "sddmm_transr": (0,), "segment_softmax_csr": (1,)},
        "mid-plateau training attention (auto: dense)")
    del model
    lines = []
    for label, graph, cfg in (("mid-plateau, auto", gm, auto),
                              ("yelp2018, forced", g, forced)):
        if not hopper_backend.use_dense_attention(graph, cfg):
            raise AssertionError(f"{label}: the dense route not taken")
        emb, w_rel, rel_embed = random_inputs(graph.n_nodes,
                                              graph.n_relations, 64, 64, gen,
                                              dev)
        a2 = (graph.rel_perm, graph.tiles, graph.src, graph.dst, emb, w_rel,
              rel_embed)

        def dense():
            return hopper_backend.attention_logits_dense(graph, emb, w_rel,
                                                         rel_embed)
        base = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        logits = dense()
        peak_gb = ((torch.cuda.max_memory_allocated() - base) / 1e9
                   if dev.type == "cuda" else 0.0)
        err = check("dense attention", label, logits, sddmm_transr(*a2))
        dense_ms = timer.device_ms(dense, 3)
        dense_k3_ms = timer.device_ms(lambda: segment_softmax_csr(
            graph.row_offsets, dense(), graph.split), 3)
        k2_k3_ms = timer.device_ms(lambda: segment_softmax_csr(
            graph.row_offsets, sddmm_transr(*a2), graph.split), 3)
        tables_gb = 2 * graph.n_relations * graph.n_nodes * 64 * 4 / 1e9
        lines.append(f"{label} ({graph.n_edges} edges, {graph.n_relations} "
                     f"relations, tables {tables_gb:.3f} GB): logits max abs "
                     f"err {err:.2e} against K2's; dense {dense_ms:.3f} ms, "
                     f"dense + K3 {dense_k3_ms:.3f} ms, K2 + K3 "
                     f"{k2_k3_ms:.3f} ms; peak memory above the inputs "
                     f"{peak_gb:.2f} GB")
        del emb, w_rel, rel_embed, logits
    print(f"[13/14] dense attention route ({smi_line}): "
          + "; ".join(lines), flush=True)
    return out


# Phase 14: a replayed CF step's loss against an eager step's from the same
# parameters and generator state (the same kernels in the same order).
REPLAY_ATOL = 1e-6
# Phase 14: a measured efficiency above this means a wrong byte count.
EFFICIENCY_MAX = 1.05
# Phase 14: the kernel path (bf16 value stream, coalesced) against the
# plain float32 path on the bench's inputs, and the partitioned path
# against the single-device kernel path. bf16 rounds to within u = 2^-8
# of a value. Each staged attention weight is the bf16 rounding of a
# float32 weight, which may differ from the plain one by 1e-4 before it
# (K2 and K3 agree to ~1e-6). all_embed's layer blocks are l2-normalised
# rows (|x| <= 1): four units of u, against 2.1e-3 measured at the smoke
# preset on the CPU, where uniform attention in place of the real one
# moves all_embed by 4.8e-2 and dropping each row's first edge by 0.73.
# The first CF loss: 1.6e-5 measured there with a batch of 1,024 and
# 5.4e-5 with 64, 1.4e-3 with each row's first edge dropped.
BENCH_ATT_RTOL = 2.0 ** -8 + 1e-4
BENCH_FWD_ATOL = 2.0 ** -6
BENCH_LOSS_RTOL = 3e-4


def bench_numbers(out: dict, where: str = "") -> dict:
    """The bench JSON's times and rates (``*_ms``, ``*_per_s``, ``*_gb_s``,
    ``*_tflops``) and efficiencies, nested blocks included: name -> value
    (each of a list apart)."""
    found = {}
    for key, v in out.items():
        name = f"{where}{key}"
        if isinstance(v, dict):
            found.update(bench_numbers(v, f"{name}."))
        elif isinstance(v, list):
            found.update({f"{name}[{i}]": x for i, x in enumerate(v)})
        elif not isinstance(v, bool) and (
                key.endswith(("_ms", "_per_s", "_gb_s", "_tflops"))
                or "eff" in key):
            found[name] = v
    return found


def check_bench(out: dict, what: str) -> None:
    """Every time and rate finite and positive, every efficiency at most
    :data:`EFFICIENCY_MAX`."""
    for name, v in bench_numbers(out).items():
        if not (math.isfinite(v) and v > 0):
            raise AssertionError(f"bench {what}: {name} = {v}")
        if "eff" in name and v > EFFICIENCY_MAX:
            raise AssertionError(f"bench {what}: {name} = {v} above "
                                 f"{EFFICIENCY_MAX}: a byte count is wrong")


def bench_payload_errors(got: dict, want: dict, what: str) -> str:
    """The kernel path's :func:`bench.bench_backend` payloads ``got``
    against the plain path's ``want`` on the same inputs: every attention
    weight within :data:`BENCH_ATT_RTOL` of the plain one, all_embed
    within :data:`BENCH_FWD_ATOL`, the first CF loss within
    :data:`BENCH_LOSS_RTOL`. Raises beyond them; returns the errors."""
    att, att_w = got["attention"].float(), want["attention"].float()
    d = (att - att_w).abs()
    att_rel = float((d / att_w.abs().clamp(min=1e-30)).max())
    fwd = float((got["forward"].float() - want["forward"].float()).abs()
                .max())
    loss = abs(got["cf_loss"] - want["cf_loss"]) / abs(want["cf_loss"])
    line = (f"attention max rel err {att_rel:.3e} (limit "
            f"{BENCH_ATT_RTOL:.3e}), all_embed max abs err {fwd:.3e} (limit "
            f"{BENCH_FWD_ATOL:.3e}), first CF loss {got['cf_loss']:.7f} vs "
            f"{want['cf_loss']:.7f}, rel err {loss:.2e} (limit "
            f"{BENCH_LOSS_RTOL:.0e})")
    if (att.shape != att_w.shape or got["forward"].shape !=
            want["forward"].shape or bool((d > BENCH_ATT_RTOL * att_w.abs())
                                          .any())
            or not fwd <= BENCH_FWD_ATOL or not loss <= BENCH_LOSS_RTOL):
        raise AssertionError(f"bench {what}: {line}")
    return line


def partitioned_against_single(ds, g, meta, sizes, dev) -> str:
    """The bench's partitioned engine (``bench.partitioned_engine``,
    ring/fused, the bench's bf16 hopper config with message dropout 0)
    at P = 1 and P = 4 on one card, from the bench's initial weights on
    its partitioned batch: the first CF loss and the eval all_embed held
    to the single-device kernel path's, as phase 8 holds its meshes."""
    cfg = bench.model_config("hopper", mess_dropout=(0.0,) * 3)
    model = bench.init_model(meta, cfg, dev)
    lines = []
    with torch.no_grad():
        att = kgat.attention_for_training(model, g, cfg)
        emb_single = kgat.propagate(model, g, att, cfg)
        for n_parts in (1, 4):
            u, ip, ineg, w = bench.partitioned_batch(ds, meta, sizes.cf_batch,
                                                     n_parts, dev)
            single = float(kgat.cf_loss(model, g, att, meta, u, ip, ineg, cfg,
                                        train=True, weight=w))
            part, _, _ = bench.partitioned_engine(g, meta, cfg, n_parts,
                                                  "ring", "fused")
            try:
                _, staged = part.attention(model)
                loss = float(part.cf_loss(model, staged, u, ip, ineg,
                                          weight=w))
                emb = float((part.propagate_eval(model, staged)
                             - emb_single).abs().max())
            finally:
                part.close()
            rel = abs(loss - single) / abs(single)
            line = (f"P = {n_parts}: first CF loss {loss:.7f} vs "
                    f"{single:.7f}, rel err {rel:.2e} (limit "
                    f"{BENCH_LOSS_RTOL:.0e}), all_embed max abs err "
                    f"{emb:.3e} (limit {BENCH_FWD_ATOL:.3e})")
            if not (rel <= BENCH_LOSS_RTOL and emb <= BENCH_FWD_ATOL):
                raise AssertionError(f"bench ring/fused against one device: "
                                     f"{line}")
            lines.append(line)
    return "; ".join(lines)


def phase_bench(tmp, sizes, dev, smi_line) -> dict:
    """Phase 14: the port's bench in this process. ``bench.run`` of the
    flags ``--compare --serving --n-devices 1 --halo-exchange ring
    --ring-transport fused`` at ``sizes.bench_preset`` (yelp2018 on the
    card), its graph built into a cache under ``tmp`` (a miss) and its ref
    cache written under ``tmp``; it prints the bench's JSON line, and its
    kernel path's payloads are held to the ref path's
    (:func:`bench_payload_errors`). Then on the same graph: P = 4
    ring/fused (``bench_partitioned``, on one card), the roofline, a
    replayed CF step against an eager one from the same parameters and
    generator state, and the ring/fused engine at P = 1 and 4 against the
    single-device kernel path (:func:`partitioned_against_single`). The
    launch counts are set to 0 before ``bench.run`` and read after P = 4,
    each captured call counted once per replay of its step graph, as
    :func:`replayed_launches` counts the main path: K1 both ways, K2 and
    K3, and under the ring K6 and K8 must have launched. Returns them."""
    cache = os.path.join(tmp, "gcache")
    refcache = os.path.join(tmp, "bench_refcache_torch.json")
    t0 = time.perf_counter()
    built = bench.build(sizes.bench_preset, cache_dir=cache)
    ds, g_host, meta, stages = built
    if stages["graph_cache"] != "miss":
        raise AssertionError(f"bench build into a new cache: {stages}")
    args = bench.parse_args([
        "--device", str(dev), "--preset", sizes.bench_preset, "--iters",
        str(sizes.bench_iters), "--batch", str(sizes.cf_batch), "--compare",
        "--serving", "--n-devices", "1", "--halo-exchange", "ring",
        "--ring-transport", "fused", "--graph-cache", cache])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_graphs = []

    class CountedStepGraph(train.StepGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            step_graphs.append(self)

    build.launch_counts.clear()
    counted = mock.patch.object(bench, "StepGraph", CountedStepGraph)
    with counted, mock.patch.object(bench, "REFCACHE", refcache):
        out, payloads = bench.run(args, built)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    check_bench(out, "--compare --serving, P = 1 ring/fused")
    payload_line = bench_payload_errors(payloads["hopper"], payloads["ref"],
                                        "hopper against ref")
    del payloads
    if out["n_edges"] != g_host.n_edges or out["scaling"]["n_devices"] != 1:
        raise AssertionError(f"bench JSON: {out}")
    if dev.type == "cuda":
        with open(refcache) as f:
            written = json.load(f)[f"{sizes.bench_preset}/{g_host.n_edges}"]
        if written["device"] != out["device"]:
            raise AssertionError(f"ref cache: {written}")
    elif os.path.exists(refcache):
        raise AssertionError("a CPU run wrote the ref cache")
    run_s = time.perf_counter() - t0
    print(f"[14/14] bench.run ({sizes.bench_preset}, --iters "
          f"{sizes.bench_iters}, --compare --serving, P = 1 ring/fused) in "
          f"{run_s:.1f} s with the build; cf_step {out['t_cf_step_ms']} ms "
          f"replayed, ref {out['ref_t_cf_step_ms']} ms, vs_baseline "
          f"{out['vs_baseline']}; peak device memory {peak_gb:.2f} GB "
          f"({smi_line})", flush=True)
    print(f"[14/14] the bench's hopper payloads (bf16, coalesced) against "
          f"its ref path's: {payload_line}", flush=True)

    g = g_host.to(dev)
    t0 = time.perf_counter()
    with counted:
        part = bench.bench_partitioned(
            ds, g, meta, "hopper", sizes.cf_batch, sizes.bench_iters, 4,
            "ring", "fused", 1, "bf16", bench.NVLINK_GB_S,
            t1_single=out["t_cf_step_ms"] / 1e3)
    check_bench(part, "P = 4 ring/fused")
    if dev.type == "cuda" and not part["scaling"]["captured"]:
        raise AssertionError("P = 4 on one card: the steps were not captured")
    launches = dict(build.launch_counts)
    for steps in step_graphs:
        for k, n in steps.calls.items():
            launches[k] += n * (steps.replays - 1)
    expect_launches(dev, launches, {
        "spmm_csr": 1, "spmm_csr_rev": 1, "sddmm_transr": 1,
        "segment_softmax_csr": 1, "segment_sum_csr": 1, "reduce_send": 1},
        "the bench's path")
    print(f"[14/14] bench_partitioned P = 4 ring/fused on one card "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(part)}",
          flush=True)
    print(f"[14/14] kernel launches on the bench's path (--compare, "
          f"--serving, P = 1 and 4 ring/fused; {len(step_graphs)} CF step "
          f"graphs, replays {[s.replays for s in step_graphs]}): "
          f"{launches}", flush=True)
    roof = bench.roofline(g, meta, **sizes.roofline)
    check_bench(roof, "roofline")
    print(f"[14/14] bench.roofline ({smi_line}): {json.dumps(roof)}",
          flush=True)

    # A replayed CF step against an eager step from the same state.
    cfg = bench.model_config("hopper")
    model = bench.init_model(meta, cfg, dev)
    att = kgat.attention_for_training(model, g, cfg)
    step = bench.single_cf_step(model, g, meta, cfg, att, sizes.cf_batch)
    step.replayed()        # the eager warm-up step, then the capture
    params = [p.detach().clone() for p in model.parameters()]
    states = [gen.get_state() for gen in step.steps.generators]
    loss_r = float(step.replayed())
    with torch.no_grad():
        for p, q in zip(model.parameters(), params):
            p.copy_(q)
    for gen, state in zip(step.steps.generators, states):
        gen.set_state(state)
    loss_e = float(step.body())
    if abs(loss_r - loss_e) > REPLAY_ATOL:
        raise AssertionError(f"bench: replayed CF step loss {loss_r} vs "
                             f"eager {loss_e}")
    how = ("from its CUDA graph" if step.steps.graph is not None
           else "eagerly: the CPU captures nothing")
    print(f"[14/14] bench CF step run {how}: loss {loss_r:.8f}; an eager step "
          f"from the same state {loss_e:.8f} (within {REPLAY_ATOL})",
          flush=True)
    del step, att, model
    print(f"[14/14] the bench's ring/fused engine against the single-device "
          f"kernel path (dropout 0, {smi_line}): "
          f"{partitioned_against_single(ds, g, meta, sizes, dev)}",
          flush=True)
    del g
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process-worker"]:
        sys.exit(process_worker(sys.argv[2:]))
    sys.exit(main())
