#!/usr/bin/env python3
"""Time K2 (the TransR attention SDDMM), K3 (the segment softmax), K4
(K2's backward), K5 (K3's backward) and K7 (the ring shift) of a checkout
on the card.

    python tools/bench_sddmm_shift.py [--root DIR] [--label NAME] [--reps 20] \
        [--kernels k2,k3,k4,k5,k7]

Builds the yelp2018-scale synthetic graph (chip_smoke's numbers, seed 0)
with the checkout at DIR (default: this one), then times on the card, per
call, by CUDA-graph replay (``--reps`` calls captured in one graph, the
graph replayed three times after a warm replay):

- K2 at d = k = 64 and at d = 64, k = 32, on Xavier-scaled inputs, with
  its max abs error against a float64 plain version beside the plain
  float32 path's;
- K3 on the logits of K2 at d = k = 64, with its max abs error against
  the plain version (the row split passed where the wrapper takes one);
- K4 at d = k = 64 on a random cotangent, per call, with each output's
  max abs error against a float64 plain version beside the plain float32
  path's, and its CUDA launches apart: device ms per call of each kernel
  by name, from ``torch.profiler`` over three calls;
- K5 on the plain softmax of K2's logits at d = k = 64 and a random
  cotangent, per call, with its max abs error against a float64 plain
  version beside the plain float32 path's, its CUDA launches apart (as
  K4's), and the edges of the forward CSR's split rows (the row split
  passed where the wrapper takes one);
- K7 and ``copy_`` hot: one chunk of R x 64 float32 (R = 34,304, the rows
  of one of P = 4 partitions; 8.78 MB) copied every call, so it stays in
  L2;
- K7 and ``copy_`` fresh: the calls take 8 such chunks in turn (70 MB,
  more than L2), as a ring CF step finds them.

``--kernels`` picks among k2, k3, k4, k5 and k7 (default k2,k7; k7 alone
builds no graph). Prints the card's
name and power limit, then one JSON line. Needs CUDA.
Run parent and change in one call, in turns (parent, change, change,
parent), to compare them: unpack the parent with ``git archive`` into a
gitignored directory and pass it as ``--root``.
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRESH_CHUNKS = 8
P_PARTS = 4


def replay_ms(fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph,
    timed over three replays after a warm one."""
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
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def time_k2(g, d, k, gen, dev, reps, random_inputs, sddmm):
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, d, k,
                                          gen, dev)
    args = (g.rel_perm, g.tiles, g.src, g.dst, emb, w_rel, rel_embed)
    got = sddmm.sddmm_transr(*args)
    plain = sddmm.sddmm_transr_plain(*args)
    want64 = sddmm.sddmm_transr_plain(*args[:4], emb.double(),
                                      w_rel.double(), rel_embed.double())
    return {"ms": replay_ms(lambda: sddmm.sddmm_transr(*args), reps),
            "max_abs_err_f64": float((got.double() - want64).abs().max()),
            "plain_f32_max_abs_err_f64": float(
                (plain.double() - want64).abs().max())}


def time_k3(g, gen, dev, reps, random_inputs, sddmm, softmax):
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, 64, 64,
                                          gen, dev)
    logits = sddmm.sddmm_transr(g.rel_perm, g.tiles, g.src, g.dst, emb,
                                w_rel, rel_embed)
    kw = ({"split": g.split} if "split" in inspect.signature(
        softmax.segment_softmax_csr).parameters else {})
    got = softmax.segment_softmax_csr(g.row_offsets, logits, **kw)
    want = softmax.segment_softmax_csr_plain(g.row_offsets, logits)
    return {"ms": replay_ms(lambda: softmax.segment_softmax_csr(
                g.row_offsets, logits, **kw), reps),
            "max_abs_err": float((got - want).abs().max())}


def time_k5(g, gen, dev, reps, random_inputs, sddmm, softmax):
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, 64, 64,
                                          gen, dev)
    w = softmax.segment_softmax_csr_plain(g.row_offsets, sddmm.sddmm_transr(
        g.rel_perm, g.tiles, g.src, g.dst, emb, w_rel, rel_embed))
    cot = torch.randn(g.n_edges, generator=gen).to(dev)
    kw = ({"split": g.split} if "split" in inspect.signature(
        softmax.segment_softmax_csr_bwd).parameters else {})

    def k5():
        return softmax.segment_softmax_csr_bwd(g.row_offsets, w, cot, **kw)
    got = k5()
    plain = softmax.segment_softmax_csr_bwd_plain(g.row_offsets, w, cot)
    want = softmax.segment_softmax_csr_bwd_plain(g.row_offsets, w.double(),
                                                 cot.double())
    rows = g.split.split_rows.long()
    return {"ms": replay_ms(k5, reps), "launches_ms": profile_ms(k5),
            "max_abs_err_f64": float((got.double() - want).abs().max()),
            "plain_f32_max_abs_err_f64": float(
                (plain.double() - want).abs().max()),
            "split_rows": int(rows.numel()),
            "split_row_edges": int((g.row_offsets[rows + 1]
                                    - g.row_offsets[rows]).sum())}


def profile_ms(fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name, from
    torch.profiler over ``calls`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = us if us is not None else getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key[:120]] = us / calls / 1e3
    return out


def time_k4(g, gen, dev, reps, random_inputs, sddmm):
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, 64, 64,
                                          gen, dev)
    cot = torch.randn(g.n_edges, generator=gen).to(dev)
    args = (g, cot, emb, w_rel, rel_embed)
    got = sddmm.sddmm_transr_bwd(*args)
    plain = sddmm.sddmm_transr_bwd_plain(*args)
    want = sddmm.sddmm_transr_bwd_plain(g, cot.double(), emb.double(),
                                        w_rel.double(), rel_embed.double())
    res = {"ms": replay_ms(lambda: sddmm.sddmm_transr_bwd(*args), reps),
           "launches_ms": profile_ms(lambda: sddmm.sddmm_transr_bwd(*args))}
    for name, a, p, w in zip(("d_emb", "d_w_rel", "d_rel_embed"), got, plain,
                             want):
        res[f"{name}_max_abs_err_f64"] = float((a.double() - w).abs().max())
        res[f"{name}_plain_f32_max_abs_err_f64"] = float(
            (p.double() - w).abs().max())
    return res


def time_k7(rows, d, gen, dev, reps, ring_shift):
    res = {}
    srcs = [torch.randn(rows, d, generator=gen).to(dev)
            for _ in range(FRESH_CHUNKS)]
    dsts = [torch.empty_like(c) for c in srcs]
    for how, n in (("hot", 1), ("fresh", FRESH_CHUNKS)):
        turn = itertools.count()

        def k7():
            i = next(turn) % n
            ring_shift([srcs[i]], 1, out=[dsts[i]])

        def copy():
            i = next(turn) % n
            dsts[i].copy_(srcs[i])
        res[f"K7_{how}"] = replay_ms(k7, reps)
        res[f"copy_{how}"] = replay_ms(copy, reps)
    for s, t in zip(srcs, dsts):
        if not torch.equal(s, t):
            raise AssertionError("ring_shift: a chunk differs from its copy")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--kernels", default="k2,k7")
    a = p.parse_args(argv)
    kernels = set(a.kernels.split(","))
    if not torch.cuda.is_available():
        print("bench_sddmm_shift: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import YELP2018, random_inputs
    from kgat_tpu_torch.data import synthetic_dataset
    from kgat_tpu_torch.ops.hopper import sddmm, softmax
    from kgat_tpu_torch.ops.hopper.remote_ring import ring_shift
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    res = {"label": a.label, "root": os.path.abspath(a.root), "device": smi}
    # PartitionInfo's rows per partition at yelp2018 scale (136,880 nodes):
    # ceil(N / P) rounded up to 128.
    rows = math.ceil(math.ceil(136_880 / P_PARTS) / 128) * 128
    with torch.no_grad():
        if kernels & {"k2", "k3", "k4", "k5"}:
            t0 = time.perf_counter()
            g = synthetic_dataset(seed=0, name="yelp2018",
                                  **YELP2018).build()[0].to(dev)
            print(f"graph {g.n_edges} edges, {g.n_nodes} nodes, "
                  f"{g.tiles.shape[0]} tiles ({time.perf_counter() - t0:.1f} "
                  f"s on the host)", flush=True)
        if "k2" in kernels:
            for d, k in ((64, 64), (64, 32)):
                res[f"K2_d{d}_k{k}"] = time_k2(g, d, k, gen, dev, a.reps,
                                               random_inputs, sddmm)
        if "k3" in kernels:
            res["K3"] = time_k3(g, gen, dev, a.reps, random_inputs, sddmm,
                                softmax)
        if "k4" in kernels:
            res["K4_d64_k64"] = time_k4(g, gen, dev, max(a.reps // 4, 3),
                                        random_inputs, sddmm)
        if "k5" in kernels:
            res["K5"] = time_k5(g, gen, dev, a.reps, random_inputs, sddmm,
                                softmax)
        if "k7" in kernels:
            res.update(time_k7(rows, 64, gen, dev, a.reps, ring_shift))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
