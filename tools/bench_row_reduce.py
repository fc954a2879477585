#!/usr/bin/env python3
"""Time the CSR row reductions (K1, K6, K8) of a checkout on the card.

    python tools/bench_row_reduce.py [--root DIR] [--chunks 256,512] \
        [--label NAME] [--reps 20]

Builds the yelp2018-scale synthetic graph (chip_smoke's numbers, seed 0)
and its P = 4 ring buckets with the checkout at DIR (default: this one),
then times on the card, per launch: K1 at d = 64 and 32 f32 on the
forward and on the reverse CSR, K6 and K8 on the largest ring bucket at
d = 64 and 32 f32, and beside them ``torch.sparse.mm`` (CSR) and
``torch.segment_reduce``. Each time is the device time of ``--reps``
calls captured in one CUDA graph, replayed (``replay``), and, for
comparison, CUDA events around the same calls made from Python
(``events``). A checkout whose reductions walk a row split
(``ops/row_split.py``) is timed once per chunk in ``--chunks``, every
CSR's schedule built with it. Prints the card's name and power limit,
then one JSON line per chunk. Needs CUDA; run parent and change in one
call to compare them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def both(fn, reps):
    """Replay and event times; a call that a CUDA graph cannot capture
    has its replay time as the error, so the other numbers still print."""
    try:
        replay = replay_ms(fn, reps)
    except RuntimeError as e:
        torch.cuda.synchronize()
        replay = f"not captured: {str(e)[:80]}"
    return {"replay": replay, "events": events_ms(fn, reps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--chunks", default="")
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_row_reduce: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import YELP2018
    from kgat_tpu_torch.data import synthetic_dataset
    from kgat_tpu_torch.ops.hopper import segment_sum as k16
    from kgat_tpu_torch.ops.hopper.remote_ring import reduce_send
    from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                                   partition_graph)
    try:
        row_split = importlib.import_module("kgat_tpu_torch.ops.row_split")
    except ImportError:
        row_split = None
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g_host, meta = synthetic_dataset(seed=0, name="yelp2018",
                                     **YELP2018).build()
    src, dst = g_host.src.numpy(), g_host.dst.numpy()
    shards, info = partition_graph(src, dst, g_host.etype.numpy(),
                                   meta.n_nodes, meta.n_relations, 4)
    big = max((b for row in build_ring_buckets(src, dst, info) for b in row),
              key=lambda b: b.n_edges)
    g, big = g_host.to(dev), big.to(dev)
    print(f"graph {g.n_edges} edges, largest bucket {big.n_edges} edges "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)
    gen = torch.Generator().manual_seed(0)
    w = torch.rand(g.n_edges, generator=gen).to(dev)
    w_rev = w[g.rev_perm.long()].contiguous()
    R = info.rows_per_part
    chunks = ([int(c) for c in a.chunks.split(",") if c]
              if row_split is not None else [])
    for chunk in chunks or [None]:
        if chunk is None:
            sp = {"fwd": (), "rev": (), "big": ()}
            send = {}
        else:
            build = row_split.build_row_split
            sp = {"fwd": (build(g.row_offsets, chunk),),
                  "rev": (build(g.rev_row_offsets, chunk),),
                  "big": (build(big.row_offsets, chunk),)}
            send = {"splits": sp["big"]}
        res = {"label": a.label, "chunk": chunk, "device": smi}
        if chunk is not None:
            res["cuda_launches"] = {k: v[0].cuda_launches
                                    for k, v in sp.items()}
            res["units"] = {k: v[0].n_units for k, v in sp.items()}
        with torch.no_grad():
            for d in (64, 32):
                x = torch.randn(g.n_nodes, d, generator=gen).to(dev)
                res[f"K1_d{d}"] = both(lambda: k16.spmm_csr(
                    g.row_offsets, g.src, w, x, *sp["fwd"]), a.reps)
                res[f"K1rev_d{d}"] = both(lambda: k16.spmm_csr_rev(
                    g.rev_row_offsets, g.rev_dst, w_rev, x, *sp["rev"]),
                    a.reps)
                csr = torch.sparse_csr_tensor(g.row_offsets, g.src, w,
                                              (g.n_nodes, g.n_nodes))
                res[f"sparse_mm_d{d}"] = both(lambda: torch.sparse.mm(csr, x),
                                              a.reps)
                chunk_x = torch.randn(R, d, generator=gen).to(dev)
                vals = (chunk_x[big.src.long()]
                        * torch.rand(big.n_edges, generator=gen).to(dev)[
                            :, None]).contiguous()
                buf = torch.empty_like(chunk_x)
                offsets = big.row_offsets.long()
                res[f"K6_d{d}"] = both(lambda: k16.segment_sum_csr(
                    big.row_offsets, vals, *sp["big"]), a.reps)
                res[f"K8_d{d}"] = both(lambda: reduce_send(
                    [big.row_offsets], [vals], [chunk_x], out=[buf], **send),
                    a.reps)
                res[f"segment_reduce_d{d}"] = both(
                    lambda: torch.segment_reduce(vals, "sum", offsets=offsets,
                                                 unsafe=True), a.reps)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
