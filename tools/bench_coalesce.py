#!/usr/bin/env python3
"""Would distinct-pair coalescing pay in the port? Time K1 on the card.

    python tools/bench_coalesce.py [--reps 20]

``kgat_tpu`` collapses the multi-edges of the CKG (several relations over
one (dst, src) pair) into one gather row with their weights summed
(``kgat_tpu/graph.py:344-489``); the port keeps every edge. This builds
the yelp2018-scale synthetic graph (chip_smoke's numbers, seed 0), its
distinct-(dst, src) CSR and reverse CSR with their row splits, and times
on the card, by CUDA-graph replay of ``--reps`` calls: K1 (``spmm_csr``)
on the full and on the coalesced CSR, forward and on the reverse CSR, at
d = 64 and 32, and the per-recompute cost of staging the summed weights
(one ``index_add_`` over the edges, and its reverse-order gather). Both
products are held to float64 under the row bound. It also times the
host start-up the ``kgat_tpu/native`` gate looks at: parsing the dataset
files, the cold graph build, the coalesced CSR's build, and the graph
cache written cold and loaded warm. Prints the card's name and power
limit, then one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from bench_row_reduce import replay_ms  # noqa: E402
from chip_smoke import YELP2018  # noqa: E402
from kgat_tpu_torch.data import (load_dataset, save_dataset,  # noqa: E402
                                 synthetic_dataset)
from kgat_tpu_torch.ops.hopper.segment_sum import (  # noqa: E402
    spmm_csr, spmm_csr_plain, spmm_csr_rev)
from kgat_tpu_torch.ops.row_split import build_row_split  # noqa: E402


def coalesce(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> dict:
    """The distinct-(dst, src) pairs of a dst-sorted edge list: for each
    edge its pair (``group``, in (dst, src) order), the pairs' src and
    CSR offsets over dst, and the reverse CSR over src."""
    order = np.lexsort((src, dst))
    s, d = src[order], dst[order]
    new = np.ones(len(s), bool)
    new[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    group = np.empty(len(s), np.int64)
    group[order] = np.cumsum(new) - 1
    c_src, c_dst = s[new], d[new]
    rev = np.argsort(c_src, kind="stable")
    as32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    ro = as32(np.searchsorted(c_dst, np.arange(n_nodes + 1)))
    rev_ro = as32(np.searchsorted(c_src[rev], np.arange(n_nodes + 1)))
    return {"group": torch.from_numpy(group), "n_pairs": int(new.sum()),
            "row_offsets": ro, "src": as32(c_src), "rev_perm": as32(rev),
            "rev_row_offsets": rev_ro, "rev_dst": as32(c_dst[rev]),
            "split": build_row_split(ro), "rev_split": build_row_split(rev_ro)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_coalesce: needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    res = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        save_dataset(synthetic_dataset(seed=0, name="yelp2018", **YELP2018),
                     tmp)
        t0 = time.perf_counter()
        ds = load_dataset(tmp, "yelp2018")
        res["parse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_host, meta = ds.build()
        res["build_s"] = time.perf_counter() - t0
        cache = os.path.join(tmp, "cache")
        for what in ("cache_cold_s", "cache_warm_s"):
            t0 = time.perf_counter()
            ds.build(cache_dir=cache)
            res[what] = time.perf_counter() - t0
        res["cache_bytes"] = os.path.getsize(ds.graph_cache_path(cache))
    t0 = time.perf_counter()
    co = coalesce(g_host.src.numpy().astype(np.int64),
                  g_host.dst.numpy().astype(np.int64), g_host.n_nodes)
    res["coalesce_build_s"] = time.perf_counter() - t0
    E, n = g_host.n_edges, g_host.n_nodes
    res.update(edges=E, pairs=co["n_pairs"],
               fewer_rows=1 - co["n_pairs"] / E)
    g = g_host.to(dev)
    co = {k: v.to(dev) if hasattr(v, "to") else v for k, v in co.items()}
    gen = torch.Generator().manual_seed(0)
    w = torch.rand(E, generator=gen).to(dev)
    w_rev = w[g.rev_perm.long()].contiguous()
    group = co["group"].long()
    c_rev_perm = co["rev_perm"].long()

    def stage():
        wc = torch.zeros(co["n_pairs"], device=dev).index_add_(0, group, w)
        return wc, wc[c_rev_perm].contiguous()

    wc, wc_rev = stage()
    res["stage_ms"] = replay_ms(stage, a.reps)
    worst = 0.0
    for d in (64, 32):
        x = (torch.randn(n, d, generator=gen) * 0.1).to(dev)
        cot = torch.randn(n, d, generator=gen).to(dev)
        calls = {
            "fwd_full": lambda: spmm_csr(g.row_offsets, g.src, w, x,
                                         g.split),
            "fwd_coalesced": lambda: spmm_csr(co["row_offsets"], co["src"],
                                              wc, x, co["split"]),
            "rev_full": lambda: spmm_csr_rev(g.rev_row_offsets, g.rev_dst,
                                             w_rev, cot, g.rev_split),
            "rev_coalesced": lambda: spmm_csr_rev(
                co["rev_row_offsets"], co["rev_dst"], wc_rev, cot,
                co["rev_split"]),
        }
        # Both products against float64 on the full CSR, under the row
        # bound n 2^-23 sum|terms| + 2^-24 |reference| (n the full row's
        # edges; a summed weight adds one rounding per merged edge).
        for side, (ro, idx, ww, vv) in (
                ("fwd", (g.row_offsets, g.src, w, x)),
                ("rev", (g.rev_row_offsets, g.rev_dst, w_rev, cot))):
            want = spmm_csr_plain(ro, idx, ww.double(), vv.double())
            terms = spmm_csr_plain(ro, idx, ww.double().abs(),
                                   vv.double().abs())
            rows = (ro[1:] - ro[:-1]).double()[:, None]
            bound = 2 ** -23 * rows * terms + 2 ** -24 * want.abs()
            for kind in ("full", "coalesced"):
                err = (calls[f"{side}_{kind}"]().double() - want).abs()
                share = float((err / bound.clamp(min=1e-300)).max())
                if share > 1:
                    raise AssertionError(f"d={d} {side} {kind}: K1 beyond "
                                         f"its bound ({share:.2f}x)")
                worst = max(worst, share)
        for name, fn in calls.items():
            res[f"{name}_d{d}_ms"] = replay_ms(fn, a.reps)
    res["worst_share_of_bound"] = worst
    # A CF step runs K1 at d = 64, 64, 32 forward and on the reverse CSR.
    for kind in ("full", "coalesced"):
        res[f"cf_step_k1_{kind}_ms"] = sum(
            m * res[f"{side}_{kind}_d{d}_ms"] for side in ("fwd", "rev")
            for d, m in ((64, 2), (32, 1)))
    res["cf_step_k1_saved_ms"] = (res["cf_step_k1_full_ms"]
                                  - res["cf_step_k1_coalesced_ms"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
