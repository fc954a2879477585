#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's serving path (kgat_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (built for
an H100, sm_90a):

    python3 chip_smoke.py

Phases, each printing one line (or a few):
  1. device  — requires CUDA; prints nvidia-smi's name and power limit.
  2. build   — compiles the three kernels from kgat_tpu_torch/ops/hopper/csrc.
  3. kernels — each kernel against its plain PyTorch version on the card:
               hand-made rows (empty, one edge, a hub) and the
               yelp2018-scale graph, with times.
  4. serving — the yelp2018-scale synthetic dataset and a random
               full-width model (d = k = 64, layers 64/32/16,
               bi-interaction) written as a checkpoint, served through
               ``kgat_tpu_torch.recommend.main`` for 1,024 users at k = 20;
               checks the lists, that every kernel launched, and the kernel
               path against the plain path on the card.
Then a JSON line of per-kernel results and, last, the device JSON line.
Any failure raises, and the script exits non-zero without the last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kgat_tpu_torch import recommend as rec
from kgat_tpu_torch.data import (load_dataset, save_dataset,
                                 synthetic_dataset)
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.sddmm import sddmm_transr, sddmm_transr_plain
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr, spmm_csr_plain
from kgat_tpu_torch.ops.hopper.softmax import (segment_softmax_csr,
                                               segment_softmax_csr_plain)
from kgat_tpu_torch.utils.checkpoint import save_params

# yelp2018 at published scale, as the repo's `make datasets` generates it.
YELP2018 = dict(n_users=45919, n_items=45538, n_entities=90961,
                n_relations_kg=42, n_interactions=1185068,
                n_triples=1853704)
N_USERS = 1024
TOP_K = 20
RTOL = ATOL = 1e-4          # kernel vs plain, f32 (sum order differs)
HUB_DEGREE = 70884          # the largest in-degree of the yelp-scale graph

KERNELS = {
    "spmm_csr": ("kgat_tpu_torch/ops/hopper/csrc/segment_sum.cu",
                 "kgat_tpu/ops/pallas/segment_sum.py:119"),
    "sddmm_transr": ("kgat_tpu_torch/ops/hopper/csrc/sddmm.cu",
                     "kgat_tpu/ops/pallas/sddmm.py:30"),
    "segment_softmax_csr": ("kgat_tpu_torch/ops/hopper/csrc/softmax.cu",
                            "kgat_tpu/ops/pallas/softmax.py:60"),
}


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events, after one
    warm-up call)."""
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


def host_ms(fn, reps: int) -> float:
    """Median wall milliseconds of ``fn`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


class Check:
    """Kernel-vs-plain comparisons, with the worst error per kernel."""

    def __init__(self):
        self.max_err = {name: 0.0 for name in KERNELS}

    def __call__(self, name, label, got, want, rtol=RTOL, atol=ATOL):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            raise AssertionError(f"{name} {label}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        self.max_err[name] = max(self.max_err[name], err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {label}: max abs err {err:.3e} "
                                 f"beyond rtol {rtol} atol {atol}")
        return err


def random_inputs(n_nodes, n_rel, d, k, gen, dev):
    """Embedding table and TransR weights at the Xavier scale."""
    def u(*shape, fan):
        lim = (6.0 / fan) ** 0.5
        return ((torch.rand(shape, generator=gen) * 2 - 1) * lim).to(dev)
    return (u(n_nodes, d, fan=n_nodes + d), u(n_rel, d, k, fan=d + k),
            u(n_rel, k, fan=n_rel + k))


def check_kernels(g, label, check, gen, dev, times=None):
    """K2 -> K3 -> K1 on graph ``g`` against the plain versions. With
    ``times`` (a dict), also records per-forward kernel and plain ms."""
    d = k = 64
    emb, w_rel, rel_embed = random_inputs(g.n_nodes, g.n_relations, d, k,
                                          gen, dev)
    a2 = (g.rel_perm, g.tiles, g.src, g.dst, emb, w_rel, rel_embed)
    logits = sddmm_transr_plain(*a2)
    e2 = check("sddmm_transr", label, sddmm_transr(*a2), logits)
    att = segment_softmax_csr_plain(g.row_offsets, logits)
    e3 = check("segment_softmax_csr", label,
               segment_softmax_csr(g.row_offsets, logits), att, atol=1e-6)
    errs = []
    for dd, dt in ((64, torch.float32), (32, torch.float32),
                   (64, torch.bfloat16)):
        x = (torch.randn(g.n_nodes, dd, generator=gen) * 0.1).to(dev, dt)
        a1 = (g.row_offsets, g.src, att, x)
        out = spmm_csr(*a1)
        errs.append(check("spmm_csr", f"{label} d={dd} {dt}", out,
                          spmm_csr_plain(*a1)))
        empty = (g.row_offsets[1:] == g.row_offsets[:-1])
        if empty.any() and out[empty].abs().max() != 0:
            raise AssertionError("spmm_csr: an empty row is not 0")
        if times is not None:
            ms = cuda_ms(lambda: spmm_csr(*a1), 20)
            plain_ms = cuda_ms(lambda: spmm_csr_plain(*a1), 5)
            print(f"[3/4] spmm_csr per call at d={dd} {dt}: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
            if dt == torch.float32:
                # The serving forward runs K1 at d = 64, 64, 32.
                n = 2 if dd == 64 else 1
                times["spmm_csr"][0] += n * ms
                times["spmm_csr"][1] += n * plain_ms
    if times is not None:
        times["sddmm_transr"] = [cuda_ms(lambda: sddmm_transr(*a2), 20),
                                 cuda_ms(lambda: sddmm_transr_plain(*a2), 5)]
        times["segment_softmax_csr"] = [
            cuda_ms(lambda: segment_softmax_csr(g.row_offsets, logits), 20),
            cuda_ms(lambda: segment_softmax_csr_plain(g.row_offsets,
                                                      logits), 5)]
    return e2, e3, errs


def handmade_graph(gen):
    """100 nodes: node 0 has no in-edge, node 1 one, node 2 is a hub of
    HUB_DEGREE in-edges, the rest 0-40; relation 4 has a single edge."""
    rs = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                 generator=gen)))
    n = 100
    deg = np.concatenate([[0, 1, HUB_DEGREE], rs.integers(0, 41, n - 3)])
    dst = np.repeat(np.arange(n), deg)
    src = rs.integers(0, n, len(dst))
    ety = rs.integers(0, 4, len(dst))
    ety[len(dst) // 2] = 4
    return build_graph(src, dst, ety, n_nodes=n, n_relations=5)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(f"[1/4] device: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    print(line, flush=True)
    return line


def phase_build():
    _, seconds, log = build.build(force=True)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    build.library()
    print(f"[2/4] build: nvcc sm_90a {seconds:.1f} s, {len(regs)} kernels, "
          f"max {max(regs, default=0)} registers, {spills} spill-store bytes",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    rec.disable_tf32()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    smi_line = phase_device()
    phase_build()

    with tempfile.TemporaryDirectory() as tmp:
        return run(tmp, dev, gen, smi_line)


def run(tmp: str, dev: torch.device, gen: torch.Generator,
        smi_line: str) -> int:
    # --- 3. kernels against their plain versions ---------------------------
    # The graph is built from the dataset as written and read back, as the
    # serving CLI builds it, so both see one canonical edge order.
    check = Check()
    t0 = time.perf_counter()
    save_dataset(synthetic_dataset(seed=0, name="yelp2018", **YELP2018), tmp)
    ds = load_dataset(tmp, "yelp2018")
    g_host, meta = ds.build()
    gen_s = time.perf_counter() - t0
    deg = (g_host.row_offsets[1:] - g_host.row_offsets[:-1])
    print(f"[3/4] yelp2018-scale graph: {g_host.n_edges} edges, "
          f"{g_host.n_nodes} nodes, {g_host.n_relations} relations, "
          f"max in-degree {int(deg.max())}, {int((deg == 0).sum())} empty "
          f"rows, {g_host.tiles.shape[0]} tiles (generated, written, read "
          f"and built in {gen_s:.1f} s on the host)", flush=True)
    hand = handmade_graph(gen).to(dev)
    e2, e3, e1 = check_kernels(hand, "hand-made", check, gen, dev)
    print(f"[3/4] hand-made rows (empty, one edge, hub of {HUB_DEGREE}): "
          f"max abs err sddmm {e2:.2e}, softmax {e3:.2e}, spmm "
          f"{', '.join(f'{e:.2e}' for e in e1)} (d64, d32, d64 bf16)",
          flush=True)
    g = g_host.to(dev)
    times = {"spmm_csr": [0.0, 0.0]}
    e2, e3, e1 = check_kernels(g, "yelp2018", check, gen, dev, times)
    print(f"[3/4] yelp2018 shapes: max abs err sddmm {e2:.2e}, softmax "
          f"{e3:.2e}, spmm {', '.join(f'{e:.2e}' for e in e1)} "
          f"(d64, d32, d64 bf16)", flush=True)
    for name, (ms, plain_ms) in times.items():
        print(f"[3/4] time per serving forward ({smi_line}): {name} "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)

    # --- 4. serving at full width ------------------------------------------
    cfg = KGATConfig(ops_backend="hopper")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=gen)
    users = np.asarray(sorted(ds.test_user_dict)[:N_USERS])
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
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    with open(out_path) as f:
        lines = [json.loads(ln) for ln in f]
    if rc != 0:
        raise AssertionError(f"recommend.main returned {rc}")
    missing = [n for n in KERNELS if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"serving never launched {missing}: {launches}")
    if [ln["user"] for ln in lines] != users.tolist():
        raise AssertionError("CLI output users differ from the request")
    for ln in lines:
        s = np.asarray(ln["scores"])
        train = set(ds.train_user_dict.get(ln["user"], np.zeros(0)).tolist())
        if (len(ln["items"]) != TOP_K or not np.isfinite(s).all()
                or (np.diff(s) > 0).any() or train & set(ln["items"])):
            raise AssertionError(f"bad list for user {ln['user']}: {ln}")
    print(f"[4/4] serving CLI: {len(lines)} users x top-{TOP_K} valid in "
          f"{cli_s:.1f} s (load, build, forward, score); launches {launches}",
          flush=True)

    model = model.to(dev)
    cfg_plain = dataclasses.replace(cfg, ops_backend="ref")
    emb_k = rec._forward(cfg, model, g)
    emb_p = rec._forward(cfg_plain, model, g)
    torch.cuda.synchronize()
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
    fwd_ms = host_ms(lambda: rec._forward(cfg, model, g), 5)
    fwd_plain_ms = host_ms(lambda: rec._forward(cfg_plain, model, g), 3)
    server = rec.Recommender(model, g, meta, cfg,
                             train_user_dict=ds.train_user_dict)
    serve_ms = host_ms(lambda: server.recommend(users, k=TOP_K), 5)
    print(f"[4/4] kernel path vs plain path on the card: all_embed max abs "
          f"err {err:.2e}; top-{TOP_K} scores within rtol {RTOL}; item sets "
          f"equal for {int(clear.sum())}/{len(users)} users with a "
          f"20th/21st gap > 1e-4, same order for {int(ordered.sum())} with "
          f"every gap > 1e-4; CLI lists in the same order for "
          f"{same_order}/{len(users)} users; a second kernel forward is "
          f"{'bit-identical' if repeat else 'NOT bit-identical'}", flush=True)
    print(f"[4/4] forward {fwd_ms:.2f} ms (plain path {fwd_plain_ms:.2f} "
          f"ms); serve {len(users)} users top-{TOP_K} from the cached "
          f"forward {serve_ms:.2f} ms ({smi_line})", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": check.max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
