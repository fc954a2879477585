"""A checkout of the benchmark at a tiny size, for the CPU tests.

``make_root(tmp)`` writes a ``BENCHMARK.json`` whose cells run the real
drivers, traffic mixes and metric readers on a tiny configuration (the
reference recipe's structure, small widths and a few hundred nodes), with
the limits of the real cells, so that the CPU tests hold the tiny runs to
the same limits as the card's.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from benchmark import run
from benchmark.spec import HERE, ROOT, Spec

TINY_DATA = dict(n_users=120, n_items=90, n_entities=200, n_relations_kg=5,
                 n_interactions=1500, n_triples=1200)
TINY_MODEL = dict(embed_dim=16, relation_dim=8, conv_dims=[16, 8, 8])
# The tiny cells and the real cells whose limits they take.
CELLS = {"tiny-train": ("train-epochs", "yelp2018-train"),
         "tiny-serve": ("serve-open-900rps", "yelp2018-serve"),
         "tiny-train-p4": ("train-epochs-4proc-allgather",
                           "yelp2018-train-p4")}
# The serving mix at a size the tiny data holds.
TINY_SERVE = dict(max_users=100, pool_requests=300, refresh_s=0.5,
                  rate_per_s=1000,
                  trace_s=0.3, check_requests=6)


def make_root(tmp) -> str:
    root = str(tmp)
    bench = os.path.join(root, "benchmark")
    for sub in ("metrics", "workloads", "limits"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(HERE, "configs", "kgat-yelp2018.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["data"].update(TINY_DATA)
    cfg["model"].update(TINY_MODEL)
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    serve = os.path.join(bench, "workloads", "serve-open-900rps.json")
    with open(serve) as f:
        mix = json.load(f)
    mix.update(TINY_SERVE)
    with open(serve, "w") as f:
        json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "source": "tiny",
                        "file": "benchmark/configs/tiny.json", "reduced": [],
                        "why": "the CPU tests' size"}]
    spec["workloads"] = [{"name": c, "config": "tiny", "traffic": t,
                          "chips": 1, "why": "a CPU test"}
                         for c, (t, _) in CELLS.items()]
    for c, (_, real) in CELLS.items():
        shutil.copy(os.path.join(bench, "limits", f"{real}.json"),
                    os.path.join(bench, "limits", f"{c}.json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, (_, real) in CELLS.items()
                              if real in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def context(root: str, cell: str, seed: int = 987654321012,
            seconds: float = 0.5, trace: bool = False) -> "run.Context":
    return run.Context(Spec(root), cell, seed, seconds, trace,
                       torch.device("cpu"))


def drive(root: str, cell: str, **kw) -> dict:
    """A run of a tiny cell on the CPU, past the look for a card: the
    result line."""
    ctx = context(root, cell, **kw)
    out = run.drive(ctx)
    return run.result_line(ctx, out, {"platform": "cpu", "kind": "cpu",
                                      "count": 1})
