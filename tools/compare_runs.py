"""Compare the port's training runs with kgat_tpu's, from their JSONL logs.

Both trainers log the same events (``start``, ``epoch``, ``eval``,
``early_stop``, ``resume``, ``done``), so one reader serves both. For each
run it prints the first epoch's ``cf_loss`` and ``kg_loss``, the best
recall@K and its epoch, the epoch it stopped at, the median epoch
``secs`` (each on its own hardware), then recall and ndcg at every eval
epoch the runs share, and a verdict.

Usage:
    python tools/compare_runs.py --name mid-plateau \\
        --port runs/torch-mid-plateau-s1234.jsonl runs/torch-mid-plateau-s1.jsonl \\
        --jax runs/mid-plateau.jsonl runs/mid-plateau-r4s.jsonl --shape early-stop

The verdict rule, fixed before the runs it judges:

* the port's value is the mean of its runs' best recall@K (their spread
  is printed beside it); JAX's is the range [lo, hi] of its runs' best;
* the pair **matches** when the port's value lies within max(0.01, 5% of
  JAX's) of that range: the gap is 0 inside it, else the distance to the
  nearer end, and the 5% is of that end;
* ``--shape early-stop``: every port run must also have stopped early;
  ``--shape peak-then-decline``: every port run must reach its best at an
  eval of epoch 10 or earlier, and its last eval must lie below that best.

The RNG streams of the two packages differ, so curves are compared in
distribution, never step by step. A log that was resumed (``--resume``
appends to it) is read as the run it became: at each ``resume`` event the
epochs and evals past the restored epoch are dropped, since the run
trained them again. Needs only ``json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
from typing import Dict, List, Optional

PEAK_BY_EPOCH = 10      # --shape peak-then-decline: best at or before it


@dataclasses.dataclass
class Run:
    path: str
    epochs: Dict[int, dict]      # epoch -> its `epoch` event
    evals: Dict[int, dict]       # epoch -> its `eval` event
    early_stop: Optional[int]    # epoch of the `early_stop` event
    resumes: int                 # `resume` events in the log

    @property
    def best(self) -> tuple:
        """(best recall, its first epoch); (nan, None) without evals."""
        if not self.evals:
            return float("nan"), None
        top = max(e["recall"] for e in self.evals.values())
        return top, min(k for k, e in self.evals.items()
                        if e["recall"] == top)

    @property
    def stop(self) -> Optional[int]:
        """The epoch it stopped at: its early stop, else its last epoch."""
        if self.early_stop is not None:
            return self.early_stop
        return max(self.epochs, default=None)

    @property
    def median_secs(self) -> Optional[float]:
        secs = [e["secs"] for e in self.epochs.values()
                if e.get("secs") is not None]
        return statistics.median(secs) if secs else None


def read_run(path: str) -> Run:
    epochs, evals, early_stop, resumes = {}, {}, None, 0
    with open(path) as f:
        for ln in f:
            if not ln.strip():
                continue
            ev = json.loads(ln)
            kind = ev.get("event")
            if kind == "resume":
                resumes += 1
                keep = ev["epoch"]
                epochs = {k: v for k, v in epochs.items() if k <= keep}
                evals = {k: v for k, v in evals.items() if k <= keep}
                if early_stop is not None and early_stop > keep:
                    early_stop = None
            elif kind == "epoch":
                epochs[ev["epoch"]] = ev
            elif kind == "eval":
                evals[ev["epoch"]] = ev
            elif kind == "early_stop":
                early_stop = ev["epoch"]
    return Run(path, epochs, evals, early_stop, resumes)


def shape_ok(run: Run, shape: Optional[str]) -> bool:
    if shape is None:
        return True
    if shape == "early-stop":
        return run.early_stop is not None
    if shape == "peak-then-decline":
        top, at = run.best
        last = run.evals[max(run.evals)]["recall"] if run.evals else top
        return at is not None and at <= PEAK_BY_EPOCH and last < top
    raise ValueError(f"unknown shape {shape!r}")


def verdict(port: List[Run], jax: List[Run],
            shape: Optional[str] = None) -> dict:
    """The rule of the module docstring, as a dict."""
    bests = [r.best[0] for r in port]
    value = statistics.fmean(bests)
    lo = min(r.best[0] for r in jax)
    hi = max(r.best[0] for r in jax)
    if value < lo:
        gap, end = lo - value, lo
    elif value > hi:
        gap, end = value - hi, hi
    else:
        gap, end = 0.0, value
    tol = max(0.01, 0.05 * end)
    shapes = [shape_ok(r, shape) for r in port]
    ok = gap <= tol and all(shapes)
    return {"verdict": "match" if ok else "mismatch", "port": value,
            "port_spread": (min(bests), max(bests)), "jax": (lo, hi),
            "gap": gap, "tol": tol, "shape": shape, "shape_ok": shapes}


def _f(x, fmt=".4f") -> str:
    return "-" if x is None else format(x, fmt)


def report(name: str, port: List[Run], jax: List[Run],
           shape: Optional[str] = None) -> str:
    out = [f"## {name}", "",
           "| run | side | epoch-1 cf_loss | epoch-1 kg_loss | best recall "
           "(epoch) | stop epoch | median epoch s | resumes |",
           "|---|---|---|---|---|---|---|---|"]
    for side, runs in (("port", port), ("jax", jax)):
        for r in runs:
            first = r.epochs.get(min(r.epochs, default=0), {})
            top, at = r.best
            early = " (early)" if r.early_stop is not None else ""
            out.append(f"| {r.path} | {side} | {_f(first.get('cf_loss'))} | "
                       f"{_f(first.get('kg_loss'))} | {top:.4f} ({at}) | "
                       f"{r.stop}{early} | {_f(r.median_secs, '.3f')} | "
                       f"{r.resumes} |")
    runs = port + jax
    common = sorted(set.intersection(*(set(r.evals) for r in runs)))
    out += ["", "| eval epoch | " + " | ".join(
        f"recall / ndcg, {os.path.basename(r.path)}" for r in runs) + " |",
        "|---|" + "---|" * len(runs)]
    for ep in common:
        out.append(f"| {ep} | " + " | ".join(
            f"{r.evals[ep]['recall']:.4f} / {r.evals[ep]['ndcg']:.4f}"
            for r in runs) + " |")
    v = verdict(port, jax, shape)
    spread = (f", spread {v['port_spread'][0]:.4f}-{v['port_spread'][1]:.4f}"
              if len(port) > 1 else "")
    out += ["", f"verdict: {v['verdict']} (port {v['port']:.4f}{spread}; "
            f"JAX {v['jax'][0]:.4f}-{v['jax'][1]:.4f}; gap {v['gap']:.4f}, "
            f"tolerance {v['tol']:.4f}; shape {shape or 'none'}: "
            f"{'ok' if all(v['shape_ok']) else 'not met'} "
            f"{v['shape_ok']})"]
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--name", default="runs")
    p.add_argument("--port", nargs="+", required=True,
                   help="the port's JSONL logs (one per seed)")
    p.add_argument("--jax", nargs="+", required=True,
                   help="kgat_tpu's JSONL logs")
    p.add_argument("--shape", choices=["early-stop", "peak-then-decline"],
                   default=None)
    a = p.parse_args(argv)
    port = [read_run(x) for x in a.port]
    jax = [read_run(x) for x in a.jax]
    print(report(a.name, port, jax, a.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
