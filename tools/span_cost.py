"""What a span and a count of ``kgat_tpu_torch.utils.trace`` cost on this
host: ns per empty host span, device span and count, with no profiler
and under ``torch.profiler``, less the empty loop's own cost. One JSON
line, with the card's name and power limit:

    python tools/span_cost.py [--n 200000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from kgat_tpu_torch.utils import trace  # noqa: E402


def _per_call_ns(fn, n: int) -> float:
    """Median over 7 passes of ns per call, less an empty loop's."""
    def loop(f):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            f()
        return (time.perf_counter_ns() - t0) / n
    empty = sorted(loop(lambda: None) for _ in range(7))[3]
    return sorted(loop(fn) for _ in range(7))[3] - empty


def measure(n: int, device: str) -> dict:
    tr = trace.Tracer()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.ones(1, device=dev)           # CUDA in use, as in a run

    def host():
        with tr.span("host"):
            pass

    def dev_span():
        with tr.span("device", device=dev):
            pass

    def count():
        tr.count("count")

    class Bare:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    bare = Bare()

    def with_only():
        with bare:
            pass

    out = {"host_span_ns": _per_call_ns(host, n),
           "count_ns": _per_call_ns(count, n),
           "device_span_ns": _per_call_ns(dev_span, n // 10),
           # What a span is made of: an empty ``with`` and the calls it
           # makes on entry (the clock is read twice).
           "parts_ns": {
               "empty_with": _per_call_ns(with_only, n),
               "clock": _per_call_ns(trace._now, n),
               "profiler_check": _per_call_ns(trace._profiling, n),
               "capture_check": _per_call_ns(
                   lambda: trace._cuda_in_use() and trace._stream_capturing(),
                   n)}}
    if dev.type == "cuda":
        # A process that made a CUDA graph (a trainer) asks CUDA
        # whether the stream captures on every span.
        torch.cuda.graph(torch.cuda.CUDAGraph())
        out["host_span_after_a_graph_ns"] = _per_call_ns(host, n)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["host_span_profiled_ns"] = _per_call_ns(host, n // 20)
    tr.summary()
    return out


def card() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": q.stdout.strip().splitlines()[:1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--device", default="cuda" if torch.cuda.is_available()
                   else "cpu")
    a = p.parse_args(argv)
    print(json.dumps({**card(), **measure(a.n, a.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
