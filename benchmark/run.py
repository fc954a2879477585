"""One run of one benchmark cell of the PyTorch/CUDA port of KGAT.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the mix's
``kind`` picks the driver (``train_cell`` or ``serve_cell``), and a mix
with ``processes`` > 1 runs one process per card (``launch.py``). Set-up
runs from the process's start until the window opens; the window
measures for ``--seconds``; then the outputs are held to the reference
(``checks.py``) and one JSON line is printed as the last line of
standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``. The numbers compared, each beside
its limit, end standard error and the line.

It needs CUDA and as many cards as the cell asks for, and exits with 2
and no result line otherwise; it exits with 3 and no result if JAX or
the JAX package was loaded into this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List  # noqa: E402

from benchmark.spec import Spec  # noqa: E402

# Top-level module names the port must not load.
FORBIDDEN = ("jax", "jaxlib", "flax", "kgat_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``kgat_tpu_torch`` is not ``kgat_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env(spec: Spec) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port's kernel library builds into its own ``ops/hopper/build``."""
    cache = spec.cache_dir()
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


class Stages:
    """Set-up's stages, each as seconds since the process started."""

    def __init__(self, t0: float):
        self.t0, self.marks = t0, {}

    def mark(self, name: str) -> None:
        self.marks[name] = time.perf_counter() - self.t0


class Context:
    """What a driver needs of the run."""

    def __init__(self, spec: Spec, cell: str, seed: int, seconds: float,
                 trace: bool, device, t0: float = T0, rank: int = 0):
        from benchmark import reference
        self.spec, self.cell, self.seed = spec, cell, seed
        self.seconds, self.trace, self.rank = seconds, trace, rank
        self.workload = spec.workload(cell)
        self.config = spec.config(self.workload["config"])
        self.traffic = spec.traffic(self.workload["traffic"])
        self.limits = spec.limits(cell)
        self.device = device
        self.cache_dir = spec.cache_dir()
        self.precision = reference.precision_of(self.config["model"])
        self.stages = Stages(t0)
        self.setup_s = None

    def window_open(self) -> None:
        """Set-up ends: what it made is collected once and left out of
        the window's garbage collections, which then scan only what the
        window allocates."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.stages.t0

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def drive(ctx: Context) -> Dict:
    """The driver's result for the cell's traffic kind."""
    kind = ctx.traffic["kind"]
    if kind == "train":
        from benchmark import train_cell
        return train_cell.run(ctx)
    if kind == "serve":
        from benchmark import serve_cell
        return serve_cell.run(ctx)
    raise ValueError(f"unknown traffic kind {kind!r}")


def metrics(ctx: Context, out: Dict) -> Dict:
    """The cell's end-to-end metrics (untraced) or its per-layer ones
    (traced), each read where the benchmark names it; a reader that finds
    nothing to read leaves its metric out."""
    spec, cell = ctx.spec, ctx.cell
    result = {}
    if not ctx.trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in spec.end_to_end(cell):
            result[m["name"]] = {"value": values[m["name"]],
                                 "unit": m["unit"]}
        return result
    run = {"cell": cell, "model": ctx.config["model"],
           "train": ctx.config["train"], "sizes": out.get("sizes", {}),
           "window": out["window"], "spans": out["spans"],
           "steps": out.get("steps", {}), "devices": out["devices"]}
    for m in spec.per_layer(cell):
        value = spec.reader(m["name"])(run)
        if value is not None:
            result[m["name"]] = {"value": value, "unit": m["unit"]}
    return result


def result_line(ctx: Context, out: Dict, device_info: Dict) -> Dict:
    from benchmark import checks
    correct, compared = checks.verdict(out["numbers"], ctx.limits)
    device = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics(ctx, out),
            "device": device}
    if ctx.trace:
        devs = out["devices"]
        device["busy_s"] = sum(d["busy_s"] for d in devs) / len(devs)
        device["window_s"] = sum(d["window_s"] for d in devs) / len(devs)
        line["breakdown"] = devs[0]["breakdown"]
        if len(devs) > 1:
            # Each card's own busy and traced seconds, process 0's first.
            line["processes"] = [{"busy_s": d["busy_s"],
                                  "window_s": d["window_s"]} for d in devs]
    line["window"] = {k: v for k, v in out["window"].items()}
    line["setup_stages"] = ctx.stages.marks
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in compared}
    return line


def device_info(n: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by launch.py on the processes it starts: this process's rank.
    p.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    spec = Spec()
    cache_env(spec)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        return 2
    workload = spec.workload(a.workload)
    chips = int(workload["chips"])
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {a.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    procs = int(spec.traffic(workload["traffic"]).get("processes", 1))
    if a.process_id is not None:
        from benchmark import launch
        return launch.worker(spec, a, T0)
    if procs > 1:
        from benchmark import launch
        out, ctx = launch.leader(spec, a, procs, T0)
    else:
        ctx = Context(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                      torch.device("cuda", 0))
        ctx.stages.mark("import")
        out = drive(ctx)
    line = result_line(ctx, out, device_info(procs))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"setup_stages_s": ctx.stages.marks}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
