"""The readings a cell's limits are set from, on the chip, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out FILE]

Set-up runs once. For each seed the program runs as a benchmark run's
set-up and check would (fresh seeded weights, Adam's state zeroed and
the generators seeded, for training; a fresh weight set and the traffic's
requests, for serving) and its compared numbers are read against the
reference: the lower readings. On each control seed the reference one
step down in precision (``reference.Precision.lower``) takes the
program's place; for training also the reference with half of each
batch left out (its weight set to 0, the mean over the rest). Prints,
and writes to ``--out``, every reading and, for each number, the largest
of the program's and the smallest of each stand-in's.

A cell whose traffic has ``processes`` > 1 runs here as it does in a
benchmark run, one process per card (``launch.group``): every process
drives its share of each seed's first steps, and process 0 alone reads
the reference, the control and the fault, while the others wait for it.

The benchmark's runs never run this; its readings and the limits set
from them are in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import checks, launch, reference, run, train_cell, weights
from benchmark.spec import Spec


# A group's peers wait this long for process 0's readings of a seed.
GROUP_TIMEOUT_S = 1800


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def _summary(readings: dict) -> dict:
    """{number: max over seeds} per kind of run."""
    out = {}
    for kind, by_seed in readings.items():
        keys = sorted({k for v in by_seed.values() for k in v})
        agg = min if kind in ("control", "half_batch",
                              "change_worst_control") else max
        out[kind] = {k: agg(v[k] for v in by_seed.values() if k in v)
                     for k in keys}
    return out


def train(ctx, seeds, control_seeds) -> dict:
    s = train_cell.setup(ctx, ctx.stages.mark)
    t, data = s["trainer"], s["data"]
    lead = ctx.rank == 0
    g = (train_cell.reference_graph(data, ctx.config["model"], ctx.device)
         if lead else None)
    shapes = weights.leaf_shapes(ctx.config["model"], data.n_nodes,
                                 data.n_relations)
    readings = {"program": {}, "control": {}, "half_batch": {},
                "reference_again": {}, "change_worst": {},
                "change_worst_control": {}}
    for i, seed in enumerate(seeds):
        if i == 0 and seed == ctx.seed:
            first, init = s["first"], s["init"]
        else:
            init = weights.make(seed, 0, shapes, t.device)
            _restart(t, init, seed)
            first = train_cell.FirstSteps(t)
            first.run()
        if lead:
            _read(ctx, data, first, init, g, seed, seed in control_seeds,
                  readings)
        if t.grouped:
            from kgat_tpu_torch.parallel import multihost
            multihost.barrier(t.device)
    # Every process drops its captured steps before its group ends, as a
    # benchmark run does (``train_cell.free``).
    del t
    train_cell.free(s)
    return readings


def _restart(t, init, seed) -> None:
    """The trainer as a fresh run of ``seed`` would start its first steps:
    its weights, Adam's state zeroed, its generators seeded as
    ``train_cell.trainer_config`` and the trainer seed them."""
    weights.copy_into(t.model, init)
    for st in t.opt.state.values():
        for v in st.values():
            v.zero_()
    base = weights.derive(seed, 1)
    t.generator.manual_seed(base)
    for i, gen in enumerate(t.part_generators):
        if gen is not None:
            gen.manual_seed(base + 1 + i)


def _read(ctx, data, first, init, g, seed, control: bool,
          readings) -> None:
    """One seed's readings: the program's, and on a control seed the
    control's, the fault's and the reference's against itself."""
    readings["program"][seed] = train_cell.compare(ctx, data, first, init, g)
    ref = train_cell.follow(ctx, data, first, init, g, ctx.precision)
    _leaves(seed, first, ref, init)
    print(f"seed {seed} loss gap by step: " + ", ".join(
        f"{k} {abs(a - b) / abs(b):.3g} (loss {b:.6g})" for k, a, b in zip(
            train_cell.CHECK_STEPS, first.losses, ref["losses"])),
        file=sys.stderr, flush=True)
    prog = {"params": first.params}
    readings["change_worst"][seed] = {
        "change_worst_gap": checks.change_gaps(prog, ref, init)["worst"]}
    if not control:
        return
    again = train_cell.follow(ctx, data, first, init, g, ctx.precision)
    readings["reference_again"][seed] = checks.train_numbers(
        again, ref, init)
    low = train_cell.follow(ctx, data, first, init, g,
                            ctx.precision.lower())
    readings["control"][seed] = checks.train_numbers(low, ref, init)
    readings["change_worst_control"][seed] = {
        "change_worst_gap": checks.change_gaps(low, ref, init)["worst"]}
    half = _Half(first)
    cut = train_cell.follow(ctx, data, half, init, g, ctx.precision)
    readings["half_batch"][seed] = checks.train_numbers(cut, ref, init)
    print(f"seed {seed}: {readings['program'][seed]} control "
          f"{readings['control'][seed]} half "
          f"{readings['half_batch'][seed]}", file=sys.stderr, flush=True)


def _leaves(seed, first, ref, init) -> None:
    """The three worst leaves of the first gradient and of the change."""
    grad = checks.leaf_gaps(first.first_grad, ref["first_grad"])
    delta = lambda p: {k: p[k] - init[k] for k in init}  # noqa: E731
    change = checks.leaf_gaps(delta(first.params), delta(ref["params"]))
    norms = {k: float(v.double().norm()) for k, v in ref["first_grad"].items()}
    for name, gaps in (("grad", grad), ("change", change)):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        print(f"seed {seed} {name} worst leaves: "
              + ", ".join(f"{k} {v:.3g} (grad norm {norms[k]:.3g})"
                          for k, v in top), file=sys.stderr, flush=True)


class _Half:
    """The first steps' record with each batch's second half weighted 0."""

    def __init__(self, first):
        self.masks = first.masks
        self.batches = []
        for b in first.batches:
            w = b[-1].clone()
            w[w.shape[0] // 2:] = 0.0
            self.batches.append(tuple(b[:-1]) + (w,))


def serve(ctx, seeds, control_seeds) -> dict:
    from benchmark import serve_cell
    s = serve_cell.setup(ctx, ctx.stages.mark)
    data, rec, model = s["data"], s["rec"], s["model"]
    mc, dev, k = ctx.config["model"], ctx.device, ctx.traffic["k"]
    g = train_cell.reference_graph(data, mc, dev)
    shapes = weights.leaf_shapes(mc, data.n_nodes, data.n_relations)
    ptr, items = data.train_items
    ptr_t = torch.as_tensor(ptr, device=dev)
    items_t = torch.as_tensor(items, device=dev)
    readings = {"program": {}, "control": {}}
    for seed in seeds:
        w = weights.make(seed, 100, shapes, dev)
        weights.copy_into(model, w)
        rec.refresh()
        reqs = serve_cell.Requests(ctx.traffic, data.user_activity(), seed)
        pick = reqs.pick.choice(reqs.sizes.size,
                                size=ctx.traffic["check_requests"],
                                replace=False).tolist()
        pick.append(int(reqs.sizes.argmax()))
        asks = [reqs.users(i) for i in pick]
        emb = reference.serve_embed(w, g, mc, ctx.precision)
        low = (reference.serve_embed(w, g, mc, ctx.precision.lower())
               if seed in control_seeds else None)
        prog, ctrl = {}, {}
        for users in asks:
            got_i, got_s = rec.recommend(users, k=k)
            u = torch.as_tensor(users, device=dev)
            ref = reference.scores(emb, u, data.n_entities, data.n_items,
                                   ptr_t, items_t, ctx.precision)
            for key, v in checks.serve_numbers(got_i, got_s, ref).items():
                prog[key] = max(prog.get(key, 0.0), v)
            if low is not None:
                lo = reference.scores(low, u, data.n_entities, data.n_items,
                                      ptr_t, items_t, ctx.precision.lower())
                top = torch.topk(lo, k, dim=1)
                for key, v in checks.serve_numbers(
                        top.indices.cpu().numpy(),
                        top.values.cpu().numpy(), ref).items():
                    ctrl[key] = max(ctrl.get(key, 0.0), v)
        readings["program"][seed] = prog
        if low is not None:
            readings["control"][seed] = ctrl
        print(f"seed {seed}: {prog} control {ctrl}", file=sys.stderr,
              flush=True)
    return readings


def calibrate(spec, a, rank: int) -> int:
    """This process's part: all of it, or its share of a group's."""
    seeds, control = _seeds(a.seeds), set(_seeds(a.control_seeds))
    ctx = run.Context(spec, a.workload, seeds[0], 16.0, False,
                      torch.device("cuda", rank), rank=rank)
    t0 = time.perf_counter()
    kind = ctx.traffic["kind"]
    readings = (train if kind == "train" else serve)(ctx, seeds, control)
    if rank != 0:
        return 0
    out = {"workload": a.workload, "seconds": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0),
           "readings": {k: {str(s): v for s, v in r.items()}
                        for k, r in readings.items()},
           "summary": _summary(readings)}
    text = json.dumps(out, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(json.dumps(out["summary"]))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    # Set by launch.group on the processes it starts: this process's rank.
    p.add_argument("--process-id", type=int, default=None,
                   help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    a = p.parse_args(argv)
    spec = Spec()
    run.cache_env(spec)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    procs = int(spec.traffic(spec.workload(a.workload)["traffic"])
                .get("processes", 1))
    if torch.cuda.device_count() < procs:
        print(f"calibrate: {a.workload} needs {procs} cards", file=sys.stderr)
        return 2
    if a.process_id is not None:
        try:
            return calibrate(spec, a, a.process_id)
        finally:
            launch._end_group()
    if procs > 1:
        with launch.group(spec, [sys.executable, "-m", "benchmark.calibrate",
                                 *argv], procs, GROUP_TIMEOUT_S):
            return calibrate(spec, a, 0)
    return calibrate(spec, a, 0)


if __name__ == "__main__":
    sys.exit(main())
