#!/usr/bin/env python3
"""Profile the PyTorch port's training steps on a GPU with torch.profiler.

    python tools/profile_train_step.py [--steps 3] [--trace DIR] [--epoch] \
        [--sparse-adam] [--n-devices N --halo-exchange allgather|ring|a2a \
         --ring-transport ppermute|dma|fused --dp-replicas D]

Builds the yelp2018-scale synthetic dataset (the repo's `make datasets`
numbers) and a Trainer at the reference recipe (d = k = 64, layers 64/32/16,
bi-interaction, CF batch 1024, KG batch 2048) on the kernel path, warms up,
then traces ``--steps`` eager CF steps and ``--steps`` eager KG steps, the
same steps replayed from the trainer's CUDA graphs (``train.StepGraph``),
and one attention recompute. ``--n-devices N`` profiles the
edge-partitioned trainer (N partitions placed round-robin over the
visible GPUs, so N = 4 share one card; ``--dp-replicas D`` as D rows of
N / D) with the exchange and transport given; its steps replay CUDA
graphs when its partitions share one card, and run eagerly only
otherwise. For each window it prints the wall time per step
(host clock around work ending in a synchronize, without the profiler,
and traced), the device time per step summed over kernels, the device
idle share against the untraced wall, the launches (for a replay, the
kernel nodes of its graph) and the kernels by device time. ``--epoch``
then times one epoch of eager steps (the trainer's steps called one by
one, uncaptured) and one replayed epoch (``Trainer.train_one_epoch``),
each with its attention recompute. ``--sparse-adam`` profiles the
trainer with the lazy KG step. With ``--trace``, it writes one Chrome
trace per window there. It also splits one eager CF step and one eager
KG step by source: each kernel's device time by what launched it
(``zero_grad``, Adam's ops, each autograd node of the backward, the
forward's ops), and for each kernel of the replayed steps the sources
that launch a kernel of that name. Needs CUDA.

Under the environment of a multi-process launch (COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID; ``kgat_tpu_torch/parallel/multihost.py``),
one process per card, each process profiles its own card: its share of
every step (its partitions, the collectives between the processes and
the gradient all-reduce, captured in the replayed steps), and prints its
lines prefixed with its rank. One host, four cards:

    for i in 0 1 2 3; do COORDINATOR_ADDRESS=localhost:29500 \
        NUM_PROCESSES=4 PROCESS_ID=$i python tools/profile_train_step.py \
        --n-devices 4 --halo-exchange ring --ring-transport fused & done; wait
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import YELP2018, graph_kernel_names  # noqa: E402
from kgat_tpu_torch import train  # noqa: E402
from kgat_tpu_torch.data import synthetic_dataset  # noqa: E402
from kgat_tpu_torch.parallel import multihost  # noqa: E402
from kgat_tpu_torch.utils.config import TrainConfig  # noqa: E402

_TAG = ""   # "[process r of W] " under a process group
# Under a process group, steps untraced in a window: the processes move in
# lock step, so a short window would time their start skew, not the step.
GROUP_WALL_STEPS = 100


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _device_kernels(prof):
    """The kernels, copies and fills that ran on the card. CPU-side ops
    and autograd functions also carry their kernels' time, and so do the
    ranges the profiler mirrors onto the device timeline under their
    names: those keys are left out."""
    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in host and not e.key.startswith("Activity Buffer")]


def _wall_ms(fn, steps) -> float:
    """Host ms per call over ``steps`` calls, from a barrier under a
    process group."""
    torch.cuda.synchronize()
    if dist.is_initialized():
        multihost.barrier(torch.cuda.current_device())
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(name, fn, steps, trace_dir, graph=None):
    """The window once without the profiler (its wall time, the step's;
    ``GROUP_WALL_STEPS`` steps under a process group), then traced: the profiler's own host work per launch slows a
    host-bound step, so the idle share is taken against the first.
    ``graph``: the StepGraph that ``fn`` replays, whose kernel nodes are
    the step's launches."""
    wall_ms = _wall_ms(fn, GROUP_WALL_STEPS if dist.is_initialized()
                       else steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_ms = _wall_ms(fn, steps)
    kernels = [(e.key, _device_us(e) / 1e3 / steps, e.count // steps)
               for e in _device_kernels(prof)]
    busy = sum(ms for _, ms, _ in kernels)
    # NCCL's kernels run from the collective's start to its end, waiting
    # for the peers: their time is the card's share of the exchange, not
    # of its own work.
    nccl = sum(ms for key, ms, _ in kernels if "nccl" in key.lower())
    launches = sum(n for _, _, n in kernels)
    if graph is not None:
        launches = (f"{len(graph_kernel_names(graph.graph.raw_cuda_graph()))}"
                    f" kernel nodes in the graph ({launches} in the trace)")
    comm = (f" (NCCL kernels {nccl:.3f} ms of it; busy without them "
            f"{busy - nccl:.3f} ms, idle {100 * (1 - (busy - nccl) / wall_ms):.1f}"
            f"%)" if nccl else "")
    print(f"{_TAG}== {name}: wall {wall_ms:.3f} ms per step ({traced_ms:.3f} "
          f"traced), device busy {busy:.3f} ms per step, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%{comm}, {launches} launches")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:15]:
        print(f"{_TAG}   {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        rank = multihost.world()[0]
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{name}.rank{rank}.json"))


_ENGINE = "autograd::engine::evaluate_function: "


def _source(evt) -> str:
    """Where a CPU op of the profile comes from: the optimizer's
    ``zero_grad`` or ``step`` (with its outermost op, one of Adam's), the
    outermost autograd node of the backward, or the forward's outermost
    op."""
    chain = []
    while evt is not None:
        chain.append(evt.name)
        evt = evt.cpu_parent
    for name in reversed(chain):
        if name.startswith("Optimizer.zero_grad"):
            return "zero_grad"
        if name.startswith("Optimizer.step"):
            ops = chain[:chain.index(name)]
            return f"adam {ops[-1] if ops else ''}"
        if name.startswith(_ENGINE):
            return f"backward {name[len(_ENGINE):]}"
    return f"forward {chain[-1]}"


def by_source(name, fn) -> dict:
    """One traced call of ``fn`` (an eager step): each kernel's device ms
    by (source, launching op, kernel name), printed largest first, and
    summed by source. Returns {kernel name: set of sources}."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows, names = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in getattr(evt, "kernels", []):
            key = (_source(evt), evt.name, k.name)
            n, us = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, us + k.duration)
            names.setdefault(k.name, set()).add(key[0])
    # Kernels the profile links to no CPU op (some launched through
    # ctypes): their launches and time by name, less what was linked.
    linked = {}
    for (_, _, kname), (n, us) in rows.items():
        c, t = linked.get(kname, (0, 0.0))
        linked[kname] = (c + n, t + us)
    for e in _device_kernels(prof):
        c, t = linked.get(e.key, (0, 0.0))
        if _device_us(e) - t > 0.5:
            rows[("(no CPU op)", "", e.key)] = (e.count - c,
                                                _device_us(e) - t)
            names.setdefault(e.key, set()).add("(no CPU op)")
    total = sum(us for _, us in rows.values())
    print(f"{_TAG}== {name} by source: {total / 1e3:.3f} device ms, "
          f"{sum(n for n, _ in rows.values())} kernels")
    sums = {}
    for (src, _, _), (n, us) in rows.items():
        c, t = sums.get(src, (0, 0.0))
        sums[src] = (c + n, t + us)
    for src, (n, us) in sorted(sums.items(), key=lambda r: -r[1][1]):
        print(f"{_TAG}   {us / 1e3:9.4f} ms  x{n:<4d} {src}")
    for (src, op, kname), (n, us) in sorted(rows.items(),
                                            key=lambda r: -r[1][1]):
        print(f"{_TAG}     {us / 1e3:9.4f} ms  x{n:<4d} {src} | {op} | "
              f"{kname[:90]}")
    return names


def replay_sources(name, fn, names, graph) -> None:
    """One traced replay: its kernels by name, with the sources that
    launch a kernel of that name in the eager step (``by_source``)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, _device_us(e) / 1e3, e.count)
               for e in _device_kernels(prof)]
    nodes = len(graph_kernel_names(graph.graph.raw_cuda_graph()))
    print(f"{_TAG}== {name} replayed by source: "
          f"{sum(ms for _, ms, _ in kernels):.3f} device ms, {nodes} kernel "
          f"nodes")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1]):
        src = "; ".join(sorted(names.get(key, {"(not in the eager step)"})))
        print(f"{_TAG}   {ms:9.4f} ms  x{n:<4d} {key[:80]} <- {src}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default=None, help="directory for traces")
    p.add_argument("--epoch", action="store_true",
                   help="also time an eager and a replayed epoch")
    p.add_argument("--sparse-adam", action="store_true",
                   help="the lazy row-sparse Adam KG step")
    p.add_argument("--n-devices", type=int, default=1)
    p.add_argument("--dp-replicas", type=int, default=1)
    p.add_argument("--halo-exchange", default="allgather",
                   choices=["allgather", "ring", "a2a"])
    p.add_argument("--ring-transport", default="ppermute",
                   choices=["ppermute", "dma", "fused"])
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    multihost.initialize_distributed(device="cuda")
    try:
        return _main(a)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(a) -> int:
    global _TAG
    rank, n_procs = multihost.world()
    dev = multihost.process_device("cuda", rank)
    if n_procs > 1:
        _TAG = f"[process {rank} of {n_procs}, {dev}] "
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{_TAG}{smi}")
    ds = synthetic_dataset(seed=0, name="yelp2018", **YELP2018)
    trainer = train.Trainer(TrainConfig(
        dataset="yelp2018", log_dir=None, seed=0, n_devices=a.n_devices,
        dp_replicas=a.dp_replicas, halo_exchange=a.halo_exchange,
        ring_transport=a.ring_transport, sparse_adam=a.sparse_adam),
        dataset=ds)
    print(f"{_TAG}dp rows {trainer.dp_replicas} of {trainer.n_parts} partitions, "
          f"exchange {a.halo_exchange}, transport {a.ring_transport}, "
          f"sparse Adam {a.sparse_adam}; steps captured {trainer.captured} "
          f"({trainer.capture_why})")
    att = trainer.attention()
    cf = lambda: trainer.cf_step(att, *trainer.sample_cf())  # noqa: E731
    kg = lambda: trainer.kg_step(*trainer.sample_kg())  # noqa: E731
    for _ in range(3):
        cf()
        kg()
    profile("cf_step", cf, a.steps, a.trace)
    profile("kg_step", kg, a.steps, a.trace)
    sources = {"cf": by_source("cf_step", cf), "kg": by_source("kg_step", kg)}
    if trainer.captured:
        trainer.stage(att)
        for steps in (trainer.cf_steps, trainer.kg_steps):
            steps.capture()
            for _ in range(3):
                steps.replay()
        replay_sources("cf_step", trainer.cf_steps.replay, sources["cf"],
                       trainer.cf_steps)
        replay_sources("kg_step", trainer.kg_steps.replay, sources["kg"],
                       trainer.kg_steps)
        profile("cf_step_replayed", trainer.cf_steps.replay, a.steps,
                a.trace, trainer.cf_steps)
        profile("kg_step_replayed", trainer.kg_steps.replay, a.steps,
                a.trace, trainer.kg_steps)
    profile("attention_recompute", trainer.attention, a.steps, a.trace)
    if a.epoch and trainer.captured:
        def eager_epoch():
            att = trainer.attention()
            for _ in range(trainer.n_cf_batches):
                trainer.cf_step(att, *trainer.sample_cf())
            for _ in range(trainer.n_kg_batches):
                trainer.kg_step(*trainer.sample_kg())

        for what, fn in (("eager", eager_epoch),
                         ("replayed", trainer.train_one_epoch)):
            print(f"{_TAG}== epoch, {what} steps ({trainer.n_cf_batches} CF, "
                  f"{trainer.n_kg_batches} KG, one attention recompute): "
                  f"{_wall_ms(fn, 1) / 1e3:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
