#!/usr/bin/env python3
"""Profile the PyTorch port's training steps on a GPU with torch.profiler.

    python tools/profile_train_step.py [--steps 3] [--trace DIR] \
        [--n-devices P --halo-exchange allgather|ring \
         --ring-transport ppermute|dma|fused]

Builds the yelp2018-scale synthetic dataset (the repo's `make datasets`
numbers) and a Trainer at the reference recipe (d = k = 64, layers 64/32/16,
bi-interaction, CF batch 1024, KG batch 2048) on the kernel path, warms up,
then traces ``--steps`` CF steps, ``--steps`` KG steps and one attention
recompute. ``--n-devices P`` profiles the edge-partitioned trainer (P
partitions placed round-robin over the visible GPUs, so P = 4 share one
card) with the exchange and transport given. For each window it prints
the wall time per step (host clock around work ending in a synchronize,
without the profiler, and traced), the device time per step summed over
kernels, the device idle share against the untraced wall, the launches,
and the kernels by device time. With
``--trace``, it writes one Chrome trace per window there. Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import YELP2018  # noqa: E402
from kgat_tpu_torch import train  # noqa: E402
from kgat_tpu_torch.data import synthetic_dataset  # noqa: E402
from kgat_tpu_torch.utils.config import TrainConfig  # noqa: E402


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(name, fn, steps, trace_dir):
    """The window once without the profiler (its wall time, the step's),
    then traced: the profiler's own host work per launch slows a
    host-bound step, so the idle share is taken against the first."""
    wall_ms = _wall_ms(fn, steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_ms = _wall_ms(fn, steps)
    kernels = [(e.key, _device_us(e) / 1e3 / steps, e.count // steps)
               for e in _device_kernels(prof)]
    busy = sum(ms for _, ms, _ in kernels)
    print(f"== {name}: wall {wall_ms:.3f} ms per step ({traced_ms:.3f} "
          f"traced), device busy {busy:.3f} ms per step, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%, "
          f"{sum(n for _, _, n in kernels)} launches")
    for key, ms, n in sorted(kernels, key=lambda r: -r[1])[:15]:
        print(f"   {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--trace", default=None, help="directory for traces")
    p.add_argument("--n-devices", type=int, default=1)
    p.add_argument("--halo-exchange", default="allgather",
                   choices=["allgather", "ring"])
    p.add_argument("--ring-transport", default="ppermute",
                   choices=["ppermute", "dma", "fused"])
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    ds = synthetic_dataset(seed=0, name="yelp2018", **YELP2018)
    trainer = train.Trainer(TrainConfig(
        dataset="yelp2018", log_dir=None, seed=0, n_devices=a.n_devices,
        halo_exchange=a.halo_exchange, ring_transport=a.ring_transport),
        dataset=ds)
    print(f"partitions {trainer.n_parts}, exchange {a.halo_exchange}, "
          f"transport {a.ring_transport}")
    att = trainer.attention()
    cf = lambda: trainer.cf_step(att, *trainer.sample_cf())  # noqa: E731
    kg = lambda: trainer.kg_step(*trainer.sample_kg())  # noqa: E731
    for _ in range(3):
        cf()
        kg()
    profile("cf_step", cf, a.steps, a.trace)
    profile("kg_step", kg, a.steps, a.trace)
    profile("attention_recompute", trainer.attention, a.steps, a.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
