#!/usr/bin/env python3
"""Run the trainer CLI with a timestamp on each of its start-up stages.

    python tools/time_train_stages.py <python -m kgat_tpu_torch.train flags>

Runs ``kgat_tpu_torch.train.main`` in this process and prints to stderr,
as ``[rank R t=SECONDS] enter|exit NAME``, the seconds since start at the
entry and exit of the stages a run goes through: the dataset build, the
samplers, the eval plan, the weights, the mesh, Adam's state (the first
CUDA work), the host partition and ring buckets, the process group's
first collectives and the K7/K8 links, the step captures, the epoch,
the evaluation, the checkpoints and the close. Under a multi-process
launch each process stamps its own lines (R is PROCESS_ID), e.g. four
processes on four cards:

    for i in 0 1 2 3; do COORDINATOR_ADDRESS=file:///tmp/grp \\
        NUM_PROCESSES=4 PROCESS_ID=$i python tools/time_train_stages.py \\
        --dataset yelp2018 --data-root DATA --epochs 1 --n-devices 4 \\
        --halo-exchange ring --ring-transport fused 2> stages$i.txt & done

SIGUSR1 prints every thread's Python stack, to find where a run waits.
"""

from __future__ import annotations

import faulthandler
import functools
import os
import signal
import sys
import time

# Seconds count from here: the imports of torch and the package too.
T0 = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch.distributed as dist  # noqa: E402

from kgat_tpu_torch import data, sampler, train  # noqa: E402
from kgat_tpu_torch.ops.hopper import remote_ring  # noqa: E402
from kgat_tpu_torch.parallel import halo, multihost  # noqa: E402

RANK = os.environ.get("PROCESS_ID", "0")


def stamp(msg: str) -> None:
    print(f"[rank {RANK} t={time.perf_counter() - T0:8.2f}] {msg}",
          file=sys.stderr, flush=True)


def wrap(owner, name: str, label: str) -> None:
    """Stamps the entry and exit of ``owner.name`` (a module's function or
    a class's method)."""
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def stamped(*args, **kwargs):
        stamp(f"enter {label}")
        out = fn(*args, **kwargs)
        stamp(f"exit  {label}")
        return out
    setattr(owner, name, stamped)


STAGES = [
    (data.Dataset, "build", "Dataset.build"),
    (sampler.CFSampleTable, "build", "CFSampleTable.build"),
    (sampler.KGSampleTable, "build", "KGSampleTable.build"),
    (train.evaluation, "make_eval_plan", "make_eval_plan"),
    (train.kgat, "init_params", "init_params"),
    (train.dp, "make_mesh", "make_mesh"),
    (train, "make_optimizer", "make_optimizer"),
    (train, "partition_graph", "partition_graph"),
    (train, "build_ring_buckets", "build_ring_buckets"),
    (halo.Partitioned, "__init__", "Partitioned.__init__"),
    (remote_ring.ProcessRing, "__init__", "ProcessRing.__init__"),
    (dist, "all_gather_object", "all_gather_object"),
    (multihost, "barrier", "barrier"),
    (train.StepGraph, "capture", "StepGraph.capture"),
    (train.Trainer, "__init__", "Trainer.__init__"),
    (train.Trainer, "train_one_epoch", "Trainer.train_one_epoch"),
    (train.Trainer, "evaluate", "Trainer.evaluate"),
    (train.Trainer, "_save_ckpt", "Trainer._save_ckpt"),
    (train.Trainer, "close", "Trainer.close"),
]


def main(argv=None) -> int:
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    for owner, name, label in STAGES:
        wrap(owner, name, label)
    stamp("start")
    train.main(sys.argv[1:] if argv is None else argv)
    stamp("main returned")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
