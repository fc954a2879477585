"""One process per card for a traffic mix with ``processes`` > 1.

The run's own process is process 0: it starts processes 1 .. W - 1 as
``python -m benchmark.run`` with the same arguments and its rank, in the
environment of the port's multi-process launch
(``kgat_tpu_torch/parallel/multihost.py``: COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID), with the rendezvous file in a directory of
its own under ``TMPDIR``. Every process runs the same driver on its own
card; process 0 gathers the others' device readings and prints the one
line. A peer's ``destroy_process_group()`` returns only with process 0's,
so process 0 ends its group as soon as its own work is done, and only
then waits for the peers. A collective that waits past
``GROUP_TIMEOUT_S`` for a peer fails its process (the port's
``KGAT_GROUP_TIMEOUT_S``), and process 0 ends any peer still running
``PEER_GRACE_S`` after its group has ended, so a peer that hangs fails
the run within a time limit. NCCL's shared-memory transport is off
(``NCCL_SHM_DISABLE``), so nothing is written to ``/dev/shm``: the cards
of one host talk over NVLink. ``calibrate.py`` forms its groups the same
way (:func:`group`).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

GROUP_TIMEOUT_S = 60
PEER_GRACE_S = 60


def _group_env(rank: int, world: int, coordinator: str,
               timeout_s: float = GROUP_TIMEOUT_S) -> dict:
    return {"COORDINATOR_ADDRESS": coordinator, "NUM_PROCESSES": str(world),
            "PROCESS_ID": str(rank), "KGAT_GROUP_TIMEOUT_S": str(timeout_s),
            "NCCL_SHM_DISABLE": "1"}


def _end_group() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def group(spec, argv, world: int, timeout_s: float = GROUP_TIMEOUT_S):
    """This process as process 0 of ``world``: starts processes 1 .. W - 1
    as ``argv --process-id r`` and runs the body; then ends its group and
    waits for them, raising if one exits non-zero, and kills any still
    running ``PEER_GRACE_S`` later."""
    tmp = tempfile.mkdtemp(prefix="kgat-bench-group-",
                           dir=os.environ.get("TMPDIR"))
    coordinator = "file://" + os.path.join(tmp, "rendezvous")
    os.environ.update(_group_env(0, world, coordinator, timeout_s))
    peers = [subprocess.Popen(
        argv + ["--process-id", str(r)], cwd=spec.root,
        env=dict(os.environ, **_group_env(r, world, coordinator, timeout_s)),
        stdout=subprocess.DEVNULL) for r in range(1, world)]
    try:
        yield
        _end_group()
        deadline = time.monotonic() + PEER_GRACE_S
        for p in peers:
            code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if code != 0:
                raise RuntimeError(f"a peer process exited with {code}")
    finally:
        for p in peers:
            if p.poll() is None:
                p.kill()
                p.wait()
        _end_group()
        shutil.rmtree(tmp, ignore_errors=True)


def leader(spec, a, world: int, t0: float):
    """Process 0: starts the peers, runs its own share, ends its group,
    then waits for them. Returns (``run.drive``'s result, context)."""
    import torch
    from benchmark import run
    argv = [sys.executable, "-m", "benchmark.run", "--workload", a.workload,
            "--seed", str(a.seed), "--seconds", str(a.seconds),
            "--trace", str(a.trace)]
    with group(spec, argv, world):
        ctx = run.Context(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                          torch.device("cuda", 0), t0=t0, rank=0)
        out = run.drive(ctx)
    return out, ctx


def worker(spec, a, t0: float) -> int:
    """Process ``a.process_id`` of the group: its share of the run."""
    import torch
    from benchmark import run
    try:
        ctx = run.Context(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                          torch.device("cuda", a.process_id), t0=t0,
                          rank=a.process_id)
        run.drive(ctx)
    finally:
        _end_group()
    return 0
