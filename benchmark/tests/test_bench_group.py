"""The partitioned cell's driver in four processes on the CPU (gloo), as
``launch.py`` runs it on four cards: the dropout masks drawn again from
each partition's generator and gathered, the window closed after the
same epoch everywhere, process 0's check; and with the exchange between
the processes left out, a run that reads not correct."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import tiny

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import tiny
    from benchmark import run
    root, out, fault = sys.argv[3], sys.argv[4], sys.argv[5]
    if fault == "exchange_left_out":
        from kgat_tpu_torch.parallel import multihost
        def local_only(x, group):
            n, r = dist.get_world_size(group), dist.get_rank(group)
            z = torch.zeros_like(x)
            return torch.cat([z] * r + [x] + [z] * (n - r - 1))
        multihost.all_gather = local_only
    rank = int(os.environ["PROCESS_ID"])
    ctx = tiny.context(root, "tiny-train-p4", trace=True)
    ctx.rank = rank
    try:
        result = run.drive(ctx)
        if rank == 0:
            line = run.result_line(ctx, result, {"platform": "cpu",
                                                 "kind": "cpu", "count": 4})
            with open(out, "w") as f:
                json.dump(line, f)
    finally:
        dist.destroy_process_group()
""")


def _group_run(tmp_path, fault: str) -> dict:
    root = tiny.make_root(tmp_path / "root")
    out = str(tmp_path / "line.json")
    here = os.path.dirname(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, repo, here, root, out, fault],
        env=dict(os.environ, OMP_NUM_THREADS="1", COORDINATOR_ADDRESS=rendezvous,
                 NUM_PROCESSES="4", PROCESS_ID=str(r),
                 KGAT_GROUP_TIMEOUT_S="60"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        errs.append(err)
        assert p.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("fault", ["none", "exchange_left_out"])
def test_four_processes(tmp_path, fault):
    line = _group_run(tmp_path, fault)
    assert line["correct"] is (fault == "none"), line["checks"]
    assert line["device"]["count"] == 4
