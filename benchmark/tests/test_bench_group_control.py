"""The partitioned cell's calibration in four processes on the CPU (gloo),
as ``calibrate.py`` runs it on four cards: every process drives each
seed's first steps, process 0 reads them; a second seed's readings from
the restarted trainer are a fresh run's; the program reads within the
cell's limits, and the control and the half batch do not."""

import json
import os
import subprocess
import sys
import textwrap

import tiny
from benchmark import checks

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import tiny
    from benchmark import calibrate
    root, out = sys.argv[3], sys.argv[4]
    seeds = [int(s) for s in sys.argv[5].split(",")]
    rank = int(os.environ["PROCESS_ID"])
    ctx = tiny.context(root, "tiny-train-p4", seed=seeds[0])
    ctx.rank = rank
    try:
        readings = calibrate.train(ctx, seeds, {seeds[-1]})
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"limits": ctx.limits, "readings": {
                    k: {str(s): v for s, v in r.items()}
                    for k, r in readings.items()}}, f)
    finally:
        dist.destroy_process_group()
""")


def _calibrate(tmp_path, seeds: str) -> dict:
    root = tiny.make_root(tmp_path / "root")
    out = str(tmp_path / "readings.json")
    here = os.path.dirname(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, repo, here, root, out, seeds],
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 COORDINATOR_ADDRESS=f"file://{tmp_path / 'rendezvous'}",
                 NUM_PROCESSES="4", PROCESS_ID=str(r),
                 KGAT_GROUP_TIMEOUT_S="120"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f)


def test_four_processes_calibrate(tmp_path):
    got = _calibrate(tmp_path / "two", "2147483653,17")
    limits, r = got["limits"], got["readings"]
    assert sorted(r["program"]) == ["17", "2147483653"]
    for seed, numbers in r["program"].items():
        assert checks.verdict(numbers, limits)[0], (seed, numbers)
    fresh = _calibrate(tmp_path / "one", "17")["readings"]["program"]["17"]
    assert r["program"]["17"] == fresh
    assert r["program"]["17"] != r["program"]["2147483653"]
    for kind in ("control", "half_batch"):
        (numbers,) = r[kind].values()
        assert not checks.verdict(numbers, limits)[0], (kind, numbers)
