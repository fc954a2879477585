"""Nothing the card path runs loads JAX or the JAX package, and the
harness refuses to run without a card."""

import os
import subprocess
import sys
import textwrap

from benchmark import run
from benchmark.spec import ROOT

# A process in which importing jax, jaxlib, flax or kgat_tpu raises, that
# drives a tiny training and serving run and prints what it loaded.
PROBE = textwrap.dedent("""
    import importlib.abc, sys
    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "kgat_tpu"):
                raise ImportError(f"{name} may not be imported")
    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import pathlib, tempfile, torch
    torch.set_num_threads(1)
    import tiny
    from benchmark import run
    root = tiny.make_root(pathlib.Path(tempfile.mkdtemp()))
    for cell in sorted(tiny.CELLS):
        assert tiny.drive(root, cell, trace=True)["correct"]
    import benchmark.calibrate, benchmark.launch
    print("LOADED", run.forbidden_modules())
""")


def test_the_card_path_loads_no_jax(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", PROBE, ROOT,
                        os.path.dirname(__file__)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "kgat_tpu_torch.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kgat_tpu.data", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "kgat_tpu"]


def test_without_a_card_it_exits_with_no_result(tmp_path):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "yelp2018-train", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
