"""The PyTorch port stands alone: importing every kgat_tpu_torch module
loads neither jax nor the JAX package (whose __init__ imports jax)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import kgat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kgat_tpu_torch.__path__,
                                               "kgat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kgat_tpu", "triton"))
print(len(names), leaked)
"""


def test_port_imports_without_jax():
    # -I: ignore PYTHONPATH and user site, so nothing preloads jax.
    proc = subprocess.run([sys.executable, "-I", "-c",
                           PROBE.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, leaked = proc.stdout.split(maxsplit=1)
    assert int(n_modules) >= 12, proc.stdout
    assert leaked.strip() == "[]", proc.stdout
