"""The PyTorch port stands alone: importing every kgat_tpu_torch module,
the partitioned trainer's (``parallel``, its multi-process module too),
the ring kernels', the explain CLI's (which keeps its own ``node_kind``
and ``rel_kind``), the native host layer's (which builds nothing at
import) and the bench's (``bench``, ``bench_attention``, which keep their
own copy of ``bench.py``'s presets) included, and the multi-process test
workers (``tests/torch_mp_worker.py``, ``tests/torch_cuda_mp_worker.py``),
loads neither jax nor the JAX package (whose __init__ imports jax) nor
the repository's ``bench.py`` and ``bench_attention.py``."""

import os
import subprocess
import sys

import torch_threads  # one intra-op thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import kgat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kgat_tpu_torch.__path__,
                                               "kgat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {tests!r})
import torch_mp_worker, torch_cuda_mp_worker
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kgat_tpu", "triton",
                                       "bench", "bench_attention"))
missing = {{"kgat_tpu_torch.parallel.partition", "kgat_tpu_torch.parallel.dp",
           "kgat_tpu_torch.parallel.halo",
           "kgat_tpu_torch.parallel.multihost",
           "kgat_tpu_torch.ops.hopper.remote_ring",
           "kgat_tpu_torch.explain", "kgat_tpu_torch.native",
           "kgat_tpu_torch.bench",
           "kgat_tpu_torch.bench_attention"}} - set(names)
# The native host layer builds and loads its library at first use only.
from kgat_tpu_torch import native
assert native.library.cache_info().currsize == 0
print(len(names), sorted(missing), leaked)
"""


def test_port_imports_without_jax():
    # -I: ignore PYTHONPATH and user site, so nothing preloads jax.
    proc = subprocess.run([sys.executable, "-I", "-c",
                           PROBE.format(repo=REPO,
                                                        tests=os.path.join(
                                                            REPO, "tests"))],
                          capture_output=True, text=True, timeout=120,
                          env=torch_threads.one_thread_env())
    assert proc.returncode == 0, proc.stderr
    n_modules, rest = proc.stdout.split(maxsplit=1)
    assert int(n_modules) >= 31, proc.stdout
    assert rest.strip() == "[] []", proc.stdout
