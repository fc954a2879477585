"""One intra-op thread for torch in the port's CPU tests.

Every ``tests/test_torch_*.py`` that runs on the CPU imports this module.
The suite runs in several pytest-xdist workers at once, and torch's
intra-op pool takes every core in each of them, so the many small sparse
ops of these tests wait on an oversubscribed OpenMP pool: the chip_smoke
rehearsal, a few seconds alone, ran past its 240 s limit in a six-worker
run of the suite on 8 cores. Importing this module pins the test process
to one intra-op thread; subprocesses get :func:`one_thread_env`.
"""

import os

import torch

torch.set_num_threads(1)


def one_thread_env() -> dict:
    """This process's environment with OpenMP held to one thread."""
    return {**os.environ, "OMP_NUM_THREADS": "1"}
