"""The benchmark's CPU tests: one intra-op thread per test process (the
suite may run in several workers at once), and the ``cuda`` marker's
fixture, which skips a test here that needs the card."""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
