"""The partition map, and the data-parallel KG phase.

Port of ``kgat_tpu/parallel/dp.py`` for one process. JAX runs one program
per device of a mesh; the port runs the P partitions in one process, as
JAX's single controller drives a mesh on one host: partition p lives on
``cuda:(p % torch.cuda.device_count())``, so P partitions share one card
or spread over the cards of the host (or all lie on the CPU).

The data-parallel KG phase (``dp.py:159-195``) shards a global TransR
batch over the devices, psums the weighted pair-loss numerator and
denominator, and divides the psum'd regulariser by the global batch. In
one process those sums are over the whole batch, which is exactly
``kgat_tpu_torch.models.kgat.kg_loss`` (``Trainer.kg_step``) on the global
batch: the partitioned trainer runs that step on a batch rounded up to a
multiple of P (``train.py:330-332``) rather than a second loss.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P partitions and the device of each."""

    devices: Tuple[torch.device, ...]

    @property
    def n_parts(self) -> int:
        return len(self.devices)


def make_mesh(n_parts: int, device="cuda") -> Mesh:
    """Partition p on ``cuda:(p % device_count)`` for a CUDA ``device``,
    else every partition on ``device``."""
    device = torch.device(device)
    if n_parts < 1:
        raise ValueError(f"n_parts must be positive, got {n_parts}")
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("CUDA is not available")
        devs = [torch.device("cuda", p % n_cards) for p in range(n_parts)]
    else:
        devs = [device] * n_parts
    return Mesh(devices=tuple(devs))


def n_parts_for(n_devices: int, device="cuda") -> int:
    """``--n-devices``: P partitions; 0 means one per visible GPU, as
    JAX's 0 means every available device (1 on the CPU)."""
    if n_devices < 0:
        raise ValueError(f"--n-devices must be >= 0, got {n_devices}")
    if n_devices == 0:
        return max(torch.cuda.device_count(), 1) \
            if torch.device(device).type == "cuda" else 1
    return n_devices


def round_batch(batch_size: int, n_parts: int) -> int:
    """A batch size rounded up to a multiple of the partition count."""
    return -(-batch_size // n_parts) * n_parts
