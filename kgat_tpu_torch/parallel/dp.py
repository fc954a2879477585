"""The partition map, and the data-parallel KG phase.

Port of ``kgat_tpu/parallel/dp.py`` for one process. JAX runs one program
per device of a mesh; the port runs the partitions in one process, as
JAX's single controller drives a mesh on one host. A 1D mesh of P
partitions puts partition p on ``cuda:(p % torch.cuda.device_count())``,
so P partitions share one card or spread over the cards of the host (or
all lie on the CPU). A 2D (dp, ep) mesh of D rows of P partitions
(``--n-devices N --dp-replicas D``, P = N / D; ``kgat_tpu/train.py:
286-301``) puts row d's partition p on ``cuda:((d P + p) % device_count)``:
every row holds the same shards on its own devices and takes its own
block of the CF batch.

The data-parallel KG phase (``dp.py:159-195``) shards a global TransR
batch over the devices, psums the weighted pair-loss numerator and
denominator, and divides the psum'd regulariser by the global batch. In
one process those sums are over the whole batch, which is exactly
``kgat_tpu_torch.models.kgat.kg_loss`` (``Trainer.kg_step``) on the global
batch: the partitioned trainer runs that step on a batch rounded up to a
multiple of the device count (``train.py:327-329``) rather than a second
loss, on a 2D mesh too (JAX's ``make_dp_kg_scan`` over both axes).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D rows of P partitions and the device of each, row-major: row d's
    partition p on ``devices[d * P + p]``."""

    devices: Tuple[torch.device, ...]
    dp_replicas: int = 1

    @property
    def n_parts(self) -> int:
        return len(self.devices) // self.dp_replicas

    def row(self, d: int) -> Tuple[torch.device, ...]:
        """The devices of row d's partitions."""
        P = self.n_parts
        return self.devices[d * P:(d + 1) * P]


def make_mesh(n_parts: int, device="cuda", dp_replicas: int = 1) -> Mesh:
    """``dp_replicas`` rows of ``n_parts`` partitions: row d's partition p
    on ``cuda:((d * n_parts + p) % device_count)`` for a CUDA ``device``,
    else every partition on ``device``."""
    device = torch.device(device)
    if n_parts < 1 or dp_replicas < 1:
        raise ValueError(f"n_parts and dp_replicas must be positive, got "
                         f"{n_parts} and {dp_replicas}")
    n = n_parts * dp_replicas
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("CUDA is not available")
        devs = [torch.device("cuda", i % n_cards) for i in range(n)]
    else:
        devs = [device] * n
    return Mesh(devices=tuple(devs), dp_replicas=dp_replicas)


def split_devices(n_devices: int, dp_replicas: int) -> int:
    """P = N / D partitions a row of a (dp, ep) mesh of ``n_devices``;
    raises unless D divides N, as ``kgat_tpu/train.py:287-289`` does."""
    dp = max(1, dp_replicas)
    if n_devices % dp:
        raise ValueError(f"--dp-replicas {dp} must divide "
                         f"--n-devices {n_devices}")
    return n_devices // dp


def n_devices_for(n_devices: int, device="cuda") -> int:
    """``--n-devices``: N partitions in all (D rows of N / D under
    ``--dp-replicas D``); 0 means one per visible GPU, as JAX's 0 means
    every available device (1 on the CPU)."""
    if n_devices < 0:
        raise ValueError(f"--n-devices must be >= 0, got {n_devices}")
    if n_devices == 0:
        return max(torch.cuda.device_count(), 1) \
            if torch.device(device).type == "cuda" else 1
    return n_devices


def round_batch(batch_size: int, n_devices: int) -> int:
    """A batch size rounded up to a multiple of the device count."""
    return -(-batch_size // n_devices) * n_devices
