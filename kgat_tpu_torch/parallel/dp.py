"""The partition map over processes, and the data-parallel KG phase.

Port of ``kgat_tpu/parallel/dp.py``. A mesh has N slots: D dp rows of P
partitions (``--n-devices N --dp-replicas D``, P = N / D;
``kgat_tpu/train.py:286-301``), row d's partition p in slot d P + p, as
``dp.make_mesh`` orders JAX's devices. Every row holds the same shards on
its own slots and takes its own block of the CF batch.

In one process (no ``torch.distributed`` group), the process drives every
slot, slot i on ``cuda:(i % torch.cuda.device_count())``: P partitions
share one card or spread over the cards of the host (or all lie on the
CPU), as JAX's single controller drives a mesh on one host. Under a
process group of W processes (``parallel/multihost.py``), process r owns
slots [r N / W, (r + 1) N / W), all on its card, and the mesh carries a
process group for each dp row that spans several processes (its
partitions' exchanges) beside the world group (the gradient all-reduce).
A process's slots lie in one row or fill whole rows.

The data-parallel KG phase (``dp.py:159-195``) shards a global TransR
batch over the devices, psums the weighted pair-loss numerator and
denominator, and divides the psum'd regulariser by the global batch. In
one process those sums are over the whole batch, which is exactly
``kgat_tpu_torch.models.kgat.kg_loss`` on the global batch; across
processes each process takes its block (:func:`kg_block_loss`) and the
trainer's gradient all-reduce is the psum. Batch sizes are rounded up to
a multiple of the slot count (``train.py:327-329``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D rows of P partitions, row-major: row d's partition p is slot
    d P + p, on ``devices[d P + p]``, None where another process owns the
    slot. ``owners`` gives each slot's process (empty in one process) and
    ``groups`` each row's process group (None for a row that one process
    holds whole)."""

    devices: Tuple[Optional[torch.device], ...]
    dp_replicas: int = 1
    owners: Tuple[int, ...] = ()
    rank: int = 0
    groups: tuple = ()

    @property
    def n_parts(self) -> int:
        return len(self.devices) // self.dp_replicas

    @property
    def n_procs(self) -> int:
        return max(self.owners, default=0) + 1

    def row(self, d: int) -> Tuple[Optional[torch.device], ...]:
        """The devices of row d's partitions (None: another process's)."""
        P = self.n_parts
        return self.devices[d * P:(d + 1) * P]

    def local_rows(self) -> Tuple[int, ...]:
        """The rows that hold a slot of this process."""
        return tuple(d for d in range(self.dp_replicas)
                     if any(dv is not None for dv in self.row(d)))

    def local_parts(self, d: int) -> range:
        """This process's partitions of row d, consecutive."""
        ps = [p for p, dv in enumerate(self.row(d)) if dv is not None]
        return range(ps[0], ps[-1] + 1) if ps else range(0)

    def group(self, d: int):
        """Row d's process group, None when this process holds it whole."""
        return self.groups[d] if self.groups else None

    def row_ranks(self, d: int) -> Tuple[int, ...]:
        """The processes of row d, in partition order."""
        if not self.owners:
            return (self.rank,)
        P = self.n_parts
        return tuple(sorted(set(self.owners[d * P:(d + 1) * P])))

    def local_slots(self) -> Tuple[int, ...]:
        return tuple(i for i, dv in enumerate(self.devices) if dv is not None)


def process_layout(n_slots: int, n_parts: int, n_procs: int) -> tuple:
    """Each slot's process for ``n_procs`` processes (consecutive blocks,
    ``multihost.slot_owners``); raises unless a process's slots lie in
    one dp row or fill whole rows."""
    owners = multihost.slot_owners(n_slots, n_procs)
    per = n_slots // n_procs
    if n_parts % per and per % n_parts:
        raise ValueError(f"{n_procs} processes of {per} slots each do not "
                         f"tile dp rows of {n_parts} partitions: a "
                         f"process's slots would straddle two rows")
    return owners


def make_mesh(n_parts: int, device="cuda", dp_replicas: int = 1) -> Mesh:
    """``dp_replicas`` rows of ``n_parts`` partitions. In one process: row
    d's partition p on ``cuda:((d * n_parts + p) % device_count)`` for a
    CUDA ``device``, else every partition on ``device``. Under a process
    group, this process's slots on its device (``multihost.
    process_device``), and a new process group for each row that spans
    several processes (every rank makes every group, in one order)."""
    device = torch.device(device)
    if n_parts < 1 or dp_replicas < 1:
        raise ValueError(f"n_parts and dp_replicas must be positive, got "
                         f"{n_parts} and {dp_replicas}")
    n = n_parts * dp_replicas
    rank, n_procs = multihost.world()
    if dist.is_available() and dist.is_initialized():
        owners = process_layout(n, n_parts, n_procs)
        dev = multihost.process_device(device, rank)
        groups = []
        for d in range(dp_replicas):
            ranks = sorted(set(owners[d * n_parts:(d + 1) * n_parts]))
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            groups.append(g if rank in ranks else None)
        return Mesh(devices=tuple(dev if o == rank else None for o in owners),
                    dp_replicas=dp_replicas, owners=owners, rank=rank,
                    groups=tuple(groups))
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
    ``--dp-replicas D``); 0 means one per process under a process group,
    else one per visible GPU, as JAX's 0 means every available device (1
    on the CPU)."""
    if n_devices < 0:
        raise ValueError(f"--n-devices must be >= 0, got {n_devices}")
    if n_devices == 0:
        _, n_procs = multihost.world()
        if n_procs > 1:
            return n_procs
        return max(torch.cuda.device_count(), 1) \
            if torch.device(device).type == "cuda" else 1
    return n_devices


def round_batch(batch_size: int, n_devices: int) -> int:
    """A batch size rounded up to a multiple of the device count."""
    return -(-batch_size // n_devices) * n_devices


def kg_block_loss(model, h, r, t_pos, t_neg, cfg, weight, block: slice
                  ) -> torch.Tensor:
    """This process's term of the data-parallel TransR loss
    (``make_dp_kg_scan``'s ``dp_loss_inner``, ``dp.py:166-172``): the
    weighted pair losses of its ``block`` of the global batch over the
    batch's total weight, plus ``reg_kg`` times its block's regulariser
    over the global batch size. The terms of all blocks sum to
    ``kgat.kg_loss`` of the global batch."""
    B = h.shape[0]
    w = torch.ones(B, device=h.device) if weight is None else weight
    pair, ssq = kgat.kg_pair_terms(model, h[block], r[block], t_pos[block],
                                   t_neg[block], cfg)
    return ((pair * w[block]).sum() / w.sum().clamp(min=1.0)
            + cfg.reg_kg * ssq / B)


def check_batch(tensors, group=None) -> None:
    """Under ``KGAT_DP_CHECK_BATCH=1``, raise unless every process of the
    group drew the same global batch (``_assert_identical_across_
    processes``, ``dp.py:66``): each process's checksum of ``tensors``
    is all-reduced, and the sum must be the process count times its own.
    Debug only: it costs a collective and a host sync a step."""
    if os.environ.get("KGAT_DP_CHECK_BATCH") != "1":
        return
    local = sum(float(t.double().sum()) + t.numel() * 1e-3 for t in tensors)
    total = torch.tensor([local], dtype=torch.float64,
                         device=tensors[0].device)
    dist.all_reduce(total, group=group)
    expect = local * dist.get_world_size(group)
    if not np.isclose(float(total), expect, rtol=1e-12, atol=1e-6):
        raise AssertionError(
            "KGAT_DP_CHECK_BATCH: host batches diverged across processes "
            f"(psum {float(total)!r} != {expect!r}); the DP identical-batch "
            "contract is violated - check sampler seeding.")
