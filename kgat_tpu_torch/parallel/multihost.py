"""Multi-process execution over ``torch.distributed``: one process per card.

Port of ``kgat_tpu/parallel/multihost.py``. JAX forms its process group
with ``jax.distributed.initialize`` and then sees every device of the
slice in one mesh; here each process drives its own card, and the
partitioned trainer's exchanges between processes are collectives over a
process group (NCCL between cards, gloo on the CPU). Launch one process
per card, with the environment variables of ``kgat_tpu``'s launch:

    host0$ COORDINATOR_ADDRESS=host0:8476 NUM_PROCESSES=4 PROCESS_ID=0 \\
           python -m kgat_tpu_torch.train --preset yelp-partitioned \\
               --halo-exchange ring --ring-transport fused
    ... PROCESS_ID=1, 2, 3 likewise, one per card

``COORDINATOR_ADDRESS`` is ``host:port`` (``tcp://`` is implied) or any
``init_method`` URL, e.g. ``file:///path`` for processes of one host.

The mesh's N slots (``parallel/dp.py``: row d's partition p is slot
d P + p) are owned in consecutive blocks: process i of W owns slots
[i N / W, (i + 1) N / W), all on its one card, ``cuda:(i % device_count)``
(:func:`local_shard_ids`, JAX's ``local_shard_ids``). Every process builds
the host partition of the graph whole and deterministically, as in JAX,
and places only its own slots' shards, buckets and halos on its card.

The differentiable collectives below carry the partitioned exchanges'
gradients: an all-gather whose backward is a reduce-scatter (sum), an
all-to-all of equal blocks whose backward is the all-to-all back, and a
neighbour send/receive whose backward sends the other way.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# A collective that waits longer than this for a peer fails the run
# (NCCL's watchdog aborts the process) instead of hanging it; so do a ring
# wait (remote_ring.ProcessRing) and a replayed step (Watch). Seconds,
# from KGAT_GROUP_TIMEOUT_S where it is set.
TIMEOUT = datetime.timedelta(
    seconds=float(os.environ.get("KGAT_GROUP_TIMEOUT_S", 300)))

_initialized: "Optional[tuple]" = None  # (coordinator, n_procs, proc_id)


def init_method(coordinator: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``file://...``) as is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def process_device(device, rank: int) -> torch.device:
    """Process ``rank``'s device: ``cuda:(rank % device_count)`` for a CUDA
    ``device``, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("CUDA is not available")
    return torch.device("cuda", rank % n)


def _check_one_rank_per_card(store, rank: int, world: int,
                             dev: torch.device) -> None:
    """Every rank posts its (host, card) to the rendezvous store; two
    ranks on one card are refused here, before NCCL would fail on them."""
    props = torch.cuda.get_device_properties(dev)
    card = f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"
    store.set(f"kgat_card/{rank}", card)
    cards = [store.get(f"kgat_card/{r}").decode() for r in range(world)]
    for r, c in enumerate(cards):
        if r != rank and c == card:
            raise RuntimeError(
                f"process {rank} and process {r} would share one card "
                f"({dev} on {socket.gethostname()}): NCCL takes one rank "
                f"per card; launch at most {torch.cuda.device_count()} "
                f"processes on this host")


def share_host_cores(world: int, n_cards: int) -> int:
    """Cuts torch's intra-op threads to this process's share of the
    host's cores, where the group's processes share a host, one per card:
    min(world, n_cards) of them. Returns the threads left. Each process's
    pool would otherwise take every core: four such pools on one 32-core
    host made the host build of the graph's partitions and ring buckets
    ten times slower (37 s against 1.9 s a process)."""
    n = max(1, torch.get_num_threads() // max(1, min(world, n_cards)))
    torch.set_num_threads(n)
    return n


def form_group(init: str, world: int, rank: int, device) -> torch.device:
    """``init_process_group`` for this process, with NCCL for a CUDA
    ``device`` and gloo for the CPU, and a finite timeout; returns the
    process's device (set as the current CUDA device), its intra-op
    threads cut to its share of the host (:func:`share_host_cores`). A
    group of one is allowed here (``initialize_distributed`` forms
    none)."""
    dev = process_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        share_host_cores(world, torch.cuda.device_count())
    # No device_id: NCCL's communicators form at the first collective,
    # after the check below.
    dist.init_process_group(backend_for(dev), init_method=init,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    if dev.type == "cuda":
        _check_one_rank_per_card(dist.distributed_c10d._get_default_store(),
                                 rank, world, dev)
    return dev


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> int:
    """Form the process group; returns this process's id.

    A no-op for one process. The arguments default to the environment
    variables COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID, as in
    ``kgat_tpu``. A second call with the same spec returns the rank; one
    with another spec raises."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    if num_processes <= 1 or not coordinator:
        return 0
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PROCESS_ID", 0)))
    global _initialized
    spec = (coordinator, num_processes, process_id)
    if _initialized is not None:
        if _initialized != spec:
            raise RuntimeError(
                "initialize_distributed called twice with conflicting "
                f"group specs: first {_initialized}, now {spec}")
        return dist.get_rank()
    form_group(init_method(coordinator), num_processes, process_id, device)
    _initialized = spec
    return process_id


def world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier(device, group=None) -> None:
    """Returns once every process of ``group`` (default the world) reached
    it: one all-reduce of a scalar, on this process's device under NCCL
    (the collective a step ends with) and on the host under gloo, read
    back. Unlike ``dist.barrier`` it names the device, which NCCL would
    otherwise guess."""
    nccl = dist.get_backend(group) == "nccl"
    t = torch.zeros(1, device=device if nccl else "cpu")
    dist.all_reduce(t, group=group)
    t.item()


class Watch:
    """Bounds the host's wait for work it queued on a device, such as
    replays of CUDA graphs that hold NCCL calls, which no watchdog sees:
    :meth:`mark` records an event after each piece of work and, once
    ``depth`` are outstanding, waits for the oldest; :meth:`drain` waits
    for the last. A wait past ``timeout_s`` (default the group's timeout)
    raises, as does a kernel that failed (a ring wait that timed out):
    a peer that stopped ends the run instead of hanging it."""

    def __init__(self, device, depth: int = 8,
                 timeout_s: Optional[float] = None, event=None):
        self.device, self.depth = torch.device(device), depth
        self.timeout_s = (TIMEOUT.total_seconds() if timeout_s is None
                          else timeout_s)
        self.events = [(event or torch.cuda.Event)() for _ in range(depth)]
        self.n = 0

    def mark(self) -> None:
        ev = self.events[self.n % self.depth]
        if self.n >= self.depth:
            self._wait(ev)
        ev.record(torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        self.n += 1

    def drain(self) -> None:
        if self.n:
            self._wait(self.events[(self.n - 1) % self.depth])

    def _wait(self, ev) -> None:
        deadline = time.monotonic() + self.timeout_s
        while not ev.query():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"work queued on {self.device} did not end within "
                    f"{self.timeout_s:g} s: a peer process stopped, or a "
                    f"collective in a replayed CUDA graph waits for one")
            time.sleep(5e-5)


def slot_owners(n_slots: int, n_procs: int) -> tuple:
    """The process of each of ``n_slots`` slots: consecutive blocks of
    n_slots / n_procs. Raises unless the process count divides it."""
    if n_procs < 1 or n_slots % n_procs:
        raise ValueError(f"{n_procs} processes cannot share {n_slots} "
                         f"mesh slots (--n-devices) evenly: the process "
                         f"count must divide --n-devices")
    per = n_slots // n_procs
    return tuple(i // per for i in range(n_slots))


def local_shard_ids(n_parts: int, rank: Optional[int] = None,
                    n_procs: Optional[int] = None) -> List[int]:
    """The slots this process owns, in mesh order (JAX's
    ``local_shard_ids``)."""
    r, w = world()
    rank = r if rank is None else rank
    n_procs = w if n_procs is None else n_procs
    return [i for i, o in enumerate(slot_owners(n_parts, n_procs))
            if o == rank]


def place_local(objs: Sequence, devices: Sequence) -> list:
    """``objs[i].to(devices[i])`` for this process's slots, None for the
    others' (``devices[i]`` None): the counterpart of ``stack_shards`` /
    ``stack_pytrees``, which materialise a process's own shards only."""
    return [None if dv is None else o.to(dv)
            for o, dv in zip(objs, devices, strict=True)]


# --- differentiable collectives --------------------------------------------
# Each forward hands NCCL detached aliases of its input and output: the
# process group keeps a collective's tensors until it has ended, and a
# tensor that carried the autograd graph would keep that step's graph, and
# with it the parameters' gradient accumulators, alive into a later
# CUDA-graph capture (whose backward would then order them on the stale
# stream of an eager step, which a capture refuses).

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.detach().contiguous(), group=group)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks ``x`` concatenated along dim 0, in rank order;
    the gradient is reduce-scattered (summed) back to each block."""
    return _AllGather.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.detach().contiguous(), group=group)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal blocks along dim 0: block j of ``x`` goes to the group's rank
    j, and block j of the result came from it. Its own transpose."""
    return _AllToAll.apply(x, group)


def send_recv(x: torch.Tensor, dst: int, src: int, group=None
              ) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor like it from
    ``src`` (NCCL or gloo point-to-point); not differentiable."""
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dst, src, group):
        ctx.peers = (dst, src, group)
        return send_recv(x.detach(), dst, src, group).detach()

    @staticmethod
    def backward(ctx, g):
        dst, src, group = ctx.peers
        return send_recv(g, src, dst, group), None, None, None


def shift(x: torch.Tensor, dst: int, src: int, group=None) -> torch.Tensor:
    """The ring's neighbour exchange: ``x`` to rank ``dst``, the result
    from rank ``src``; the gradient goes the other way."""
    return _Shift.apply(x, dst, src, group)


class GradSum:
    """The gradients of replicated parameters and a step's loss in one
    flat buffer, summed over the processes by one all-reduce: each
    parameter's ``.grad`` becomes a view into it (keeping its address, as
    a captured step needs; backward accumulates into the views), and the
    loss is its last entry."""

    def __init__(self, params, device):
        params = list(params)
        self.flat = torch.zeros(sum(p.numel() for p in params) + 1,
                                device=device)
        at = 0
        for p in params:
            p.grad = self.flat[at:at + p.numel()].view_as(p)
            at += p.numel()

    def __call__(self, loss: torch.Tensor) -> torch.Tensor:
        """After a backward: every process's gradients and ``loss`` (its
        share) summed over the world, in place; returns the summed
        loss."""
        self.flat[-1].copy_(loss.detach())
        dist.all_reduce(self.flat)
        return self.flat[-1].clone()
