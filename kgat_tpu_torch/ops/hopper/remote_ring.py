"""K7 and K8 wrappers (``csrc/remote_ring.cu``): the ring exchange's
neighbour shift and fused bucket reduce + send, with their autograd.

K7 (:func:`ring_shift`) replaces ``kgat_tpu/ops/pallas/remote_ring.py::
_shift_kernel`` (``make_ring_shift``); K8 (:func:`reduce_send`) replaces
``::_reduce_send_kernel`` (``make_reduce_send``). JAX runs one program per
chip and the kernel sends to the neighbour chip by remote DMA. The port
runs the P partitions in one process, partition p on
``cuda:(p % device_count)``: one launch per partition stores its chunk
into the receive buffer of the partition it sends to, through a plain
device pointer on one card or a peer pointer on another. A receive buffer
is never a buffer that a launch of the same step reads (the wrappers
refuse aliased buffers): each step stores into fresh buffers, so a
partition's current chunk and its receive buffer are always two buffers.

Direction: ``ring_shift(parts, +1)`` gives partition j the chunk of
partition j - 1, so data moves left to right, as ``lax.ppermute(x, axis,
[(i, (i + 1) % P)])`` (``remote_ring.py:17-21``); its transpose is the
shift by -1.

The differentiable ops: :func:`ring_send` (K7 forward, K7 the other way
backward) and :func:`bucket_spmm_send` (K8 forward; backward the reverse
bucket K6 reduce of the side cotangent plus K7 of the next-chunk
cotangent the other way, ``halo.py:116-125``).

Across processes (one process per card, a dp row's partitions in several
processes), a :class:`ProcessRing` is one process's link in its row's
ring: K7 and K8 store the chunk of its last partition into a fixed
receive buffer of the next process, registered once through CUDA IPC,
one buffer per (layer, ring step, direction); a flag in the receiver's
memory, set by the sender's stream after the store and awaited (for a
bounded time) and cleared by the receiver's, orders the read after the
store (see ``csrc/remote_ring.cu``). :func:`ring_send` and
:func:`bucket_spmm_send` take the link for such a row; between the
partitions of one process they launch as above. On the CPU the store
into the peer process is a gloo point-to-point exchange, K7's plain
version across processes.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kgat_tpu_torch.graph import EdgeWeights
from kgat_tpu_torch.ops import ref, row_split
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.segment_sum import (MAX_DIM, bucket_cotangent,
                                                   bucket_vals, edge_dot,
                                                   partials, split_args)
from kgat_tpu_torch.parallel import multihost


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _route(name: str, pairs) -> bool:
    """One routing decision for all partitions: ``pairs`` is (destination
    device, the source partition's tensors) per launch."""
    uses = {build.use_ring_kernel(name, dest, *ts) for dest, ts in pairs}
    if len(uses) != 1:
        raise ValueError(f"{name}: partitions lie on the CPU and on CUDA")
    return uses.pop()


def _stream_waits(waiter: torch.device, on: torch.device) -> None:
    """Order ``waiter``'s current stream after the work queued so far on
    ``on``'s (nothing to do on one device: one stream)."""
    if waiter != on:
        torch.cuda.current_stream(waiter).wait_stream(
            torch.cuda.current_stream(on))


def _receive_buffers(parts: Sequence[torch.Tensor], step: int,
                     out: Optional[Sequence[torch.Tensor]]):
    n = len(parts)
    if out is None:
        return [torch.empty_like(parts[(j - step) % n],
                                 device=parts[j].device) for j in range(n)]
    if len(out) != n:
        raise ValueError(f"{len(out)} receive buffers for {n} partitions")
    for j, o in enumerate(out):
        src = parts[(j - step) % n]
        if o.shape != src.shape or o.dtype != src.dtype:
            raise ValueError(f"receive buffer {j}: {tuple(o.shape)} "
                             f"{o.dtype}, sent {tuple(src.shape)} "
                             f"{src.dtype}")
    return list(out)


def ring_shift(parts: Sequence[torch.Tensor], step: int,
               out: Optional[Sequence[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
    """K7: partition j receives partition (j - step) mod P's tensor.

    One launch per partition p copies ``parts[p]`` (any dtype,
    contiguous) into ``out[(p + step) % P]``, the receive buffer on that
    partition's device (fresh buffers by default). Raises if a receive
    buffer aliases a part or another receive buffer. CPU tensors take
    ``ref.ring_shift``; CUDA tensors launch the kernel. Forward only:
    :func:`ring_send` is the shift with a backward."""
    name = "ring_shift"
    n = len(parts)
    out = _receive_buffers(parts, step, out)
    build.check_disjoint(name, out, parts)
    if not _route(name, [(out[(p + step) % n].device, (parts[p],))
                         for p in range(n)]):
        for o, s in zip(out, ref.ring_shift(parts, step)):
            o.copy_(s)
        return out
    for p in range(n):
        src, dst = parts[p], out[(p + step) % n]
        if not src.is_contiguous():
            raise ValueError(f"{name}: part {p} must be contiguous")
        _stream_waits(src.device, dst.device)
        _shift_launch(src, dst.data_ptr())
        _stream_waits(dst.device, src.device)
    return out


def _shift_launch(src: torch.Tensor, dst_ptr: int) -> None:
    """One K7 launch on ``src``'s card: its bytes into ``dst_ptr``."""
    if _nbytes(src) == 0:
        return
    lib = build.library()
    with torch.cuda.device(src.device):
        code = lib.kgat_ring_shift(
            src.data_ptr(), dst_ptr, _nbytes(src),
            ctypes.c_void_p(build.stream_ptr(src.device)))
    build.check_launch(lib, code, "ring_shift")
    build.launch_counts["ring_shift"] += 1


def reduce_send(row_offsets: Sequence[torch.Tensor],
                vals: Sequence[torch.Tensor],
                chunks: Sequence[torch.Tensor],
                out: Optional[Sequence[torch.Tensor]] = None, *,
                splits: Optional[Sequence[row_split.RowSplit]] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """K8: one ring step of every partition, one wrapper launch each.

    For partition p: ``sums[p]`` = K6's segment sums of its bucket's
    value stream ``vals[p]`` ((E_p, d) float32 or bfloat16, E_p may be 0)
    over the CSR ``row_offsets[p]``, whose RowSplit is ``splits[p]``
    (``Bucket.split``) -> (n_rows, d) float32 on p's device; and
    ``chunks[p]`` stored into ``out[(p + 1) % P]``, the right neighbour's
    receive buffer (fresh by default). The grid is split: the first
    blocks copy, the others walk the bucket's units; a second CUDA launch
    sums the partials of rows longer than the chunk. Returns (sums, next)
    with next[j] = chunks[j - 1]. Raises on aliased buffers, and on the
    card without ``splits``. CPU tensors take ``ref.reduce_send``."""
    name = "reduce_send"
    n = len(chunks)
    if not len(row_offsets) == len(vals) == n:
        raise ValueError(f"{name}: {len(row_offsets)} CSRs, {len(vals)} "
                         f"value streams, {n} chunks")
    if splits is not None and len(splits) != n:
        raise ValueError(f"{name}: {len(splits)} RowSplits for {n} chunks")
    out = _receive_buffers(chunks, 1, out)
    build.check_disjoint(name, out, [*chunks, *vals])
    if not _route(name, [(out[(p + 1) % n].device,
                          (row_offsets[p], vals[p], chunks[p],
                           *(() if splits is None else splits[p].tensors)))
                         for p in range(n)]):
        sums, nxt = ref.reduce_send(row_offsets, vals, chunks)
        for o, s in zip(out, nxt):
            o.copy_(s)
        return sums, out
    sums = []
    for p in range(n):
        src, dst = chunks[p], out[(p + 1) % n]
        if not src.is_contiguous():
            raise ValueError(f"{name}: chunk {p} must be contiguous")
        _stream_waits(src.device, dst.device)
        sums.append(_reduce_send_launch(
            row_offsets[p], vals[p], None if splits is None else splits[p],
            src, dst.data_ptr(), f"partition {p}"))
        _stream_waits(dst.device, src.device)
    return sums, out


def _reduce_send_launch(ro: torch.Tensor, v: torch.Tensor,
                        split: Optional[row_split.RowSplit],
                        src: torch.Tensor, dst_ptr: int, what: str
                        ) -> torch.Tensor:
    """One K8 launch on ``src``'s card: the segment sums of ``v`` over the
    CSR ``ro`` (returned), and ``src`` stored into ``dst_ptr``."""
    name = "reduce_send"
    build.check_tensor("row_offsets", ro, (torch.int32,), 1)
    build.check_tensor("vals", v, (torch.float32, torch.bfloat16), 2)
    n_rows, d = ro.numel() - 1, v.shape[1]
    if not 0 < d <= MAX_DIM or n_rows <= 0 or _nbytes(src) == 0:
        raise ValueError(f"{name}: {what}: {n_rows} rows, feature dim {d}, "
                         f"{_nbytes(src)} chunk bytes")
    split = row_split.require(name, split, n_rows, v.shape[0])
    s = torch.empty((n_rows, d), dtype=torch.float32, device=v.device)
    scratch = partials(split, d, v.device)
    lib = build.library()
    with torch.cuda.device(src.device):
        code = lib.kgat_reduce_send(
            *split_args(split), v.data_ptr(), s.data_ptr(),
            scratch.data_ptr(), d, int(v.dtype == torch.bfloat16),
            src.data_ptr(), dst_ptr, _nbytes(src),
            ctypes.c_void_p(build.stream_ptr(src.device)))
    build.check_launch(lib, code, name)
    build.launch_counts[name] += 1
    return s


# --- across processes -------------------------------------------------------

# K7's and K8's launches that stored into another process's buffer (also
# counted in ``build.launch_counts`` under the kernel's name).
process_launches: "collections.Counter[str]" = collections.Counter()

_HANDLE = 64   # bytes of a cudaIpcMemHandle_t
_ALIGN = 256   # bytes between the starts of two buffers of one allocation


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr``, for ``torch.as_tensor``
    (the CUDA array interface); the tensor does not own the memory."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


class ProcessRing:
    """One process's link in the ring of a dp row that spans processes.

    The process's last partition sends its chunk to global rank
    ``next_rank`` (whose first partition receives it) and its first
    partition receives from ``prev_rank``; gradients go the other way.
    ``keys`` maps each key (layer, ring step, direction: +1 a chunk from
    ``prev_rank``, -1 a gradient from ``next_rank``) to the (shape, dtype)
    received under it. Every process of the row's ``group`` makes its link
    at once, with the same keys: on CUDA the constructor allocates one
    device allocation of its own (``kgat_ipc_alloc``) holding a flag and a
    fixed receive buffer per key, exports it (``kgat_ipc_export``),
    gathers every process's handle over the group once and opens its
    neighbours' (``kgat_ipc_open``). A peer whose memory cannot be opened
    raises, naming the two cards. A wait for a peer's store that lasts
    past ``timeout_s`` (default the process group's timeout) fails the
    process's CUDA context. On the CPU nothing is registered: a send is a
    gloo point-to-point exchange.

    :meth:`close`, called by every process of the group together after
    its last send, unmaps the neighbours' allocations and frees this
    one's; the tensors it returned alias that memory and die with it.
    """

    def __init__(self, group, prev_rank: int, next_rank: int,
                 device: torch.device,
                 keys: Dict[tuple, Tuple[tuple, torch.dtype]],
                 timeout_s: Optional[float] = None):
        self.group, self.prev, self.next = group, prev_rank, next_rank
        self.device = torch.device(device)
        self.keys = sorted(keys)
        self.shapes = {k: (tuple(shape), dtype)
                       for k, (shape, dtype) in keys.items()}
        self.timeout_ns = int(1e9 * (multihost.TIMEOUT.total_seconds()
                                     if timeout_s is None else timeout_s))
        self.recv: Dict[tuple, torch.Tensor] = {}
        self._peer: Dict[tuple, Tuple[int, int]] = {}  # key -> (buf, flag)
        self._opened: List[int] = []
        self._base: Optional[int] = None
        if self.device.type == "cuda":
            self._register()

    def _register(self) -> None:
        lib, dev = build.library(), self.device
        # The flags (4 bytes a key), then each key's buffer: one layout on
        # every process, since every process registers the same keys.
        at, layout = _aligned(4 * len(self.keys)), {}
        for k in self.keys:
            shape, dtype = self.shapes[k]
            layout[k] = at
            at += _aligned(torch.Size(shape).numel() * dtype.itemsize)
        base = ctypes.c_void_p(0)
        with torch.cuda.device(dev):
            build.check_launch(lib, lib.kgat_ipc_alloc(at, ctypes.byref(base)),
                               "ipc alloc")
        self._base = base.value
        for k in self.keys:
            shape, dtype = self.shapes[k]
            raw = torch.as_tensor(_DeviceBytes(
                self._base + layout[k],
                torch.Size(shape).numel() * dtype.itemsize), device=dev)
            self.recv[k] = raw.view(dtype).view(shape)
        handle = ctypes.create_string_buffer(_HANDLE)
        with torch.cuda.device(dev):
            build.check_launch(lib, lib.kgat_ipc_export(self._base, handle),
                               "ipc export")
        gathered = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(
            gathered, (dist.get_rank(), str(dev), handle.raw, layout),
            group=self.group)
        peers = {r: (d, h, lay) for r, d, h, lay in gathered}
        bases = {}
        for rank in sorted({self.prev, self.next}):
            peer_dev, peer_handle, peer_layout = peers[rank]
            if peer_layout != layout:
                raise ValueError(f"ring keys differ between process "
                                 f"{dist.get_rank()} and process {rank}")
            opened = ctypes.c_void_p(0)
            with torch.cuda.device(dev):
                code = lib.kgat_ipc_open(peer_handle, ctypes.byref(opened))
            if code != 0:
                raise RuntimeError(
                    f"ring kernels across processes: process "
                    f"{dist.get_rank()} on {dev} cannot open the receive "
                    f"buffers of process {rank} on {peer_dev} (CUDA error "
                    f"{code}): K7 and K8 need CUDA IPC between the two cards")
            bases[rank] = opened.value
            self._opened.append(opened.value)
        for i, k in enumerate(self.keys):
            # A chunk goes into the next process's buffer, a gradient
            # into the previous one's.
            peer = bases[self.next if k[-1] > 0 else self.prev]
            self._peer[k] = (peer + layout[k], peer + 4 * i)
        self._flag_ptr = {k: self._base + 4 * i
                          for i, k in enumerate(self.keys)}

    def _ends(self, key) -> Tuple[int, int]:
        """(destination rank, source rank) of ``key``'s direction."""
        return ((self.next, self.prev) if key[-1] > 0
                else (self.prev, self.next))

    def _finish(self, key) -> torch.Tensor:
        """Signal the receiver of ``key`` (after the stream's store into
        it), then wait for this process's own buffer of ``key``."""
        lib, stream = build.library(), ctypes.c_void_p(
            build.stream_ptr(self.device))
        with torch.cuda.device(self.device):
            build.check_launch(lib, lib.kgat_signal(self._peer[key][1],
                                                    stream), "signal")
            build.check_launch(lib, lib.kgat_wait(
                self._flag_ptr[key], self.timeout_ns, stream), "wait")
        return self.recv[key]

    def shift(self, key, x: torch.Tensor) -> torch.Tensor:
        """K7 across processes: ``x`` into the neighbour's buffer of
        ``key`` (the next process for direction +1, the previous for -1);
        returns what this process received under ``key``. On the CPU, a
        gloo exchange (K7's plain version)."""
        self._check(key, x)
        dst, src = self._ends(key)
        if self.device.type != "cuda":
            return multihost.send_recv(x, dst, src, self.group)
        x = x.contiguous()
        _shift_launch(x, self._peer[key][0])
        process_launches["ring_shift"] += 1
        return self._finish(key)

    def reduce_send(self, key, row_offsets: torch.Tensor,
                    vals: torch.Tensor, split: Optional[row_split.RowSplit],
                    chunk: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K8 across processes: the segment sums of ``vals`` over the CSR
        ``row_offsets`` and ``chunk`` stored into the next process's
        buffer of ``key`` in one launch; returns (sums, the chunk this
        process received). On the CPU, K6's plain version and a gloo
        exchange."""
        self._check(key, chunk)
        dst, src = self._ends(key)
        if self.device.type != "cuda":
            return (ref.segment_sum_csr(row_offsets, vals),
                    multihost.send_recv(chunk, dst, src, self.group))
        chunk = chunk.contiguous()
        sums = _reduce_send_launch(row_offsets, vals, split, chunk,
                                   self._peer[key][0], f"key {key}")
        process_launches["reduce_send"] += 1
        return sums, self._finish(key)

    def _check(self, key, x: torch.Tensor) -> None:
        if key not in self.shapes:
            raise KeyError(f"ring key {key} is not registered: {self.keys}")
        shape, dtype = self.shapes[key]
        if tuple(x.shape) != shape or x.dtype != dtype or (
                x.device != self.device):
            raise ValueError(f"ring key {key}: sending {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, registered {shape} "
                             f"{dtype} on {self.device}")
        if self.device.type == "cuda" and self._base is None:
            raise RuntimeError("the ring link is closed")

    def close(self) -> None:
        """With every process of the group, after the last send: once
        every process's stores have landed, unmaps the neighbours'
        allocations, and once every process has unmapped this one's,
        frees it."""
        if self._base is None:
            return
        lib = build.library()
        torch.cuda.synchronize(self.device)
        multihost.barrier(self.device, self.group)
        with torch.cuda.device(self.device):
            for base in self._opened:
                build.check_launch(lib, lib.kgat_ipc_close(base), "ipc close")
        self._opened = []
        multihost.barrier(self.device, self.group)
        self.recv = {}
        with torch.cuda.device(self.device):
            build.check_launch(lib, lib.kgat_ipc_free(self._base), "ipc free")
        self._base = None


# --- differentiable ops -----------------------------------------------------
# A row's ring either lies in this process (no link: every partition is
# here) or spans processes, and then a ProcessRing carries the chunk that
# crosses this process's end, under the key (layer, ring step, direction);
# the other partitions of the process pass theirs here. The link's
# tensors come back as detached aliases: a Function's output takes the
# node that made it as its grad_fn, and a receive buffer the link keeps
# for good would keep that step's graph, its parameters' gradient
# accumulators too, alive into a later CUDA-graph capture (whose backward
# would then order them on a stale stream).
# (autograd.Function materialises the cotangent of an unused output as
# zeros, so every backward below gets a tensor for each output.)

def _pass(parts: Sequence[torch.Tensor], step: int,
          link: Optional[ProcessRing], key: tuple) -> List[torch.Tensor]:
    """K7 over this process's partitions: partition j receives partition
    j - step's tensor. Across processes (``link``, step +1 or -1) the one
    that leaves this process goes to the neighbour under (*key, step), and
    the neighbour's on the other side comes in."""
    if link is None:
        return ring_shift([p.contiguous() for p in parts], step)
    k = len(parts)
    return [ring_shift([parts[j - step].contiguous()], 1)[0]
            if 0 <= j - step < k
            else link.shift((*key, step), parts[(j - step) % k]).detach()
            for j in range(k)]


class _RingSend(torch.autograd.Function):
    """K7 forward; the transpose (K7 by -step) backward
    (``remote_ring.py:234-236``)."""

    @staticmethod
    def forward(ctx, step, link, key, *parts):
        ctx.step, ctx.link, ctx.key = step, link, key
        return tuple(_pass(parts, step, link, key))

    @staticmethod
    def backward(ctx, *grads):
        # out[j] = x[j - step]  =>  dx[p] = g[p + step]: shift by -step.
        return (None, None, None,
                *_pass(grads, -ctx.step, ctx.link, ctx.key))


def ring_send(parts: Sequence[torch.Tensor], step: int = 1,
              link: Optional[ProcessRing] = None, key: tuple = ()
              ) -> List[torch.Tensor]:
    """Differentiable :func:`ring_shift`: partition j receives partition
    (j - step) mod P's chunk; the gradient rides the ring the other way.
    ``parts`` are a row's partitions in this process, all of them unless
    ``link`` carries the row's ring to the neighbour processes (step 1;
    ``key`` is (layer, ring step))."""
    if link is not None and step != 1:
        raise ValueError(f"a ring across processes shifts by 1, not {step}")
    return list(_RingSend.apply(step, link, key, *parts))


class _BucketSpmmSend(torch.autograd.Function):
    """K8 forward: every partition's bucket reduce and the chunks' send
    one hop right. Backward: the reverse-bucket K6 reduce of each side
    cotangent, plus K7 by -1 of the next-chunk cotangents; the per-edge
    dot for a weight that needs a gradient."""

    @staticmethod
    def forward(ctx, buckets, w_revs, link, key, *tensors):
        n = len(buckets)
        ctx.buckets, ctx.w_revs, ctx.link, ctx.key = buckets, w_revs, link, key
        ctx.save_for_backward(*tensors[:n])
        chunks = [c.contiguous() for c in tensors[:n]]
        vals = [bucket_vals(b, w, c)
                for b, w, c in zip(buckets, tensors[n:], chunks)]
        ros = [b.row_offsets for b in buckets]
        splits = [b.split for b in buckets]
        if link is None:
            sums, nxt = reduce_send(ros, vals, chunks, splits=splits)
            return (*sums, *nxt)
        # The last partition's chunk leaves the process; each other one
        # goes to the next partition here.
        sums, nxt = [None] * n, [None] * n
        sums[-1], got = link.reduce_send((*key, 1), ros[-1], vals[-1],
                                         splits[-1], chunks[-1])
        nxt[0] = got.detach()
        for i in range(n - 1):
            (sums[i],), (nxt[i + 1],) = reduce_send(
                [ros[i]], [vals[i]], [chunks[i]], splits=[splits[i]])
        return (*sums, *nxt)

    @staticmethod
    def backward(ctx, *grads):
        chunks = ctx.saved_tensors
        n = len(chunks)
        g_side = [g.contiguous() for g in grads[:n]]
        back = _pass(grads[n:], -1, ctx.link, ctx.key)
        d_chunks = [bucket_cotangent(b, w, g, c.dtype) + bk.to(c.dtype)
                    for b, w, g, c, bk in zip(ctx.buckets, ctx.w_revs,
                                              g_side, chunks, back)]
        d_w = [edge_dot(b.src, b.dst, c, g)
               if ctx.needs_input_grad[4 + n + p] else None
               for p, (b, c, g) in enumerate(zip(ctx.buckets, chunks,
                                                 g_side))]
        return (None, None, None, None, *d_chunks, *d_w)


def bucket_spmm_send(buckets: Sequence, edge_ws: Sequence[EdgeWeights],
                     chunks: Sequence[torch.Tensor],
                     link: Optional[ProcessRing] = None, key: tuple = ()
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One fused ring step over a row's partitions in this process,
    differentiable in the chunks and the forward weights: (side partials,
    next chunks), where partition p's partial is the sum over its bucket's
    edges of w * chunk[p][src] -> (R, d) float32, and next[j] =
    chunks[j - 1], next[0] from the previous process where ``link``
    carries the row's ring across processes (``key`` (layer, ring step)).
    ``buckets[p]`` is partition p's bucket of this step
    (``parallel.partition.Bucket``), ``edge_ws[p]`` its staged weights."""
    n = len(chunks)
    out = _BucketSpmmSend.apply(list(buckets), [ew.rev for ew in edge_ws],
                                link, key, *chunks,
                                *(ew.fwd for ew in edge_ws))
    return list(out[:n]), list(out[n:])
