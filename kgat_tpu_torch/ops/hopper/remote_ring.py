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
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from kgat_tpu_torch.graph import EdgeWeights
from kgat_tpu_torch.ops import ref, row_split
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.segment_sum import (MAX_DIM, bucket_cotangent,
                                                   bucket_vals, edge_dot,
                                                   partials, split_args)


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
    lib = build.library()
    for p in range(n):
        src, dst = parts[p], out[(p + step) % n]
        if not src.is_contiguous():
            raise ValueError(f"{name}: part {p} must be contiguous")
        if _nbytes(src) == 0:
            continue
        _stream_waits(src.device, dst.device)
        with torch.cuda.device(src.device):
            code = lib.kgat_ring_shift(
                src.data_ptr(), dst.data_ptr(), _nbytes(src),
                ctypes.c_void_p(build.stream_ptr(src.device)))
        build.check_launch(lib, code, name)
        build.launch_counts[name] += 1
        _stream_waits(dst.device, src.device)
    return out


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
    lib = build.library()
    sums = []
    for p in range(n):
        ro, v, src, dst = row_offsets[p], vals[p], chunks[p], out[(p + 1) % n]
        build.check_tensor("row_offsets", ro, (torch.int32,), 1)
        build.check_tensor("vals", v, (torch.float32, torch.bfloat16), 2)
        if not src.is_contiguous():
            raise ValueError(f"{name}: chunk {p} must be contiguous")
        n_rows, d = ro.numel() - 1, v.shape[1]
        if not 0 < d <= MAX_DIM or n_rows <= 0 or _nbytes(src) == 0:
            raise ValueError(f"{name}: partition {p}: {n_rows} rows, "
                             f"feature dim {d}, {_nbytes(src)} chunk bytes")
        split = row_split.require(name, None if splits is None
                                  else splits[p], n_rows, v.shape[0])
        s = torch.empty((n_rows, d), dtype=torch.float32, device=v.device)
        scratch = partials(split, d, v.device)
        _stream_waits(src.device, dst.device)
        with torch.cuda.device(src.device):
            code = lib.kgat_reduce_send(
                *split_args(split), v.data_ptr(), s.data_ptr(),
                scratch.data_ptr(), d,
                int(v.dtype == torch.bfloat16), src.data_ptr(),
                dst.data_ptr(), _nbytes(src),
                ctypes.c_void_p(build.stream_ptr(src.device)))
        build.check_launch(lib, code, name)
        build.launch_counts[name] += 1
        _stream_waits(dst.device, src.device)
        sums.append(s)
    return sums, out


# --- differentiable ops -----------------------------------------------------
# (autograd.Function materialises the cotangent of an unused output as
# zeros, so every backward below gets a tensor for each output.)

class _RingSend(torch.autograd.Function):
    """K7 forward; the transpose (K7 by -step) backward
    (``remote_ring.py:234-236``)."""

    @staticmethod
    def forward(ctx, step, *parts):
        ctx.step = step
        return tuple(ring_shift([p.contiguous() for p in parts], step))

    @staticmethod
    def backward(ctx, *grads):
        # out[j] = x[j - step]  =>  dx[p] = g[p + step]: shift by -step.
        return (None, *ring_shift([g.contiguous() for g in grads],
                                  -ctx.step))


def ring_send(parts: Sequence[torch.Tensor], step: int = 1
              ) -> List[torch.Tensor]:
    """Differentiable :func:`ring_shift`: partition j receives partition
    (j - step) mod P's chunk; the gradient rides the ring the other way."""
    return list(_RingSend.apply(step, *parts))


class _BucketSpmmSend(torch.autograd.Function):
    """K8 forward: every partition's bucket reduce and the chunks' send
    one hop right. Backward: the reverse-bucket K6 reduce of each side
    cotangent, plus K7 by -1 of the next-chunk cotangents; the per-edge
    dot for a weight that needs a gradient."""

    @staticmethod
    def forward(ctx, buckets, w_revs, *tensors):
        n = len(buckets)
        chunks, w_fwds = tensors[:n], tensors[n:]
        ctx.buckets, ctx.w_revs = buckets, w_revs
        ctx.save_for_backward(*chunks)
        vals = [bucket_vals(b, w, c)
                for b, w, c in zip(buckets, w_fwds, chunks)]
        sums, nxt = reduce_send([b.row_offsets for b in buckets], vals,
                                [c.contiguous() for c in chunks],
                                splits=[b.split for b in buckets])
        return (*sums, *nxt)

    @staticmethod
    def backward(ctx, *grads):
        chunks = ctx.saved_tensors
        n = len(chunks)
        g_side = [g.contiguous() for g in grads[:n]]
        back = ring_shift([g.contiguous() for g in grads[n:]], -1)
        d_chunks = [bucket_cotangent(b, w, g, c.dtype) + bk.to(c.dtype)
                    for b, w, g, c, bk in zip(ctx.buckets, ctx.w_revs,
                                              g_side, chunks, back)]
        d_w = [edge_dot(b.src, b.dst, c, g)
               if ctx.needs_input_grad[2 + n + p] else None
               for p, (b, c, g) in enumerate(zip(ctx.buckets, chunks,
                                                 g_side))]
        return (None, None, *d_chunks, *d_w)


def bucket_spmm_send(buckets: Sequence, edge_ws: Sequence[EdgeWeights],
                     chunks: Sequence[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One fused ring step over all partitions, differentiable in the
    chunks and the forward weights: (side partials, next chunks), where
    partition p's partial is the sum over its bucket's edges of
    w * chunk[p][src] -> (R, d) float32, and next[j] = chunks[j - 1].
    ``buckets[p]`` is partition p's bucket of this step
    (``parallel.partition.Bucket``), ``edge_ws[p]`` its staged weights."""
    n = len(chunks)
    out = _BucketSpmmSend.apply(list(buckets), [ew.rev for ew in edge_ws],
                                *chunks, *(ew.fwd for ew in edge_ws))
    return list(out[:n]), list(out[n:])
