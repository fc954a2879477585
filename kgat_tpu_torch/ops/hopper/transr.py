"""The KG step's TransR projection as one op (``csrc/transr.cu``): the
relation-indexed products and the gradients of the relation tables summed
by relation, without ``w_rel[r]``'s (B, d, k) gather and without
autograd's accumulating ``index_put``.

:func:`transr_project` takes the gathered entity rows ``eh``, ``ep``,
``en`` (B, d), the tables ``rel_embed`` (R, k) and ``w_rel`` (R, d, k)
and the relations ``r`` (B,), and returns ``eh W_r``, ``ep W_r``, ``en
W_r`` and ``e_r`` (B, k), differentiable in the rows and both tables.
It replaces no TPU kernel (``kgat_tpu``'s ``kg_loss`` leaves the products
to XLA). The hopper backend's ``kg_projection`` calls it.

A call first makes a plan (:class:`TransRPlan`): the batch sorted by
relation, stably, and each relation's run cut into units of at most
``UNIT_ROWS`` rows. The forward launches the plan and the projection; the
backward the units' partial sums and their fold by relation. CPU tensors
take the plain version (the per-pair gather of ``w_rel`` and
``rel_embed``, through autograd), CUDA tensors the kernels, which take
float32 alone and raise for any other dtype. The kernels sum in a fixed
order and without atomics, so two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build

# Rows per unit, chosen on an H100 (PERF.md, the kernel table): short
# enough that the interaction relations' runs (some 380 and 830 rows of a
# 2,048-row batch) spread over many blocks, long enough that a unit stages
# W_r (16 KB at d = k = 64) for many rows.
UNIT_ROWS = 32
# Entity rows a block stages in shared memory at a time (kStage).
STAGE_ROWS = 32
MAX_WIDTH = 256
SMEM_BYTES = 227 * 1024
# CUDA launches per wrapper call.
CUDA_LAUNCHES = {"transr_plan": 1, "transr_forward": 1, "transr_backward": 2}


@dataclasses.dataclass(frozen=True)
class TransRPlan:
    """A batch's rows grouped by relation, all tensors int32 on its
    device."""

    perm: torch.Tensor          # (B,) batch rows sorted by relation, stably
    rel_offsets: torch.Tensor   # (R + 1,) relation q's rows: perm[rel_offsets[q]:rel_offsets[q + 1]]
    units: torch.Tensor         # (max_units, 4) (rel, lo, hi, 0) over perm; lo == hi past the last
    unit_offsets: torch.Tensor  # (R + 1,) relation q's units: units[unit_offsets[q]:unit_offsets[q + 1]]

    @property
    def tensors(self):
        return self.perm, self.rel_offsets, self.units, self.unit_offsets


def max_units(n: int, n_rel: int, unit_rows: int = UNIT_ROWS) -> int:
    """The static bound on a plan's units: ceil(n / unit_rows) + n_rel."""
    return -(-n // unit_rows) + n_rel


def transr_plan_plain(r: torch.Tensor, n_rel: int,
                      unit_rows: int = UNIT_ROWS) -> TransRPlan:
    """Plain PyTorch version of :func:`transr_plan`."""
    r = r.long()
    dev = r.device
    counts = torch.bincount(r, minlength=n_rel)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    rel_offsets = torch.cat([zero, torch.cumsum(counts, 0)])
    per_rel = (counts + unit_rows - 1) // unit_rows
    unit_offsets = torch.cat([zero, torch.cumsum(per_rel, 0)])
    rel = torch.repeat_interleave(torch.arange(n_rel, device=dev), per_rel)
    t = torch.arange(rel.numel(), device=dev) - unit_offsets[rel]
    lo = rel_offsets[rel] + t * unit_rows
    hi = torch.minimum(lo + unit_rows, rel_offsets[rel + 1])
    units = torch.zeros((max_units(r.numel(), n_rel, unit_rows), 4),
                        dtype=torch.long, device=dev)
    units[:rel.numel(), :3] = torch.stack([rel, lo, hi], 1)
    as32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return TransRPlan(perm=as32(torch.sort(r, stable=True).indices),
                      rel_offsets=as32(rel_offsets), units=as32(units),
                      unit_offsets=as32(unit_offsets))


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(build.stream_ptr(t.device))


def transr_plan(r: torch.Tensor, n_rel: int,
                unit_rows: int = UNIT_ROWS) -> TransRPlan:
    """The batch ``r`` ((B,) relations in [0, n_rel), B > 0) grouped by
    relation: a stable counting sort and units of at most ``unit_rows``
    rows. CPU tensors take :func:`transr_plan_plain`; CUDA tensors launch
    one block."""
    if not build.use_kernel("transr_plan", r):
        return transr_plan_plain(r, n_rel, unit_rows)
    r = r.to(torch.int64).contiguous()
    n = r.numel()
    if r.dim() != 1 or n == 0 or n_rel < 1:
        raise ValueError(f"transr_plan: r {tuple(r.shape)}, {n_rel} relations")
    i32 = dict(dtype=torch.int32, device=r.device)
    plan = TransRPlan(perm=torch.empty(n, **i32),
                      rel_offsets=torch.empty(n_rel + 1, **i32),
                      units=torch.empty((max_units(n, n_rel, unit_rows), 4),
                                        **i32),
                      unit_offsets=torch.empty(n_rel + 1, **i32))
    lib = build.library()
    with torch.cuda.device(r.device):
        code = lib.kgat_transr_plan(
            r.data_ptr(), n, n_rel, unit_rows, plan.units.shape[0],
            plan.perm.data_ptr(), plan.rel_offsets.data_ptr(),
            plan.units.data_ptr(), plan.unit_offsets.data_ptr(), _stream(r))
    build.check_launch(lib, code, "transr_plan")
    build.launch_counts["transr_plan"] += 1
    return plan


def check_widths(d: int, k: int) -> None:
    """Raise unless the kernels take rows of d and k floats: multiples of
    4 from 4 to ``MAX_WIDTH``, W_r and ``STAGE_ROWS`` rows of each kind
    within a block's shared memory."""
    smem = 4 * (d * (k + 4) + STAGE_ROWS * (3 * d + 4 * k + 1))
    if (min(d, k) < 4 or max(d, k) > MAX_WIDTH or d % 4 or k % 4
            or smem > SMEM_BYTES):
        raise ValueError(f"the TransR kernels take d and k in multiples of 4 "
                         f"up to {MAX_WIDTH} with W_r and {STAGE_ROWS} rows "
                         f"in {SMEM_BYTES} bytes of shared memory, not "
                         f"d = {d}, k = {k}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte boundary, as the kernels read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def transr_forward_plain(eh, ep, en, rel_embed, w_rel, r):
    """Plain PyTorch version of :func:`transr_project`: ``w_rel`` and
    ``rel_embed`` gathered per pair, then ``ref.project_rows``."""
    return (*ref.project_rows(eh, ep, en, w_rel[r]), rel_embed[r])


def transr_forward(plan: TransRPlan, eh: torch.Tensor, ep: torch.Tensor,
                   en: torch.Tensor, rel_embed: torch.Tensor,
                   w_rel: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(ph, pp, pn, e_r), each (B, k): the rows eh, ep, en (B, d) times
    W_r, and e_r, over ``plan``'s units. CUDA float32 tensors only (the
    plain version takes ``r``, not a plan)."""
    if not build.use_kernel("transr_forward", eh, ep, en, rel_embed, w_rel,
                            plan.perm):
        raise ValueError("transr_forward: CUDA tensors only")
    for name, t in (("eh", eh), ("ep", ep), ("en", en),
                    ("rel_embed", rel_embed), ("w_rel", w_rel)):
        if t.dtype != torch.float32 or t.dim() != (3 if t is w_rel else 2):
            raise ValueError(f"transr_forward: {name} {t.dtype} "
                             f"{tuple(t.shape)}")
    (n, d), (n_rel, _, k) = eh.shape, w_rel.shape
    check_widths(d, k)
    if (ep.shape != eh.shape or en.shape != eh.shape or w_rel.shape[1] != d
            or rel_embed.shape != (n_rel, k)):
        raise ValueError(f"transr_forward: eh {tuple(eh.shape)}, ep "
                         f"{tuple(ep.shape)}, en {tuple(en.shape)}, w_rel "
                         f"{tuple(w_rel.shape)}, rel_embed "
                         f"{tuple(rel_embed.shape)} disagree")
    eh, ep, en, rel_embed, w_rel = map(_rows,
                                       (eh, ep, en, rel_embed, w_rel))
    out = [torch.empty((n, k), dtype=torch.float32, device=eh.device)
           for _ in range(4)]
    lib = build.library()
    with torch.cuda.device(eh.device):
        code = lib.kgat_transr_fwd(
            plan.units.data_ptr(), plan.units.shape[0], plan.perm.data_ptr(),
            eh.data_ptr(), ep.data_ptr(), en.data_ptr(), rel_embed.data_ptr(),
            w_rel.data_ptr(), *(o.data_ptr() for o in out), d, k,
            _stream(eh))
    build.check_launch(lib, code, "transr_forward")
    build.launch_counts["transr_forward"] += 1
    return tuple(out)


def transr_backward_plain(eh, ep, en, w_rel, r, gph, gpp, gpn, ger):
    """Plain PyTorch version of :func:`transr_backward` (in float64 when
    the inputs are): the rows' gradients through W_r, and the relation
    tables' summed by relation with ``index_add_``."""
    w_r = w_rel[r]
    back = lambda g: torch.einsum("bk,bdk->bd", g, w_r)  # noqa: E731
    outer = (torch.einsum("bd,bk->bdk", eh, gph)
             + torch.einsum("bd,bk->bdk", ep, gpp)
             + torch.einsum("bd,bk->bdk", en, gpn))
    d_w = torch.zeros_like(w_rel).index_add_(0, r, outer)
    d_er = torch.zeros((w_rel.shape[0], ger.shape[1]), dtype=ger.dtype,
                       device=ger.device).index_add_(0, r, ger)
    return back(gph), back(gpp), back(gpn), d_er, d_w


def transr_backward(plan: TransRPlan, eh, ep, en, w_rel, gph, gpp, gpn,
                    ger) -> Tuple[torch.Tensor, ...]:
    """(d eh, d ep, d en, d rel_embed, d w_rel) from the cotangents of
    :func:`transr_forward`'s outputs: two launches, the units (the rows'
    gradients and each unit's partial sums) and their fold by relation in
    unit order (zeros for a relation the batch leaves out)."""
    if not build.use_kernel("transr_backward", eh, ep, en, w_rel, gph, gpp,
                            gpn, ger, plan.perm):
        raise ValueError("transr_backward: CUDA tensors only")
    for name, t in (("gph", gph), ("gpp", gpp), ("gpn", gpn), ("ger", ger)):
        if t.dtype != torch.float32 or t.shape != (eh.shape[0],
                                                   w_rel.shape[2]):
            raise ValueError(f"transr_backward: {name} {t.dtype} "
                             f"{tuple(t.shape)}")
    (n, d), (n_rel, _, k) = eh.shape, w_rel.shape
    check_widths(d, k)
    eh, ep, en, w_rel, gph, gpp, gpn, ger = map(
        _rows, (eh, ep, en, w_rel, gph, gpp, gpn, ger))
    dev = eh.device
    d_rows = [torch.empty((n, d), dtype=torch.float32, device=dev)
              for _ in range(3)]
    d_er = torch.empty((n_rel, k), dtype=torch.float32, device=dev)
    d_w = torch.empty((n_rel, d, k), dtype=torch.float32, device=dev)
    n_units = plan.units.shape[0]
    partials = torch.empty((n_units, d * k + k), dtype=torch.float32,
                           device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_transr_bwd(
            plan.units.data_ptr(), n_units, plan.unit_offsets.data_ptr(),
            plan.perm.data_ptr(), eh.data_ptr(), ep.data_ptr(), en.data_ptr(),
            w_rel.data_ptr(), gph.data_ptr(), gpp.data_ptr(), gpn.data_ptr(),
            ger.data_ptr(), *(t.data_ptr() for t in d_rows),
            partials.data_ptr(), d_w.data_ptr(), d_er.data_ptr(), n_rel, d,
            k, _stream(eh))
    build.check_launch(lib, code, "transr_backward")
    build.launch_counts["transr_backward"] += 1
    return (*d_rows, d_er, d_w)


class _TransRProject(torch.autograd.Function):
    """The plan and the projection forward; the units and the fold
    backward."""

    @staticmethod
    def forward(ctx, eh, ep, en, rel_embed, w_rel, r):
        plan = transr_plan(r, w_rel.shape[0], UNIT_ROWS)
        ctx.save_for_backward(eh, ep, en, w_rel, *plan.tensors)
        return transr_forward(plan, eh, ep, en, rel_embed, w_rel)

    @staticmethod
    def backward(ctx, gph, gpp, gpn, ger):
        eh, ep, en, w_rel, *plan = ctx.saved_tensors
        grads = transr_backward(TransRPlan(*plan), eh, ep, en, w_rel, gph,
                                gpp, gpn, ger)
        return (*grads, None)


def transr_project(eh: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                   rel_embed: torch.Tensor, w_rel: torch.Tensor,
                   r: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(eh W_r, ep W_r, en W_r, e_r), each (B, k), differentiable in eh,
    ep, en (B, d), rel_embed (R, k) and w_rel (R, d, k); r (B,) holds
    relations in [0, R). CPU tensors take :func:`transr_forward_plain`;
    CUDA tensors the kernels, float32 only."""
    if not eh.is_cuda:
        return transr_forward_plain(eh, ep, en, rel_embed, w_rel, r)
    return _TransRProject.apply(eh, ep, en, rel_embed, w_rel, r)
