"""The device samplers' negative draw as one launch (``csrc/sampler.cu``).

:func:`kg_draw` and :func:`cf_draw` take the random numbers a batch drew
from the trainer's generator (``torch.randint``'s indices and bits,
``torch.rand``'s float64 uniforms) and the sample table, and return the
batch: the table gathers, the negative's rank among the allowed values,
the ``rank_skip`` search that turns it into the value, and the weight, in
one launch, one warp a row. The plain versions,
``kgat_tpu_torch.sampler.kg_draw_plain`` and ``cf_draw_plain``, run the
same integer arithmetic as torch ops; the kernel returns the same bits.
It replaces no TPU kernel (``kgat_tpu``'s samplers are jnp ops fused by
XLA). ``kgat_tpu_torch.sampler`` calls these for tables on CUDA; the
tables and draws must be contiguous, int64 (the uniforms float64), on one
CUDA device, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from kgat_tpu_torch.ops.hopper import build

# CUDA launches per wrapper call.
CUDA_LAUNCHES = {"kg_draw": 1, "cf_draw": 1}


def _check(name: str, draws: dict, table, keys) -> None:
    """Raise unless the draws and the table's ``keys`` are contiguous 1-D
    int64 tensors (the uniforms ``u01`` float64) on one CUDA device, the
    draws of one length."""
    dev = next(iter(draws.values())).device
    for what, t in {**draws, **{k: getattr(table, k) for k in keys}}.items():
        dtype = torch.float64 if what == "u01" else torch.int64
        build.check_tensor(f"{name}: {what}", t, (dtype,), 1)
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {what} on {t.device}, expected one "
                             f"CUDA device ({dev})")
    if len({t.numel() for t in draws.values()}) != 1:
        raise ValueError(f"{name}: draws of lengths "
                         f"{[t.numel() for t in draws.values()]}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(build.stream_ptr(dev))


def kg_draw(idx: torch.Tensor, u01: torch.Tensor,
            table) -> Tuple[torch.Tensor, ...]:
    """(h, r, t+, t-, weight) of the KG batch of triples ``idx`` (int64
    indices into ``table``'s sampling list) whose negatives' ranks come
    from the uniforms ``u01`` (float64 in [0, 1)): ``table`` a
    ``KGSampleTable`` on the draws' CUDA device. One launch."""
    dev, n = idx.device, idx.numel()
    _check("kg_draw", dict(idx=idx, u01=u01), table,
           ("h", "r", "t", "rg_lo", "rg_hi", "t_sorted"))
    out = torch.empty((4, n), dtype=torch.int64, device=dev)
    weight = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_kg_draw(
            idx.data_ptr(), u01.data_ptr(), table.h.data_ptr(),
            table.r.data_ptr(), table.t.data_ptr(), table.rg_lo.data_ptr(),
            table.rg_hi.data_ptr(), table.t_sorted.data_ptr(),
            table.n_entities, n, out.data_ptr(), weight.data_ptr(),
            _stream(dev))
    build.check_launch(lib, code, "kg_draw")
    build.launch_counts["kg_draw"] += 1
    return (*out.unbind(0), weight)


def cf_draw(a_idx: torch.Tensor, p_bits: torch.Tensor, u01: torch.Tensor,
            table) -> Tuple[torch.Tensor, ...]:
    """(u, i+, i-, weight) of the CF batch of users
    ``table.active_users[a_idx]``, whose positives are their items at
    ``p_bits`` modulo their degrees and whose negatives' ranks come from
    the uniforms ``u01``: ``table`` a ``CFSampleTable`` on the draws' CUDA
    device. One launch."""
    dev, n = a_idx.device, a_idx.numel()
    _check("cf_draw", dict(a_idx=a_idx, p_bits=p_bits, u01=u01), table,
           ("active_users", "user_ptr", "items"))
    out = torch.empty((3, n), dtype=torch.int64, device=dev)
    weight = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_cf_draw(
            a_idx.data_ptr(), p_bits.data_ptr(), u01.data_ptr(),
            table.active_users.data_ptr(), table.user_ptr.data_ptr(),
            table.items.data_ptr(), table.n_items, n, out.data_ptr(),
            weight.data_ptr(), _stream(dev))
    build.check_launch(lib, code, "cf_draw")
    build.launch_counts["cf_draw"] += 1
    return (*out.unbind(0), weight)
