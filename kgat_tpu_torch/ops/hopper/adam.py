"""The trainer's Adam step as one kernel launch (``csrc/adam.cu``).

:func:`adam_step` updates every parameter of a :class:`AdamPlan` with
``optax.adam``'s arithmetic: each value, its gradient and both moments
read once, the value and moments written once, and the one step count
that all parameters share advanced, on the device, in the same launch.
It replaces no TPU kernel (``kgat_tpu`` leaves the update to XLA).
``optim.make_optimizer`` drives it for parameters on CUDA; CPU tensors
keep ``torch.optim.Adam``, and ``optim._adam`` is the plain version of
the arithmetic.

A plan is two device tables: one record a parameter (the addresses of
its value, gradient and moments, its length, its first chunk) and the
parameter of each chunk of the kernel's blocks. It is built from the
tensors' addresses and kept while they stay; a CUDA graph that captured
a launch replays it, as the addresses must not move (``train.StepGraph``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from kgat_tpu_torch.ops.hopper import build

# CUDA launches per wrapper call.
CUDA_LAUNCHES = {"adam": 1}
# Bytes a value moves: p, g, m, v read; p, m, v written (float32).
BYTES_PER_VALUE = 28


@dataclasses.dataclass(frozen=True)
class AdamPlan:
    """Device tables of one launch over a fixed set of float32 tensors."""

    key: Tuple[int, ...]        # the addresses and lengths it holds
    tensors: torch.Tensor       # (n, 6) int64: p, g, m, v, numel, first chunk
    chunk_tensor: torch.Tensor  # (n_chunks,) int32: each chunk's parameter
    step: torch.Tensor          # () float32: the shared step count
    ticket: torch.Tensor        # (1,) int32: the blocks that have finished


def _key(params, grads, exp_avgs, exp_avg_sqs, step) -> Tuple[int, ...]:
    return (step.data_ptr(),) + tuple(
        x for ts in zip(params, grads, exp_avgs, exp_avg_sqs)
        for x in (*(t.data_ptr() for t in ts), ts[0].numel()))


def plan_for(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             exp_avgs: Sequence[torch.Tensor],
             exp_avg_sqs: Sequence[torch.Tensor], step: torch.Tensor,
             old: Optional[AdamPlan] = None) -> AdamPlan:
    """The plan of these tensors: ``old`` when it holds the same addresses
    and lengths, else a new one (a host-to-device copy of the tables,
    which raises during a CUDA graph capture: take one step eagerly
    first). All tensors contiguous float32 on one CUDA device, each
    gradient and moment the shape of its parameter; ``step`` a float32
    scalar there."""
    key = _key(params, grads, exp_avgs, exp_avg_sqs, step)
    if old is not None and old.key == key:
        return old
    if not params:
        raise ValueError("adam: no parameters")
    dev = params[0].device
    for group in zip(params, grads, exp_avgs, exp_avg_sqs):
        for t in group:
            if (t.device != dev or dev.type != "cuda"
                    or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.shape != group[0].shape):
                raise ValueError(
                    f"adam: contiguous float32 tensors on one CUDA device, "
                    f"each the shape of its parameter, not {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if (step.device != dev or step.dtype != torch.float32
            or step.numel() != 1):
        raise ValueError(f"adam: step {step.dtype} {tuple(step.shape)} on "
                         f"{step.device}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("adam: the tensors' addresses changed during a "
                           "CUDA graph capture; step once eagerly first")
    chunk = build.library().kgat_adam_chunk()
    sizes = [p.numel() for p in params]
    per = [-(-n // chunk) for n in sizes]
    first = np.concatenate([[0], np.cumsum(per)[:-1]])
    rows = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(),
                      v.data_ptr(), n, f]
                     for p, g, m, v, n, f in zip(params, grads, exp_avgs,
                                                 exp_avg_sqs, sizes, first)],
                    dtype=np.int64)
    chunk_tensor = np.repeat(np.arange(len(params), dtype=np.int32), per)
    return AdamPlan(key=key, tensors=torch.from_numpy(rows).to(dev),
                    chunk_tensor=torch.from_numpy(chunk_tensor).to(dev),
                    step=step,
                    ticket=torch.zeros(1, dtype=torch.int32, device=dev))


def adam_step(plan: AdamPlan, lr: float, b1: float, b2: float,
              eps: float) -> None:
    """One Adam step over ``plan``'s tensors at count ``plan.step`` + 1,
    in place, in one launch on the current stream; the count is advanced
    on the device."""
    lib = build.library()
    dev = plan.step.device
    with torch.cuda.device(dev):
        code = lib.kgat_adam(
            plan.tensors.data_ptr(), plan.tensors.shape[0],
            plan.chunk_tensor.data_ptr(), plan.chunk_tensor.shape[0],
            plan.step.data_ptr(), plan.ticket.data_ptr(), lr, b1, b2, eps,
            ctypes.c_void_p(build.stream_ptr(dev)))
    build.check_launch(lib, code, "adam")
    build.launch_counts["adam"] += 1
