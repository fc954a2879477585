"""Adam for the trainer: the shared dense Adam, and the lazy KG step of
``--sparse-adam``.

Port of ``kgat_tpu/optim.py``. One ``torch.optim.Adam`` with
``optax.adam``'s defaults spans every parameter in both phases
(:func:`make_optimizer`); on CUDA its step is one launch of a
hand-written kernel over every parameter (:class:`KernelAdam`).
``--sparse-adam`` replaces the KG phase's dense
Adam pass by :func:`sparse_kg_step`, with TF-LazyAdam semantics: the
TransR loss touches 3B rows of ``entity_embed`` a batch, and only those
rows' parameters and moments are updated (duplicate ids' gradients
summed, as the dense gradient sums them); rows the batch does not name
keep stale moments, with no decay. ``rel_embed`` and ``w_rel`` get a dense
Adam update, and the KG phase freezes the conv weights: their values and
moments stay as they are. One step count serves both phases, as optax's
``count`` does: the lazy step advances every parameter's ``step``, the
skipped conv weights' too, so the next CF step's bias correction counts
the KG steps.

The lazy step has static shapes and no host synchronisation (no
``unique`` or ``nonzero``), so a CUDA graph can capture it
(``train.StepGraph``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from kgat_tpu_torch.models.kgat import (KGAT, KGATConfig, kg_loss,
                                        kg_pair_terms_rows, weighted_mean)
from kgat_tpu_torch.ops.hopper import adam

# optax.adam's defaults.
B1, B2, EPS = 0.9, 0.999, 1e-8


class KernelAdam(torch.optim.Adam):
    """``torch.optim.Adam`` over parameters on one CUDA device whose step
    is one launch of ``ops.hopper.adam.adam_step``: optax's arithmetic
    on each value, gradient and both moments, read once and written once,
    and the step count advanced on the device in the same launch. Every
    parameter's state holds one ``step`` tensor, the same for all, beside
    its own ``exp_avg`` and ``exp_avg_sq``. Nothing is read back to the
    host, so a CUDA graph captures the step, once a first step outside
    the capture has built the launch's tables (``adam.plan_for``); they
    are built again when a parameter's, gradient's or moment's address
    changes. ``zero_grad`` is torch's, one ``_foreach_zero_`` (hence
    ``foreach``)."""

    def __init__(self, params, lr: float):
        super().__init__(params, lr=lr, betas=(B1, B2), eps=EPS,
                         foreach=True)
        self._plan: Optional[adam.AdamPlan] = None

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KernelAdam.step takes no closure")
        (group,) = self.param_groups
        params = group["params"]
        states = [self.state[p] for p in params]
        self._plan = adam.plan_for(
            params, [p.grad for p in params],
            [s["exp_avg"] for s in states], [s["exp_avg_sq"] for s in states],
            states[0]["step"], self._plan)
        b1, b2 = group["betas"]
        adam.adam_step(self._plan, group["lr"], b1, b2, group["eps"])


def make_optimizer(params: Iterable[torch.Tensor],
                   lr: float) -> torch.optim.Adam:
    """One Adam over every parameter with ``optax.adam``'s defaults (b1
    0.9, b2 0.999, eps 1e-8 outside the square root). Each parameter gets a
    zero ``.grad`` now, and the steps zero it in place (``zero_grad(
    set_to_none=False)``), so a parameter that a loss does not reach still
    takes its step, as an optax leaf whose gradient is 0 does, and all
    share one step count. The state (``step``, ``exp_avg``,
    ``exp_avg_sq``) is made now as Adam's first step would make it, so a
    checkpoint loads into it and :func:`sparse_kg_step` finds it before
    any dense step. Parameters on CUDA take :class:`KernelAdam`, whose
    parameters hold one ``step`` tensor on the device; the CPU keeps
    ``torch.optim.Adam``, a ``step`` a parameter on the CPU."""
    params = list(params)
    on_card = bool(params) and all(p.is_cuda for p in params)
    if on_card:
        opt = KernelAdam(params, lr)
        shared = torch.zeros((), dtype=torch.float32,
                             device=params[0].device)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=(B1, B2), eps=EPS)
    for p in params:
        p.grad = torch.zeros_like(p)
        opt.state[p] = {
            "step": shared if on_card else torch.zeros((),
                                                       dtype=torch.float32),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
    return opt


def _step_counts(opt: torch.optim.Adam) -> list:
    """Each distinct ``step`` tensor of ``opt``'s state once (one on
    CUDA, where the parameters share it; one a parameter on the CPU)."""
    return list({id(s["step"]): s["step"]
                 for s in opt.state.values()}.values())


def adam_count(opt: torch.optim.Adam) -> int:
    """The shared step count (every parameter's ``step`` is equal)."""
    counts = {int(s["step"]) for s in opt.state.values()}
    if len(counts) != 1:
        raise ValueError(f"Adam's step counts differ: {sorted(counts)}")
    return counts.pop()


def set_adam_count(opt: torch.optim.Adam, count: int) -> None:
    """Sets every parameter's ``step`` to ``count``, in place (on the
    device on CUDA)."""
    for step in _step_counts(opt):
        step.fill_(float(count))


def _hyper(opt: torch.optim.Adam) -> Tuple[float, float, float, float]:
    group = opt.param_groups[0]
    b1, b2 = group["betas"]
    return group["lr"], b1, b2, group["eps"]


def _adam(p, g, m, v, count, lr, b1, b2, eps):
    """optax's Adam arithmetic on rows: (new p, m, v)."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * (g * g)
    mhat = m2 / (1.0 - b1 ** count)
    vhat = v2 / (1.0 - b2 ** count)
    return p - lr * mhat / (vhat.sqrt() + eps), m2, v2


def sparse_kg_step(model: KGAT, opt: torch.optim.Adam, h: torch.Tensor,
                   r: torch.Tensor, t_pos: torch.Tensor, t_neg: torch.Tensor,
                   cfg: KGATConfig,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One KG step with the lazy entity-row Adam; returns the loss on the
    device. b1, b2, eps and lr come from ``opt``'s param group.

    The TransR loss and its gradients are taken on the 3B gathered rows
    of ``entity_embed`` and on ``rel_embed`` and ``w_rel``. The ids are
    sorted; the first of each run of equal ids opens a segment, and each
    segment sums its rows' gradients. Every sorted position then takes its
    segment's sum and computes the Adam update of its row, so positions
    that name one row compute bit-identical values, and the scatter back
    (``index_copy_``) writes each row with one value whichever duplicate
    lands last."""
    lr, b1, b2, eps = _hyper(opt)
    emb, rel, w_rel = model.entity_embed, model.rel_embed, model.w_rel
    B = h.shape[0]
    idx = torch.cat([h, t_pos, t_neg])
    with torch.enable_grad():
        rows = emb.detach()[idx].requires_grad_()
        eh, ep, en = rows.split(B)
        pair, ssq = kg_pair_terms_rows(eh, ep, en, rel[r], w_rel[r])
        loss = weighted_mean(pair, weight) + cfg.reg_kg * ssq / B
        g_rows, g_rel, g_w = torch.autograd.grad(loss, (rows, rel, w_rel))
    with torch.no_grad():
        ids, order = torch.sort(idx, stable=True)
        first = torch.ones_like(ids, dtype=torch.bool)
        first[1:] = ids[1:] != ids[:-1]
        seg = torch.cumsum(first, 0) - 1
        g_seg = torch.zeros_like(g_rows).index_add_(0, seg, g_rows[order])
        for step in _step_counts(opt):
            step += 1
        st = opt.state[emb]
        count = st["step"]
        p2, m2, v2 = _adam(emb[ids], g_seg[seg], st["exp_avg"][ids],
                           st["exp_avg_sq"][ids], count, lr, b1, b2, eps)
        emb.index_copy_(0, ids, p2)
        st["exp_avg"].index_copy_(0, ids, m2)
        st["exp_avg_sq"].index_copy_(0, ids, v2)
        for p, g in ((rel, g_rel), (w_rel, g_w)):
            s = opt.state[p]
            p2, m2, v2 = _adam(p, g, s["exp_avg"], s["exp_avg_sq"], count,
                               lr, b1, b2, eps)
            p.copy_(p2)
            s["exp_avg"].copy_(m2)
            s["exp_avg_sq"].copy_(v2)
    return loss.detach()


def sparse_kg_step_plain(model: KGAT, opt: torch.optim.Adam,
                         h: torch.Tensor, r: torch.Tensor,
                         t_pos: torch.Tensor, t_neg: torch.Tensor,
                         cfg: KGATConfig,
                         weight: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = torch.float64
                         ) -> Tuple[float, Dict[str, tuple], np.ndarray]:
    """The dense-state oracle of :func:`sparse_kg_step`, in ``dtype``:
    ``kg_loss``'s gradient over the whole tables (the ref backend's
    gathered path: the hopper backend's kernels take float32 alone), then
    Adam on the rows the batch names (found with ``torch.unique``) and
    dense Adam on the relation tables, at count + 1. Leaves ``model`` and ``opt`` as they
    are. Returns (loss, {name: (param, exp_avg, exp_avg_sq)} for
    ``entity_embed``, ``rel_embed`` and ``w_rel``, the touched rows)."""
    lr, b1, b2, eps = _hyper(opt)
    names = ("entity_embed", "rel_embed", "w_rel")
    params = {n: getattr(model, n).detach().to(dtype).requires_grad_()
              for n in names}
    with torch.enable_grad():
        loss = kg_loss(types.SimpleNamespace(**params), h, r, t_pos, t_neg,
                       dataclasses.replace(cfg, ops_backend="ref"),
                       weight=None if weight is None else weight.to(dtype))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    count = float(adam_count(opt) + 1)
    touched = torch.unique(torch.cat([h, t_pos, t_neg]))
    out = {}
    with torch.no_grad():
        for n, g in zip(names, grads):
            s = opt.state[getattr(model, n)]
            p, m, v = (params[n].detach().clone(), s["exp_avg"].to(dtype),
                       s["exp_avg_sq"].to(dtype))
            sel = touched if n == "entity_embed" else slice(None)
            p[sel], m[sel], v[sel] = _adam(p[sel], g[sel], m[sel], v[sel],
                                           count, lr, b1, b2, eps)
            out[n] = (p, m, v)
    return float(loss.detach()), out, touched.cpu().numpy()
