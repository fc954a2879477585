"""The comparisons that decide ``correct``, and what each one reads.

Each check is (name, value, limit): the run is correct when every value
is at most its limit, or its limit is null (read, not compared). The
limits are the cell's (``benchmark/limits/<cell>.json``), set from the
program's readings over a dozen seeds and the control's
(``calibrate.py``); PERF.md gives the readings beside each limit.

Training (the trainer's first steps, which set-up drives through the
window's own call, ``StepGraph.run``):

* ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss.
* ``grad_gap``: the first step's gradient, as the program's Adam holds it
  after one step (its first moment over 1 - b1), against the reference's:
  over the leaves, the largest gap between the two norms of a leaf, over
  the larger of the reference's norm of that leaf and of the median leaf.
* ``change_median_gap``: the same of each leaf's change over the steps,
  the median leaf's (see :func:`change_gaps`). A leaf whose reference
  gradient stays under a thousandth of the median leaf's in every step is
  left out (at the reference recipe ``layers.0.w2``, whose gradient norm
  is about 6e-5).
* ``bad_rows``: batch rows the program drew that the data forbids (a
  positive that is not the user's, a negative that is; a KG positive
  that is no triple, a negative that is). The reference takes the
  program's batches and dropout masks, which it cannot draw itself; this
  and ``mask_z`` check them by themselves.
* ``mask_z``: how many standard deviations the dropout masks' keep rate
  lies from 1 - rate.

Serving (a sample of the requests the window answered, with the longest):

* ``rank_gap``: the widest gap by which a served item's reference score
  lies below the reference's best at its rank, over the user's largest
  |score|.
* ``score_gap``: the largest |served score - reference score| of a
  served item, over the same scale.
* ``masked_served``: served items that are the user's train items.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Check = Tuple[str, float, Optional[float]]


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖ of the leaf, median
    leaf ‖ref‖)."""
    leaves = list(ref if leaves is None else leaves)
    pn = _norms({k: prog[k] for k in leaves})
    rn = _norms({k: ref[k] for k in leaves})
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(gap, leaf): the worst leaf's of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, leaves)
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def moving_leaves(grads: List[Dict[str, torch.Tensor]]) -> List[str]:
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's in some step."""
    peak = {k: max(float(g[k].double().norm()) for g in grads)
            for k in grads[0]}
    med = float(np.median(list(peak.values())))
    return [k for k, v in peak.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict, init: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """The compared numbers of the training steps. ``prog`` and ``ref``
    each hold ``losses``, ``first_grad`` and ``params`` (after the steps);
    ``ref`` also each step's ``grads``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, _ = norm_gap(prog["first_grad"], ref["first_grad"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_median_gap": change_gaps(prog, ref, init)["median"]}


def change_gaps(prog: dict, ref: dict, init: Dict[str, torch.Tensor]
                ) -> Dict[str, float]:
    """The change's leaf gaps over the moving leaves: the median leaf's,
    which is compared, and the worst leaf's, which is not: under Adam a
    leaf's change is set entry by entry, and entries whose gradient is
    near Adam's eps move with the reference's own summation order (two
    reference runs read up to 3.5e-4 against each other)."""
    delta = lambda p: {k: p[k] - init[k] for k in init}  # noqa: E731
    gaps = sorted(leaf_gaps(delta(prog["params"]), delta(ref["params"]),
                            moving_leaves(ref["grads"])).values())
    return {"median": gaps[len(gaps) // 2], "worst": gaps[-1]}


class Members:
    """Membership in sorted runs: run j holds items[ptr[j]:ptr[j + 1]],
    each value below ``big``."""

    def __init__(self, ptr: np.ndarray, items: np.ndarray, big: int):
        run = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
        self.keys, self.big = run * big + items, big

    def has(self, rows: np.ndarray, vals: np.ndarray) -> np.ndarray:
        q = rows * self.big + vals
        pos = np.minimum(np.searchsorted(self.keys, q), self.keys.size - 1)
        return self.keys[pos] == q


def cf_members(data) -> Members:
    ptr, items = data.train_items
    return Members(ptr, items, data.n_items + 1)


def kg_members(data) -> Members:
    """The CKG's tails t of each (h, r), for the KG batch check."""
    src, dst, ety = data.ckg
    key = dst * data.n_relations + ety
    order = np.lexsort((src, key))
    counts = np.bincount(key, minlength=data.n_nodes * data.n_relations)
    return Members(np.concatenate([[0], np.cumsum(counts)]), src[order],
                   data.n_nodes + 1)


def bad_cf_rows(data, members: Members, batch) -> int:
    u, ip, ineg, w = (t.cpu().numpy() for t in batch)
    bad = ~members.has(u, ip) | (ip < 0) | (ip >= data.n_items)
    neg_bad = ((ineg < 0) | (ineg >= data.n_items)
               | members.has(u, np.clip(ineg, 0, None)))
    return int(bad.sum() + ((w > 0) & neg_bad).sum() + (w != (w > 0)).sum())


def bad_kg_rows(data, members: Members, batch) -> int:
    h, r, tp, tn, w = (t.cpu().numpy() for t in batch)
    key = h * data.n_relations + r
    bad = ~members.has(key, tp)
    neg_bad = ((tn < 0) | (tn >= data.n_nodes)
               | members.has(key, np.clip(tn, 0, None)))
    return int(bad.sum() + ((w > 0) & neg_bad).sum() + (w != (w > 0)).sum())


def mask_z(masks: List[Optional[torch.Tensor]], rates) -> float:
    """|keep rate - (1 - rate)| in standard deviations, the worst layer."""
    worst = 0.0
    for m, rate in zip(masks, rates):
        if m is None or rate <= 0:
            continue
        n = m.numel()
        keep = float(m.float().mean())
        sd = math.sqrt(rate * (1 - rate) / n)
        worst = max(worst, abs(keep - (1 - rate)) / sd)
    return worst


def serve_numbers(served_items: np.ndarray, served_scores: np.ndarray,
                  ref_scores: torch.Tensor) -> Dict[str, float]:
    """The compared numbers of one request's users: ``served_*`` (B, k),
    ``ref_scores`` (B, n_items) with the train items at -inf."""
    k = served_items.shape[1]
    ref = ref_scores.double()
    best = torch.topk(ref, k, dim=1).values
    items = torch.as_tensor(served_items, device=ref.device)
    at = torch.gather(ref, 1, items)
    finite = torch.isfinite(ref)
    scale = torch.where(finite, ref.abs(), 0.0).amax(1, keepdim=True)
    scale = scale.clamp(min=1e-30)
    masked = int((~torch.isfinite(at)).sum())
    at_f = torch.where(torch.isfinite(at), at, best)
    rank_gap = float(((best - at_f) / scale).max())
    served = torch.as_tensor(served_scores, device=ref.device).double()
    score_gap = float(((served - at_f).abs() / scale).max())
    return {"rank_gap": rank_gap, "score_gap": score_gap,
            "masked_served": float(masked)}


def verdict(numbers: Dict[str, float], limits: Optional[Dict[str, float]]
            ) -> Tuple[bool, List[Check]]:
    """(correct, checks): each number beside its limit; a number without a
    limit, or no limits at all, is not correct. A limit of None (``null``
    in the file) marks a number that is read and printed but not compared:
    one that neither the control nor a fault separates from sound runs."""
    limits = {} if limits is None else limits
    checks = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(k in limits and (lim is None or (math.isfinite(v) and v <= lim))
             for k, v, lim in checks)
    return ok, checks
