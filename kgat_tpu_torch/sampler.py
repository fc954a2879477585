"""Minibatch samplers on the device: BPR (u, i+, i-) and TransR
(h, r, t+, t-).

Port of ``kgat_tpu/sampler.py``. The device path (``--sampler device``,
the default): the tables live on the device; a batch is a few vectorised
gathers and one binary search, with randomness from an explicit
``torch.Generator`` on the same device. The host samplers (``--sampler
host``, :class:`HostCFSampler` and :class:`HostKGSampler`) are
``kgat_tpu``'s numpy rejection loops, which draw the same batches as
``kgat_tpu``'s from the same seed and data.

The negative draw is direct, not rejection sampling: a rank k is drawn
uniformly among the values the row may take (items the user has not
interacted with; tails t with (h, r, t) not in the CKG), and
:func:`rank_skip` turns it into the value with one binary search over the
row's sorted forbidden run. The distribution is the one rejection sampling
converges to, uniform over the allowed set, with no retries and no failed
rows; a row whose allowed set is empty (the user has every item) gets
weight 0, and the losses drop it from the batch mean.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _log_steps(max_len: int) -> int:
    return max(1, int(np.ceil(np.log2(max_len + 1))))


def rank_skip(sorted_v: torch.Tensor, lo0: torch.Tensor, g: torch.Tensor,
              k: torch.Tensor, steps: int) -> torch.Tensor:
    """Order-statistics core of the direct negative draw.

    ``sorted_v[lo0:lo0+g)`` is a sorted run of unique FORBIDDEN values. For
    a rank k (0-indexed) among the allowed values, returns p = the number
    of forbidden values <= the k-th allowed value; the sample is k + p.
    Invariant: sorted_v[lo0+p] - p counts the allowed values below that
    forbidden value, so p is the smallest p with sorted_v[lo0+p] - p > k,
    found by ``steps`` >= ceil(log2(max run + 1)) rounds of bisection.
    """
    n = sorted_v.shape[0]
    lo_p = torch.zeros_like(k)
    hi_p = torch.broadcast_to(g, k.shape).to(k.dtype)
    for _ in range(max(1, steps)):
        mid = (lo_p + hi_p) // 2
        v = sorted_v[torch.clamp(lo0 + mid, max=n - 1)]
        # mid < hi_p guards the converged state (p == g would otherwise
        # probe one past the forbidden run, into the next row's values).
        le = ((v - mid) <= k) & (mid < hi_p)
        lo_p = torch.where(le, mid + 1, lo_p)
        hi_p = torch.where(le, hi_p, mid)
    return lo_p


@dataclasses.dataclass(frozen=True)
class CFSampleTable:
    """Training interactions on the device, unique and sorted by
    (user, item)."""

    items: torch.Tensor        # (n_train,) int64, sorted within each user
    user_ptr: torch.Tensor     # (n_users + 1,) int64 offsets into items
    active_users: torch.Tensor  # (n_active,) int64 users with >= 1 item
    n_items: int
    max_deg: int

    @staticmethod
    def build(cf_train: np.ndarray, n_users: int, n_items: int, *,
              device=None) -> "CFSampleTable":
        # Unique pairs: positives come from the user's item SET, and
        # rank_skip needs unique sorted forbidden runs.
        pairs = np.unique(np.asarray(cf_train, dtype=np.int64).reshape(-1, 2),
                          axis=0)
        user_ptr = np.searchsorted(pairs[:, 0], np.arange(n_users + 1))
        max_deg = int(np.diff(user_ptr).max()) if len(pairs) else 0
        dev = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                        device=device)
        return CFSampleTable(items=dev(pairs[:, 1]), user_ptr=dev(user_ptr),
                             active_users=dev(np.unique(pairs[:, 0])),
                             n_items=int(n_items), max_deg=max_deg)


def sample_cf_batch(table: CFSampleTable, generator: torch.Generator,
                    batch_size: int) -> Tuple[torch.Tensor, ...]:
    """(u, i+, i-, weight) on the table's device: users uniform over users
    with interactions, one positive uniform over the user's items, one
    negative uniform over the items the user has not interacted with
    (the reference's generate_cf_batch semantics)."""
    dev = table.items.device
    randint = lambda high, **kw: torch.randint(  # noqa: E731
        high, (batch_size,), generator=generator, device=dev, **kw)
    u = table.active_users[randint(table.active_users.shape[0])]
    lo, hi = table.user_ptr[u], table.user_ptr[u + 1]
    deg = hi - lo
    i_pos = table.items[lo + randint(1 << 30) % deg.clamp(min=1)]
    n_allowed = table.n_items - deg
    # A rank in [0, n_allowed): a uniform float times n_allowed, as
    # torch.randint takes no per-row bound.
    k = (torch.rand(batch_size, generator=generator, device=dev,
                    dtype=torch.float64) * n_allowed.clamp(min=1)).long()
    k = torch.minimum(k, (n_allowed - 1).clamp(min=0))
    i_neg = k + rank_skip(table.items, lo, deg, k, _log_steps(table.max_deg))
    valid = n_allowed > 0
    return (u, i_pos, torch.where(valid, i_neg, 0),
            valid.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class KGSampleTable:
    """CKG triples (with inverses and the interaction relations) on the
    device: the sampling list, and the unique tails sorted by (h, r, t)
    with each list row's (h, r) run in them."""

    h: torch.Tensor          # (n_kg,) int64, in sampling order
    r: torch.Tensor
    t: torch.Tensor
    t_sorted: torch.Tensor   # (n_unique,) int64 tails, lex-sorted (h, r, t)
    rg_lo: torch.Tensor      # (n_kg,) int64 row's (h, r) run in t_sorted
    rg_hi: torch.Tensor
    n_entities: int
    max_rg: int              # largest (h, r) run: the rank_skip bound

    @staticmethod
    def build(triples: np.ndarray, n_entities: int, n_relations: int, *,
              device=None) -> "KGSampleTable":
        tr = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        # The sorted index must be UNIQUE for rank_skip; the sampling list
        # keeps multiplicity (positives are uniform over the triple LIST).
        srt = np.unique(tr, axis=0)
        n_rel = max(int(n_relations), 1)
        skey = srt[:, 0] * n_rel + srt[:, 1]
        okey = tr[:, 0] * n_rel + tr[:, 1]
        starts = np.flatnonzero(np.diff(skey, prepend=-1))
        runs = np.diff(np.append(starts, len(skey)))
        dev = lambda a: torch.as_tensor(a, dtype=torch.int64,  # noqa: E731
                                        device=device)
        return KGSampleTable(
            h=dev(tr[:, 0]), r=dev(tr[:, 1]), t=dev(tr[:, 2]),
            t_sorted=dev(srt[:, 2]),
            rg_lo=dev(np.searchsorted(skey, okey, side="left")),
            rg_hi=dev(np.searchsorted(skey, okey, side="right")),
            n_entities=int(n_entities), max_rg=int(runs.max(initial=0)))


def sample_kg_batch(table: KGSampleTable, generator: torch.Generator,
                    batch_size: int) -> Tuple[torch.Tensor, ...]:
    """(h, r, t+, t-, weight) on the table's device: a triple uniform over
    the list, and a negative tail uniform over the entities t with
    (h, r, t) not in the CKG (the reference's generate_kg_batch)."""
    dev = table.h.device
    idx = torch.randint(table.h.shape[0], (batch_size,), generator=generator,
                        device=dev)
    h, r, t_pos = table.h[idx], table.r[idx], table.t[idx]
    lo, hi = table.rg_lo[idx], table.rg_hi[idx]
    g = hi - lo
    n_allowed = table.n_entities - g
    k = (torch.rand(batch_size, generator=generator, device=dev,
                    dtype=torch.float64) * n_allowed.clamp(min=1)).long()
    k = torch.minimum(k, (n_allowed - 1).clamp(min=0))
    t_neg = k + rank_skip(table.t_sorted, lo, g, k, _log_steps(table.max_rg))
    valid = n_allowed > 0
    return (h, r, t_pos, torch.where(valid, t_neg, 0),
            valid.to(torch.float32))


# ---------------------------------------------------------------------------
# Host samplers (the reference's numpy rejection sampling), for parity runs.
# ---------------------------------------------------------------------------

class HostCFSampler:
    """(u, i+, i-) in numpy: users uniform over users with interactions,
    a positive uniform over the user's items, a negative by rejection
    (``kgat_tpu.sampler.HostCFSampler``, draw for draw)."""

    def __init__(self, train_user_dict, n_items: int, seed: int = 0):
        self.dict = {u: set(v.tolist()) for u, v in train_user_dict.items()}
        self.users = np.asarray(sorted(self.dict), dtype=np.int64)
        self.items_by_user = {u: np.asarray(sorted(s), dtype=np.int64)
                              for u, s in self.dict.items()}
        self.n_items = n_items
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int):
        u = self.rng.choice(self.users, size=batch_size)
        i_pos = np.empty(batch_size, np.int64)
        i_neg = np.empty(batch_size, np.int64)
        for k, uu in enumerate(u):
            items = self.items_by_user[int(uu)]
            i_pos[k] = items[self.rng.integers(len(items))]
            while True:
                cand = int(self.rng.integers(self.n_items))
                if cand not in self.dict[int(uu)]:
                    i_neg[k] = cand
                    break
        return u, i_pos, i_neg


class HostKGSampler:
    """(h, r, t+, t-) in numpy: a triple uniform over the list, a negative
    tail by rejection against the set of triples
    (``kgat_tpu.sampler.HostKGSampler``, draw for draw)."""

    def __init__(self, triples: np.ndarray, n_entities: int, seed: int = 0):
        self.triples = np.asarray(triples, dtype=np.int64)
        self.existing = set(map(tuple, self.triples.tolist()))
        self.n_entities = n_entities
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int):
        idx = self.rng.integers(len(self.triples), size=batch_size)
        h, r, t_pos = self.triples[idx].T
        t_neg = np.empty(batch_size, np.int64)
        for k in range(batch_size):
            while True:
                cand = int(self.rng.integers(self.n_entities))
                if (int(h[k]), int(r[k]), cand) not in self.existing:
                    t_neg[k] = cand
                    break
        return h, r, t_pos, t_neg
