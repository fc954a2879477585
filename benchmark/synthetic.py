"""The structural synthetic CKG generator, frozen for the benchmark.

A copy of ``kgat_tpu_torch/data.py::synthetic_dataset`` at commit d0f90ce
(itself draw for draw ``kgat_tpu.data.synthetic_dataset``, the generator
of ``make datasets``), returning plain numpy arrays. It is kept here so
that a later change to the program's generator cannot change the data a
cell trains or serves on; ``benchmark/tests`` holds the two equal at a
small size. The original is listed in PERF.md for a later PR to decide on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate(seed: int, n_users: int, n_items: int, n_entities: int,
             n_relations_kg: int, n_interactions: int, n_triples: int,
             test_frac: float = 0.2, n_factors: int = 32,
             cf_affinity: float = 0.75, kg_affinity: float = 0.75,
             user_mixture: int = 1) -> Dict[str, np.ndarray]:
    """``{"cf_train", "cf_test", "kg_triples"}``: (n, 2) (user, item)
    train and test pairs and (n, 3) (h, r, t) triples, int64. Zipf-like
    popularity over items and entities, one latent cluster per entity and
    user, every user with at least one train and one test interaction."""
    rng = np.random.default_rng(seed)
    if n_entities < n_items:
        raise ValueError("n_entities must be >= n_items")

    item_p = 1.0 / (np.arange(n_items) + 1.0)
    item_p = rng.permutation(item_p)
    item_p /= item_p.sum()

    K = max(1, min(int(n_factors), n_items))
    ent_cluster = rng.integers(0, K, size=n_entities)
    m_mix = max(1, int(user_mixture))
    user_clusters = rng.integers(0, K, size=(n_users, m_mix))
    if m_mix == 1:
        user_w = np.ones((n_users, 1))
    else:
        user_w = rng.dirichlet(np.ones(m_mix), size=n_users)
    user_w_cum = np.cumsum(user_w, axis=1)

    def draw_items(uids: np.ndarray) -> np.ndarray:
        n = len(uids)
        out = rng.choice(n_items, size=n, p=item_p)
        use_aff = rng.random(n) < cf_affinity
        mix_pick = (rng.random(n)[:, None]
                    < user_w_cum[uids]).argmax(axis=1)
        chosen = user_clusters[uids, mix_pick]
        for c in range(K):
            m = use_aff & (chosen == c)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            members = np.nonzero(ent_cluster[:n_items] == c)[0]
            if len(members) == 0:
                continue
            pc = item_p[members] / item_p[members].sum()
            out[m] = rng.choice(members, size=cnt, p=pc)
        return out

    users = rng.integers(0, n_users, size=n_interactions)
    items = draw_items(users)
    base_u = np.repeat(np.arange(n_users), 2)
    base_i = draw_items(base_u)
    users = np.concatenate([base_u, users])
    items = np.concatenate([base_i, items])
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)

    order = rng.permutation(len(pairs))
    pairs = pairs[order]
    sort = np.argsort(pairs[:, 0], kind="stable")
    pairs = pairs[sort]
    uids = pairs[:, 0]
    starts = np.searchsorted(uids, np.arange(n_users), side="left")
    ends = np.searchsorted(uids, np.arange(n_users), side="right")
    counts = ends - starts
    rank = np.arange(len(pairs)) - np.repeat(starts, counts)
    n_test_per_user = np.maximum(1, (counts * test_frac).astype(np.int64))
    n_test_per_user = np.minimum(n_test_per_user, np.maximum(counts - 1, 0))
    is_test = rank < np.repeat(n_test_per_user, counts)
    cf_train = pairs[~is_test]
    cf_test = pairs[is_test]

    ent_p = 1.0 / (np.arange(n_entities) + 1.0)
    ent_p = rng.permutation(ent_p)
    ent_p /= ent_p.sum()

    def draw_tails(heads: np.ndarray) -> np.ndarray:
        n = len(heads)
        out = rng.choice(n_entities, size=n, p=ent_p)
        use_aff = rng.random(n) < kg_affinity
        for c in range(K):
            m = use_aff & (ent_cluster[heads] == c)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            members = np.nonzero(ent_cluster == c)[0]
            if len(members) == 0:
                continue
            pc = ent_p[members] / ent_p[members].sum()
            out[m] = rng.choice(members, size=cnt, p=pc)
        return out

    h = rng.choice(n_entities, size=n_triples, p=ent_p)
    t = draw_tails(h)
    r = rng.integers(0, n_relations_kg, size=n_triples)
    cov_h = np.arange(n_items)
    cov_t = draw_tails(cov_h)
    for _ in range(4):
        m = cov_t == cov_h
        if not m.any():
            break
        cov_t[m] = draw_tails(cov_h[m])
    cov_t = np.where(cov_t == cov_h, (cov_h + 1) % n_entities, cov_t)
    h = np.concatenate([h, cov_h])
    t = np.concatenate([t, cov_t])
    r = np.concatenate([r, rng.integers(0, n_relations_kg, size=n_items)])
    keep = h != t
    kg = np.unique(np.stack([h[keep], r[keep], t[keep]], axis=1), axis=0)
    return {"cf_train": cf_train.astype(np.int64),
            "cf_test": cf_test.astype(np.int64),
            "kg_triples": kg.astype(np.int64)}
