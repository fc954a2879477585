"""Data layer: dataset loaders and synthetic data, host-side numpy.

Port of ``kgat_tpu/data.py``. File formats (original KGAT release):

  train.txt / test.txt : one user per line: ``uid iid iid ...``
  kg_final.txt         : one triple per line: ``h r t`` (ids already remapped,
                         items occupy entity ids [0, n_items))

:func:`synthetic_dataset` makes the same numpy RNG calls in the same order
as ``kgat_tpu.data.synthetic_dataset``, so the two return bit-equal arrays
for the same arguments. The parsers are the plain-Python ones (the JAX
package's native parser gives the same arrays).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

from kgat_tpu_torch.graph import REL_TILE, CKGMeta, Graph, build_ckg


@dataclasses.dataclass
class Dataset:
    """A loaded recsys+KG dataset, host-side."""

    name: str
    cf_train: np.ndarray            # (n_train, 2) int64 (user, item)
    cf_test: np.ndarray             # (n_test, 2) int64
    kg_triples: np.ndarray          # (n_triples, 3) int64 (h, r, t)
    n_users: int
    n_items: int
    n_entities: int
    n_relations_kg: int

    # Derived, filled in __post_init__:
    train_user_dict: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    test_user_dict: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.train_user_dict:
            self.train_user_dict = _group_by_user(self.cf_train)
        if not self.test_user_dict:
            self.test_user_dict = _group_by_user(self.cf_test)

    def build(self, *, rel_tile: int = REL_TILE) -> Tuple[Graph, CKGMeta]:
        """Construct the collaborative knowledge graph from train CF + KG."""
        return build_ckg(
            self.cf_train, self.kg_triples,
            n_users=self.n_users, n_entities=self.n_entities,
            n_items=self.n_items, n_relations_kg=self.n_relations_kg,
            rel_tile=rel_tile)


def _group_by_user(pairs: np.ndarray) -> Dict[int, np.ndarray]:
    if len(pairs) == 0:
        return {}
    pairs = np.unique(np.asarray(pairs, dtype=np.int64), axis=0)
    uids, starts = np.unique(pairs[:, 0], return_index=True)
    chunks = np.split(pairs[:, 1], starts[1:])
    return {int(u): c for u, c in zip(uids, chunks)}


def _parse_user_items(path: str) -> np.ndarray:
    """Parse ``uid iid iid ...`` lines -> (n, 2) int64 pairs."""
    pairs = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            u = int(toks[0])
            pairs.extend((u, int(t)) for t in toks[1:])
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def load_dataset(root: str, name: str) -> Dataset:
    """Load a dataset in the reference's on-disk format (amazon-book etc.)."""
    ddir = os.path.join(root, name)
    train = _parse_user_items(os.path.join(ddir, "train.txt"))
    test = _parse_user_items(os.path.join(ddir, "test.txt"))
    kg = np.loadtxt(os.path.join(ddir, "kg_final.txt"),
                    dtype=np.int64).reshape(-1, 3)
    # Deduplicate triples as the reference loader does.
    kg = np.unique(kg, axis=0)
    n_users = int(max(train[:, 0].max(), test[:, 0].max())) + 1
    n_items = int(max(train[:, 1].max(), test[:, 1].max())) + 1
    n_entities = int(max(kg[:, 0].max(), kg[:, 2].max(), n_items - 1)) + 1
    n_relations = int(kg[:, 1].max()) + 1
    return Dataset(
        name=name, cf_train=train, cf_test=test, kg_triples=kg,
        n_users=n_users, n_items=n_items, n_entities=n_entities,
        n_relations_kg=n_relations,
    )


def synthetic_dataset(
    seed: int = 0,
    n_users: int = 200,
    n_items: int = 150,
    n_entities: int = 300,
    n_relations_kg: int = 6,
    n_interactions: int = 2000,
    n_triples: int = 1500,
    test_frac: float = 0.2,
    name: str = "synthetic",
    n_factors: int = 32,
    cf_affinity: float = 0.75,
    kg_affinity: float = 0.75,
    user_mixture: int = 1,
) -> Dataset:
    """Generate a structurally-faithful synthetic dataset.

    Zipf-like item/entity popularity with a latent-factor signal: every
    entity belongs to one of ``n_factors`` clusters, each user prefers one
    cluster (or a Dirichlet mixture of ``user_mixture`` clusters), and a
    ``cf_affinity`` fraction of interactions (``kg_affinity`` of KG tails)
    is drawn from the preferred (head's) cluster. Every user has at least
    one train and one test interaction. See ``kgat_tpu.data`` for the
    full rationale; the draws here are the same, call for call.
    """
    rng = np.random.default_rng(seed)
    if n_entities < n_items:
        raise ValueError("n_entities must be >= n_items")

    # Zipf-ish item popularity.
    item_p = 1.0 / (np.arange(n_items) + 1.0)
    item_p = rng.permutation(item_p)
    item_p /= item_p.sum()

    # Latent clusters over ALL entities (items are entities [0, n_items)).
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
        out = rng.choice(n_items, size=n, p=item_p)     # popularity draws
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
    # Guarantee >= 2 interactions per user (1 train + 1 test).
    base_u = np.repeat(np.arange(n_users), 2)
    base_i = draw_items(base_u)
    users = np.concatenate([base_u, users])
    items = np.concatenate([base_i, items])
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)

    # Per-user split: test_frac of each user's items go to test.
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
    # Every item appears in the KG as a head; redraw coverage tails that
    # hit their own head, with a guaranteed-distinct fallback.
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

    return Dataset(
        name=name, cf_train=cf_train.astype(np.int64),
        cf_test=cf_test.astype(np.int64), kg_triples=kg.astype(np.int64),
        n_users=n_users, n_items=n_items, n_entities=n_entities,
        n_relations_kg=n_relations_kg,
    )


def save_dataset(ds: Dataset, root: str) -> str:
    """Write a dataset in the reference's on-disk format.

    Produces <root>/<name>/{train,test,kg_final}.txt, readable by
    :func:`load_dataset` and by ``kgat_tpu.data.load_dataset``.
    """
    ddir = os.path.join(root, ds.name)
    os.makedirs(ddir, exist_ok=True)

    def write_ui(path, user_dict):
        with open(path, "w") as f:
            for u in sorted(user_dict):
                items = " ".join(str(i) for i in user_dict[u])
                f.write(f"{u} {items}\n")

    write_ui(os.path.join(ddir, "train.txt"), ds.train_user_dict)
    write_ui(os.path.join(ddir, "test.txt"), ds.test_user_dict)
    with open(os.path.join(ddir, "kg_final.txt"), "w") as f:
        f.writelines(f"{h} {r} {t}\n" for h, r, t in ds.kg_triples.tolist())
    return ddir
