"""The port's device samplers (kgat_tpu_torch.sampler) on the CPU.

Every positive is an observed pair or triple and every negative lies
outside the user's item set or the (h, r) tail set; a chi-squared test
shows the negatives uniform over the allowed set; ``rank_skip`` matches
``kgat_tpu.sampler.rank_skip`` on identical inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from kgat_tpu import sampler as jsampler
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.sampler import (CFSampleTable, KGSampleTable, rank_skip,
                                    sample_cf_batch, sample_kg_batch)

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=3, n_users=50, n_items=40, n_entities=80, n_relations_kg=4,
             n_interactions=600, n_triples=400)


@pytest.fixture(scope="module")
def small():
    ds = tdata.synthetic_dataset(**SMALL)
    g, meta = ds.build()
    triples = np.stack([g.dst.numpy(), g.etype.numpy(), g.src.numpy()], 1)
    return ds, meta, triples


def test_rank_skip_matches_jax():
    """Random sorted forbidden runs (some empty, one covering a whole
    prefix) and every allowed rank of each run: the same p as kgat_tpu."""
    rs = np.random.default_rng(0)
    n_values, runs = 50, []
    for size in (0, 1, 7, 20, 49, 3):
        runs.append(np.sort(rs.choice(n_values, size, replace=False)))
    runs.append(np.arange(12))                 # forbidden prefix 0..11
    sorted_v = np.concatenate(runs).astype(np.int64)
    starts = np.cumsum([0] + [len(r) for r in runs[:-1]])
    lo0, g, k, run = [], [], [], []
    for i, (s, r) in enumerate(zip(starts, runs)):
        for rank in range(n_values - len(r)):
            lo0.append(s)
            g.append(len(r))
            k.append(rank)
            run.append(i)
    lo0, g, k, run = (np.asarray(a, np.int64) for a in (lo0, g, k, run))
    steps = jsampler._log_steps(max(len(r) for r in runs))
    want = np.asarray(jsampler.rank_skip(
        jnp.asarray(sorted_v, jnp.int32), jnp.asarray(lo0, jnp.int32),
        jnp.asarray(g, jnp.int32), jnp.asarray(k, jnp.int32), steps))
    got = rank_skip(torch.tensor(sorted_v), torch.tensor(lo0),
                    torch.tensor(g), torch.tensor(k), steps).numpy()
    np.testing.assert_array_equal(got, want)
    # And the sample k + p is the k-th allowed value of its run.
    for i, r in enumerate(runs):
        allowed = np.setdiff1d(np.arange(n_values), r)
        np.testing.assert_array_equal((k + got)[run == i], allowed)


def test_cf_batch_positives_observed_negatives_not(small):
    ds, meta, _ = small
    table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items)
    u, ip, ineg, w = sample_cf_batch(table, torch.Generator().manual_seed(1),
                                     2048)
    assert u.shape == ip.shape == ineg.shape == w.shape == (2048,)
    assert (w == 1).all()
    train = {int(x): set(v.tolist()) for x, v in ds.train_user_dict.items()}
    for uu, p, n in zip(u.tolist(), ip.tolist(), ineg.tolist()):
        assert p in train[uu]
        assert n not in train[uu] and 0 <= n < meta.n_items
    assert len(set(ineg.tolist())) > meta.n_items // 2


def test_kg_batch_positives_observed_negatives_not(small):
    _, meta, triples = small
    table = KGSampleTable.build(triples, meta.n_nodes, meta.n_relations)
    h, r, tp, tn, w = sample_kg_batch(table, torch.Generator().manual_seed(2),
                                      2048)
    assert (w == 1).all()
    existing = set(map(tuple, triples.tolist()))
    for hh, rr, p, n in zip(h.tolist(), r.tolist(), tp.tolist(), tn.tolist()):
        assert (hh, rr, p) in existing
        assert (hh, rr, n) not in existing and 0 <= n < meta.n_nodes


def _one_user_table(forbidden, n_items):
    pairs = np.stack([np.zeros(len(forbidden), np.int64), forbidden], 1)
    return CFSampleTable.build(pairs, 1, n_items)


def test_cf_negatives_uniform_over_allowed_items():
    """One user with items {1, 4, 5, 9} of 12: 20,000 negatives over the 8
    allowed items pass a chi-squared test of uniformity (p > 0.001; the
    seed is fixed, so the test is deterministic)."""
    table = _one_user_table(np.array([1, 4, 5, 9]), 12)
    _, _, ineg, w = sample_cf_batch(table, torch.Generator().manual_seed(3),
                                    20000)
    allowed = np.setdiff1d(np.arange(12), [1, 4, 5, 9])
    counts = np.bincount(ineg.numpy(), minlength=12)
    assert counts[[1, 4, 5, 9]].sum() == 0 and (w == 1).all()
    assert stats.chisquare(counts[allowed]).pvalue > 1e-3


def test_kg_negatives_uniform_over_allowed_tails():
    """Head 0 with relation 1 has tails {0, 2, 3} of 10 entities (another
    (h, r) run beside it): the ~24,000 negatives drawn for its three
    triples' rows, over the 7 allowed tails,
    pass a chi-squared test of uniformity (p > 0.001)."""
    triples = np.array([[0, 1, 0], [0, 1, 2], [0, 1, 3], [0, 0, 5],
                        [4, 1, 6]])
    table = KGSampleTable.build(triples, n_entities=10, n_relations=2)
    h, r, _, tn, _ = sample_kg_batch(table, torch.Generator().manual_seed(4),
                                     40000)
    sel = ((h == 0) & (r == 1)).numpy()
    tails = tn.numpy()[sel]
    counts = np.bincount(tails, minlength=10)
    assert counts[[0, 2, 3]].sum() == 0
    allowed = np.setdiff1d(np.arange(10), [0, 2, 3])
    assert stats.chisquare(counts[allowed]).pvalue > 1e-3


def test_user_with_every_item_gets_weight_zero():
    table = _one_user_table(np.arange(6), 6)
    u, ip, ineg, w = sample_cf_batch(table, torch.Generator().manual_seed(5),
                                     16)
    assert (w == 0).all() and (ineg == 0).all()
    assert ((0 <= ip) & (ip < 6)).all()
