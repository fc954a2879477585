"""The port's device samplers (kgat_tpu_torch.sampler).

On the CPU: every positive is an observed pair or triple and every
negative lies outside the user's item set or the (h, r) tail set; a
chi-squared test shows the negatives uniform over the allowed set;
``rank_skip`` matches ``kgat_tpu.sampler.rank_skip`` on identical inputs,
and the draw kernel's 32-way search, written out in numpy, matches
``rank_skip``. On a CUDA card (marker ``cuda``; this file imports jax only
inside the one test that compares with ``kgat_tpu``, so run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_sampler.py``): the
draw kernels give the plain path's bits, and a captured KG step draws its
batch with one launch.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.sampler import (CFSampleTable, KGSampleTable,
                                    cf_draw_plain, kg_draw_plain, rank_skip,
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
    import jax.numpy as jnp
    from kgat_tpu import sampler as jsampler
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


def _warp_search(sorted_v, lo0, g, k):
    """``csrc/sampler.cu``'s rank_skip_warp for one row, lane by lane: 32
    probes a round, the count of those whose predicate holds cuts the
    interval. Returns (p, rounds)."""
    lo, hi, rounds = 0, g, 0
    while lo < hi:
        s = (hi - lo + 31) >> 5
        probes = [lo + lane * s for lane in range(32)]
        c = sum(p < hi and sorted_v[lo0 + p] - p <= k for p in probes)
        top = lo + c * s
        if c > 0:
            lo += (c - 1) * s + 1
        hi = min(hi, top)
        rounds += 1
    return lo, rounds


@pytest.mark.parametrize("size", [0, 1, 31, 32, 33, 1025, 1100])
def test_warp_search_matches_rank_skip(size):
    """The draw kernel's 32-way search gives rank_skip's p for every
    allowed rank of a run of ``size`` forbidden values among 1,200 (a
    prefix, a suffix, random), in ceil(log32(size + 1)) rounds at most."""
    rs = np.random.default_rng(size)
    n_values = 1200
    for run in (np.arange(size), np.arange(n_values - size, n_values),
                np.sort(rs.choice(n_values, size, replace=False))):
        sorted_v = np.concatenate([[-5, 7], run, [3, 1]]).astype(np.int64)
        k = np.arange(n_values - size)
        want = rank_skip(torch.tensor(sorted_v), torch.tensor(2),
                         torch.tensor(size), torch.tensor(k),
                         max(1, int(np.ceil(np.log2(size + 1))))).numpy()
        most = int(np.ceil(np.log(size + 1) / np.log(32))) if size else 0
        for kk, w in zip(k.tolist(), want.tolist()):
            got, rounds = _warp_search(sorted_v.tolist(), 2, size, kk)
            assert got == w and rounds <= max(most, 1 if size else 0), (
                kk, got, w, rounds)


# ---------------------------------------------------------------------------
# On the card: the draw kernels (ops/hopper/sampler.py).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the CPU the samplers take the "
                    "plain draws (the tests above)")
    return torch.device("cuda")


def _edge_tables(dev):
    """A KG table whose (h, r) runs hold 1, 31, 32, 33, 1,100 and every
    one of 1,500 entities (no tail allowed: weight 0), beside 300 random
    short runs, and a copy of it whose every seventh triple has an empty
    run; a CF table whose users hold 1, 31, 32, 33, 1,100 and every one of
    1,500 items, beside 300 users of random degree."""
    rs = np.random.default_rng(5)
    n = 1500
    sizes = [1, 31, 32, 33, 1100, n] + rs.integers(1, 40, 300).tolist()
    triples, pairs = [], []
    for i, size in enumerate(sizes):
        tails = np.sort(rs.choice(n, size, replace=False))
        triples.append(np.stack([np.full(size, i % 500),
                                 np.full(size, i // 500 + 2 * (i % 3)),
                                 tails], 1))
        pairs.append(np.stack([np.full(size, i), tails], 1))
    kg = KGSampleTable.build(np.concatenate(triples), n, 8, device=dev)
    empty = torch.arange(kg.h.shape[0], device=dev) % 7 == 0
    kg_empty = dataclasses.replace(
        kg, rg_hi=torch.where(empty, kg.rg_lo, kg.rg_hi))
    cf = CFSampleTable.build(np.concatenate(pairs), len(sizes), n,
                             device=dev)
    return kg, kg_empty, cf


def _ends(n, dev):
    """Uniforms at 0, at the largest double below 1 and between."""
    u = torch.rand(n, dtype=torch.float64, device=dev)
    u[0::3] = 0.0
    u[1::3] = float(np.nextafter(1.0, 0.0))
    return u


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), (a, b)


@pytest.mark.cuda
def test_draw_kernels_give_the_plain_bits(dev):
    """200 KG and 200 CF batches of 512 from one generator state: the
    kernel's batch (sample_*_batch on CUDA tables) equals the plain draw's
    from the same draws, bit for bit; then every row of each table with
    uniforms at 0 and just below 1 (k at 0 and at n_allowed - 1), and the
    KG table with empty runs. Rows with nothing allowed get t- 0 and weight
    0."""
    from kgat_tpu_torch.ops.hopper import build, sampler as draw
    kg, kg_empty, cf = _edge_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(2**31 + 11)
    before = build.launch_counts["kg_draw"], build.launch_counts["cf_draw"]
    for _ in range(200):
        state = gen.get_state()
        got = sample_kg_batch(kg, gen, 512)
        gen.set_state(state)
        idx = torch.randint(kg.h.shape[0], (512,), generator=gen, device=dev)
        u01 = torch.rand(512, generator=gen, device=dev, dtype=torch.float64)
        _equal(got, kg_draw_plain(idx, u01, kg))
        state = gen.get_state()
        got = sample_cf_batch(cf, gen, 512)
        gen.set_state(state)
        a_idx, p_bits = (torch.randint(high, (512,), generator=gen,
                                       device=dev)
                         for high in (cf.active_users.shape[0], 1 << 30))
        u01 = torch.rand(512, generator=gen, device=dev, dtype=torch.float64)
        _equal(got, cf_draw_plain(a_idx, p_bits, u01, cf))
    assert (build.launch_counts["kg_draw"] - before[0],
            build.launch_counts["cf_draw"] - before[1]) == (200, 200)
    for table in (kg, kg_empty):
        idx = torch.arange(table.h.shape[0], device=dev).repeat(3)
        u01 = _ends(idx.numel(), dev)
        got = draw.kg_draw(idx, u01, table)
        _equal(got, kg_draw_plain(idx, u01, table))
        assert float(got[4].min()) == 0.0 and float(got[4].max()) == 1.0
    a_idx = torch.arange(cf.active_users.shape[0], device=dev).repeat(3)
    p_bits = torch.randint(1 << 30, a_idx.shape, device=dev)
    u01 = _ends(a_idx.numel(), dev)
    got = draw.cf_draw(a_idx, p_bits, u01, cf)
    _equal(got, cf_draw_plain(a_idx, p_bits, u01, cf))
    assert float(got[3].min()) == 0.0 and bool((got[2][got[3] == 0] == 0)
                                               .all())
    with pytest.raises(TypeError):
        draw.kg_draw(idx.int(), u01, kg)
    with pytest.raises(ValueError):
        draw.kg_draw(idx, u01.cpu(), kg)


@pytest.mark.cuda
def test_captured_kg_step_draws_with_one_launch(dev):
    """The trainer's captured KG step records one ``kg_draw`` call, and its
    graph holds one node of the draw kernel and none of torch's index
    kernels (the plain draw's gathers and bisection); the captured CF step
    records one ``cf_draw`` call."""
    from chip_smoke import graph_kernel_names
    from kgat_tpu_torch import train
    from kgat_tpu_torch.models import kgat
    from kgat_tpu_torch.utils.config import TrainConfig
    tr = train.Trainer(TrainConfig(
        dataset="synthetic", device="cuda", log_dir=None, seed=3,
        cf_batch_size=128, kg_batch_size=256, syn_users=300, syn_items=200,
        syn_entities=500, syn_relations=6, syn_interactions=6000,
        syn_triples=4000, model=kgat.KGATConfig(
            embed_dim=32, relation_dim=32, conv_dims=(32, 16),
            mess_dropout=(0.1, 0.1), ops_backend="hopper")))
    tr.stage(tr.attention())
    tr.kg_steps.capture()
    tr.cf_steps.capture()
    assert tr.kg_steps.calls["kg_draw"] == 1 and "cf_draw" not in (
        tr.kg_steps.calls)
    assert tr.cf_steps.calls["cf_draw"] == 1
    names = graph_kernel_names(tr.kg_steps.graph.raw_cuda_graph())
    assert sum("kg_draw_kernel" in n for n in names) == 1, names
    assert not any("index_elementwise_kernel" in n for n in names), names
    tr.kg_steps.replay()
    torch.cuda.synchronize()
