"""Port parity: kgat_tpu_torch data + graph vs kgat_tpu, bit for bit.

The same numpy-seeded inputs go through both packages' synthetic data
generator, loaders and CKG builder; every array the serving path reads
must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu.graph import host_array
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import REL_TILE, build_graph

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


def _assert_datasets_equal(a, b):
    for f in ("cf_train", "cf_test", "kg_triples"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    for f in ("n_users", "n_items", "n_entities", "n_relations_kg"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("train_user_dict", "test_user_dict"):
        da, db = getattr(a, f), getattr(b, f)
        assert sorted(da) == sorted(db), f
        for u in da:
            np.testing.assert_array_equal(da[u], db[u])


@pytest.mark.parametrize("kwargs", [
    SMALL,
    dict(seed=3, n_users=90, n_items=70, n_entities=150, n_relations_kg=5,
         n_interactions=1200, n_triples=800, user_mixture=3, n_factors=8),
])
def test_synthetic_dataset_bit_equal(kwargs):
    _assert_datasets_equal(tdata.synthetic_dataset(**kwargs),
                           jdata.synthetic_dataset(**kwargs))


def test_group_by_user_bit_equal(rng):
    pairs = rng.integers(0, 30, size=(400, 2))
    a = tdata._group_by_user(pairs)
    b = jdata._group_by_user(pairs)
    assert sorted(a) == sorted(b)
    for u in a:
        np.testing.assert_array_equal(a[u], b[u])
    assert tdata._group_by_user(np.zeros((0, 2), np.int64)) == {}


def test_save_load_roundtrip_matches_jax(tmp_path):
    ds = dataclasses.replace(tdata.synthetic_dataset(**SMALL), name="rt")
    tdata.save_dataset(ds, str(tmp_path))
    got = tdata.load_dataset(str(tmp_path), "rt")
    want = jdata.load_dataset(str(tmp_path), "rt")
    _assert_datasets_equal(got, want)
    # The export holds the train/test pairs and the triples exactly.
    np.testing.assert_array_equal(got.kg_triples, ds.kg_triples)
    assert sorted(got.train_user_dict) == sorted(ds.train_user_dict)


@pytest.fixture(scope="module")
def graphs():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, tmeta = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg, tmeta


def test_ckg_matches_jax(graphs):
    jg, jmeta, tg, tmeta = graphs
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges
    assert tg.n_relations == jg.n_relations
    for f in ("src", "dst", "etype"):
        got = getattr(tg, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      host_array(jg, f)[: jg.n_edges], f)
    np.testing.assert_array_equal(
        tg.row_offsets.numpy(), host_array(jg, "row_offsets")[: jg.n_nodes + 1])
    # rel_perm is the JAX relation-blocked gather with its pads removed.
    att = host_array(jg, "att_gather")
    np.testing.assert_array_equal(tg.rel_perm.numpy(), att[att < jg.n_edges])


def test_relation_tiles_cover_rel_perm_once(graphs):
    _, _, tg, _ = graphs
    tiles = tg.tiles.numpy()
    ety = tg.etype.numpy()[tg.rel_perm.numpy()]
    assert (tiles[:, 2] > 0).all() and (tiles[:, 2] <= REL_TILE).all()
    covered = np.concatenate([np.arange(s, s + c) for _, s, c in tiles])
    np.testing.assert_array_equal(covered, np.arange(tg.n_edges))
    for r, s, c in tiles:
        assert (ety[s:s + c] == r).all()  # no tile spans two relations
    off = tg.rel_offsets
    assert off[0] == 0 and off[-1] == tg.n_edges
    for r in range(tg.n_relations):
        assert (ety[off[r]:off[r + 1]] == r).all()


def test_small_rel_tile_and_to_device(graphs):
    _, _, tg, _ = graphs
    ds = tdata.synthetic_dataset(**SMALL)
    g7, _ = ds.build(rel_tile=7)
    assert (g7.tiles[:, 2] <= 7).all()
    assert int(g7.tiles[:, 2].sum()) == g7.n_edges
    torch.testing.assert_close(g7.rel_perm, tg.rel_perm, rtol=0, atol=0)
    moved = tg.to("cpu")
    assert moved.src.device.type == "cpu" and moved.rel_offsets == tg.rel_offsets
    torch.testing.assert_close(moved.row_offsets, tg.row_offsets)


@pytest.mark.parametrize("bad", ["dst", "src", "etype"])
def test_build_graph_rejects_out_of_range(bad):
    arrs = {"src": np.array([0, 1]), "dst": np.array([1, 2]),
            "etype": np.array([0, 0])}
    arrs[bad] = np.array([0, 5])
    with pytest.raises(ValueError, match="out of range"):
        build_graph(arrs["src"], arrs["dst"], arrs["etype"], n_nodes=3,
                    n_relations=1)
