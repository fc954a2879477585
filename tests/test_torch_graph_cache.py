"""The port's npz graph cache (``Dataset.build(cache_dir=...)``,
``graph.save_graph`` / ``load_graph``) and ``--graph-cache`` in its CLIs.

A warm load gives the graph a fresh build gives, every array, both row
splits and the coalesced CSRs (with theirs) bit-equal; a changed
dataset, a damaged file and a file of another cache version (version 1,
which had no coalesced CSRs, too) are rebuilt; one directory holds ``kgat_tpu``'s
cache file and the port's side by side; the trainer and the serving CLI
give the same results with the cache cold, warm and absent.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import graph as tgraph
from kgat_tpu_torch import recommend as trec
from kgat_tpu_torch import train
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops.row_split import RowSplit, build_row_split
from kgat_tpu_torch.utils.checkpoint import save_params

import torch_threads  # noqa: F401  (one intra-op thread)

TINY = dict(seed=7, n_users=30, n_items=25, n_entities=50, n_relations_kg=4,
            n_interactions=300, n_triples=200)
MODEL_FLAGS = ["--embed-dim", "16", "--relation-dim", "16", "--conv-dims",
               "16,8", "--mess-dropout", "0.1,0.1"]
SYN_FLAGS = ["--syn-users", "60", "--syn-items", "40", "--syn-entities", "90",
             "--syn-relations", "3", "--syn-interactions", "800",
             "--syn-triples", "400"]


def assert_graphs_equal(got: tgraph.Graph, want: tgraph.Graph) -> None:
    """Every field equal: tensors bit-equal with their dtype, both row
    splits' and the coalesced CSRs' tensors and statics (theirs too), the
    tuples and sizes."""
    def same(a, b, where):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), where
        elif isinstance(b, (RowSplit, tgraph.Coalesced)):
            assert type(a) is type(b), where
            for f in dataclasses.fields(b):
                same(getattr(a, f.name), getattr(b, f.name),
                     where + (f.name,))
        else:
            assert a == b, where
    for f in dataclasses.fields(want):
        same(getattr(got, f.name), getattr(want, f.name), (f.name,))


def _built(ds, **kw):
    """A fresh build of ``ds`` with its coalesced CSRs at the default
    cap: what the cache holds."""
    g, meta = ds.build(**kw)
    tgraph.coalesced(g)
    return g, meta


@pytest.fixture(scope="module")
def tiny():
    ds = tdata.synthetic_dataset(**TINY)
    g, meta = _built(ds)
    assert g.co.n_pairs < g.n_edges   # the graph has multi-edges
    return ds, g, meta


def _cache_files(d):
    return sorted(os.path.basename(p) for p in glob.glob(f"{d}/*.npz"))


@pytest.mark.parametrize("chunk", [None, 4])
def test_save_load_round_trips_every_field(tiny, tmp_path, chunk):
    """Chunk 4 splits rows into several units, so the splits' slots and
    split rows are not empty (the coalesced CSRs' too)."""
    _, g, meta = tiny
    if chunk is not None:
        co = dataclasses.replace(
            g.co, split=build_row_split(g.co.row_offsets, chunk),
            rev_split=build_row_split(g.co.rev_row_offsets, chunk))
        g = dataclasses.replace(
            g, split=build_row_split(g.row_offsets, chunk),
            rev_split=build_row_split(g.rev_row_offsets, chunk), co=co)
        assert g.split.n_split > 0 and g.rev_split.n_slots > 0
        assert co.split.n_split > 0 and co.rev_split.n_slots > 0
    path = tgraph.save_graph(str(tmp_path / "g.npz"), g, meta)
    got, got_meta = tgraph.load_graph(path)
    assert_graphs_equal(got, g)
    assert got_meta == meta
    assert tgraph.load_graph(tgraph.save_graph(str(tmp_path / "m.npz"),
                                               g))[1] is None
    # The writer's temporary file is gone.
    assert _cache_files(tmp_path) == ["g.npz", "m.npz"]
    assert not glob.glob(f"{tmp_path}/*.tmp")


def test_cold_then_warm_build_gives_one_file_and_equal_graphs(
        tiny, tmp_path, monkeypatch):
    ds, g, meta = tiny
    cold = ds.build(cache_dir=str(tmp_path))
    files = _cache_files(tmp_path)
    assert len(files) == 1 and files[0].startswith("ckg-torch-"), files
    assert os.path.join(str(tmp_path), files[0]) == ds.graph_cache_path(
        str(tmp_path))
    # Warm: nothing is built.
    monkeypatch.setattr(tdata, "build_ckg", lambda *a, **k: pytest.fail(
        "a warm cache built the graph"))
    warm = ds.build(cache_dir=str(tmp_path))
    for got in (cold, warm):
        assert_graphs_equal(got[0], g)
        assert got[1] == meta
    assert _cache_files(tmp_path) == files
    # A row split on the loaded graph travels with .to, as a built one's,
    # and so do the coalesced CSRs with theirs.
    moved = warm[0].to("cpu")
    assert moved.split.n_units == g.split.n_units
    assert moved.co.rev_split.n_units == g.co.rev_split.n_units


@pytest.mark.parametrize("change", ["cf_train", "kg_triples", "rel_tile"])
def test_changed_dataset_misses_the_cache(tiny, tmp_path, change):
    ds, _, _ = tiny
    ds.build(cache_dir=str(tmp_path))
    kw = {}
    if change == "rel_tile":
        other = ds
        kw["rel_tile"] = 7
    else:
        other = dataclasses.replace(ds, **{change: getattr(ds, change)[1:]})
    got, meta = other.build(cache_dir=str(tmp_path), **kw)
    assert len(_cache_files(tmp_path)) == 2
    assert_graphs_equal(got, _built(other, **kw)[0])


@pytest.mark.parametrize("damage", ["truncated", "garbage", "version",
                                    "version-1"])
def test_damaged_or_stale_file_is_rebuilt(tiny, tmp_path, damage,
                                          monkeypatch):
    """A file of version 1 (before the cache carried the coalesced CSRs)
    is refused by load_graph and rebuilt by the build, never used to
    train uncoalesced."""
    ds, g, meta = tiny
    path = ds.graph_cache_path(str(tmp_path))
    if damage.startswith("version"):
        old = 1 if damage == "version-1" else 0
        monkeypatch.setattr(tgraph, "GRAPH_CACHE_VERSION", old)
        tgraph.save_graph(path, dataclasses.replace(g, co=None), meta)
        monkeypatch.undo()
        with pytest.raises(ValueError, match=f"graph cache version {old}"):
            tgraph.load_graph(path)
    else:
        tgraph.save_graph(path, g, meta)
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[: len(raw) // 2] if damage == "truncated"
                    else b"not an npz" * 10)
    got, got_meta = ds.build(cache_dir=str(tmp_path))
    assert_graphs_equal(got, g)
    assert got.co is not None and got_meta == meta
    # The file was written anew, and reads.
    assert_graphs_equal(tgraph.load_graph(path)[0], g)
    assert _cache_files(tmp_path) == [os.path.basename(path)]


def test_one_directory_serves_both_packages(tmp_path):
    jds = jdata.synthetic_dataset(**TINY)
    tds = tdata.synthetic_dataset(**TINY)
    d = str(tmp_path)
    jg, jmeta = jds.build(cache_dir=d)
    tg, tmeta = tds.build(cache_dir=d)
    files = _cache_files(tmp_path)
    assert len(files) == 2, files
    assert sum(f.startswith("ckg-torch-") for f in files) == 1
    # Warm, each package reads its own file.
    jg2, jmeta2 = jds.build(cache_dir=d)
    tg2, tmeta2 = tds.build(cache_dir=d)
    assert _cache_files(tmp_path) == files
    assert dataclasses.asdict(jmeta2) == dataclasses.asdict(tmeta2) == \
        dataclasses.asdict(tmeta)
    assert_graphs_equal(tg2, _built(tds)[0])
    # One canonical edge order in both packages.
    E = tg2.n_edges
    for key in ("src", "dst", "etype"):
        np.testing.assert_array_equal(np.asarray(getattr(jg2, key))[:E],
                                      getattr(tg2, key).numpy())


def _train_losses(tmp_path, name, extra):
    train.main(["--device", "cpu", "--ops-backend", "ref", "--dataset",
                "synthetic", "--epochs", "1", "--eval-every", "1",
                "--cf-batch-size", "256", "--kg-batch-size", "512",
                "--seed", "0", "--log-dir", str(tmp_path), "--run-name",
                name, *MODEL_FLAGS, *SYN_FLAGS, *extra])
    with open(tmp_path / f"{name}.jsonl") as f:
        events = [json.loads(ln) for ln in f]
    epoch = next(e for e in events if e["event"] == "epoch")
    ev = next(e for e in events if e["event"] == "eval")
    return epoch["cf_loss"], epoch["kg_loss"], ev["recall"], ev["ndcg"]


@pytest.mark.parametrize("mode", ["", "--n-devices 2 --halo-exchange ring"])
def test_train_cli_with_graph_cache_cold_and_warm(tmp_path, mode):
    """The trainer (and the partitioned one, whose partitions come from
    the loaded graph) gives the same losses and metrics with the cache
    absent, cold and warm."""
    cache = str(tmp_path / "cache")
    flags = mode.split()
    plain = _train_losses(tmp_path, "plain", flags)
    cold = _train_losses(tmp_path, "cold", [*flags, "--graph-cache", cache])
    assert len(_cache_files(cache)) == 1
    warm = _train_losses(tmp_path, "warm", [*flags, "--graph-cache", cache])
    assert plain == cold == warm
    assert len(_cache_files(cache)) == 1


def test_recommend_cli_with_graph_cache_cold_and_warm(tmp_path):
    ds = dataclasses.replace(tdata.synthetic_dataset(**TINY), name="tinyrec")
    root = str(tmp_path / "data")
    tdata.save_dataset(ds, root)
    g, meta = tdata.load_dataset(root, "tinyrec").build()
    cfg = tkgat.KGATConfig(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
                           mess_dropout=(0.0, 0.0))
    model = tkgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                              generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt")
    save_params(ckpt, tkgat.numpy_params(model), {
        "dataset": "tinyrec",
        "model": {"embed_dim": 16, "relation_dim": 16, "conv_dims": [16, 8],
                  "aggregator": cfg.aggregator}})
    cache = str(tmp_path / "cache")
    outs = []
    for run, extra in (("plain", []), ("cold", ["--graph-cache", cache]),
                       ("warm", ["--graph-cache", cache])):
        out = str(tmp_path / f"{run}.jsonl")
        assert trec.main(["--ckpt", ckpt, "--data-root", root, "--device",
                          "cpu", "--users", "0,3,7,11", "--k", "5",
                          "--out", out, *extra]) == 0
        with open(out) as f:
            outs.append(f.read())
        if run != "plain":
            assert len(_cache_files(cache)) == 1
    assert outs[0] == outs[1] == outs[2] and outs[0].count("\n") == 4
