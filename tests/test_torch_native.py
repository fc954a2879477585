"""The port's native host layer (``kgat_tpu_torch.native``) against
``kgat_tpu.native`` and against the plain versions, bit for bit.

The library is built with the host's ``g++`` at first use. Its
parsers must give ``kgat_tpu.native``'s arrays on every file, malformed
ones included, and the plain Python / numpy parsers' arrays on
well-formed ones; its counting sort and CSR offsets must give numpy's
stable argsort and searchsorted. The graph, the dataset loader and the
partitions built through it must equal ``kgat_tpu``'s and those built
through numpy's sorts. A build with a compiler that cannot run raises,
and nothing falls back to a Python path.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu import native as jnative
from kgat_tpu.graph import host_array
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import native
from kgat_tpu_torch.graph import build_ckg
from kgat_tpu_torch.ops.row_split import RowSplit
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)

import torch_threads  # noqa: F401  (one intra-op thread)


def plain_index():
    """numpy's stable argsort and searchsorted in place of the native
    counting sort and CSR offsets, for as long as the context lasts."""
    return mock.patch.multiple(native, sort_perm=native.sort_perm_plain,
                               csr_offsets=native.csr_offsets_plain)


# --- parsers -----------------------------------------------------------------

EDGE_CASES = {
    "blank lines": "0 5 7 9\n\n\n1 2\n\n",
    "a user without items": "0 5 7\n3\n4 1\n",
    "tabs": "0\t5\t7\n1 \t 2\t\t3\n",
    "crlf": "0 5 7\r\n1 2\r\n2 0 1 3 4\r\n",
    "no final newline": "0 5 7 9\n1 2",
    "ids past 2^31": "3000000000 2147483648 9000000000000\n1 4294967297\n",
    "an empty file": "",
    "spaces around": "  0 5 7  \n   \n 1 2 \n",
}


def random_user_lines(seed: int) -> str:
    """A seeded train.txt-like file: random users, item lists (some
    empty), separators of spaces and tabs, blank lines, CRLF endings."""
    rs = np.random.default_rng(seed)
    lines = []
    for u in rs.permutation(300):
        items = rs.integers(0, 2 ** 40 if rs.random() < 0.1 else 5000,
                            rs.integers(0, 30))
        sep = [" ", "\t", "  ", " \t"][rs.integers(4)]
        lines.append(sep.join(str(x) for x in [u, *items]))
        if rs.random() < 0.05:
            lines.append("")
    end = "\r\n" if seed % 2 else "\n"
    return end.join(lines) + (end if seed % 3 else "")


def _write(tmp_path, text, name="f.txt"):
    p = tmp_path / name
    p.write_bytes(text.encode())
    return str(p)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_parse_user_items_edge_cases(tmp_path, case):
    path = _write(tmp_path, EDGE_CASES[case])
    got = native.parse_user_items(path)
    assert got.dtype == np.int64 and got.shape[1:] == (2,)
    np.testing.assert_array_equal(got, jnative.parse_user_items(path))
    np.testing.assert_array_equal(got, tdata._parse_user_items_plain(path))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_parse_user_items_random_files(tmp_path, seed):
    path = _write(tmp_path, random_user_lines(seed))
    got = native.parse_user_items(path)
    np.testing.assert_array_equal(got, jnative.parse_user_items(path))
    np.testing.assert_array_equal(got, tdata._parse_user_items_plain(path))
    assert len(got) > 1000


def random_triples(seed: int, n: int = 2000) -> np.ndarray:
    rs = np.random.default_rng(seed)
    big = 2 ** 33 if seed % 2 else 90000
    return np.stack([rs.integers(0, big, n), rs.integers(0, 40, n),
                     rs.integers(0, big, n)], axis=1)


@pytest.mark.parametrize("seed,layout", [(0, "lines"), (1, "lines"),
                                         (2, "tabs and crlf"),
                                         (3, "no final newline")])
def test_parse_triples_well_formed(tmp_path, seed, layout):
    kg = random_triples(seed)
    rows = [(f"{h}\t{r}\t{t}" if layout == "tabs and crlf"
             else f"{h} {r} {t}") for h, r, t in kg.tolist()]
    end = "\r\n" if layout == "tabs and crlf" else "\n"
    text = end.join(rows) + ("" if layout == "no final newline" else end)
    path = _write(tmp_path, text)
    got = native.parse_triples(path)
    np.testing.assert_array_equal(got, kg)
    np.testing.assert_array_equal(got, jnative.parse_triples(path))
    np.testing.assert_array_equal(got, tdata._parse_triples_plain(path))


@pytest.mark.parametrize("text,want", [
    # A line of two tokens takes the first token of the next line: the
    # triples are read from the token stream, not by line.
    ("1 0 2\n3 1\n4 5 6\n7 2 8\n", [[1, 0, 2], [3, 1, 4], [5, 6, 7]]),
    # A token that is not a number drops the triple begun so far.
    ("1 0 2\n3 x 4\n5 1 6\n", [[1, 0, 2], [4, 5, 1]]),
    # Four tokens on a line.
    ("1 0 2 9\n3 1 4\n", [[1, 0, 2], [9, 3, 1]]),
    ("", np.zeros((0, 3), np.int64)),
])
def test_parse_triples_malformed_as_kgat_tpu_native(tmp_path, text, want):
    """kgat_tpu.native reads the triples as a token stream; the port
    does the same, where np.loadtxt refuses the file."""
    path = _write(tmp_path, text)
    got = native.parse_triples(path)
    np.testing.assert_array_equal(got, jnative.parse_triples(path))
    np.testing.assert_array_equal(got, np.asarray(want, np.int64)
                                  .reshape(-1, 3))
    if text:
        with pytest.raises(ValueError):
            tdata._parse_triples_plain(path)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_user_items(str(tmp_path / "none.txt"))
    with pytest.raises(FileNotFoundError):
        native.parse_triples(str(tmp_path / "none.txt"))


# --- counting sort and CSR offsets -----------------------------------------

@pytest.mark.parametrize("n,n_keys", [(0, 5), (1, 1), (1, 9), (50, 1),
                                      (100_000, 777), (10_000, 100_000)])
def test_sort_perm_is_numpys_stable_argsort(n, n_keys):
    keys = np.random.default_rng(n + n_keys).integers(0, n_keys, n)
    got = native.sort_perm(keys, n_keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got, native.sort_perm_plain(keys, n_keys))


def test_sort_perm_all_keys_equal_keeps_input_order():
    keys = np.full(1000, 3, np.int32)
    np.testing.assert_array_equal(native.sort_perm(keys, 4), np.arange(1000))


@pytest.mark.parametrize("bad", [[-1, 0], [0, 4]])
def test_sort_perm_refuses_keys_out_of_range(bad):
    with pytest.raises(ValueError, match="must lie in"):
        native.sort_perm(np.asarray(bad), 4)


@pytest.mark.parametrize("n,n_segments", [(0, 0), (0, 6), (1, 1),
                                          (5000, 50), (5000, 20_000)])
def test_csr_offsets_is_searchsorted(n, n_segments):
    keys = np.sort(np.random.default_rng(n).integers(0, max(n_segments, 1),
                                                     n))
    got = native.csr_offsets(keys, n_segments)
    want = np.searchsorted(keys, np.arange(n_segments + 1), side="left")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.csr_offsets_plain(keys, n_segments),
                                  want)


# --- the graph, the loader and the partitions through it ------------------

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


def _graph_arrays(g) -> dict:
    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        elif isinstance(v, RowSplit):
            for sf in dataclasses.fields(v):
                sv = getattr(v, sf.name)
                out[f"{f.name}.{sf.name}"] = (
                    sv.numpy() if isinstance(sv, torch.Tensor) else sv)
        else:
            out[f.name] = v
    return out


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [11, 12])
def test_build_ckg_matches_kgat_tpu_and_the_argsort_path(seed):
    ds = tdata.synthetic_dataset(**{**SMALL, "seed": seed})
    args = dict(n_users=ds.n_users, n_entities=ds.n_entities,
                n_items=ds.n_items, n_relations_kg=ds.n_relations_kg)
    g, meta = build_ckg(ds.cf_train, ds.kg_triples, **args)
    with plain_index():
        g_plain, meta_plain = build_ckg(ds.cf_train, ds.kg_triples, **args)
    assert meta == meta_plain
    _assert_same(_graph_arrays(g), _graph_arrays(g_plain))
    jg, _ = jdata.synthetic_dataset(**{**SMALL, "seed": seed}).build()
    for f in ("src", "dst", "etype"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      host_array(jg, f)[:jg.n_edges], f)
    np.testing.assert_array_equal(
        g.row_offsets.numpy(), host_array(jg, "row_offsets")[:jg.n_nodes + 1])
    att = host_array(jg, "att_gather")
    np.testing.assert_array_equal(g.rel_perm.numpy(), att[att < jg.n_edges])


def test_load_dataset_matches_kgat_tpu_and_the_plain_parsers(tmp_path):
    ds = dataclasses.replace(tdata.synthetic_dataset(**{**SMALL, "seed": 5}),
                             name="ld")
    tdata.save_dataset(ds, str(tmp_path))
    got = tdata.load_dataset(str(tmp_path), "ld")
    want = jdata.load_dataset(str(tmp_path), "ld")
    with mock.patch.multiple(
            native, parse_user_items=tdata._parse_user_items_plain,
            parse_triples=tdata._parse_triples_plain):
        plain = tdata.load_dataset(str(tmp_path), "ld")
    for other in (want, plain):
        for f in ("cf_train", "cf_test", "kg_triples"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(other, f), f)
            assert getattr(got, f).dtype == getattr(other, f).dtype
        for f in ("n_users", "n_items", "n_entities", "n_relations_kg"):
            assert getattr(got, f) == getattr(other, f), f
    np.testing.assert_array_equal(got.kg_triples, ds.kg_triples)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitions_buckets_and_halos_match_the_argsort_path(n_parts):
    ds = tdata.synthetic_dataset(seed=21, n_users=200, n_items=150,
                                 n_entities=300, n_relations_kg=3,
                                 n_interactions=1500, n_triples=1000)
    g, meta = ds.build()
    args = (g.src.numpy(), g.dst.numpy(), g.etype.numpy(), meta.n_nodes,
            meta.n_relations, n_parts)

    def build():
        shards, info = partition_graph(*args)
        return (shards, build_ring_buckets(args[0], args[1], info),
                build_selective_halo(shards, info))

    native_parts = build()
    with plain_index():
        plain_parts = build()
    for s_n, s_p in zip(native_parts[0], plain_parts[0]):
        _assert_same(_graph_arrays(s_n.graph), _graph_arrays(s_p.graph))
        for f in ("dst_global", "edge_ids"):
            np.testing.assert_array_equal(getattr(s_n, f).numpy(),
                                          getattr(s_p, f).numpy(), f)
    for row_n, row_p in zip(native_parts[1], plain_parts[1]):
        for b_n, b_p in zip(row_n, row_p):
            _assert_same(_graph_arrays(b_n), _graph_arrays(b_p))
    for h_n, h_p in zip(native_parts[2], plain_parts[2]):
        _assert_same(_graph_arrays(h_n.graph), _graph_arrays(h_p.graph))
        for f in ("local_ids", "send_idx"):
            np.testing.assert_array_equal(getattr(h_n, f).numpy(),
                                          getattr(h_p, f).numpy(), f)


# --- the build ---------------------------------------------------------------

@pytest.mark.parametrize("cxx,says", [("no-such-g++", "cannot run"),
                                      ("false", "failed with code 1")])
def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                      cxx, says):
    """A compiler that cannot run, or fails, raises RuntimeError naming
    it; the loader raises with it instead of parsing in Python."""
    if cxx != "false":
        cxx = str(tmp_path / cxx)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native.library.cache_clear()
    ds = dataclasses.replace(tdata.synthetic_dataset(**SMALL), name="nb")
    tdata.save_dataset(ds, str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match=says) as err:
            tdata.load_dataset(str(tmp_path), "nb")
        assert cxx in str(err.value)
        with pytest.raises(RuntimeError, match=says):
            native.sort_perm(np.zeros(3, np.int32), 1)
    finally:
        native.library.cache_clear()


def test_build_is_cached_and_rebuilt_when_the_source_is_newer(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    path, first = native.build()
    assert path.startswith(str(tmp_path)) and first > 0
    assert native.build() == (path, 0.0)
    _, again = native.build(force=True)
    assert again > 0
