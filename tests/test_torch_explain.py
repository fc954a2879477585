"""Port parity: attention-path explanations (``kgat_tpu_torch.explain``).

The port's attention from parameters carried over from ``kgat_tpu``; its
vectorised attention index against ``kgat_tpu``'s per-node loop, array
for array, on the same attention vector (the two packages share one
canonical edge order); ``explain()`` equal to ``kgat_tpu``'s there; the
DFS oracle of ``tests/test_explain.py``; and the CLI on the CPU, against
``kgat_tpu``'s CLI, with and without ``--item`` and ``--graph-cache``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu import explain as jex
from kgat_tpu.models import kgat as jkgat
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import explain as tex
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.utils.checkpoint import save_params

import torch_threads  # noqa: F401  (one intra-op thread)

TINY = dict(seed=7, n_users=30, n_items=25, n_entities=50, n_relations_kg=4,
            n_interactions=300, n_triples=200)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def attention():
    """Both packages' graphs of one dataset, and kgat_tpu's attention from
    test_explain.py's parameters, as numpy, cut to the real edges."""
    jg, jmeta = jdata.synthetic_dataset(**TINY).build()
    tg, tmeta = tdata.synthetic_dataset(**TINY).build()
    cfg = jkgat.KGATConfig(conv_dims=(16,), mess_dropout=(0.0,))
    params = jkgat.init_params(jax.random.key(3), jmeta.n_nodes,
                               jmeta.n_relations, cfg)
    att = np.asarray(jax.jit(
        lambda p: jkgat.compute_attention(p, jg, cfg))(params))
    return dict(jg=jg, jmeta=jmeta, tg=tg, tmeta=tmeta, params=params,
                att_pad=att, att=att[: tg.n_edges])


def _edge_map(tg, att):
    return {(int(d), int(s), int(r)): float(a) for s, d, r, a in zip(
        tg.src.tolist(), tg.dst.tolist(), tg.etype.tolist(), att)}


@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_port_attention_matches_kgat_tpu(attention, backend):
    np_params = jax.tree.map(np.asarray, attention["params"])
    cfg = tkgat.KGATConfig(conv_dims=(16,), mess_dropout=(0.0,),
                           ops_backend=backend)
    model = tkgat.params_from_jax(np_params, cfg)
    with torch.no_grad():
        got = tkgat.compute_attention(model, attention["tg"], cfg).numpy()
    np.testing.assert_allclose(got, attention["att"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fanout", [1, 3, 16, 10_000])
@pytest.mark.parametrize("ties", [False, True])
def test_attention_index_matches_kgat_tpu_array_for_array(attention, fanout,
                                                          ties):
    """``ties`` rounds the attention to one decimal, so most rows hold
    equal values, which must keep their canonical order in both."""
    att = attention["att_pad"]
    if ties:
        att = np.round(att, 1)
    want = jex.build_attention_index(attention["jg"], att, fanout=fanout)
    got = tex.build_attention_index(attention["tg"], att[: attention[
        "tg"].n_edges], fanout=fanout)
    assert got.n_nodes == want.n_nodes == attention["tmeta"].n_nodes
    for n in range(got.n_nodes):
        nbr, rel, a = got.row(n)
        assert nbr.dtype == rel.dtype == np.int64 and a.dtype == np.float64
        np.testing.assert_array_equal(nbr, want.nbr[n])
        np.testing.assert_array_equal(rel, want.rel[n])
        np.testing.assert_array_equal(a, want.att[n])


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_explain_equals_kgat_tpus_on_the_same_attention(attention, hops):
    jg, jmeta, tg, tmeta = (attention[k] for k in ("jg", "jmeta", "tg",
                                                   "tmeta"))
    att = attention["att"]
    index = tex.build_attention_index(tg, att, fanout=8)
    n = 0
    for user in range(0, tmeta.n_users, 3):
        for item in range(0, tmeta.n_items, 4):
            kw = dict(hops=hops, beam=16, fanout=8, n_paths=4)
            want = jex.explain(jg, jmeta, attention["att_pad"], user, item,
                               **kw)
            assert tex.explain(tg, tmeta, att, user, item, **kw) == want
            assert tex.explain(tg, tmeta, att, user, item, index=index,
                               **kw) == want
            n += bool(want)
    assert n > 10


def test_explain_paths_are_real_edges(attention):
    tg, meta, att = attention["tg"], attention["tmeta"], attention["att"]
    edges = _edge_map(tg, att)
    user = 0
    u_node = meta.user_node(user)
    item = next(s for (d, s, r) in edges
                if d == u_node and r == meta.rel_interact)
    paths = tex.explain(tg, meta, att, user, item, hops=2, beam=128,
                        fanout=64, n_paths=5)
    assert paths
    strengths = [p["strength"] for p in paths]
    assert strengths == sorted(strengths, reverse=True)
    for rec in paths:
        prod = 1.0
        for side, endpoint in (("user_side", u_node), ("item_side", item)):
            at = endpoint
            for hop in rec[side]:
                assert hop["from"] == at
                key = (hop["from"], hop["to"], hop["rel"])
                assert key in edges, f"hop {hop} is not a graph edge"
                np.testing.assert_allclose(hop["att"], edges[key], atol=1e-6)
                prod *= edges[key]
                at = hop["to"]
            assert at == rec["meeting_node"]
        np.testing.assert_allclose(rec["strength"], prod, rtol=1e-12)


def test_explain_matches_dfs_oracle(attention):
    """Beam search with a wide beam finds the true best joined path
    (``tests/test_explain.py::test_explain_matches_dfs_oracle``)."""
    tg, meta, att = attention["tg"], attention["tmeta"], attention["att"]
    edges = _edge_map(tg, att)
    in_edges = {}
    for (d, s, r), a in edges.items():
        in_edges.setdefault(d, []).append((s, r, a))

    def best_reach(start, hops):
        best = {start: 1.0}
        frontier = {start: (1.0, (start,))}
        for _ in range(hops):
            nxt = {}
            for node, (w, seen) in frontier.items():
                for s, r, a in in_edges.get(node, ()):
                    if s in seen:
                        continue
                    if w * a > nxt.get(s, (0.0, ()))[0]:
                        nxt[s] = (w * a, seen + (s,))
            for node, (w, _) in nxt.items():
                if w > best.get(node, 0.0):
                    best[node] = w
            frontier = nxt
        return best

    user, hops = 3, 2
    u_node = meta.user_node(user)
    item = next(s for (d, s, r) in edges
                if d == u_node and r == meta.rel_interact)
    fu, fi = best_reach(u_node, hops), best_reach(int(item), hops)
    oracle = max(fu[n] * fi[n] for n in set(fu) & set(fi)
                 if not (n == u_node and n == item))
    paths = tex.explain(tg, meta, att, user, int(item), hops=hops,
                        beam=10_000, fanout=10_000, n_paths=1)
    np.testing.assert_allclose(paths[0]["strength"], oracle, rtol=1e-6)


def test_node_and_rel_kinds_match_kgat_tpu(attention):
    jmeta, meta = attention["jmeta"], attention["tmeta"]
    for n in range(meta.n_nodes):
        assert tex.node_kind(meta, n) == jex.node_kind(jmeta, n)
    for r in range(meta.n_relations):
        assert tex.rel_kind(meta, r) == jex.rel_kind(jmeta, r)
    assert tex.node_kind(meta, meta.user_node(2)) == "user:2"
    assert tex.rel_kind(meta, 1 + meta.n_relations_kg) == "kg:1^-1"


def test_explain_refuses_ids_out_of_range(attention):
    tg, meta, att = attention["tg"], attention["tmeta"], attention["att"]
    with pytest.raises(ValueError, match="user id"):
        tex.explain(tg, meta, att, meta.n_users, 0)
    with pytest.raises(ValueError, match="item id"):
        tex.explain(tg, meta, att, 0, meta.n_items)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A dataset on disk and a checkpoint of random weights for it."""
    root = tmp_path_factory.mktemp("explain")
    ds = dataclasses.replace(tdata.synthetic_dataset(**TINY), name="tinyex")
    tdata.save_dataset(ds, str(root / "data"))
    _, meta = tdata.load_dataset(str(root / "data"), "tinyex").build()
    cfg = tkgat.KGATConfig(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
                           mess_dropout=(0.0, 0.0))
    model = tkgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                              generator=torch.Generator().manual_seed(1))
    ckpt = str(root / "ckpt")
    save_params(ckpt, tkgat.numpy_params(model), {
        "dataset": "tinyex",
        "model": {"embed_dim": 16, "relation_dim": 16, "conv_dims": [16, 8],
                  "aggregator": cfg.aggregator}})
    return dict(root=root, ckpt=ckpt, data=str(root / "data"))


def _cli(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


def _assert_same_explanation(got, want):
    """The same item and paths; strengths and attentions within float32
    rounding, as the two packages compute the attention apart."""
    assert (got["user"], got["item"]) == (want["user"], want["item"])
    assert len(got["paths"]) == len(want["paths"])
    for g, w in zip(got["paths"], want["paths"]):
        np.testing.assert_allclose(g.pop("strength"), w.pop("strength"),
                                   rtol=1e-5)
        for side in ("user_side", "item_side"):
            for gh, wh in zip(g[side], w[side], strict=True):
                np.testing.assert_allclose(gh.pop("att"), wh.pop("att"),
                                           atol=2e-6)
        assert g == w


@pytest.mark.parametrize("item", [None, 3])
def test_cli_on_the_cpu_matches_kgat_tpus(saved, capsys, item):
    argv = ["--ckpt", saved["ckpt"], "--data-root", saved["data"],
            "--user", "4", "--hops", "2"] + (
        [] if item is None else ["--item", str(item)])
    want = _cli(jex.main, [*argv, "--device", "cpu"], capsys)
    cache = str(saved["root"] / f"cache{item}")
    got = [_cli(tex.main, [*argv, "--device", "cpu", *extra], capsys)
           for extra in ([], ["--graph-cache", cache],
                         ["--graph-cache", cache])]
    assert got[0] == got[1] == got[2]
    if item is not None:
        assert got[0]["item"] == item
    assert got[0]["paths"], got[0]
    _assert_same_explanation(got[0], want)


def test_cli_needs_cuda_unless_told_cpu(saved):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works here")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tex.main(["--ckpt", saved["ckpt"], "--data-root", saved["data"],
                  "--user", "0"])
