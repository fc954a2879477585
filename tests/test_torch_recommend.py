"""Port parity: the serving path (kgat_tpu_torch.recommend) vs kgat_tpu's.

Same dataset, same JAX-initialised params, same users: the port's top-K
(plain versions on the CPU) must equal ``kgat_tpu.recommend`` on the ref
backend, as tests/test_recommend.py runs it; the port reads the JAX
trainer's checkpoints; and the two CLIs print the same JSONL.
"""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu import recommend as jrec
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.utils.checkpoint import load_params as jax_load_params
from kgat_tpu.utils.checkpoint import save_checkpoint
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import recommend as trec
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.utils.checkpoint import load_params, save_params

import torch_threads  # noqa: F401  (one intra-op thread)

TINY = dict(seed=7, n_users=30, n_items=25, n_entities=50, n_relations_kg=4,
            n_interactions=300, n_triples=200)


@pytest.fixture(autouse=True)
def _full_f32():
    trec.disable_tf32()


@pytest.fixture(scope="module")
def served():
    jds = jdata.synthetic_dataset(**TINY)
    jg, jmeta = jds.build()
    jcfg = jkgat.KGATConfig(ops_backend="ref")
    params = jkgat.init_params(jax.random.key(5), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    tds = tdata.synthetic_dataset(**TINY)
    tg, tmeta = tds.build()
    cfg = tkgat.KGATConfig(ops_backend="hopper")
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return dict(jds=jds, jg=jg, jmeta=jmeta, jcfg=jcfg, params=params,
                tds=tds, tg=tg, tmeta=tmeta, cfg=cfg, model=model)


def _model_meta(cfg):
    return {"embed_dim": cfg.embed_dim, "relation_dim": cfg.relation_dim,
            "conv_dims": list(cfg.conv_dims), "aggregator": cfg.aggregator,
            "mess_dropout": list(cfg.mess_dropout)}


def _assert_topk_equal(got, want, rtol=1e-5, atol=1e-5):
    """Equal finite slots (-inf slots of exhausted users are dropped by both
    CLIs, and their item ids are arbitrary)."""
    (gi, gs), (wi, ws) = got, want
    assert gi.shape == wi.shape
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=rtol, atol=atol)


def test_recommend_matches_jax_and_masks_train(served):
    s = served
    users = sorted(s["tds"].train_user_dict)[:8]
    want = jrec.recommend(s["params"], s["jg"], s["jmeta"], s["jcfg"], users,
                          k=5, train_user_dict=s["jds"].train_user_dict)
    got = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"], users,
                         k=5, train_user_dict=s["tds"].train_user_dict)
    _assert_topk_equal(got, want)
    items, scores = got
    for i, u in enumerate(users):
        assert (np.diff(scores[i]) <= 0).all()
        assert not set(items[i]) & set(s["tds"].train_user_dict[u].tolist())
    # Both backends of the port agree too.
    ref_cfg = dataclasses.replace(s["cfg"], ops_backend="ref")
    _assert_topk_equal(trec.recommend(
        s["model"], s["tg"], s["tmeta"], ref_cfg, users, k=5,
        train_user_dict=s["tds"].train_user_dict), want)


def test_exhausted_users_get_short_lists(served):
    """k = n_items: a user's masked slots come back as -inf, like JAX."""
    s = served
    users = sorted(s["tds"].train_user_dict)[:3]
    k = s["tmeta"].n_items
    want = jrec.recommend(s["params"], s["jg"], s["jmeta"], s["jcfg"], users,
                          k=k, train_user_dict=s["jds"].train_user_dict)
    got = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"], users,
                         k=k, train_user_dict=s["tds"].train_user_dict)
    _assert_topk_equal(got, want)
    for i, u in enumerate(users):
        n_train = len(s["tds"].train_user_dict[u])
        assert np.isfinite(got[1][i]).sum() == k - n_train


def test_blocked_matches_unblocked(served):
    s = served
    users = sorted(s["tds"].train_user_dict)[:13]
    kw = dict(k=5, train_user_dict=s["tds"].train_user_dict)
    a = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"], users,
                       block=4, **kw)
    b = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"], users,
                       block=2048, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-6)


def test_recommender_caches_forward_until_refresh(served, monkeypatch):
    s = served
    users_a = sorted(s["tds"].train_user_dict)[:6]
    users_b = sorted(s["tds"].train_user_dict)[6:11]
    kw = dict(k=5, train_user_dict=s["tds"].train_user_dict)
    want_a = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"],
                            users_a, **kw)
    want_b = trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"],
                            users_b, **kw)
    calls = {"n": 0}
    real_forward = trec._forward

    def counting_forward(*args):
        calls["n"] += 1
        return real_forward(*args)

    monkeypatch.setattr(trec, "_forward", counting_forward)
    rec = trec.Recommender(s["model"], s["tg"], s["tmeta"], s["cfg"],
                           train_user_dict=s["tds"].train_user_dict)
    for users, want in ((users_a, want_a), (users_b, want_b)):
        got = rec.recommend(users, k=5)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert calls["n"] == 1
    halved = tkgat.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x) * 0.5, s["params"]), s["cfg"])
    rec.refresh(halved)
    rec.recommend(users_a, k=5)
    assert calls["n"] == 2


def test_rejects_mismatched_model_and_users(served):
    s = served
    params = jax.tree.map(np.asarray, s["params"])
    params["entity_embed"] = params["entity_embed"][:-3]
    bad = tkgat.params_from_jax(params, s["cfg"])
    with pytest.raises(ValueError, match="rows but the built graph"):
        trec.recommend(bad, s["tg"], s["tmeta"], s["cfg"], [0], k=3)
    with pytest.raises(ValueError, match="user ids"):
        trec.recommend(s["model"], s["tg"], s["tmeta"], s["cfg"],
                       [s["tmeta"].n_users], k=3)


def test_checkpoints_cross_read(tmp_path, served):
    """The port reads a JAX trainer checkpoint (with optimizer state) bit
    for bit, and the JAX loader reads what the port writes."""
    s = served
    params = s["params"]
    meta = {"model": _model_meta(s["jcfg"]), "dataset": "tiny"}
    path = str(tmp_path / "jax_ck")
    save_checkpoint(path, params, optax.adam(1e-3).init(params), epoch=3,
                    rng=jax.random.key(0), extra=meta)
    got, got_meta = load_params(path)
    assert got_meta["model"] == meta["model"]
    assert got_meta["dataset"] == "tiny"
    leaves = lambda t: jax.tree_util.tree_leaves_with_path(t)  # noqa: E731
    want_flat = leaves(jax.tree.map(np.asarray, params))
    for flat in (leaves(got),
                 leaves(jax_load_params(_port_write(tmp_path, got, meta))[0])):
        assert [str(p) for p, _ in flat] == [str(p) for p, _ in want_flat]
        for (_, a), (_, b) in zip(flat, want_flat):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _port_write(tmp_path, params, meta):
    path = str(tmp_path / "port_ck")
    save_params(path, params, meta)
    return path


def test_cli_matches_jax_cli(tmp_path, served):
    s = served
    root = str(tmp_path / "data")
    jdata.save_dataset(dataclasses.replace(s["jds"], name="tinyrec"), root)
    ck = str(tmp_path / "run_best")
    save_checkpoint(ck, s["params"], optax.adam(1e-3).init(s["params"]),
                    epoch=1, rng=jax.random.key(0),
                    extra={"model": _model_meta(s["jcfg"]),
                           "dataset": "tinyrec"})
    users = sorted(s["jds"].train_user_dict)
    common = ["--ckpt", ck, "--data-root", root, "--k", "6", "--users",
              ",".join(str(u) for u in users)]
    assert jrec.main(common + ["--out", str(tmp_path / "jax.jsonl")]) == 0
    assert trec.main(common + ["--out", str(tmp_path / "port.jsonl"),
                               "--device", "cpu"]) == 0
    want = [json.loads(ln) for ln in open(tmp_path / "jax.jsonl")]
    got = [json.loads(ln) for ln in open(tmp_path / "port.jsonl")]
    assert [(g["user"], g["items"]) for g in got] == [
        (w["user"], w["items"]) for w in want]
    # Scores are printed rounded to 6 decimals; the two frameworks' f32
    # sums differ in the last bits, which can flip the 6th decimal.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=2e-6)


def test_cli_default_device_needs_cuda(tmp_path, served):
    """No silent CPU fallback: the default --device cuda exits non-zero
    when CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works here")
    s = served
    ck = str(tmp_path / "ck")
    save_params(ck, jax.tree.map(np.asarray, s["params"]),
                {"model": _model_meta(s["jcfg"]), "dataset": "tiny"})
    with pytest.raises(SystemExit, match="CUDA is not available"):
        trec.main(["--ckpt", ck, "--data-root", str(tmp_path)])
