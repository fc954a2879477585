"""The port's evaluation (kgat_tpu_torch.eval, utils.metrics) against
kgat_tpu's on the same inputs, on the CPU.

Same dataset, same ``all_embed``: ``evaluate`` returns the same dict
(keys and values within 1e-6) as ``kgat_tpu.eval.evaluate`` for several
cutoffs, one or many user blocks; the plan's index tables are equal; the
per-user metrics equal ``kgat_tpu.utils.metrics``'s.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgat_tpu import eval as jeval
from kgat_tpu.graph import CKGMeta as JMeta
from kgat_tpu.utils import metrics as jmetrics
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import eval as teval
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.utils import metrics as tmetrics

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=9, n_users=70, n_items=50, n_entities=90, n_relations_kg=3,
             n_interactions=900, n_triples=300)


@pytest.fixture(scope="module")
def setup():
    disable_tf32()
    ds = tdata.synthetic_dataset(**SMALL)
    _, meta = ds.build()
    rs = np.random.default_rng(0)
    all_embed = rs.normal(size=(meta.n_nodes, 24)).astype(np.float32)
    jmeta = JMeta(**dataclasses.asdict(meta))
    return ds, meta, jmeta, all_embed


@pytest.mark.parametrize("k,ks,block", [(20, (), 2048), (20, (5, 40), 16),
                                        (10, (3,), 7)])
def test_evaluate_matches_jax(setup, k, ks, block):
    ds, meta, jmeta, all_embed = setup
    want = jeval.evaluate(
        jnp.asarray(all_embed), jmeta,
        jeval.make_eval_plan(ds.train_user_dict, ds.test_user_dict,
                             meta.n_items, block=block), k=k, ks=ks)
    plan = teval.make_eval_plan(ds.train_user_dict, ds.test_user_dict,
                                meta.n_items, block=block)
    got = teval.evaluate(torch.tensor(all_embed), meta, plan, k=k, ks=ks)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name
    assert 0.0 < got["recall"] <= 1.0


def test_eval_plan_equals_jax(setup):
    ds, meta, _, _ = setup
    want = jeval.make_eval_plan(ds.train_user_dict, ds.test_user_dict,
                                meta.n_items, block=16)
    got = teval.make_eval_plan(ds.train_user_dict, ds.test_user_dict,
                               meta.n_items, block=16)
    for field in ("user_blocks", "train_pairs", "test_pairs"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.block, got.n_items) == (want.block, want.n_items)


def test_topk_metrics_match_jax():
    """Per-user recall/ndcg/precision/hit, including a user with no test
    item and one with more test items than K. Tolerance 1e-6."""
    rs = np.random.default_rng(1)
    scores = rs.normal(size=(6, 30)).astype(np.float32)
    test = (rs.random((6, 30)) < 0.2).astype(np.float32)
    test[0] = 0.0
    test[1, :25] = 1.0
    want = jmetrics.topk_metrics(jnp.asarray(scores), jnp.asarray(test), 5)
    got = tmetrics.topk_metrics(torch.tensor(scores), torch.tensor(test), 5)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    multi = tmetrics.topk_metrics_multi(torch.tensor(scores),
                                        torch.tensor(test), (5, 10))
    jmulti = jmetrics.topk_metrics_multi(jnp.asarray(scores),
                                         jnp.asarray(test), (5, 10))
    assert sorted(multi) == sorted(jmulti)
    for name in jmulti:
        np.testing.assert_allclose(multi[name].numpy(),
                                   np.asarray(jmulti[name]), rtol=0,
                                   atol=1e-6, err_msg=name)
