"""The dense-projection attention route: the port against ``kgat_tpu``.

``hopper_backend.use_dense_attention`` resolves as
``pallas_backend.use_dense_attention`` over a grid of graph sizes and
configs; ``hopper_backend.attention_logits_dense`` gives
``pallas_backend._attention_logits_fwd_dense``'s logits (XLA, no Pallas),
mapped from its aligned order to canonical edge order, on the same
numpy-seeded weights: rtol 1e-4, atol 1e-6 with float32 tables; with bf16
tables within 2 * 2^-8 * sum_k |q t| per edge (each of the two tables
rounded once). It also agrees with the port's relation-tile route (K2's
plain version) at rtol 1e-4, and ``--att-impl dense`` trains an epoch.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgat_tpu import data as jdata
from kgat_tpu.graph import host_array
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import train
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops import hopper_backend
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@dataclasses.dataclass
class Sized:
    """What the route rule reads of a graph."""
    n_relations: int
    n_nodes: int


# (R, N): the mid-plateau CKG (64.5 MB of float32 tables at k = 64), the
# yelp2018-scale one (6.0 GB), and one whose tables pass in bf16 only.
SIZES = [(18, 7000), (86, 136880), (10, 31250)]


@pytest.mark.parametrize("impl", ["auto", "dense", "relblock"])
@pytest.mark.parametrize("k", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("bf16", [False, True])
def test_route_resolves_as_kgat_tpu(impl, k, bf16):
    for r, n in SIZES:
        g = Sized(r, n)
        jcfg = jkgat.KGATConfig(relation_dim=k, att_impl=impl,
                                att_table_dtype=jnp.bfloat16 if bf16
                                else None)
        tcfg = tkgat.KGATConfig(relation_dim=k, att_impl=impl,
                                att_table_dtype=torch.bfloat16 if bf16
                                else None)
        try:
            want = pb.use_dense_attention(g, jcfg)
        except ValueError:
            with pytest.raises(ValueError, match="divide 128"):
                hopper_backend.use_dense_attention(g, tcfg)
            assert impl == "dense" and 128 % k
            continue
        assert hopper_backend.use_dense_attention(g, tcfg) == want, (r, n)
    # Both sides of the bound: mid-plateau dense, yelp2018 relblock, and
    # the third size dense in bf16 alone.
    if impl == "auto" and k == 64:
        got = [hopper_backend.use_dense_attention(Sized(r, n), tcfg)
               for r, n in SIZES]
        assert got == [True, False, bf16]


@pytest.fixture(scope="module")
def small():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, _ = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg


def _canonical(jg, aligned):
    """kgat_tpu's forward-aligned logits in canonical edge order."""
    gather = host_array(jg.fwd_layout, "gather")
    live = gather < jg.n_edges
    out = np.zeros(jg.n_edges, np.float32)
    out[gather[live]] = np.asarray(aligned)[live]
    return out


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("bf16", [False, True])
def test_dense_logits_match_kgat_tpu(small, k, bf16):
    jg, jmeta, tg = small
    jcfg = jkgat.KGATConfig(ops_backend="pallas", embed_dim=16,
                            relation_dim=k, conv_dims=(16,),
                            mess_dropout=(0.1,),
                            att_table_dtype=jnp.bfloat16 if bf16 else None)
    params = jkgat.init_params(jax.random.key(k), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    want = _canonical(jg, pb._attention_logits_fwd_dense(params, jg, jcfg))
    cfg = tkgat.KGATConfig(ops_backend="hopper", embed_dim=16,
                           relation_dim=k, conv_dims=(16,),
                           mess_dropout=(0.1,))
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    with torch.no_grad():
        got = hopper_backend.attention_logits_dense(
            tg, model.entity_embed, model.w_rel, model.rel_embed,
            torch.bfloat16 if bf16 else None).numpy()
        if not bf16:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
            # The relation-tile route (K2's plain version) agrees.
            k2 = tkgat.attention_logits(model, tg, cfg).numpy()
            np.testing.assert_allclose(got, k2, rtol=1e-4, atol=1e-6)
            return
    # bf16 tables: each logit within 2 * 2^-8 * sum_k |q t| (float64).
    emb = np.asarray(params["entity_embed"], np.float64)
    w = np.asarray(params["w_rel"], np.float64)
    er = np.asarray(params["rel_embed"], np.float64)
    src, dst, ety = (getattr(tg, a).numpy() for a in ("src", "dst", "etype"))
    q = np.einsum("ed,edk->ek", emb[src], w[ety])
    t = np.tanh(np.einsum("ed,edk->ek", emb[dst], w[ety]) + er[ety])
    bound = 2 * 2.0 ** -8 * np.abs(q * t).sum(-1)
    assert (np.abs(got - want) <= bound).all()
    assert (np.abs(got - (q * t).sum(-1)) <= bound).all()


def test_training_attention_takes_the_route_auto_picks(small, monkeypatch):
    """attention_for_training on the hopper backend reaches the dense
    route where auto resolves to it (this size), and not under
    'relblock' or on the ref backend; both give the same weights."""
    _, _, tg = small
    calls = []
    dense = hopper_backend.attention_logits_dense
    monkeypatch.setattr(hopper_backend, "attention_logits_dense",
                        lambda *a: calls.append(1) or dense(*a))
    cfg = tkgat.KGATConfig(ops_backend="hopper", embed_dim=16,
                           relation_dim=16, conv_dims=(16,),
                           mess_dropout=(0.1,), coalesce=False)
    model = tkgat.init_params(tg.n_nodes, tg.n_relations, cfg,
                              generator=torch.Generator().manual_seed(0))
    got = {}
    for impl, backend in (("auto", "hopper"), ("relblock", "hopper"),
                          ("dense", "ref")):
        c = dataclasses.replace(cfg, att_impl=impl, ops_backend=backend)
        got[impl] = tkgat.attention_for_training(model, tg, c).fwd
    assert len(calls) == 1
    torch.testing.assert_close(got["auto"], got["relblock"], rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(got["auto"], got["dense"], rtol=1e-4,
                               atol=1e-6)


def test_att_impl_dense_trains_a_cpu_epoch(tmp_path, monkeypatch):
    calls = []
    dense = hopper_backend.attention_logits_dense
    monkeypatch.setattr(hopper_backend, "attention_logits_dense",
                        lambda *a: calls.append(1) or dense(*a))
    cfg = train.parse_args(["--preset", "smoke-gcn", "--att-impl", "dense",
                            "--device", "cpu", "--epochs", "1",
                            "--eval-every", "1", "--log-dir", str(tmp_path),
                            "--run-name", "dense"])
    assert cfg.model.att_impl == "dense" and cfg.model.coalesce
    tr = train.Trainer(cfg)
    tr.train()
    with open(tmp_path / "dense.jsonl") as f:
        events = [json.loads(ln) for ln in f]
    assert [e["event"] for e in events] == ["start", "epoch", "eval", "done"]
    assert np.isfinite(events[1]["cf_loss"]) and 0 <= events[2]["recall"]
    # The epoch's two attention recomputes (its start and end).
    assert len(calls) == 2
