"""Port parity: the KGAT module vs kgat_tpu's model functions.

Parameters come from ``kgat_tpu.models.kgat.init_params`` and pass into
the port through ``params_from_jax``; the JAX side runs the pallas backend
in interpret mode, the port its plain versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.models import kgat as jkgat
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.recommend import disable_tf32

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def graphs():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, tmeta = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg, tmeta


def _jax_params(meta, agg, seed=5):
    cfg = jkgat.KGATConfig(aggregator=agg)
    return jkgat.init_params(jax.random.key(seed), meta.n_nodes,
                             meta.n_relations, cfg)


@pytest.fixture(scope="module")
def jax_attention(graphs):
    """Pallas-backend attention (the same for every aggregator: init_params
    draws entity/relation tables from the same keys)."""
    jg, jmeta, _, _ = graphs
    params = _jax_params(jmeta, "bi-interaction")
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jkgat.compute_attention(
            params, jg, jkgat.KGATConfig(ops_backend="pallas")))


@pytest.mark.parametrize("agg", ["gcn", "graphsage", "bi-interaction"])
def test_propagate_matches_pallas(graphs, jax_attention, agg):
    jg, jmeta, tg, tmeta = graphs
    params = _jax_params(jmeta, agg)
    jcfg = jkgat.KGATConfig(aggregator=agg, ops_backend="pallas")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkgat.propagate(params, jg,
                                          jnp.asarray(jax_attention), jcfg))
    cfg = tkgat.KGATConfig(aggregator=agg, ops_backend="hopper")
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    with torch.no_grad():
        att = tkgat.compute_attention(model, tg, cfg)
        np.testing.assert_allclose(att.numpy(), jax_attention[: jg.n_edges],
                                   rtol=1e-4, atol=1e-6)
        got = tkgat.propagate(model, tg, att, cfg)
        assert got.shape == (tmeta.n_nodes, cfg.out_dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        # The module's forward is attention then propagation.
        torch.testing.assert_close(model(tg, cfg), got)


def test_cf_scores_match_jax(graphs, rng):
    jg, jmeta, _, tmeta = graphs
    emb = rng.normal(size=(jmeta.n_nodes, 24)).astype(np.float32)
    u = rng.integers(0, jmeta.n_users, 16)
    i = rng.integers(0, jmeta.n_items, 16)
    want = np.asarray(jkgat.cf_scores(jnp.asarray(emb), jmeta,
                                      jnp.asarray(u), jnp.asarray(i)))
    got = tkgat.cf_scores(torch.from_numpy(emb), tmeta, torch.from_numpy(u),
                          torch.from_numpy(i))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["gcn", "graphsage", "bi-interaction"])
def test_params_from_jax_roundtrip(graphs, agg):
    _, jmeta, _, _ = graphs
    params = jax.tree.map(np.asarray, _jax_params(jmeta, agg))
    cfg = tkgat.KGATConfig(aggregator=agg)
    back = tkgat.numpy_params(tkgat.params_from_jax(params, cfg))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [str(p) for p, _ in flat_a] == [str(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_rejects_mismatched_config(graphs):
    _, jmeta, _, _ = graphs
    params = jax.tree.map(np.asarray, _jax_params(jmeta, "bi-interaction"))
    with pytest.raises(ValueError, match="do not match"):
        tkgat.params_from_jax(params, tkgat.KGATConfig(aggregator="gcn"))
    with pytest.raises(ValueError, match="shape"):
        tkgat.params_from_jax(params, tkgat.KGATConfig(conv_dims=(64, 32, 8)))


def test_init_params_xavier_and_seeded(graphs):
    _, _, _, tmeta = graphs
    cfg = tkgat.KGATConfig()
    make = lambda seed: tkgat.init_params(  # noqa: E731
        tmeta.n_nodes, tmeta.n_relations, cfg,
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    for (name, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                            b.named_parameters(),
                                            c.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.split(".")[-1].startswith("b"):
            assert not pa.any(), name
            continue
        assert not torch.equal(pa, pc), name
        limit = (6.0 / (pa.shape[-2] + pa.shape[-1])) ** 0.5
        assert pa.abs().max() <= limit, name
    assert a.w_rel.shape == (tmeta.n_relations, 64, 64)
    assert [tuple(layer["w1"].shape) for layer in a.layers] == [
        (64, 64), (64, 32), (32, 16)]


def test_bf16_value_stream_close_to_f32(graphs):
    _, _, tg, tmeta = graphs
    cfg = tkgat.KGATConfig(ops_backend="hopper")
    model = tkgat.init_params(tmeta.n_nodes, tmeta.n_relations, cfg,
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        f32 = model(tg, cfg)
        bf16 = model(tg, dataclasses.replace(cfg,
                                             compute_dtype=torch.bfloat16))
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, f32, rtol=2e-2, atol=2e-2)
