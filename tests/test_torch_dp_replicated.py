"""Data parallelism over a replicated graph: the port's (dp, ep) = (D, 1)
mesh against ``kgat_tpu.parallel.make_dp_cf_step``.

``kgat_tpu``'s dp CF step shards the batch over D devices and replicates
the graph and the parameters. The port computes the same thing as a
(D, 1) mesh of its partitioned engine: D rows, each holding the one
partition (the whole graph) and taking its block of the batch, the loss
summed over the rows (``--n-devices D --dp-replicas D``). Both take the
same 32-row batch, parameters and attention, dropout 0 (the RNG streams
differ), and one Adam step; the tolerances are
``tests/test_parallel_dp.py``'s: loss rtol 1e-5, the entity table atol
1e-5. The KG side, ``make_dp_kg_step``, is pinned by
``tests/test_torch_multihost.py::test_kg_block_losses_sum_to_the_global_loss``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgat_tpu.data import synthetic_dataset as j_synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.parallel import make_dp_cf_step, make_mesh as j_make_mesh
from kgat_tpu_torch import train
from kgat_tpu_torch.graph import CKGMeta, EdgeWeights
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import partition_graph

import torch_threads  # noqa: F401  (one intra-op thread)

MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
             mess_dropout=(0.0, 0.0))
B = 32


@pytest.fixture(scope="module")
def setup():
    # tests/test_parallel_dp.py's graph, config and parameters.
    ds = j_synthetic_dataset(seed=5, n_users=40, n_items=30, n_entities=60,
                             n_relations_kg=3, n_interactions=400,
                             n_triples=300)
    graph, jmeta = ds.build()
    jcfg = jkgat.KGATConfig(**MODEL)
    params = jkgat.init_params(jax.random.key(0), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    att = jkgat.compute_attention(params, graph, jcfg)
    return graph, jmeta, jcfg, params, att


@pytest.mark.parametrize("rows", [2, 4])
def test_dp_rows_of_one_partition_match_make_dp_cf_step(setup, rows):
    graph, jmeta, jcfg, params, att = setup
    u = np.arange(B, dtype=np.int32) % jmeta.n_users
    ip = np.arange(B, dtype=np.int32) % jmeta.n_items
    ineg = (np.arange(B, dtype=np.int32) + 5) % jmeta.n_items
    opt = optax.adam(1e-3)
    step = make_dp_cf_step(j_make_mesh(rows), graph, jmeta, jcfg, opt)
    p_j, _, loss_j = step(jax.tree.map(jnp.copy, params), opt.init(params),
                          att, jnp.asarray(u), jnp.asarray(ip),
                          jnp.asarray(ineg), jax.random.key(7))

    coo = host_coo(graph)
    shards, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                                   jmeta.n_nodes, jmeta.n_relations, 1)
    # One partition holds every edge, in the graph's canonical order.
    np.testing.assert_array_equal(shards[0].edge_ids.numpy(),
                                  np.arange(graph.n_edges))
    cfg = KGATConfig(ops_backend="ref", **MODEL)
    part = halo.Partitioned(dp.make_mesh(1, "cpu", rows), shards, info,
                            CKGMeta(**dataclasses.asdict(jmeta)), cfg)
    assert (part.n_rows, part.n_parts) == (rows, 1)
    model = kgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    # The port's attention equals JAX's; the step then takes JAX's.
    att_j = torch.from_numpy(np.array(att)[:graph.n_edges])
    torch.testing.assert_close(part.attention(model)[0][0], att_j,
                               rtol=1e-5, atol=1e-6)
    staged = [[EdgeWeights.stage(shards[0].graph, att_j)]
              for _ in range(rows)]

    adam = train.make_optimizer(model.parameters(), 1e-3)
    adam.zero_grad(set_to_none=False)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    loss = part.cf_loss(model, staged, t(u), t(ip), t(ineg))
    loss.backward()
    adam.step()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(model.entity_embed.detach().numpy(),
                               np.asarray(p_j["entity_embed"]), atol=1e-5)
