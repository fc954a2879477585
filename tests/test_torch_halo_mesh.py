"""The selective halo all-to-all and the 2D (dp, ep) mesh against
``kgat_tpu.parallel``, and the partitioned trainer's step path.

The same seeded graph and weights (``params_from_jax``) go through the JAX
package, on a P = 4 mesh (or a (2, 4) (dp, ep) mesh) of the virtual CPU
devices with ``ops_backend="ref"``, and through ``kgat_tpu_torch.parallel``
with every partition on the CPU, as ``tests/test_torch_partition.py``
does. Tolerances are ``tests/test_partition.py``'s: forward rtol/atol
1e-4, the CF loss rtol 1e-5, the entity table after one Adam step atol
2e-5.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu.data import synthetic_dataset as j_synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.models.kgat import KGATConfig as JKGATConfig
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.parallel.dp import make_mesh as j_make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned as j_make_partitioned
from kgat_tpu_torch import train
from kgat_tpu_torch.graph import CKGMeta
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.utils.config import TrainConfig, parse_args

import torch_threads  # noqa: F401  (one intra-op thread)

P = 4
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8))
B = 32
MESH_CASES = [("allgather", "ppermute"), ("ring", "fused"),
              ("ring", "ppermute"), ("a2a", "ppermute")]


@pytest.fixture(scope="module")
def setup():
    # 500 nodes: R = 128, every partition owns rows and edges.
    ds = j_synthetic_dataset(seed=21, n_users=200, n_items=150,
                             n_entities=300, n_relations_kg=3,
                             n_interactions=1500, n_triples=1000)
    g, jmeta = ds.build()
    coo = host_coo(g)
    src, dst, ety = coo["src"], coo["dst"], coo["etype"]
    jpg, jinfo = jpart.partition_graph(src, dst, ety, jmeta.n_nodes,
                                       jmeta.n_relations, P)
    shards, info = partition_graph(src, dst, ety, jmeta.n_nodes,
                                   jmeta.n_relations, P)
    jparams = jkgat.init_params(jax.random.key(0), jmeta.n_nodes,
                                jmeta.n_relations,
                                JKGATConfig(ops_backend="ref", **MODEL))
    return dict(
        jmeta=jmeta, meta=CKGMeta(**dataclasses.asdict(jmeta)), src=src,
        dst=dst, jpg=jpg, jinfo=jinfo, shards=shards, info=info,
        jrb=jpart.build_ring_buckets(src, dst, jinfo),
        jsh=jpart.build_selective_halo(src, dst, jinfo),
        buckets=build_ring_buckets(src, dst, info),
        halos=build_selective_halo(shards, info),
        jmeshes={1: j_make_mesh(P, axis=AXIS), 2: jax.make_mesh(
            (2, P), ("dp", AXIS),
            axis_types=(jax.sharding.AxisType.Auto,) * 2)},
        np_params=jax.tree.map(np.asarray, jparams), jparams=jparams,
        jax_cache={})


def _jax_model(setup, exchange, transport, rows, dropout=0.0):
    """kgat_tpu's partitioned functions on a 1D (rows = 1) or (2, 4)
    mesh, cached."""
    key = (exchange, transport, rows, dropout)
    if key not in setup["jax_cache"]:
        pltpu.reset_tpu_interpret_mode_state()
        cfg = JKGATConfig(ops_backend="ref", mess_dropout=(dropout,) * 2,
                          **MODEL)
        setup["jax_cache"][key] = j_make_partitioned(
            setup["jmeshes"][rows], setup["jpg"], setup["jinfo"],
            setup["jmeta"], cfg, exchange=exchange,
            ring_buckets=setup["jrb"] if exchange == "ring" else None,
            sel_halo=setup["jsh"] if exchange == "a2a" else None,
            ring_transport=transport,
            dp_axis="dp" if rows > 1 else None)
    return setup["jax_cache"][key]


def _port(setup, exchange, transport, rows, backend="hopper", dropout=0.0):
    cfg = KGATConfig(ops_backend=backend, mess_dropout=(dropout,) * 2,
                     **MODEL)
    part = halo.Partitioned(
        dp.make_mesh(P, "cpu", rows), setup["shards"], setup["info"],
        setup["meta"], cfg, exchange=exchange,
        ring_buckets=setup["buckets"] if exchange == "ring" else None,
        halos=setup["halos"] if exchange == "a2a" else None,
        ring_transport=transport)
    return part, kgat.params_from_jax(setup["np_params"], cfg)


def _real(block, sentinel):
    return block[block < sentinel]


def test_selective_halo_matches_kgat_tpu(setup):
    """Per shard: each peer's send set and the local table's global rows
    equal kgat_tpu's once its padding is stripped; the halo CSR holds the
    shard's edges (the same multiset as kgat_tpu's layout) in the shard's
    order; both row splits cover every edge once."""
    info, jsh = setup["info"], setup["jsh"]
    R, N = info.rows_per_part, info.n_nodes_global
    Hj = jsh.halo_rows
    j_ids, j_send = np.asarray(jsh.local_ids), np.asarray(jsh.send_idx)
    j_node, j_seg = np.asarray(jsh.fwd.node), np.asarray(jsh.fwd.seg)
    j_gather = np.asarray(jsh.fwd.gather)
    halos = setup["halos"]
    H = halos[0].halo_rows
    assert 0 < H <= Hj and all(h.table_rows == R + P * H for h in halos)
    # need[p][q]: the global rows of q that p reads, from kgat_tpu.
    need = [[_real(j_ids[p, R + q * Hj:R + (q + 1) * Hj], N)
             for q in range(P)] for p in range(P)]
    assert max(len(rows) for per in need for rows in per) == H
    for p, (h, shard) in enumerate(zip(halos, setup["shards"])):
        ids = h.local_ids.numpy()
        np.testing.assert_array_equal(ids[:R], j_ids[p, :R])
        for q in range(P):
            block = ids[R + q * H:R + (q + 1) * H]
            np.testing.assert_array_equal(_real(block, N), need[p][q])
            assert (block[len(need[p][q]):] == N).all()
            n_sent = len(need[q][p])
            np.testing.assert_array_equal(h.send_idx[q, :n_sent].numpy(),
                                          j_send[p, q, :n_sent])
            np.testing.assert_array_equal(h.send_idx[q, :n_sent].numpy()
                                          + p * R, need[q][p])
        g = h.graph
        n_e = shard.n_edges
        # The shard's edges in its order: sources through the table.
        np.testing.assert_array_equal(ids[g.src.numpy()],
                                      shard.graph.src.numpy())
        np.testing.assert_array_equal(g.dst.numpy(), shard.graph.dst.numpy())
        live = j_gather[p] < n_e
        got = sorted(zip(ids[g.src.numpy()], g.dst.numpy()))
        want = sorted(zip(j_ids[p][j_node[p][live]], j_seg[p][live]))
        assert got == want
        # Reverse CSR over the T table rows.
        rev = g.rev_perm.long()
        np.testing.assert_array_equal(
            g.rev_row_offsets.numpy(),
            np.searchsorted(np.sort(g.src.numpy()),
                            np.arange(h.table_rows + 1)))
        np.testing.assert_array_equal(g.rev_dst.numpy(), g.dst[rev].numpy())
        for split, ro in ((g.split, g.row_offsets),
                          (g.rev_split, g.rev_row_offsets)):
            unit, edge = ref._unit_edges(split, "cpu")
            np.testing.assert_array_equal(np.sort(edge.numpy()),
                                          np.arange(n_e))
            row = split.units[:, 0].long()[unit]
            assert ((ro.long()[row] <= edge) & (edge < ro.long()[row + 1])
                    ).all()


def _batch(meta):
    u = np.arange(B, dtype=np.int32) % meta.n_users
    ip = np.arange(B, dtype=np.int32) % meta.n_items
    ineg = (np.arange(B, dtype=np.int32) + 3) % meta.n_items
    return u, ip, ineg, np.ones(B, np.float32)


def _forward_matches(setup, exchange, transport, rows, backend):
    attention, propagate_eval, _, _ = _jax_model(setup, exchange, transport,
                                                 rows)
    _, ew = attention(setup["jpg"], setup["jparams"])
    want = np.asarray(propagate_eval(ew, setup["jparams"]))
    part, model = _port(setup, exchange, transport, rows, backend)
    got = part.propagate_eval(model, part.attention(model)[1])
    assert got.shape == want.shape == (setup["meta"].n_nodes, 16 + 16 + 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _cf_step_matches(setup, exchange, transport, rows):
    """One CF step with dropout 0: the loss to 1e-5 and the entity table
    after one Adam step to 2e-5 (``tests/test_partition.py:247-300``)."""
    _, _, make_cf_step, _ = _jax_model(setup, exchange, transport, rows)
    attention = _jax_model(setup, exchange, transport, rows)[0]
    u, ip, ineg, w = _batch(setup["meta"])
    opt = optax.adam(1e-3)
    _, ew = attention(setup["jpg"], setup["jparams"])
    jp = jax.tree.map(jnp.copy, setup["jparams"])
    p_j, _, loss_j = make_cf_step(opt)(jp, opt.init(jp), ew, u, ip, ineg,
                                       w, jax.random.key(9))

    part, model = _port(setup, exchange, transport, rows)
    adam = train.make_optimizer(model.parameters(), 1e-3)
    adam.zero_grad(set_to_none=False)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    loss = part.cf_loss(model, part.attention(model)[1], t(u), t(ip),
                        t(ineg), weight=torch.from_numpy(w))
    loss.backward()
    adam.step()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(model.entity_embed.detach().numpy(),
                               np.asarray(p_j["entity_embed"]), atol=2e-5)


@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_a2a_propagate_eval_matches_kgat_tpu(setup, backend):
    _forward_matches(setup, "a2a", "ppermute", 1, backend)


def test_a2a_cf_step_matches_kgat_tpu(setup):
    _cf_step_matches(setup, "a2a", "ppermute", 1)


@pytest.mark.parametrize("exchange,transport", MESH_CASES)
def test_2d_mesh_propagate_eval_matches_kgat_tpu(setup, exchange, transport):
    """D = 2 rows of P = 4 against kgat_tpu's (2, 4) (dp, ep) mesh."""
    _forward_matches(setup, exchange, transport, 2, "hopper")


@pytest.mark.parametrize("exchange,transport", MESH_CASES)
def test_2d_mesh_cf_step_matches_kgat_tpu(setup, exchange, transport):
    """The CF step on the (2, 4) mesh: each row its block of the batch,
    the loss over both rows, one Adam step (``tests/test_partition.py:
    446-491``)."""
    _cf_step_matches(setup, exchange, transport, 2)


def test_2d_mesh_rows_draw_their_own_dropout(setup):
    """Row d's partition p draws from generators[d P + p]: with dropout
    on, a CF loss depends on every row's generators, and the mesh wants
    one per (row, partition)."""
    part, model = _port(setup, "a2a", "ppermute", 2, dropout=0.5)
    staged = part.attention(model)[1]
    users = torch.arange(B) % setup["meta"].n_users
    batch = (users, users % setup["meta"].n_items,
             (users + 3) % setup["meta"].n_items)

    def loss(seeds):
        return part.cf_loss(model, staged, *batch, generators=[
            torch.Generator().manual_seed(s) for s in seeds]).item()

    base = loss(range(2 * P))
    assert loss(range(2 * P)) == base
    for i in (1, P + 1):                 # a partition of each row
        seeds = list(range(2 * P))
        seeds[i] = 100
        assert loss(seeds) != base, i
    with pytest.raises(ValueError, match="generator per partition"):
        loss(range(P))


def _trainer_cfg(tmp_path, **kw):
    return TrainConfig(**{
        **dict(dataset="synthetic", epochs=2, eval_every=2, lr=5e-3,
               device="cpu", cf_batch_size=62, kg_batch_size=64, seed=5,
               log_dir=str(tmp_path), syn_users=50, syn_items=40,
               syn_entities=80, syn_relations=3, syn_interactions=500,
               syn_triples=400,
               model=KGATConfig(mess_dropout=(0.1, 0.1),
                                ops_backend="hopper", **MODEL)), **kw})


@pytest.mark.parametrize("kw,mesh", [
    (dict(n_devices=4, halo_exchange="a2a"), (1, 4)),
    (dict(n_devices=4, dp_replicas=2), (2, 2)),
    (dict(n_devices=4, dp_replicas=2, halo_exchange="ring",
          ring_transport="fused"), (2, 2))])
def test_trainer_two_epochs(tmp_path, kw, mesh):
    """Two CPU epochs with falling, finite losses and an eval: the a2a
    exchange, and a (2, 2) mesh (``tests/test_partition.py:494-516``);
    one dropout generator per (row, partition), seeded seed + 1 + p + P d;
    batches rounded up to a multiple of the four devices."""
    tr = train.Trainer(_trainer_cfg(tmp_path, **kw))
    assert tr.partitioned and (tr.dp_replicas, tr.n_parts) == mesh
    assert tr.part.n_rows == mesh[0] and tr.n_devices == 4
    assert (tr.cf_batch_size, tr.kg_batch_size) == (64, 64)
    assert [g.initial_seed() for g in tr.part_generators] == [6, 7, 8, 9]
    assert not tr.captured and tr.capture_why == "the CPU runs eager steps"
    cf1, kg1 = tr.train_one_epoch()
    cf2, kg2 = tr.train_one_epoch()
    assert np.isfinite([cf1, cf2, kg1, kg2]).all()
    assert cf2 < cf1 and kg2 < kg1
    assert 0 <= tr.evaluate()["recall"] <= 1


def test_dp_replicas_must_divide_n_devices(tmp_path):
    """``--dp-replicas 3 --n-devices 4`` is refused with kgat_tpu's
    message (``kgat_tpu/train.py:287-289``)."""
    cfg = parse_args(["--device", "cpu", "--n-devices", "4",
                      "--dp-replicas", "3"])
    assert (cfg.n_devices, cfg.dp_replicas) == (4, 3)
    with pytest.raises(ValueError, match="--dp-replicas 3 must divide "
                                         "--n-devices 4"):
        train.Trainer(_trainer_cfg(tmp_path, n_devices=4, dp_replicas=3))
    with pytest.raises(SystemExit):
        parse_args(["--n-devices", "4", "--dp-replicas", "0"])


def test_dp_checkpoint_restores_every_partition_generator(tmp_path):
    """A (2, 2) run's checkpoint holds each (row, partition) generator
    under ``part_generator/{d P + p}``; ``--resume`` restores all four."""
    cfg = _trainer_cfg(tmp_path, n_devices=4, dp_replicas=2,
                       halo_exchange="a2a", epochs=1, eval_every=1)
    first = train.Trainer(cfg)
    first.train()
    resumed = train.Trainer(dataclasses.replace(cfg, resume=True, epochs=2))
    assert not any(torch.equal(g.get_state(), h.get_state())
                   for g, h in zip(first.part_generators,
                                   resumed.part_generators))
    resumed._resume()
    assert resumed.epoch == 1 and len(resumed.part_generators) == 4
    for g, h in zip(first.part_generators, resumed.part_generators):
        assert torch.equal(g.get_state(), h.get_state())
    assert torch.equal(first.generator.get_state(),
                       resumed.generator.get_state())


@pytest.mark.parametrize("kw", [
    dict(n_devices=4, halo_exchange="ring", ring_transport="fused"),
    dict(n_devices=4, dp_replicas=2, halo_exchange="a2a")])
def test_partitioned_epoch_runs_the_step_bodies(tmp_path, kw):
    """The partitioned epoch goes through the StepGraph bodies, one call a
    step, and from the same seeds gives exactly the losses of an eager
    loop of ``cf_step`` and ``kg_step`` on the epoch's attention."""
    cfg = _trainer_cfg(tmp_path, **kw)
    tr = train.Trainer(cfg)
    calls = []
    for steps in (tr.cf_steps, tr.kg_steps):
        body = steps.body
        steps.body = lambda body=body: calls.append(body) or body()
    got = tr.train_one_epoch()
    assert len(calls) == tr.n_cf_batches + tr.n_kg_batches
    assert tr.cf_drawn is not None and tr.kg_drawn is not None

    eager = train.Trainer(dataclasses.replace(cfg, log_dir=None))
    att = eager.attention()
    cf_sum = torch.zeros(())
    for _ in range(eager.n_cf_batches):
        cf_sum += eager.cf_step(att, *eager.sample_cf())
    kg_sum = torch.zeros(())
    for _ in range(eager.n_kg_batches):
        kg_sum += eager.kg_step(*eager.sample_kg())
    assert got == (float(cf_sum) / eager.n_cf_batches,
                   float(kg_sum) / eager.n_kg_batches)


def test_capture_mode_follows_the_mesh():
    """The steps are captured when every partition lies on one card; a
    mesh over several cards runs eager steps, by a mode decided from the
    mesh that names its reason (no CUDA is touched to decide it)."""
    def mode(devices, rows=1, sampler="device"):
        fake = SimpleNamespace(
            device=torch.device("cuda"), partitioned=bool(devices),
            cfg=TrainConfig(sampler=sampler), n_devices=len(devices),
            mesh=dp.Mesh(devices=tuple(map(torch.device, devices)),
                          dp_replicas=rows))
        return train.Trainer._capture_mode(fake)

    assert mode(["cuda:0"] * 4) == (True, "all 4 partitions on cuda:0")
    assert mode(["cuda:0"] * 4, rows=2)[0]
    captured, why = mode(["cuda:0", "cuda:1"] * 2, rows=2)
    assert not captured and "span 2 cards (cuda:0, cuda:1)" in why
    assert mode([]) == (True, "one device, cuda")
    assert mode([], sampler="host") == (False,
                                        "--sampler host runs eager steps")
    mesh = dp.make_mesh(2, "cpu", 3)
    assert (mesh.n_parts, len(mesh.devices)) == (2, 6)
    assert mesh.row(2) == mesh.devices[4:]
    with pytest.raises(ValueError, match="must divide"):
        dp.split_devices(4, 3)
    assert dp.split_devices(4, 2) == 2
