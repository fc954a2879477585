"""The port's edge-partitioned path against ``kgat_tpu.parallel``.

The same graph, the same weights (``params_from_jax``) and the same batch
go through the JAX package on a P = 4 mesh of the virtual CPU devices and
through ``kgat_tpu_torch.parallel`` with four partitions on the CPU. The
JAX side runs with ``ops_backend="ref"`` (Pallas inside ``shard_map``
hangs under CPU emulation, ``kgat_tpu/parallel/halo.py:215-242``); its
'dma' and 'fused' ring transports still run their remote-DMA kernels in
interpret mode, so the widths stay at d = 16. P = 4, so a ring shift by
+1 and by -1 differ. Tolerances are ``tests/test_partition.py``'s.
"""

import dataclasses

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
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               partition_graph)
from kgat_tpu_torch.utils.config import TrainConfig

import torch_threads  # noqa: F401  (one intra-op thread)

P = 4
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8))
CASES = [("allgather", "ppermute"), ("ring", "ppermute"), ("ring", "dma"),
         ("ring", "fused")]
B = 32


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
    jrb = jpart.build_ring_buckets(src, dst, jinfo)
    shards, info = partition_graph(src, dst, ety, jmeta.n_nodes,
                                   jmeta.n_relations, P)
    assert all(s.n_edges for s in shards)
    buckets = build_ring_buckets(src, dst, info)
    meta = CKGMeta(**dataclasses.asdict(jmeta))
    jparams = jkgat.init_params(jax.random.key(0), jmeta.n_nodes,
                                jmeta.n_relations,
                                JKGATConfig(ops_backend="ref", **MODEL))
    return dict(g=g, jmeta=jmeta, meta=meta, src=src, dst=dst, ety=ety,
                jpg=jpg, jinfo=jinfo, jrb=jrb, shards=shards, info=info,
                buckets=buckets, jmesh=j_make_mesh(P, axis=AXIS),
                np_params=jax.tree.map(np.asarray, jparams),
                jparams=jparams, jax_cache={})


def _jax_model(setup, exchange, transport, dropout):
    """kgat_tpu's partitioned functions for one exchange, cached."""
    key = (exchange, transport, dropout)
    if key not in setup["jax_cache"]:
        pltpu.reset_tpu_interpret_mode_state()
        cfg = JKGATConfig(ops_backend="ref", mess_dropout=(dropout,) * 2,
                          **MODEL)
        setup["jax_cache"][key] = (cfg, j_make_partitioned(
            setup["jmesh"], setup["jpg"], setup["jinfo"], setup["jmeta"],
            cfg, exchange=exchange,
            ring_buckets=setup["jrb"] if exchange == "ring" else None,
            ring_transport=transport))
    return setup["jax_cache"][key]


def _port(setup, exchange, transport, backend="hopper", dropout=0.1):
    cfg = KGATConfig(ops_backend=backend, mess_dropout=(dropout,) * 2,
                     **MODEL)
    part = halo.Partitioned(
        dp.make_mesh(P, "cpu"), setup["shards"], setup["info"],
        setup["meta"], cfg, exchange=exchange,
        ring_buckets=setup["buckets"] if exchange == "ring" else None,
        ring_transport=transport)
    return part, kgat.params_from_jax(setup["np_params"], cfg)


def _shard_edges(jpg, p):
    """kgat_tpu's shard p: its real edges' (src, global dst, etype) in
    the shard's canonical order."""
    live = np.asarray(jpg.edge_mask[p]) > 0
    return [np.asarray(getattr(jpg, k)[p])[live]
            for k in ("src", "dst", "etype")]


def test_shards_match_kgat_tpu(setup):
    info, jinfo = setup["info"], setup["jinfo"]
    assert (info.rows_per_part, info.n_nodes_pad) == (jinfo.rows_per_part,
                                                      jinfo.n_nodes_pad)
    R = info.rows_per_part
    assert sum(s.n_edges for s in setup["shards"]) == len(setup["src"])
    for p, shard in enumerate(setup["shards"]):
        want = _shard_edges(setup["jpg"], p)
        g = shard.graph
        np.testing.assert_array_equal(g.src.numpy(), want[0])
        np.testing.assert_array_equal(shard.dst_global.numpy(), want[1])
        np.testing.assert_array_equal(g.etype.numpy(), want[2])
        np.testing.assert_array_equal(g.dst.numpy() + p * R, want[1])
        np.testing.assert_array_equal(
            g.row_offsets.numpy(), np.searchsorted(g.dst.numpy(),
                                                   np.arange(R + 1)))
        assert g.rev_row_offsets.shape == (info.n_nodes_pad + 1,)
        np.testing.assert_array_equal(setup["src"][shard.edge_ids.numpy()],
                                      want[0])


def test_ring_buckets_match_kgat_tpu(setup):
    """Bucket (p, s) holds the same shard edges as kgat_tpu's: those whose
    source lies in partition (p - s) mod P's rows; its CSRs address the
    chunk's rows and p's local dst rows."""
    info, jrb = setup["info"], setup["jrb"]
    R = info.rows_per_part
    gather = np.asarray(jrb.fwd.gather)         # (P, P, E_aligned)
    for p, row in enumerate(setup["buckets"]):
        shard = setup["shards"][p]
        n_e = shard.n_edges
        s_src, s_dst = shard.graph.src.numpy(), shard.graph.dst.numpy()
        for s, b in enumerate(row):
            q = (p - s) % P
            want = np.sort(gather[p, s][gather[p, s] < n_e])
            slots = b.gather.numpy()
            np.testing.assert_array_equal(np.sort(slots), want)
            np.testing.assert_array_equal(s_src[slots] // R,
                                          np.full(len(slots), q))
            np.testing.assert_array_equal(b.src.numpy(), s_src[slots] - q * R)
            np.testing.assert_array_equal(b.dst.numpy(), s_dst[slots])
            rev = b.rev_gather.numpy()
            np.testing.assert_array_equal(np.sort(rev), np.sort(slots))
            np.testing.assert_array_equal(
                b.rev_row_offsets.numpy(),
                np.searchsorted(np.sort(s_src[rev] - q * R),
                                np.arange(R + 1)))
            np.testing.assert_array_equal(b.rev_dst.numpy(), s_dst[rev])


def test_attention_matches_kgat_tpu(setup):
    _, (attention, _, _, _) = _jax_model(setup, "allgather", "ppermute",
                                         0.1)
    att_j, _ = attention(setup["jpg"], setup["jparams"])
    part, model = _port(setup, "allgather", "ppermute")
    atts, _ = part.attention(model)
    for p, att in enumerate(atts):
        n_e = setup["shards"][p].n_edges
        np.testing.assert_allclose(att.numpy(), np.asarray(att_j[p])[:n_e],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["ref", "hopper"])
@pytest.mark.parametrize("exchange,transport", CASES)
def test_propagate_eval_matches_kgat_tpu(setup, exchange, transport,
                                         backend):
    _, (attention, propagate_eval, _, _) = _jax_model(setup, exchange,
                                                      transport, 0.1)
    _, ew = attention(setup["jpg"], setup["jparams"])
    want = np.asarray(propagate_eval(ew, setup["jparams"]))
    part, model = _port(setup, exchange, transport, backend)
    got = part.propagate_eval(model, part.attention(model)[1])
    assert got.shape == want.shape == (setup["meta"].n_nodes, 16 + 16 + 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("exchange,transport", CASES)
def test_cf_step_matches_kgat_tpu(setup, exchange, transport):
    """One CF step with dropout 0: the loss to 1e-5 and the entity table
    after one Adam step to 2e-5 (``tests/test_partition.py:118-120``)."""
    meta = setup["meta"]
    jcfg, (attention, _, make_cf_step, _) = _jax_model(setup, exchange,
                                                       transport, 0.0)
    u = np.arange(B, dtype=np.int32) % meta.n_users
    ip = np.arange(B, dtype=np.int32) % meta.n_items
    ineg = (np.arange(B, dtype=np.int32) + 3) % meta.n_items
    w = np.ones(B, np.float32)
    opt = optax.adam(1e-3)
    _, ew = attention(setup["jpg"], setup["jparams"])
    jp = jax.tree.map(jnp.copy, setup["jparams"])
    p_j, _, loss_j = make_cf_step(opt)(jp, opt.init(jp), ew, u, ip, ineg,
                                       w, jax.random.key(9))

    part, model = _port(setup, exchange, transport, dropout=0.0)
    adam = train.make_optimizer(model.parameters(), 1e-3)
    adam.zero_grad(set_to_none=False)
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    loss = part.cf_loss(model, part.attention(model)[1], t(u), t(ip),
                        t(ineg), weight=torch.from_numpy(w))
    loss.backward()
    adam.step()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(model.entity_embed.detach().numpy(),
                               np.asarray(p_j["entity_embed"]), atol=2e-5)


@pytest.mark.parametrize("exchange,transport", CASES)
def test_partitioned_trainer_two_epochs(tmp_path, exchange, transport):
    """The partitioned Trainer (``tests/test_partition.py:213-244``): two
    epochs with four partitions, finite losses that fall, an eval."""
    cfg = TrainConfig(
        dataset="synthetic", epochs=2, eval_every=2, lr=5e-3, device="cpu",
        cf_batch_size=62, kg_batch_size=64, n_devices=P, seed=5,
        halo_exchange=exchange, ring_transport=transport,
        log_dir=str(tmp_path), syn_users=50, syn_items=40, syn_entities=80,
        syn_relations=3, syn_interactions=500, syn_triples=400,
        model=KGATConfig(mess_dropout=(0.1, 0.1), ops_backend="hopper",
                         **MODEL))
    tr = train.Trainer(cfg)
    assert tr.partitioned and tr.n_parts == P
    assert (tr.cf_batch_size, tr.kg_batch_size) == (64, 64)
    cf1, kg1 = tr.train_one_epoch()
    cf2, kg2 = tr.train_one_epoch()
    assert np.isfinite([cf1, cf2, kg1, kg2]).all()
    assert cf2 < cf1 and kg2 < kg1
    m = tr.evaluate()
    assert 0 <= m["recall"] <= 1


def test_partitioned_all_embed_matches_single_device(setup):
    """The port's own single-device propagation agrees with every
    partitioned exchange on the same weights."""
    part, model = _port(setup, "allgather", "ppermute", "ref")
    from kgat_tpu_torch.graph import build_graph
    g = build_graph(setup["src"], setup["dst"], setup["ety"],
                    setup["meta"].n_nodes, setup["meta"].n_relations)
    cfg = KGATConfig(ops_backend="ref", **MODEL)
    want = kgat.propagate(model, g, kgat.compute_attention(model, g, cfg),
                          cfg).detach()
    for exchange, transport in CASES:
        part, model = _port(setup, exchange, transport)
        got = part.propagate_eval(model, part.attention(model)[1])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_unknown_exchange_and_missing_buckets_are_refused(setup):
    mesh = dp.make_mesh(P, "cpu")
    cfg = KGATConfig(mess_dropout=(0.1, 0.1), **MODEL)
    args = (mesh, setup["shards"], setup["info"], setup["meta"], cfg)
    with pytest.raises(ValueError, match="unknown exchange"):
        halo.Partitioned(*args, exchange="all-to-all")
    with pytest.raises(ValueError, match="requires ring_buckets"):
        halo.Partitioned(*args, exchange="ring")
    with pytest.raises(ValueError, match="requires halos"):
        halo.Partitioned(*args, exchange="a2a")
    with pytest.raises(ValueError, match="generator per partition"):
        part = halo.Partitioned(*args)
        model = kgat.params_from_jax(setup["np_params"], cfg)
        part.propagate(model, part.attention(model)[1], train=True)
