"""Multi-edge coalescing: the port against ``kgat_tpu``'s coalesced path.

The same graph (built by both packages from one COO, with multi-edges,
one pair of 11 members among them) and the same numpy-seeded weights and
features go through ``kgat_tpu`` (``graph.build_coalesced_layouts``,
``pallas_backend.prepare_weights(coalesce=True)`` and its ``spmm``, its
Pallas kernels in interpret mode, as ``tests/test_pallas_ops.py:188-245``
runs them) and through the port (``graph.Coalesced``,
``coalesce_weights``, the hopper backend's plain versions on the CPU).
The partitioned all-gather runs ``make_partitioned(coalesced=...)`` as
``tests/test_partition_pallas.py:275-306`` does. Tolerances: the staged
group weights rtol 1e-6 in float32 (the same sums in the same order);
the SpMM forward rtol 1e-4, its gradients rtol 1e-3; propagate rtol 1e-4;
the port coalesced against the port uncoalesced rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import build_coalesced_layouts
from kgat_tpu.graph import build_graph as j_build_graph
from kgat_tpu.graph import host_array, host_coo
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.parallel.dp import make_mesh as j_make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned as j_make_partitioned
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import graph as tgraph
from kgat_tpu_torch import train
from kgat_tpu_torch.graph import CKGMeta, EdgeWeights
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops import hopper_backend, ref
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8))


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def graphs():
    """Both packages' graph of one COO: the small synthetic CKG plus 11
    edges of one (dst, src) pair, so a run splits at caps 1, 2 and 8."""
    jg0, meta = jdata.synthetic_dataset(**SMALL).build()
    coo = host_coo(jg0)
    src = np.concatenate([coo["src"], np.full(11, 7)])
    dst = np.concatenate([coo["dst"], np.full(11, 3)])
    ety = np.concatenate([coo["etype"], np.arange(11) % meta.n_relations])
    jg = j_build_graph(src, dst, ety, meta.n_nodes, meta.n_relations)
    tg = tgraph.build_graph(src, dst, ety, meta.n_nodes, meta.n_relations)
    return jg, tg, meta


def jax_groups(jg, cap):
    """``kgat_tpu``'s groups at ``cap``, in group order: (n_pairs, dst,
    src, members as canonical edge ids, each group's position in the
    coalesced forward layout)."""
    co = build_coalesced_layouts(jg, cap)
    gather = host_array(co.fwd, "gather")
    pos = np.nonzero(gather < co.n_pairs)[0]
    pos = pos[np.argsort(gather[pos])]
    last = np.asarray(co.pick_fwd)[pos]
    within = np.asarray(co.within)
    fwd_gather = host_array(jg.fwd_layout, "gather")
    members = [fwd_gather[p - within[p]:p + 1] for p in last]
    return (co.n_pairs, host_array(co.fwd, "seg")[pos],
            host_array(co.fwd, "node")[pos], members, pos)


def port_members(co):
    order, within, last = (co.order.numpy(), co.within.numpy(),
                           co.last.numpy())
    return [order[p - within[p]:p + 1] for p in last]


@pytest.mark.parametrize("cap", [1, 2, 8])
def test_groups_match_kgat_tpu(graphs, cap):
    jg, tg, _ = graphs
    n_pairs, dst, src, members, _ = jax_groups(jg, cap)
    co = tgraph.build_coalesced(tg, cap)
    assert co.n_pairs == n_pairs
    np.testing.assert_array_equal(co.dst.numpy(), dst)
    np.testing.assert_array_equal(co.src.numpy(), src)
    got = port_members(co)
    assert len(got) == len(members)
    for a, b in zip(got, members):
        np.testing.assert_array_equal(a, b)
    # The 11-member run splits into ceil(11 / cap) groups of the pair.
    pair = (co.dst.numpy() == 3) & (co.src.numpy() == 7)
    assert pair.sum() == -(-11 // cap)
    # The CSRs: forward over dst rows, reverse stable by src, row splits.
    ro = co.row_offsets.numpy()
    np.testing.assert_array_equal(ro, np.searchsorted(
        co.dst.numpy(), np.arange(tg.n_nodes + 1)))
    rev = co.rev_perm.numpy()
    np.testing.assert_array_equal(rev, np.argsort(co.src.numpy(),
                                                  kind="stable"))
    np.testing.assert_array_equal(co.rev_dst.numpy(), co.dst.numpy()[rev])
    assert (co.split.n_edges, co.rev_split.n_edges) == (n_pairs, n_pairs)
    assert co.to("cpu").rev_split.n_units == co.rev_split.n_units


@pytest.mark.parametrize("cap", [1, 2, 8])
def test_staged_group_weights_match_kgat_tpu(graphs, cap):
    jg, tg, _ = graphs
    rng = np.random.default_rng(cap)
    w = rng.uniform(size=tg.n_edges).astype(np.float32)
    w_pad = np.zeros(jg.n_edges_pad, np.float32)
    w_pad[:tg.n_edges] = w
    _, _, _, _, pos = jax_groups(jg, cap)
    for dtype, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        ew = pb.prepare_weights(jg, jnp.asarray(w_pad), dtype=jdt,
                                coalesce=True, cap=cap)
        want = np.asarray(ew.fwd.astype(jnp.float32))[pos]
        got = tgraph.coalesce_weights(tgraph.build_coalesced(tg, cap),
                                      torch.from_numpy(w), dtype)
        assert got.coalesced and got.cap == cap
        if dtype is None:
            np.testing.assert_allclose(got.fwd.numpy(), want, rtol=1e-6)
        else:
            # Within one bf16 ulp, and every value a bf16.
            assert torch.equal(got.fwd, got.fwd.to(dtype).float())
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
            assert (np.abs(got.fwd.numpy() - want) <= ulp).all()
        np.testing.assert_array_equal(
            got.rev.numpy(), got.fwd.numpy()[
                tgraph.build_coalesced(tg, cap).rev_perm.numpy()])


def test_coalesced_spmm_and_grads_match_kgat_tpu(graphs):
    jg, tg, _ = graphs
    rng = np.random.default_rng(3)
    E, N = tg.n_edges, tg.n_nodes
    w = rng.uniform(size=E).astype(np.float32)
    x = rng.normal(size=(N, 16)).astype(np.float32)
    cot = rng.normal(size=(N, 16)).astype(np.float32)
    w_pad = np.zeros(jg.n_edges_pad, np.float32)
    w_pad[:E] = w

    def loss(w_, x_):
        return jnp.vdot(pb.spmm(jg, pb.prepare_weights(jg, w_, coalesce=True),
                                x_), jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pb.spmm(jg, pb.prepare_weights(
            jg, jnp.asarray(w_pad), coalesce=True), jnp.asarray(x)))
        dw_j, dx_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w_pad),
                                                    jnp.asarray(x))
    tgraph.coalesced(tg)
    for ops in (hopper_backend, ref):
        wt = torch.tensor(w, requires_grad=True)
        xt = torch.tensor(x, requires_grad=True)
        ew = tgraph.stage_weights(tg, wt, coalesce=True)
        out = ops.spmm(tg, ew, xt)
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j)[:E],
                                   rtol=1e-3, atol=1e-5)


def test_coalesced_weights_need_their_csrs(graphs):
    """Weights coalesced at one cap on a graph whose CSRs are another's
    are refused, never reduced over the wrong groups."""
    _, tg, _ = graphs
    g = dataclasses.replace(tg, co=None)
    ew = tgraph.coalesce_weights(tgraph.build_coalesced(g, 2),
                                 torch.ones(g.n_edges))
    x = torch.ones(g.n_nodes, 4)
    with pytest.raises(ValueError, match="no coalesced CSRs at that cap"):
        hopper_backend.spmm(g, ew, x)
    tgraph.coalesced(g, 8)
    with pytest.raises(ValueError, match="no coalesced CSRs at that cap"):
        ref.spmm(g, ew, x)


@pytest.fixture(scope="module")
def small():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, tmeta = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg, tmeta


def test_propagate_at_the_defaults_matches_kgat_tpu(small):
    """kgat_tpu's training attention at its defaults (pallas: the dense
    route at this size, coalesced) and propagate, against the port's."""
    jg, jmeta, tg, _ = small
    jcfg = jkgat.KGATConfig(ops_backend="pallas", **MODEL)
    assert jcfg.coalesce and pb.use_dense_attention(jg, jcfg)
    params = jkgat.init_params(jax.random.key(4), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    with pltpu.force_tpu_interpret_mode():
        ew = jkgat.attention_for_training(params, jg, jcfg)
        want = np.asarray(jkgat.propagate(params, jg, ew, jcfg))
    cfg = tkgat.KGATConfig(ops_backend="hopper", **MODEL)
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    got_ew = tkgat.attention_for_training(model, tg, cfg)
    assert got_ew.coalesced and got_ew.fwd.shape == (tg.co.n_pairs,)
    with torch.no_grad():
        got = tkgat.propagate(model, tg, got_ew, cfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        # The port coalesced against the port uncoalesced.
        plain = dataclasses.replace(cfg, coalesce=False)
        ew_full = tkgat.attention_for_training(model, tg, plain)
        assert not ew_full.coalesced
        full = tkgat.propagate(model, tg, ew_full, plain)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_clones_keep_the_coalesced_staging(small):
    """The captured steps' weight buffers (clone_weights, copy_weights_)
    hold coalesced tensors and keep saying so."""
    _, _, tg, tmeta = small
    cfg = tkgat.KGATConfig(ops_backend="hopper", **MODEL)
    model = tkgat.init_params(tmeta.n_nodes, tmeta.n_relations, cfg,
                              generator=torch.Generator().manual_seed(1))
    ew = tkgat.attention_for_training(model, tg, cfg)
    buf = tgraph.clone_weights([ew, [ew]])
    assert buf[0].coalesced and buf[1][0].coalesced
    assert buf[0].fwd.shape == (tg.co.n_pairs,)
    with torch.no_grad():
        model.entity_embed.mul_(2.0)
    ew2 = tkgat.attention_for_training(model, tg, cfg)
    tgraph.copy_weights_(buf, [ew2, [ew2]])
    torch.testing.assert_close(buf[0].fwd, ew2.fwd, rtol=0, atol=0)
    torch.testing.assert_close(buf[1][0].rev, ew2.rev, rtol=0, atol=0)


def test_kgat_config_defaults_match_kgat_tpu():
    j, t = jkgat.KGATConfig(), tkgat.KGATConfig()
    assert (t.coalesce, t.coalesce_cap, t.att_impl) == (
        j.coalesce, j.coalesce_cap, j.att_impl)
    assert j.att_table_dtype is None and t.att_table_dtype is None


# --- the partitioned all-gather's coalesced shards -------------------------

PART = dict(seed=31, n_users=60, n_items=50, n_entities=90,
            n_relations_kg=3, n_interactions=600, n_triples=450)
PMODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 16),
              mess_dropout=(0.0, 0.0))


@pytest.fixture(scope="module")
def part_setup():
    jg, jmeta = jdata.synthetic_dataset(**PART).build()
    coo = host_coo(jg)
    meta = CKGMeta(**dataclasses.asdict(jmeta))
    jcfg = jkgat.KGATConfig(ops_backend="pallas", **PMODEL)
    params = jkgat.init_params(jax.random.key(2), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    return dict(jmeta=jmeta, meta=meta, coo=coo, jcfg=jcfg, params=params)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_allgather_shards_coalesce_as_kgat_tpu(part_setup, n_parts):
    s = part_setup
    coo, jmeta = s["coo"], s["jmeta"]
    src, dst, ety = coo["src"], coo["dst"], coo["etype"]
    pg, info = jpart.partition_graph(src, dst, ety, jmeta.n_nodes,
                                     jmeta.n_relations, n_parts,
                                     chunk_edges=256, rel_block=256)
    jco = jpart.build_coalesced_shards(pg, info)
    pltpu.reset_tpu_interpret_mode_state()
    attention, propagate_eval, _, _ = j_make_partitioned(
        j_make_mesh(n_parts, axis=AXIS), pg, info, jmeta, s["jcfg"],
        coalesced=jco)
    _, ew_stack = attention(pg, s["params"])
    assert ew_stack.coalesced
    want = np.asarray(propagate_eval(ew_stack, s["params"]))

    shards, tinfo = partition_graph(src, dst, ety, jmeta.n_nodes,
                                    jmeta.n_relations, n_parts)
    cfg = tkgat.KGATConfig(ops_backend="hopper", **PMODEL)
    part = halo.Partitioned(dp.make_mesh(n_parts, "cpu"), shards, tinfo,
                            s["meta"], cfg)
    assert part.coalesce
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, s["params"]), cfg)
    _, staged = part.attention(model)
    gather = np.asarray(jco.fwd.gather)
    for p, host_shard in enumerate(pg._shards):
        co = part.shards[0][p].graph.co
        n_pairs, gdst, gsrc, members, _ = jax_groups_shard(
            host_shard, info)
        assert co.n_pairs == n_pairs
        np.testing.assert_array_equal(co.dst.numpy(), gdst)
        np.testing.assert_array_equal(co.src.numpy(), gsrc)
        for a, b in zip(port_members(co), members):
            np.testing.assert_array_equal(a, b)
        pos = np.nonzero(gather[p] < n_pairs)[0]
        pos = pos[np.argsort(gather[p][pos])]
        ew = staged[0][p]
        assert ew.coalesced and ew.fwd.shape == (n_pairs,)
        np.testing.assert_allclose(
            ew.fwd.numpy(), np.asarray(ew_stack.fwd[p])[pos], rtol=1e-4,
            atol=1e-6)
    got = part.propagate_eval(model, staged)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def jax_groups_shard(g, info):
    """A ``kgat_tpu`` shard's groups (local dst forward, global src)."""
    co = build_coalesced_layouts(g, 8, n_rows_fwd=info.rows_per_part,
                                 n_rows_rev=info.n_nodes_pad)
    gather = host_array(co.fwd, "gather")
    pos = np.nonzero(gather < co.n_pairs)[0]
    pos = pos[np.argsort(gather[pos])]
    within = np.asarray(co.within)
    fwd_gather = host_array(g.fwd_layout, "gather")
    members = [fwd_gather[p - within[p]:p + 1]
               for p in np.asarray(co.pick_fwd)[pos]]
    return (co.n_pairs, host_array(co.fwd, "seg")[pos],
            host_array(co.fwd, "node")[pos], members, pos)


@pytest.mark.parametrize("exchange", ["ring", "a2a"])
def test_ring_and_a2a_stay_uncoalesced(part_setup, exchange):
    """As kgat_tpu builds coalesced shards for the all-gather alone
    (kgat_tpu/train.py:306-319), the ring's buckets and the a2a halos
    stage every edge, whatever ``coalesce`` says."""
    s = part_setup
    src, dst, ety = (s["coo"][k] for k in ("src", "dst", "etype"))
    shards, info = partition_graph(src, dst, ety, s["meta"].n_nodes,
                                   s["meta"].n_relations, 3)
    cfg = tkgat.KGATConfig(ops_backend="hopper", **PMODEL)
    assert cfg.coalesce
    part = halo.Partitioned(
        dp.make_mesh(3, "cpu"), shards, info, s["meta"], cfg,
        exchange=exchange,
        ring_buckets=(build_ring_buckets(src, dst, info)
                      if exchange == "ring" else None),
        halos=(build_selective_halo(shards, info)
               if exchange == "a2a" else None))
    assert not part.coalesce
    model = tkgat.init_params(s["meta"].n_nodes, s["meta"].n_relations, cfg,
                              generator=torch.Generator().manual_seed(0))
    atts, staged = part.attention(model)
    for p in range(3):
        assert part.shards[0][p].graph.co is None
        ws = staged[0][p] if exchange == "ring" else [staged[0][p]]
        assert all(isinstance(w, EdgeWeights) and not w.coalesced
                   for w in ws)
        assert sum(w.fwd.numel() for w in ws) == shards[p].n_edges


TRAIN_FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
               "--eval-every", "1", "--embed-dim", "16", "--relation-dim",
               "16", "--conv-dims", "16,8", "--mess-dropout", "0.1,0.1",
               "--syn-users", "60", "--syn-items", "40", "--syn-entities",
               "90", "--syn-relations", "3", "--syn-interactions", "800",
               "--syn-triples", "400"]


@pytest.mark.parametrize("flags,want", [
    ([], True), (["--no-coalesce"], False),
    (["--n-devices", "2"], True),
    (["--n-devices", "2", "--no-coalesce"], False),
    (["--n-devices", "2", "--halo-exchange", "ring"], False),
    (["--n-devices", "2", "--halo-exchange", "a2a"], False)])
def test_trainer_cli_coalesces_as_kgat_tpu(tmp_path, flags, want):
    """The trainer CLI at kgat_tpu's defaults trains coalesced on one
    device and under the all-gather; --no-coalesce, the ring and a2a
    train on every edge. Its epoch's CF steps read staged weights of
    that kind."""
    cfg = train.parse_args([*TRAIN_FLAGS, "--log-dir", str(tmp_path),
                            *flags])
    assert cfg.model.coalesce == ("--no-coalesce" not in flags)
    tr = train.Trainer(cfg)
    tr.train()
    got = [tr._step_att] if not tr.partitioned else [
        w for row in tr._step_att for p in row
        for w in (p if isinstance(p, list) else [p])]
    assert all(w.coalesced == want for w in got)
    assert np.isfinite(tr.evaluate()["recall"])
