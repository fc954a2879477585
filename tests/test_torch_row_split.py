"""The row split: the work units of the CSR row reduction (K1, K6, K8).

The schedule (``ops/row_split.py``) against its definition on hand-made
rows around the chunk boundaries and a hub; that every CSR of a graph,
a shard and a ring bucket carries its own, and ``.to`` moves it; and a
plain emulation of the split reduction (``ref.split_segment_sum``: a sum
per unit, then per row in unit order) against kgat_tpu's SpMM kernel and
its bucket reduce ``segment_sum_aligned`` in interpret mode. The kernels
themselves run the same units on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import host_coo
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.ops.pallas.segment_sum import segment_sum_aligned
from kgat_tpu.parallel import partition as jpart
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.ops import ref, row_split
from kgat_tpu_torch.ops.row_split import CHUNK, RowSplit, build_row_split
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

P = 4
D = 16
SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _offsets(lens):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(
        np.int32))


def _boundary_lens(c):
    """Empty rows, a one-edge row, rows of C - 1, C, C + 1 and 3C + 5
    edges, and a hub of 20C + 3."""
    return [0, 1, c - 1, c, c + 1, 0, 3 * c + 5, 2, 20 * c + 3, 0]


def check_schedule(split: RowSplit, row_offsets: torch.Tensor, chunk: int):
    """Units in row order tile each row's edges in order, one unit for a
    row of at most ``chunk`` edges (an empty row one empty unit) and
    ceil(n / chunk) units of at most ``chunk`` edges otherwise; slots -1
    for whole rows, consecutive in unit order for split rows."""
    ro = row_offsets.tolist()
    units = split.units.tolist()
    assert split.units.dtype == torch.int32 and split.units.shape[1] == 4
    assert split.n_rows == len(ro) - 1 and split.n_edges == ro[-1]
    assert split.chunk == chunk
    at, slot, split_rows, slot_offsets = 0, 0, [], [0]
    for r in range(len(ro) - 1):
        n = ro[r + 1] - ro[r]
        want = max(1, -(-n // chunk))
        mine = units[at:at + want]
        at += want
        assert [u[0] for u in mine] == [r] * want
        # Contiguous, in edge order, each at most chunk, covering the row.
        assert mine[0][1] == ro[r] and mine[-1][2] == ro[r + 1]
        for a, b in zip(mine, mine[1:]):
            assert a[2] == b[1]
        assert all(0 < u[2] - u[1] <= chunk for u in mine) or n == 0
        if want == 1:
            assert mine[0][3] == -1
        else:
            assert [u[3] for u in mine] == list(range(slot, slot + want))
            slot += want
            split_rows.append(r)
            slot_offsets.append(slot)
    assert at == split.n_units
    assert split.split_rows.tolist() == split_rows
    assert split.slot_offsets.tolist() == slot_offsets
    assert split.n_slots == slot and split.n_split == len(split_rows)
    assert split.cuda_launches == 1 + bool(split_rows)
    # Every edge exactly once.
    covered = np.zeros(ro[-1], np.int64)
    for u in units:
        covered[u[1]:u[2]] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("chunk", [1, 8, 100, CHUNK])
def test_units_cover_every_edge_once_in_order(chunk):
    ro = _offsets(_boundary_lens(chunk))
    split = build_row_split(ro, chunk)
    check_schedule(split, ro, chunk)
    assert split.n_split == (3 if chunk > 1 else 4)


def test_default_chunk_and_degenerate_csrs():
    ro = _offsets(_boundary_lens(CHUNK))
    assert build_row_split(ro).chunk == CHUNK
    empty = build_row_split(torch.zeros(6, dtype=torch.int32))
    check_schedule(empty, torch.zeros(6, dtype=torch.int32), CHUNK)
    assert empty.n_units == 5 and empty.cuda_launches == 1
    none = build_row_split(torch.zeros(1, dtype=torch.int32))
    assert none.n_units == 0 and none.n_rows == 0
    with pytest.raises(ValueError, match="chunk"):
        build_row_split(ro, 0)


def test_require_refuses_a_missing_or_foreign_split():
    ro = _offsets([3, 0, 5])
    split = build_row_split(ro)
    assert row_split.require("k", split, 3, 8) is split
    with pytest.raises(ValueError, match="needs the CSR's RowSplit"):
        row_split.require("k", None, 3, 8)
    with pytest.raises(ValueError, match="RowSplit of 3 rows"):
        row_split.require("k", split, 3, 9)


def test_graph_carries_a_split_per_csr():
    """build_graph builds both CSRs' splits; Graph.to moves them."""
    tg, _ = tdata.synthetic_dataset(**SMALL).build()
    rs = np.random.default_rng(2)
    deg = np.array(_boundary_lens(CHUNK))
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rs.integers(0, len(deg), len(dst))
    src[: 2 * CHUNK + 1] = 3           # a reverse row of 2C + 1 at least
    hand = build_graph(src, dst, rs.integers(0, 2, len(dst)),
                       n_nodes=len(deg), n_relations=2)
    for g in (tg, hand):
        check_schedule(g.split, g.row_offsets, CHUNK)
        check_schedule(g.rev_split, g.rev_row_offsets, CHUNK)
    assert hand.split.n_split == 3 and hand.rev_split.n_split >= 1
    moved = hand.to("meta")
    for a, b in ((moved.split, hand.split),
                 (moved.rev_split, hand.rev_split)):
        assert all(t.device.type == "meta" for t in a.tensors)
        assert (a.n_rows, a.n_edges, a.n_slots, a.chunk) == (
            b.n_rows, b.n_edges, b.n_slots, b.chunk)


@pytest.fixture(scope="module")
def rings():
    """kgat_tpu's and the port's partitions and ring buckets of one small
    CKG, P = 4 (as tests/test_torch_remote_ring.py builds them)."""
    ds = jdata.synthetic_dataset(seed=13, n_users=200, n_items=150,
                                 n_entities=300, n_relations_kg=3,
                                 n_interactions=1500, n_triples=1000)
    g, meta = ds.build()
    coo = host_coo(g)
    _, jinfo = jpart.partition_graph(coo["src"], coo["dst"], coo["etype"],
                                     meta.n_nodes, meta.n_relations, P)
    shards, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                                   meta.n_nodes, meta.n_relations, P)
    return dict(jrb=jpart.build_ring_buckets(coo["src"], coo["dst"], jinfo),
                shards=shards, info=info,
                buckets=build_ring_buckets(coo["src"], coo["dst"], info))


def test_shards_and_buckets_carry_a_split_per_csr(rings):
    info = rings["info"]
    for shard in rings["shards"]:
        g = shard.graph
        assert g.split.n_rows == info.rows_per_part
        assert g.rev_split.n_rows == info.n_nodes_pad
        check_schedule(g.split, g.row_offsets, CHUNK)
        check_schedule(g.rev_split, g.rev_row_offsets, CHUNK)
        assert shard.to("meta").graph.split.units.device.type == "meta"
    for row in rings["buckets"]:
        for b in row:
            check_schedule(b.split, b.row_offsets, CHUNK)
            check_schedule(b.rev_split, b.rev_row_offsets, CHUNK)
            moved = b.to("meta")
            assert moved.split.units.device.type == "meta"
            assert moved.rev_split.slot_offsets.device.type == "meta"


@pytest.mark.parametrize("chunk", [3, 16])
def test_split_reduction_matches_pallas_spmm(rng, chunk):
    """K1's split reduction, emulated on the forward and reverse CSRs,
    against kgat_tpu's SpMM (``_kernel_w``) and its transpose."""
    jg, _ = jdata.synthetic_dataset(**SMALL).build()
    tg, _ = tdata.synthetic_dataset(**SMALL).build()
    w = rng.uniform(size=tg.n_edges).astype(np.float32)
    x = rng.normal(size=(tg.n_nodes, D)).astype(np.float32)
    w_pad = np.zeros(jg.n_edges_pad, np.float32)
    w_pad[: tg.n_edges] = w
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pb.spmm(jg, jnp.asarray(w_pad), jnp.asarray(x)))
        _, vjp = jax.vjp(lambda v: pb.spmm(jg, jnp.asarray(w_pad), v),
                         jnp.asarray(x))
        want_rev = np.asarray(vjp(jnp.ones((tg.n_nodes, D)) * 0.5
                                  + jnp.asarray(x))[0])
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    split = build_row_split(tg.row_offsets, chunk)
    assert split.n_split > 0
    got = ref.split_segment_sum(split, xt[tg.src.long()] * wt[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # The reverse CSR: d_x[u] = sum over u's out-edges of w * g[dst].
    g = torch.ones(tg.n_nodes, D) * 0.5 + xt
    rev = build_row_split(tg.rev_row_offsets, chunk)
    w_rev = wt[tg.rev_perm.long()]
    got_rev = ref.split_segment_sum(rev, g[tg.rev_dst.long()]
                                    * w_rev[:, None])
    np.testing.assert_allclose(got_rev.numpy(), want_rev, rtol=1e-4,
                               atol=1e-4)


def _aligned_vals(layout, chunk, w_canon):
    """kgat_tpu's value stream of a bucket: chunk[node] * w at each
    aligned position; dead positions gather past the shard's edges."""
    w_ext = np.append(w_canon, np.float32(0))
    w = w_ext[np.minimum(np.asarray(layout.gather), len(w_canon))]
    return chunk[np.asarray(layout.node)] * w[:, None]


@pytest.mark.parametrize("chunk", [2, CHUNK])
def test_split_reduction_matches_segment_sum_aligned(rings, chunk):
    """K6 and K8's split reduction, emulated on every bucket of one
    partition, against kgat_tpu's K6 (``segment_sum_aligned``) in
    interpret mode."""
    info, p = rings["info"], 2
    R = info.rows_per_part
    rs = np.random.default_rng(6)
    w_canon = rs.normal(size=rings["shards"][p].n_edges).astype(np.float32)
    for s, bucket in enumerate(rings["buckets"][p]):
        chunk_x = rs.normal(size=(R, D)).astype(np.float32)
        layout = jax.tree.map(lambda a: a[p, s], rings["jrb"].fwd)
        want = np.asarray(segment_sum_aligned(
            jnp.asarray(_aligned_vals(layout, chunk_x, w_canon)), layout, R,
            interpret=True))
        vals = (torch.from_numpy(chunk_x)[bucket.src.long()]
                * torch.from_numpy(w_canon)[bucket.gather][:, None])
        split = (bucket.split if chunk == CHUNK
                 else build_row_split(bucket.row_offsets, chunk))
        got = ref.split_segment_sum(split, vals)
        assert got.shape == (R, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        empty = bucket.row_offsets[1:] == bucket.row_offsets[:-1]
        assert not got[empty].any()


def test_split_reduction_float64_and_an_odd_width():
    """In float64 and at d = 33, the emulation equals the CSR segment sum
    up to float64 roundings (the order of the sums is the only change)."""
    ro = _offsets(_boundary_lens(4))
    vals = torch.from_numpy(np.random.default_rng(1).normal(
        size=(int(ro[-1]), 33)))
    got = ref.split_segment_sum(build_row_split(ro, 4), vals)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref.segment_sum_csr(ro, vals),
                               rtol=1e-12, atol=1e-12)
    assert dataclasses.is_dataclass(build_row_split(ro, 4))
