"""The plain versions of K6, K7 and K8 against kgat_tpu's Pallas kernels.

K6 (``segment_sum_csr``) against ``segment_sum_aligned`` in interpret
mode, outside ``shard_map``, on real ring buckets; K7 (``ring_shift`` and
the differentiable ``ring_send``) against ``make_ring_shift`` and
``lax.ppermute`` on a P = 4 mesh of the virtual CPU devices, value and
gradient; K8 (``reduce_send``) against ``make_reduce_send``. On the CPU
the wrappers take their plain versions, so this holds those to the TPU
kernels; ``tests/test_torch_cuda.py`` holds the CUDA kernels to the plain
versions on the card. P = 4 everywhere a shift's direction matters (with
P = 2 a shift by +1 and by -1 agree). d = 16 keeps the interpret-mode
blocks under the 64 x 128 limit of CPU emulation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as JP

from kgat_tpu.data import synthetic_dataset as j_synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.ops.pallas.remote_ring import make_reduce_send, make_ring_shift
from kgat_tpu.ops.pallas.segment_sum import segment_sum_aligned
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.parallel.dp import make_mesh as j_make_mesh
from kgat_tpu_torch.graph import EdgeWeights
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper.remote_ring import (bucket_spmm_send,
                                                   reduce_send, ring_send,
                                                   ring_shift)
from kgat_tpu_torch.ops.hopper.segment_sum import bucket_spmm, segment_sum_csr
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               partition_graph)

import torch_threads  # noqa: F401  (one intra-op thread)

P = 4
AXIS = "ep"
D = 16


@pytest.fixture(scope="module")
def rings():
    """kgat_tpu's and the port's ring buckets of one small CKG, P = 4."""
    # 500 nodes: R = 128, every partition owns rows and edges.
    ds = j_synthetic_dataset(seed=13, n_users=200, n_items=150,
                             n_entities=300, n_relations_kg=3,
                             n_interactions=1500, n_triples=1000)
    g, meta = ds.build()
    coo = host_coo(g)
    _, jinfo = jpart.partition_graph(coo["src"], coo["dst"], coo["etype"],
                                     meta.n_nodes, meta.n_relations, P)
    jrb = jpart.build_ring_buckets(coo["src"], coo["dst"], jinfo)
    shards, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                                   meta.n_nodes, meta.n_relations, P)
    return dict(jrb=jrb, info=info, shards=shards,
                buckets=build_ring_buckets(coo["src"], coo["dst"], info),
                mesh=j_make_mesh(P, axis=AXIS))


def _aligned_vals(layout, chunk, w_canon):
    """kgat_tpu's value stream of a bucket: chunk[node] * w at each
    aligned position, 0 at dead ones (their gather is past the shard's
    edges)."""
    return chunk[np.asarray(layout.node)] * _aligned_w(layout.gather,
                                                       w_canon)[:, None]


def _aligned_w(gather, w_canon):
    """Canonical weights at aligned positions; a dead position's gather
    is the shard's first pad slot, len(w_canon), and gets 0."""
    w_ext = np.append(w_canon, np.float32(0))
    return w_ext[np.minimum(np.asarray(gather), len(w_canon))]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_segment_sum_csr_matches_segment_sum_aligned(rings, dtype):
    """K6's plain version (and the wrapper on the CPU) against kgat_tpu's
    K6 in interpret mode, bucket by bucket of one shard, empty rows 0."""
    info, p = rings["info"], 1
    R = info.rows_per_part
    rs = np.random.default_rng(5)
    n_e = rings["shards"][p].n_edges
    w_canon = rs.normal(size=n_e).astype(np.float32)
    for s, bucket in enumerate(rings["buckets"][p]):
        chunk = rs.normal(size=(R, D)).astype(np.float32)
        layout = jax.tree.map(lambda a: a[p, s], rings["jrb"].fwd)
        vals_j = jnp.asarray(_aligned_vals(layout, chunk, w_canon)).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
        want = np.asarray(segment_sum_aligned(vals_j, layout, R,
                                              interpret=True))
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        vals = (torch.from_numpy(chunk)[bucket.src.long()]
                * torch.from_numpy(w_canon)[bucket.gather][:, None]).to(tdt)
        for got in (ref.segment_sum_csr(bucket.row_offsets, vals),
                    segment_sum_csr(bucket.row_offsets, vals)):
            assert got.dtype == torch.float32 and got.shape == (R, D)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            empty = (bucket.row_offsets[1:] == bucket.row_offsets[:-1])
            assert not got[empty].any()


def test_segment_sum_csr_empty_bucket_and_float64():
    """A bucket with no edge gives zero rows; a float64 stream sums in
    float64, as the kernels' references need."""
    out = ref.segment_sum_csr(torch.zeros(6, dtype=torch.int32),
                              torch.zeros(0, 3))
    assert out.shape == (5, 3) and not out.any()
    ro = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    vals = torch.tensor([[1.0], [2.0 ** -40], [3.0]], dtype=torch.float64)
    got = segment_sum_csr(ro, vals)
    assert got.dtype == torch.float64
    assert got[:, 0].tolist() == [1.0 + 2.0 ** -40, 0.0, 3.0]


def _smap(mesh, fn, n_in=1):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(JP(AXIS),) * n_in,
                                 out_specs=JP(AXIS), check_vma=False))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ring_shift_matches_make_ring_shift_and_ppermute(rings, dtype):
    pltpu.reset_tpu_interpret_mode_state()
    x = (jnp.arange(P * 16 * 24, dtype=jnp.float32)
         .reshape(P * 16, 24).astype(dtype))
    shift = make_ring_shift(AXIS, P, interpret=True)
    got_j = np.asarray(_smap(rings["mesh"], shift)(x).astype(jnp.float32))
    perm = [(i, (i + 1) % P) for i in range(P)]
    want = np.asarray(_smap(rings["mesh"], lambda v: jax.lax.ppermute(
        v, AXIS, perm))(x).astype(jnp.float32))
    np.testing.assert_array_equal(got_j, want)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    parts = list(torch.tensor(np.asarray(x.astype(jnp.float32)))
                 .to(tdt).reshape(P, 16, 24))
    for shifted in (ring_shift(parts, 1), ring_send(parts, 1),
                    ref.ring_shift(parts, 1)):
        got = torch.cat(shifted).float().numpy()
        np.testing.assert_array_equal(got, want)
    back = torch.cat(ring_shift(ring_shift(parts, 1), -1))
    assert torch.equal(back, torch.cat(parts))


def test_ring_send_gradient_matches_ppermute(rings):
    """The shift's transpose is the shift the other way
    (``remote_ring.py:234-236``): the gradient of sum(shift(x)^2 w)."""
    pltpu.reset_tpu_interpret_mode_state()
    shift = make_ring_shift(AXIS, P, interpret=True)
    x = jnp.linspace(0.0, 1.0, P * 8 * 16).reshape(P * 8, 16)
    w = jnp.cos(jnp.arange(P * 8 * 16, dtype=jnp.float32)).reshape(P * 8, 16)

    def inner(xv, wv):
        return jax.lax.psum(jnp.sum(shift(xv) ** 2 * wv), AXIS)

    smapped = jax.shard_map(inner, mesh=rings["mesh"],
                            in_specs=(JP(AXIS), JP(AXIS)), out_specs=JP(),
                            check_vma=False)
    want = np.asarray(jax.jit(jax.grad(lambda xv: smapped(xv, w)))(x))
    xt = torch.tensor(np.asarray(x)).requires_grad_()
    wt = torch.from_numpy(np.asarray(w)).reshape(P, 8, 16)
    out = ring_send(list(xt.reshape(P, 8, 16)), 1)
    sum((o ** 2 * wp).sum() for o, wp in zip(out, wt)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_reduce_send_matches_make_reduce_send(rings):
    """K8's plain version against kgat_tpu's fused kernel on bucket 0 of
    every shard: the sums, and the chunks one hop right bit for bit."""
    info, jrb = rings["info"], rings["jrb"]
    R = info.rows_per_part
    rs = np.random.default_rng(3)
    chunks = rs.normal(size=(P, R, D)).astype(np.float32)
    w_canon = [rs.normal(size=s.n_edges).astype(np.float32)
               for s in rings["shards"]]
    fwd0 = jax.tree.map(lambda a: a[:, 0], jrb.fwd)
    w_al = np.stack([_aligned_w(fwd0.gather[p], w_canon[p])
                     for p in range(P)])

    pltpu.reset_tpu_interpret_mode_state()
    fused = make_reduce_send(AXIS, P, interpret=True)

    def run_fused(chunk, wv, node, seg, bounds, cb, gather):
        lay = dataclasses.replace(fwd0, node=node[0], seg=seg[0],
                                  bounds=bounds[0], chunk_block=cb[0],
                                  gather=gather[0])
        return fused(chunk[lay.node] * wv[0][:, None], chunk, lay, R)

    smapped = jax.jit(jax.shard_map(
        run_fused, mesh=rings["mesh"], in_specs=(JP(AXIS),) * 7,
        out_specs=(JP(AXIS), JP(AXIS)), check_vma=False))
    sums_j, next_j = smapped(jnp.asarray(chunks.reshape(P * R, D)),
                             jnp.asarray(w_al), fwd0.node, fwd0.seg,
                             fwd0.bounds, fwd0.chunk_block, fwd0.gather)

    bks = [row[0] for row in rings["buckets"]]
    parts = list(torch.from_numpy(chunks))
    vals = [parts[p][b.src.long()]
            * torch.from_numpy(w_canon[p])[b.gather][:, None]
            for p, b in enumerate(bks)]
    sums, nxt = reduce_send([b.row_offsets for b in bks], vals, parts)
    np.testing.assert_array_equal(torch.cat(nxt).numpy(),
                                  np.asarray(next_j))
    np.testing.assert_array_equal(torch.cat(nxt).numpy(),
                                  np.roll(chunks, 1, axis=0).reshape(-1, D))
    np.testing.assert_allclose(torch.cat(sums).numpy(), np.asarray(sums_j),
                               rtol=1e-4, atol=1e-4)


def test_bucket_ops_gradients_match_plain_autograd(rings):
    """The differentiable K6 and K8 ops (``bucket_spmm``,
    ``bucket_spmm_send``) against autograd of the plain path in float64:
    one fused step then a plain step, gradients w.r.t. the chunks and the
    forward weights (``halo.py:116-125``)."""
    info = rings["info"]
    R = info.rows_per_part
    rs = np.random.default_rng(11)
    chunks = torch.from_numpy(rs.normal(size=(P, R, D))).requires_grad_()
    cot = torch.from_numpy(rs.normal(size=(2, P, R, D)))
    ews = []
    for p in range(P):
        w = torch.from_numpy(rs.normal(size=rings["shards"][p].n_edges))
        w.requires_grad_()
        ews.append(w)

    def staged(p, s):
        b = rings["buckets"][p][s]
        return EdgeWeights(fwd=ews[p][b.gather], rev=ews[p][b.rev_gather])

    def run(fused):
        b0 = [rings["buckets"][p][0] for p in range(P)]
        b1 = [rings["buckets"][p][1] for p in range(P)]
        parts = list(chunks)
        if fused:
            side, nxt = bucket_spmm_send(b0, [staged(p, 0) for p in range(P)],
                                         parts)
            side2 = [bucket_spmm(b, staged(p, 1), c)
                     for p, (b, c) in enumerate(zip(b1, nxt))]
        else:
            side = [ref.bucket_spmm(b, staged(p, 0), c)
                    for p, (b, c) in enumerate(zip(b0, parts))]
            nxt = [parts[(j - 1) % P] for j in range(P)]
            side2 = [ref.bucket_spmm(b, staged(p, 1), c)
                     for p, (b, c) in enumerate(zip(b1, nxt))]
        loss = sum((a * cot[0, p]).sum() + (b * cot[1, p]).sum()
                   for p, (a, b) in enumerate(zip(side, side2)))
        return torch.autograd.grad(loss, [chunks, *ews])

    for got, want in zip(run(True), run(False)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_ring_wrappers_refuse_aliased_buffers():
    """A receive buffer must never be a buffer that a launch of the same
    step reads: with shared buffers a partition could overwrite a chunk
    its neighbour has yet to send."""
    parts = [torch.ones(8, 4) * p for p in range(P)]
    with pytest.raises(ValueError, match="aliases"):
        ring_shift(parts, 1, out=[parts[3], parts[0], parts[1], parts[2]])
    with pytest.raises(ValueError, match="aliases"):
        ring_shift(parts, 1, out=[parts[1][:8]] + [torch.empty(8, 4)
                                                   for _ in range(3)])
    fresh = [torch.empty(8, 4) for _ in range(P)]
    with pytest.raises(ValueError, match="aliases"):
        ring_shift(parts, 1, out=[fresh[0], fresh[0], fresh[2], fresh[3]])
    ro = [torch.tensor([0, 1] + [1] * 7, dtype=torch.int32)] * P
    vals = [torch.ones(1, 4) for _ in range(P)]
    with pytest.raises(ValueError, match="aliases"):
        reduce_send(ro, vals, parts, out=[parts[1], parts[2], parts[3],
                                          parts[0]])
    with pytest.raises(ValueError, match="aliases"):
        reduce_send(ro, vals, parts, out=[vals[0].expand(8, 4)] + fresh[1:])
    got = ring_shift(parts, 1, out=fresh)
    assert got is not None and all(torch.equal(got[j], parts[j - 1])
                                   for j in range(P))
