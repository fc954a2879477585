"""The Hopper kernels on the GPU against their plain PyTorch versions.

Needs a CUDA device, nvcc and the sm_90a target; everywhere else these
tests skip. This file imports no jax (the GPU machine has none), so run it
there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from kgat_tpu_torch.data import synthetic_dataset
from kgat_tpu_torch.graph import EdgeWeights, build_graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops import hopper_backend, ref
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.sddmm import (sddmm_transr, sddmm_transr_bwd,
                                             sddmm_transr_bwd_plain,
                                             sddmm_transr_plain)
from kgat_tpu_torch.ops.hopper.remote_ring import reduce_send, ring_shift
from kgat_tpu_torch.ops.hopper.segment_sum import (segment_sum_csr, spmm_csr,
                                                   spmm_csr_plain)
from kgat_tpu_torch.ops.hopper.softmax import (segment_softmax_csr,
                                               segment_softmax_csr_bwd,
                                               segment_softmax_csr_bwd_plain,
                                               segment_softmax_csr_plain)
from kgat_tpu_torch.recommend import disable_tf32

pytestmark = pytest.mark.cuda

# U is one float32 rounding. A float32 sum of n terms, in any order, lies
# within n * 2U times the sum of the terms' magnitudes of the exact sum
# (Higham's gamma_n): K1 on the reverse CSR and K5 are held to that. K4's
# term magnitudes are not at hand: it is held to C_STAT * U * sqrt(L) times
# the largest |reference|, L its longest reduction, the size of rounding
# errors of random sign (the cotangents here are random per edge).
U = 2.0 ** -24
C_STAT = 8.0


def _assert_within(got, want64, bound64, what):
    """|got - want64| <= bound64 elementwise, against a float64 reference."""
    err = (got.double() - want64).abs()
    worst = float((err / bound64.clamp(min=1e-300)).max()) if err.numel() \
        else 0
    assert worst <= 1.0, f"{what}: error {float(err.max()):.3e} is " \
                         f"{worst:.2f}x its bound"


def _stat_bound(want64, length):
    return (C_STAT * U * length ** 0.5 * want64.abs().max()
            + U * want64.abs())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the CPU the wrappers run their "
                    "plain versions (tests/test_torch_ops.py)")
    disable_tf32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hand_graph(dev):
    """Node 0 has no in-edge, node 1 one, node 2 is a hub of 5,000; node 3
    is the source of a quarter of the edges (a hub of the reverse CSR); a
    relation of a single edge, and relation 4 with none."""
    rs = np.random.default_rng(0)
    deg = np.concatenate([[0, 1, 5000], rs.integers(0, 30, 60)])
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rs.integers(0, len(deg), len(dst))
    src[rs.random(len(dst)) < 0.25] = 3
    ety = rs.integers(0, 3, len(dst))
    ety[7] = 3
    return build_graph(src, dst, ety, n_nodes=len(deg), n_relations=5,
                       rel_tile=64).to(dev)


def _rand(gen, *shape, dev, scale=0.2):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


@pytest.mark.parametrize("k", [64, 32, 100])
def test_sddmm_matches_plain(dev, hand_graph, k):
    g, gen = hand_graph, torch.Generator().manual_seed(k)
    args = (g.rel_perm, g.tiles, g.src, g.dst, _rand(gen, g.n_nodes, 64,
                                                     dev=dev),
            _rand(gen, g.n_relations, 64, k, dev=dev),
            _rand(gen, g.n_relations, k, dev=dev))
    n = build.launch_counts["sddmm_transr"]
    got = sddmm_transr(*args)
    torch.cuda.synchronize()
    assert build.launch_counts["sddmm_transr"] == n + 1
    torch.testing.assert_close(got, sddmm_transr_plain(*args), rtol=1e-4,
                               atol=1e-5)


def test_softmax_matches_plain(dev, hand_graph):
    g, gen = hand_graph, torch.Generator().manual_seed(1)
    logits = _rand(gen, g.n_edges, dev=dev, scale=3.0)
    got = segment_softmax_csr(g.row_offsets, logits)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, segment_softmax_csr_plain(g.row_offsets, logits), rtol=1e-4,
        atol=1e-6)
    assert got[int(g.row_offsets[1])] == 1.0  # the one-edge row


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (32, torch.float32),
                                     (48, torch.float32), (64, torch.bfloat16),
                                     (200, torch.float32)])
def test_spmm_matches_plain(dev, hand_graph, d, dtype):
    g, gen = hand_graph, torch.Generator().manual_seed(d)
    w = torch.rand(g.n_edges, generator=gen).to(dev)
    x = _rand(gen, g.n_nodes, d, dev=dev).to(dtype)
    got = spmm_csr(g.row_offsets, g.src, w, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert not got[0].any()  # the empty row is written as 0
    torch.testing.assert_close(got, spmm_csr_plain(g.row_offsets, g.src, w, x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [64, 32])
def test_spmm_backward_is_k1_on_the_reverse_csr(dev, hand_graph, d):
    g, gen = hand_graph, torch.Generator().manual_seed(d)
    w = torch.rand(g.n_edges, generator=gen).to(dev)
    x = _rand(gen, g.n_nodes, d, dev=dev).requires_grad_(True)
    cot = _rand(gen, g.n_nodes, d, dev=dev)
    n = build.launch_counts["spmm_csr_rev"]
    hopper_backend.spmm(g, EdgeWeights.stage(g, w), x).backward(cot)
    torch.cuda.synchronize()
    assert build.launch_counts["spmm_csr_rev"] == n + 1
    rev_w = w[g.rev_perm.long()].double()
    want = spmm_csr_plain(g.rev_row_offsets, g.rev_dst, rev_w, cot.double())
    terms = spmm_csr_plain(g.rev_row_offsets, g.rev_dst, rev_w,
                           cot.double().abs())
    rows = (g.rev_row_offsets[1:] - g.rev_row_offsets[:-1]).double()
    _assert_within(x.grad, want, 2 * U * rows[:, None] * terms
                   + U * want.abs(), "d_x")
    assert not x.grad[(rows == 0).nonzero()].any()
    # The weights' gradient is the per-edge dot, as autograd of the plain
    # path gives it.
    w2 = w.clone().requires_grad_(True)
    hopper_backend.spmm(g, w2, x.detach()).backward(cot)
    w3 = w.clone().requires_grad_(True)
    ref.spmm(g, w3, x.detach()).backward(cot)
    torch.testing.assert_close(w2.grad, w3.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,k", [(64, 64), (64, 32), (32, 100)])
def test_sddmm_backward_matches_float64_plain(dev, hand_graph, d, k):
    g, gen = hand_graph, torch.Generator().manual_seed(d + k)
    emb = _rand(gen, g.n_nodes, d, dev=dev)
    w_rel = _rand(gen, g.n_relations, d, k, dev=dev)
    rel_embed = _rand(gen, g.n_relations, k, dev=dev)
    cot = _rand(gen, g.n_edges, dev=dev, scale=1.0)
    n = build.launch_counts["sddmm_transr_bwd"]
    got = sddmm_transr_bwd(g, cot, emb, w_rel, rel_embed)
    again = sddmm_transr_bwd(g, cot, emb, w_rel, rel_embed)
    torch.cuda.synchronize()
    assert build.launch_counts["sddmm_transr_bwd"] == n + 2
    want = sddmm_transr_bwd_plain(g, cot.double(), emb.double(),
                                  w_rel.double(), rel_embed.double())
    # Longest reduction: a node's head + tail edges times k, or a
    # relation's edges.
    deg = (g.row_offsets[1:] - g.row_offsets[:-1]
           + g.rev_row_offsets[1:] - g.rev_row_offsets[:-1])
    length = max(int(deg.max()) * k, g.n_edges)
    for name, a, b, c in zip(("d_emb", "d_w_rel", "d_rel_embed"), got, want,
                             again):
        assert torch.equal(a, c), f"{name}: a second call differs"
        _assert_within(a, b, _stat_bound(b, length), name)
    assert not got[1][4].any() and not got[2][4].any()  # relation 4: no edge


def test_softmax_backward_matches_float64_plain(dev, hand_graph):
    g, gen = hand_graph, torch.Generator().manual_seed(2)
    w = segment_softmax_csr(g.row_offsets,
                            _rand(gen, g.n_edges, dev=dev, scale=3.0))
    cot = _rand(gen, g.n_edges, dev=dev, scale=1.0)
    got = segment_softmax_csr_bwd(g.row_offsets, w, cot)
    again = segment_softmax_csr_bwd(g.row_offsets, w, cot)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = segment_softmax_csr_bwd_plain(g.row_offsets, w.double(),
                                         cot.double())
    dst = ref.offsets_to_dst(g.row_offsets)
    rows = (g.row_offsets[1:] - g.row_offsets[:-1]).double()
    row_abs = ref.segment_sum_coo(dst, (w.double() * cot.double()).abs(),
                                  g.n_nodes)
    # The row sum takes its length + 5 roundings (lanes, then the shuffle
    # tree); g - s and w (g - s) one each.
    bound = (2 * U * w.double() * ((rows[dst] + 5) * row_abs[dst]
                                   + cot.double().abs())
             + 2 * U * want.abs())
    _assert_within(got, want, bound, "d_logits")


def test_attention_gradient_kernel_path_matches_plain_path(dev, hand_graph):
    """logits -> softmax -> a random linear functional, differentiated
    through K2/K3 with K4/K5 against autograd of the plain path."""
    g, gen = hand_graph, torch.Generator().manual_seed(3)
    params = [_rand(gen, g.n_nodes, 64, dev=dev),
              _rand(gen, g.n_relations, 64, 64, dev=dev),
              _rand(gen, g.n_relations, 64, dev=dev)]
    cot = _rand(gen, g.n_edges, dev=dev, scale=1.0)
    grads = {}
    for name, ops, dt in (("hopper", hopper_backend, torch.float32),
                          ("ref", ref, torch.float64)):
        ps = [p.to(dt, copy=True).requires_grad_(True) for p in params]
        att = ops.segment_softmax(g, ops.attention_logits(g, *ps))
        (att * cot.to(dt)).sum().backward()
        grads[name] = [p.grad for p in ps]
    assert build.launch_counts["sddmm_transr_bwd"] > 0
    assert build.launch_counts["segment_softmax_csr_bwd"] > 0
    length = g.n_edges * 64
    for name, a, b in zip(("d_emb", "d_w_rel", "d_rel_embed"),
                          grads["hopper"], grads["ref"]):
        _assert_within(a, b, _stat_bound(b, length), name)


def test_wrappers_refuse_grad_and_bad_inputs(dev, hand_graph):
    g = hand_graph
    x = torch.ones(g.n_nodes, 8, device=dev, requires_grad=True)
    w = torch.ones(g.n_edges, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        spmm_csr(g.row_offsets, g.src, w, x)
    with torch.no_grad():
        spmm_csr(g.row_offsets, g.src, w, x)
    with pytest.raises(TypeError, match="dtype"):
        spmm_csr(g.row_offsets, g.src.long(), w, x.detach())
    with pytest.raises(ValueError, match="contiguous"):
        segment_softmax_csr(g.row_offsets,
                            torch.zeros(2 * g.n_edges, device=dev)[::2])


def _bucket_csr(rs, n_rows, hub):
    """CSR offsets of ``n_rows`` rows: row 0 empty, row 1 one edge, row 2
    a hub of ``hub`` edges, the rest 0-20."""
    deg = np.concatenate([[0, 1, hub], rs.integers(0, 21, n_rows - 3)])
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32))


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (32, torch.float32),
                                     (16, torch.float32), (64, torch.bfloat16),
                                     (200, torch.float32)])
def test_segment_sum_csr_matches_float64_plain(dev, d, dtype):
    """K6 against its plain version in float64, under Higham's bound on
    each row (n * 2^-23 * sum|terms|); a second call bit-identical; an
    empty row and an empty bucket written as 0."""
    rs = np.random.default_rng(d)
    ro = _bucket_csr(rs, 300, 3000).to(dev)
    vals = torch.from_numpy(rs.normal(size=(int(ro[-1]), d)).astype(
        np.float32)).to(dev, dtype)
    n = build.launch_counts["segment_sum_csr"]
    got = segment_sum_csr(ro, vals)
    again = segment_sum_csr(ro, vals)
    torch.cuda.synchronize()
    assert build.launch_counts["segment_sum_csr"] == n + 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    want = ref.segment_sum_csr(ro, vals.double())
    terms = ref.segment_sum_csr(ro, vals.double().abs())
    rows = (ro[1:] - ro[:-1]).double()[:, None]
    _assert_within(got, want, 2 * U * rows * terms + U * want.abs(), "K6")
    assert not got[0].any()
    empty = segment_sum_csr(torch.zeros(7, dtype=torch.int32, device=dev),
                            vals[:0])
    torch.cuda.synchronize()
    assert empty.shape == (6, d) and not empty.any()


def _parts(rs, n, rows, d, dtype, dev):
    return [torch.from_numpy(rs.normal(size=(rows, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_shift_is_a_bit_exact_copy_around_the_ring(dev, dtype):
    """K7 against its plain version, both directions, P = 4 (so +1 and -1
    differ); 17 x 3 bf16 rows (102 bytes) take the byte tail."""
    rs = np.random.default_rng(4)
    for rows, d in ((64, 64), (17, 3)):
        parts = _parts(rs, 4, rows, d, dtype, dev)
        for step in (1, -1):
            n = build.launch_counts["ring_shift"]
            got = ring_shift(parts, step)
            torch.cuda.synchronize()
            assert build.launch_counts["ring_shift"] == n + 4
            for g, w in zip(got, ref.ring_shift(parts, step)):
                assert torch.equal(g, w)
            assert torch.equal(got[1], parts[0]) if step == 1 else \
                torch.equal(got[0], parts[1])


def test_ring_wrappers_refuse_aliased_buffers(dev):
    parts = [torch.ones(8, 4, device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="aliases"):
        ring_shift(parts, 1, out=[parts[2], parts[0], parts[1]])
    ro = [torch.tensor([0, 1], dtype=torch.int32, device=dev)] * 3
    vals = [torch.ones(1, 4, device=dev) for _ in range(3)]
    with pytest.raises(ValueError, match="aliases"):
        reduce_send(ro, vals, parts, out=[parts[1], parts[2], parts[0]])


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (32, torch.bfloat16)])
def test_reduce_send_matches_plain(dev, d, dtype):
    """K8: every partition's sums against float64 under Higham's bound,
    the sent chunks bit-exact; one bucket has no edge."""
    rs = np.random.default_rng(d + 1)
    ros = [_bucket_csr(rs, 128, 500).to(dev) for _ in range(3)]
    ros.append(torch.zeros(129, dtype=torch.int32, device=dev))
    vals = [torch.from_numpy(rs.normal(size=(int(r[-1]), d)).astype(
        np.float32)).to(dev, dtype) for r in ros]
    chunks = _parts(rs, 4, 128, d, dtype, dev)
    n = build.launch_counts["reduce_send"]
    sums, nxt = reduce_send(ros, vals, chunks)
    torch.cuda.synchronize()
    assert build.launch_counts["reduce_send"] == n + 4
    want_sums, want_next = ref.reduce_send(ros, [v.double() for v in vals],
                                           chunks)
    for ro, v, got, want in zip(ros, vals, sums, want_sums):
        terms = ref.segment_sum_csr(ro, v.double().abs())
        rows = (ro[1:] - ro[:-1]).double()[:, None]
        _assert_within(got, want, 2 * U * rows * terms + U * want.abs(), "K8")
    assert not sums[3].any()
    for g, w in zip(nxt, want_next):
        assert torch.equal(g, w)


def test_ring_kernels_between_two_cards():
    """K7 and K8 storing into a peer card's buffer: partitions alternate
    between cuda:0 and cuda:1."""
    if torch.cuda.device_count() < 2 or not (
            torch.cuda.can_device_access_peer(0, 1)
            and torch.cuda.can_device_access_peer(1, 0)):
        pytest.skip("needs two GPUs with peer access")
    rs = np.random.default_rng(9)
    devs = [torch.device(f"cuda:{p % 2}") for p in range(4)]
    parts = [p[0].to(dv) for p, dv in zip(
        (_parts(rs, 1, 64, 32, torch.float32, "cpu") for _ in devs), devs)]
    got = ring_shift(parts, 1)
    ros = [_bucket_csr(rs, 64, 100).to(dv) for dv in devs]
    vals = [torch.ones(int(r[-1]), 32, device=r.device) for r in ros]
    sums, nxt = reduce_send(ros, vals, parts)
    for dv in devs:
        torch.cuda.synchronize(dv)
    for j in range(4):
        assert got[j].device == devs[j] and nxt[j].device == devs[j]
        assert torch.equal(got[j].cpu(), parts[j - 1].cpu())
        assert torch.equal(nxt[j].cpu(), parts[j - 1].cpu())
        assert torch.equal(sums[j].cpu(), ref.segment_sum_csr(
            ros[j].cpu(), vals[j].cpu()))


def test_forward_kernel_path_matches_plain_path(dev):
    ds = synthetic_dataset(seed=3, n_users=400, n_items=300, n_entities=600,
                           n_relations_kg=6, n_interactions=6000,
                           n_triples=5000)
    g_host, meta = ds.build()
    g = g_host.to(dev)
    cfg = kgat.KGATConfig(ops_backend="hopper")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(0),
                             device=dev)
    build.launch_counts.clear()
    with torch.no_grad():
        got = model(g, cfg)
        want = model(g, dataclasses.replace(cfg, ops_backend="ref"))
    torch.cuda.synchronize()
    assert dict(build.launch_counts) == {
        "sddmm_transr": 1, "segment_softmax_csr": 1, "spmm_csr": 3}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
