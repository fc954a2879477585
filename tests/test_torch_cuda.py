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
from kgat_tpu_torch.ops.row_split import CHUNK, build_row_split
from kgat_tpu_torch.ops.hopper.sddmm import (sddmm_transr, sddmm_transr_bwd,
                                             sddmm_transr_bwd_plain,
                                             sddmm_transr_plain)
from kgat_tpu_torch.ops.hopper.remote_ring import reduce_send, ring_shift
from kgat_tpu_torch.ops.hopper.segment_sum import (segment_sum_csr, spmm_csr,
                                                   spmm_csr_plain,
                                                   spmm_csr_rev)
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
# Rows at the row split's chunk boundaries: one unit of C - 1 and of C
# edges, two units of C + 1, four of 3C + 5.
BOUNDARY_ROWS = [CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5]


def _assert_within(got, want64, bound64, what):
    """|got - want64| <= bound64 elementwise, against a float64 reference."""
    err = (got.double() - want64).abs()
    worst = float((err / bound64.clamp(min=1e-300)).max()) if err.numel() \
        else 0
    assert worst <= 1.0, f"{what}: error {float(err.max()):.3e} is " \
                         f"{worst:.2f}x its bound"


def _higham(want64, terms64, rows):
    """n * 2^-23 * sum|terms| + U |reference| per row of n terms."""
    return 2 * U * rows[:, None] * terms64 + U * want64.abs()


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
    """Node 0 has no in-edge, node 1 one, node 2 is a hub of 5,000, nodes
    3-6 sit at the row split's chunk boundaries; node 3 is the source of a
    quarter of the edges (a hub of the reverse CSR); a relation of a single
    edge, and relation 4 with none."""
    rs = np.random.default_rng(0)
    deg = np.concatenate([[0, 1, 5000], BOUNDARY_ROWS,
                          rs.integers(0, 30, 60)])
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rs.integers(0, len(deg), len(dst))
    src[rs.random(len(dst)) < 0.25] = 3
    ety = rs.integers(0, 3, len(dst))
    ety[7] = 3
    return build_graph(src, dst, ety, n_nodes=len(deg), n_relations=5,
                       rel_tile=64).to(dev)


def _rand(gen, *shape, dev, scale=0.2):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


@pytest.fixture(scope="module")
def tile_graph(dev):
    """Relations of 1, 15, 16, 17, 64 and 300 edges over 64-edge tiles:
    tiles of 1, 15, 16, 17 and 64 edges (K2's 16-edge groups whole,
    partial and single), and 300 = 4 x 64 + 44."""
    rs = np.random.default_rng(5)
    counts = [1, 15, 16, 17, 64, 300]
    ety = np.repeat(np.arange(len(counts)), counts)
    rs.shuffle(ety)
    dst = np.sort(rs.integers(0, 120, len(ety)))
    src = rs.integers(0, 120, len(ety))
    g = build_graph(src, dst, ety, n_nodes=120, n_relations=len(counts),
                    rel_tile=64)
    assert {1, 15, 16, 17, 64} <= set(g.tiles[:, 2].tolist())
    return g.to(dev)


@pytest.mark.parametrize("d,k", [(64, 64), (64, 32), (64, 100), (33, 20)])
def test_sddmm_matches_plain(dev, hand_graph, tile_graph, d, k):
    """K2 against its plain version at rtol 1e-4, and against float64 at
    rtol and atol 1e-5, which three TF32 passes meet (their error here is
    near 1e-6) and one would not (near 1e-3): on the hand-made graph and on tiles of
    1, 15, 16, 17 and 64 edges, at padded widths (d = 33, k = 100, 20) and
    in two column passes (k = 100)."""
    for g in (hand_graph, tile_graph):
        gen = torch.Generator().manual_seed(d + k)
        args = (g.rel_perm, g.tiles, g.src, g.dst,
                _rand(gen, g.n_nodes, d, dev=dev),
                _rand(gen, g.n_relations, d, k, dev=dev),
                _rand(gen, g.n_relations, k, dev=dev))
        n = build.launch_counts["sddmm_transr"]
        got = sddmm_transr(*args)
        torch.cuda.synchronize()
        assert build.launch_counts["sddmm_transr"] == n + 1
        torch.testing.assert_close(got, sddmm_transr_plain(*args), rtol=1e-4,
                                   atol=1e-5)
        want64 = sddmm_transr_plain(*args[:4], *(t.double() for t in args[4:]))
        torch.testing.assert_close(got.double(), want64, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [CHUNK, 16])
def test_softmax_matches_plain(dev, hand_graph, chunk):
    """K3 on the row split's units against its plain version: the hub of
    5,000 and the chunk-boundary rows split into (max, sum) partials, rows
    of equal logits and of +-1e30; one launch per call, a second call
    bit-identical; the empty row untouched, the one-edge row 1."""
    g, gen = hand_graph, torch.Generator().manual_seed(1)
    split = (g.split if chunk == CHUNK
             else build_row_split(g.row_offsets, chunk))
    assert split.n_split > 0
    logits = _rand(gen, g.n_edges, dev=dev, scale=3.0)
    ro = g.row_offsets.tolist()
    logits[ro[3]:ro[4]] = 0.7                 # equal logits, C - 1 edges
    logits[ro[6]:ro[7]:2] = 1e30              # 3C + 5 edges: split
    logits[ro[6] + 1:ro[7]:2] = -1e30
    n = build.launch_counts["segment_softmax_csr"]
    got = segment_softmax_csr(g.row_offsets, logits, split)
    again = segment_softmax_csr(g.row_offsets, logits, split)
    torch.cuda.synchronize()
    assert build.launch_counts["segment_softmax_csr"] == n + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    torch.testing.assert_close(
        got, segment_softmax_csr_plain(g.row_offsets, logits), rtol=1e-4,
        atol=1e-6)
    assert got[ro[1]] == 1.0  # the one-edge row
    big = got[ro[6]:ro[7]:2]
    torch.testing.assert_close(big, torch.full_like(big, 1 / big.numel()))
    assert not got[ro[6] + 1:ro[7]:2].any()


SPMM_CASES = [(64, torch.float32), (32, torch.float32), (48, torch.float32),
              (64, torch.bfloat16), (200, torch.float32), (33, torch.float32),
              (33, torch.bfloat16)]


@pytest.mark.parametrize("d,dtype", SPMM_CASES)
def test_spmm_matches_plain(dev, hand_graph, d, dtype):
    """K1 on the dst CSR against float64 under Higham's bound per row
    (the hub, the chunk-boundary rows); 16-byte and single-value loads
    (d = 33); a second call bit-identical; the empty row 0."""
    g, gen = hand_graph, torch.Generator().manual_seed(d)
    w = torch.rand(g.n_edges, generator=gen).to(dev)
    x = _rand(gen, g.n_nodes, d, dev=dev).to(dtype)
    args = (g.row_offsets, g.src, w, x, g.split)
    got = spmm_csr(*args)
    again = spmm_csr(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert not got[0].any()  # the empty row is written as 0
    want = spmm_csr_plain(g.row_offsets, g.src, w.double(), x.double())
    terms = spmm_csr_plain(g.row_offsets, g.src, w.double(),
                           x.double().abs())
    rows = (g.row_offsets[1:] - g.row_offsets[:-1]).double()
    _assert_within(got, want, _higham(want, terms, rows), "K1")


@pytest.mark.parametrize("d,dtype", SPMM_CASES[::2] + [(64, torch.bfloat16)])
def test_spmm_rev_matches_float64_plain(dev, hand_graph, d, dtype):
    """K1 on the reverse CSR (the src hub, node 3, is one row of a
    quarter of the edges) against float64, Higham's bound; bit-identical
    twice."""
    g, gen = hand_graph, torch.Generator().manual_seed(d + 1)
    w_rev = torch.rand(g.n_edges, generator=gen).to(dev)
    cot = _rand(gen, g.n_nodes, d, dev=dev).to(dtype)
    args = (g.rev_row_offsets, g.rev_dst, w_rev, cot, g.rev_split)
    got = spmm_csr_rev(*args)
    again = spmm_csr_rev(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = spmm_csr_plain(g.rev_row_offsets, g.rev_dst, w_rev.double(),
                          cot.double())
    terms = spmm_csr_plain(g.rev_row_offsets, g.rev_dst, w_rev.double(),
                           cot.double().abs())
    rows = (g.rev_row_offsets[1:] - g.rev_row_offsets[:-1]).double()
    assert g.rev_split.n_split > 0
    _assert_within(got, want, _higham(want, terms, rows), "K1 rev")


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
    _assert_within(x.grad, want, _higham(want, terms, rows), "d_x")
    assert not x.grad[(rows == 0).nonzero()].any()
    # The weights' gradient is the per-edge dot, as autograd of the plain
    # path gives it.
    w2 = w.clone().requires_grad_(True)
    hopper_backend.spmm(g, w2, x.detach()).backward(cot)
    w3 = w.clone().requires_grad_(True)
    ref.spmm(g, w3, x.detach()).backward(cot)
    torch.testing.assert_close(w2.grad, w3.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,k", [(64, 64), (64, 32), (64, 100), (33, 20),
                                 (32, 100), (256, 32), (65, 126)])
def test_sddmm_backward_matches_float64_plain(dev, hand_graph, tile_graph,
                                              d, k):
    """K4 against float64 on the hand-made graph (a hub of 5,000 head
    edges and a source of a quarter of the edges, both split rows of the
    fold) and on tiles of 1, 15, 16, 17 and 64 edges; padded widths
    (d = 33, 65; k = 20, 100, 126), k in two chunks of phase A (k = 100,
    126), and shapes whose block stages W_r in the forward order alone,
    which fits more warps (64 x 100, 256 x 32, 65 x 126); a second call
    bit-identical."""
    for g in (hand_graph, tile_graph):
        gen = torch.Generator().manual_seed(d + k)
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
        for name, a, b, c in zip(("d_emb", "d_w_rel", "d_rel_embed"), got,
                                 want, again):
            assert torch.equal(a, c), f"{name}: a second call differs"
            _assert_within(a, b, _stat_bound(b, length), name)
        if g is hand_graph:  # relation 4 has no edge
            assert not got[1][4].any() and not got[2][4].any()


def test_softmax_backward_matches_float64_plain(dev, hand_graph):
    g, gen = hand_graph, torch.Generator().manual_seed(2)
    w = segment_softmax_csr(g.row_offsets,
                            _rand(gen, g.n_edges, dev=dev, scale=3.0),
                            g.split)
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
        spmm_csr(g.row_offsets, g.src, w, x, g.split)
    with torch.no_grad():
        spmm_csr(g.row_offsets, g.src, w, x, g.split)
    with pytest.raises(TypeError, match="dtype"):
        spmm_csr(g.row_offsets, g.src.long(), w, x.detach(), g.split)
    # A launch never builds a schedule: none, or another CSR's, raises.
    with pytest.raises(ValueError, match="RowSplit"):
        spmm_csr(g.row_offsets, g.src, w, x.detach())
    with pytest.raises(ValueError, match="RowSplit"):
        spmm_csr(g.row_offsets, g.src, w, x.detach(),
                 build_row_split(g.row_offsets[:-1]))
    with pytest.raises(ValueError, match="RowSplit"):
        segment_sum_csr(g.row_offsets, x.detach()[g.src.long()])
    with pytest.raises(ValueError, match="contiguous"):
        segment_softmax_csr(g.row_offsets,
                            torch.zeros(2 * g.n_edges, device=dev)[::2])
    with pytest.raises(ValueError, match="RowSplit"):
        segment_softmax_csr(g.row_offsets, w)
    bare = dataclasses.replace(g, rev_split=None)
    with pytest.raises(ValueError, match="RowSplit"):
        sddmm_transr_bwd(bare, w, x.detach(),
                         torch.zeros(g.n_relations, 8, 8, device=dev),
                         torch.zeros(g.n_relations, 8, device=dev))


def _bucket_csr(rs, n_rows, hub):
    """CSR offsets of ``n_rows`` rows: row 0 empty, row 1 one edge, row 2
    a hub of ``hub`` edges, rows 3-6 at the chunk boundaries, the rest
    0-20."""
    deg = np.concatenate([[0, 1, hub], BOUNDARY_ROWS,
                          rs.integers(0, 21, n_rows - 7)])
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32))


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (32, torch.float32),
                                     (16, torch.float32), (64, torch.bfloat16),
                                     (200, torch.float32), (33, torch.float32),
                                     (33, torch.bfloat16)])
def test_segment_sum_csr_matches_float64_plain(dev, d, dtype):
    """K6 against its plain version in float64, under Higham's bound on
    each row (n * 2^-23 * sum|terms|), the hub and the chunk-boundary
    rows among them; a second call bit-identical; an empty row and an
    empty bucket written as 0; one wrapper launch per call."""
    rs = np.random.default_rng(d)
    ro = _bucket_csr(rs, 300, 3000).to(dev)
    split = build_row_split(ro)
    vals = torch.from_numpy(rs.normal(size=(int(ro[-1]), d)).astype(
        np.float32)).to(dev, dtype)
    n = build.launch_counts["segment_sum_csr"]
    got = segment_sum_csr(ro, vals, split)
    again = segment_sum_csr(ro, vals, split)
    torch.cuda.synchronize()
    assert build.launch_counts["segment_sum_csr"] == n + 2
    assert torch.equal(got, again) and got.dtype == torch.float32
    want = ref.segment_sum_csr(ro, vals.double())
    terms = ref.segment_sum_csr(ro, vals.double().abs())
    rows = (ro[1:] - ro[:-1]).double()
    _assert_within(got, want, _higham(want, terms, rows), "K6")
    assert not got[0].any()
    ro0 = torch.zeros(7, dtype=torch.int32, device=dev)
    empty = segment_sum_csr(ro0, vals[:0], build_row_split(ro0))
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
    splits = [build_row_split(r) for r in ro]
    with pytest.raises(ValueError, match="aliases"):
        reduce_send(ro, vals, parts, out=[parts[1], parts[2], parts[0]],
                    splits=splits)
    with pytest.raises(ValueError, match="RowSplit"):
        reduce_send(ro, vals, parts)


@pytest.mark.parametrize("d,dtype", [(64, torch.float32), (32, torch.bfloat16),
                                     (33, torch.float32)])
def test_reduce_send_matches_plain(dev, d, dtype):
    """K8: every partition's sums against float64 under Higham's bound
    (the chunk-boundary rows among them), the sent chunks bit-exact, a
    second call's sums bit-identical; one bucket has no edge."""
    rs = np.random.default_rng(d + 1)
    ros = [_bucket_csr(rs, 128, 500 * (p + 1)).to(dev) for p in range(3)]
    ros.append(torch.zeros(129, dtype=torch.int32, device=dev))
    splits = [build_row_split(r) for r in ros]
    vals = [torch.from_numpy(rs.normal(size=(int(r[-1]), d)).astype(
        np.float32)).to(dev, dtype) for r in ros]
    chunks = _parts(rs, 4, 128, d, dtype, dev)
    n = build.launch_counts["reduce_send"]
    sums, nxt = reduce_send(ros, vals, chunks, splits=splits)
    again, _ = reduce_send(ros, vals, chunks, splits=splits)
    torch.cuda.synchronize()
    assert build.launch_counts["reduce_send"] == n + 8
    want_sums, want_next = ref.reduce_send(ros, [v.double() for v in vals],
                                           chunks)
    for ro, v, got, want, a in zip(ros, vals, sums, want_sums, again):
        terms = ref.segment_sum_csr(ro, v.double().abs())
        rows = (ro[1:] - ro[:-1]).double()
        _assert_within(got, want, _higham(want, terms, rows), "K8")
        assert torch.equal(got, a)
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
    sums, nxt = reduce_send(ros, vals, parts,
                            splits=[build_row_split(r) for r in ros])
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
