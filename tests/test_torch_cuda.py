"""The Hopper kernels on the GPU against their plain PyTorch versions.

Needs a CUDA device, nvcc and the sm_90a target; everywhere else these
tests skip. This file imports no jax (the GPU machine has none), so run it
there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math
import subprocess
import sys

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
from kgat_tpu_torch import train
from kgat_tpu_torch.parallel import multihost
from kgat_tpu_torch.utils.config import TrainConfig

import torch_cuda_mp_worker as mp_worker

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


@pytest.mark.parametrize("msg,reduce", [("u_mul_e", "sum"),
                                        ("u_mul_e", "mean"),
                                        ("copy_u", "sum"),
                                        ("copy_u", "mean")])
def test_gspmm_sum_and_mean_run_k1(dev, hand_graph, msg, reduce):
    """The hopper backend's gspmm sends the weighted sum and mean, and
    copy_u's, through K1 (one launch forward, one on the reverse CSR for
    d_x), held to the float64 plain path under the row bound; d_w is the
    plain path's."""
    g, gen = hand_graph, torch.Generator().manual_seed(11)
    w = (None if msg == "copy_u"
         else torch.randn(g.n_edges, generator=gen).to(dev))
    x = _rand(gen, g.n_nodes, 64, dev=dev).requires_grad_(True)
    cot = _rand(gen, g.n_nodes, 64, dev=dev)
    before = {k: build.launch_counts[k] for k in ("spmm_csr",
                                                  "spmm_csr_rev")}
    out = hopper_backend.gspmm(g, msg, reduce, x, w)
    out.backward(cot)
    torch.cuda.synchronize()
    assert {k: build.launch_counts[k] - n for k, n in before.items()} == {
        "spmm_csr": 1, "spmm_csr_rev": 1}
    w64 = (torch.ones(g.n_edges, dtype=torch.float64, device=dev)
           if w is None else w.double())
    x64 = x.detach().double().requires_grad_(True)
    want = ref.gspmm(g, "u_mul_e", reduce, x64, w64)
    want.backward(cot.double())
    # The terms' magnitudes: the same linear maps of |w|, |x| and |cot|.
    xa = x64.detach().abs().requires_grad_(True)
    terms = ref.gspmm(g, "u_mul_e", reduce, xa, w64.abs())
    terms.backward(cot.double().abs())
    rows = (g.row_offsets[1:] - g.row_offsets[:-1]).double()
    extra = U * want.detach().abs() if reduce == "mean" else 0
    _assert_within(out.detach(), want.detach(),
                   _higham(want.detach(), terms.detach(), rows) + extra,
                   f"{msg} {reduce}")
    rev_rows = (g.rev_row_offsets[1:] - g.rev_row_offsets[:-1]).double()
    _assert_within(x.grad, x64.grad, _higham(x64.grad, xa.grad, rev_rows),
                   f"{msg} {reduce} d_x")
    if w is not None:
        w2 = w.clone().requires_grad_(True)
        hopper_backend.gspmm(g, msg, reduce, x.detach(), w2).backward(cot)
        w3 = w.clone().requires_grad_(True)
        ref.gspmm(g, msg, reduce, x.detach(), w3).backward(cot)
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


@pytest.mark.parametrize("chunk", [CHUNK, 16, 1000])
def test_softmax_backward_matches_float64_plain(dev, chunk):
    """K5 on the row split's units against its float64 plain version,
    under the Higham bound: an empty row, a one-edge row, hubs of 5,000
    and 9,000 edges (past 256 x 32: at chunk 256 its 36 slots take more
    than one a lane in the second launch), rows at the chunk boundaries,
    one of +-1e30 logits (weights 0); one wrapper launch per call, a
    second call bit-identical, no call without the split. Chunk 1000 puts
    units longer than 256 edges on the units kernel, which reads them
    twice instead of keeping them in registers."""
    rs = np.random.default_rng(chunk)
    deg = np.concatenate([[0, 1, 9000, 5000], BOUNDARY_ROWS,
                          [chunk - 1, chunk + 1, 3 * chunk + 5],
                          rs.integers(0, 30, 60)])
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32)).to(dev)
    split = build_row_split(ro, chunk)
    assert split.n_split > 0 and split.cuda_launches == 2
    gen = torch.Generator().manual_seed(2)
    logits = _rand(gen, int(deg.sum()), dev=dev, scale=3.0)
    big = slice(int(ro[9]), int(ro[10]))      # chunk + 1 edges: split
    logits[big][::2], logits[big][1::2] = 1e30, -1e30
    w = segment_softmax_csr(ro, logits, split)
    cot = _rand(gen, w.numel(), dev=dev, scale=1.0)
    n = build.launch_counts["segment_softmax_csr_bwd"]
    got = segment_softmax_csr_bwd(ro, w, cot, split)
    again = segment_softmax_csr_bwd(ro, w, cot, split)
    torch.cuda.synchronize()
    assert build.launch_counts["segment_softmax_csr_bwd"] == n + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert got[int(ro[1])] == 0.0             # one edge: w = 1
    assert not got[big][1::2].any()           # weight 0
    want = segment_softmax_csr_bwd_plain(ro, w.double(), cot.double())
    dst = ref.offsets_to_dst(ro)
    rows = (ro[1:] - ro[:-1]).double()
    row_abs = ref.segment_sum_coo(dst, (w.double() * cot.double()).abs(),
                                  len(deg))
    # The row sum takes its length + 5 roundings (lanes, then the shuffle
    # tree; a split row's slots fewer); g - s and w (g - s) one each.
    bound = (2 * U * w.double() * ((rows[dst] + 5) * row_abs[dst]
                                   + cot.double().abs())
             + 2 * U * want.abs())
    _assert_within(got, want, bound, "d_logits")
    with pytest.raises(ValueError, match="RowSplit"):
        segment_softmax_csr_bwd(ro, w, cot)


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


# ---------------------------------------------------------------------------
# The captured training steps (train.StepGraph).
# ---------------------------------------------------------------------------

def _trainer(**kw):
    cfg = TrainConfig(**{
        **dict(dataset="synthetic", device="cuda", log_dir=None, seed=3,
               cf_batch_size=128, kg_batch_size=256, syn_users=300,
               syn_items=200, syn_entities=500, syn_relations=6,
               syn_interactions=6000, syn_triples=4000,
               model=kgat.KGATConfig(embed_dim=32, relation_dim=32,
                                     conv_dims=(32, 16),
                                     mess_dropout=(0.1, 0.1),
                                     ops_backend="hopper")), **kw})
    tr = train.Trainer(cfg)
    tr.stage(tr.attention())
    return tr


def _snapshot(tr):
    return ([p.detach().clone() for p in tr.model.parameters()],
            {p: {k: v.clone() for k, v in s.items()}
             for p, s in tr.opt.state.items()})


def _restore(tr, snap):
    params, state = snap
    with torch.no_grad():
        for p, v in zip(tr.model.parameters(), params):
            p.copy_(v)
        for p, s in state.items():
            for k, v in s.items():
                tr.opt.state[p][k].copy_(v)


@pytest.mark.parametrize("sparse", [False, True])
def test_replayed_steps_match_eager_steps(dev, sparse):
    """One replay of each captured step against an eager step from the same
    parameters and Adam state on the batch and dropout masks the replay
    drew (it exposes them): equal losses (rtol 1e-5), gradients within
    rtol 1e-4 (two float32 paths whose gather backward adds in no fixed
    order), the same step counts. Under --sparse-adam the KG step leaves
    .grad alone: its moments are compared instead, and the conv weights
    must not move."""
    tr = _trainer(sparse_adam=sparse)
    tr.cf_steps.capture()
    tr.kg_steps.capture()
    build.launch_counts.clear()
    for steps, eager in ((tr.cf_steps, lambda: tr.cf_step(
            tr._step_att, *tr.cf_drawn[:4], masks=tr.cf_drawn[4])),
            (tr.kg_steps, lambda: tr.kg_step(*tr.kg_drawn))):
        snap = _snapshot(tr)
        steps.loss_sum.zero_()
        steps.replay()
        loss = float(steps.loss_sum)
        grads = [p.grad.clone() for p in tr.model.parameters()]
        state = {k: [tr.opt.state[p][k].clone() for p in tr.model.parameters()]
                 for k in ("exp_avg", "exp_avg_sq", "step")}
        moved = [p.detach().clone() for p in tr.model.parameters()]
        _restore(tr, snap)
        assert abs(float(eager()) - loss) <= 1e-5 * abs(loss)
        for (name, p), g, m, v, n, new, old in zip(
                tr.model.named_parameters(), grads, *state.values(), moved,
                snap[0]):
            s = tr.opt.state[p]
            assert torch.equal(s["step"], n)
            if sparse and steps is tr.kg_steps:
                torch.testing.assert_close(s["exp_avg"], m, rtol=1e-4,
                                           atol=1e-9)
                torch.testing.assert_close(s["exp_avg_sq"], v, rtol=1e-4,
                                           atol=1e-12)
                if name.startswith("layers."):
                    assert torch.equal(new, old), name
            else:
                torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-8)
    # Replays launch nothing through the wrappers: only the eager CF step
    # above counted its K1 launches.
    assert dict(build.launch_counts) == {"spmm_csr": 2, "spmm_csr_rev": 2}
    assert tr.cf_steps.calls == {"spmm_csr": 2, "spmm_csr_rev": 2}


def test_two_replays_draw_different_batches(dev):
    """The trainer's generator is registered with each graph: every replay
    draws a fresh batch and fresh dropout masks, as eager steps from the
    same seed would, in the same order."""
    tr = _trainer()
    tr.cf_steps.capture()
    tr.kg_steps.capture()
    draws = []
    for _ in range(2):
        tr.cf_steps.replay()
        tr.kg_steps.replay()
        u, i_pos, i_neg, _, masks = tr.cf_drawn
        h, r, t_pos, t_neg, _ = tr.kg_drawn
        draws.append([t.clone() for t in (u, i_pos, i_neg, *masks, h, r,
                                          t_pos, t_neg)])
    for a, b in zip(*draws):
        assert not torch.equal(a, b)
    # The same seed drives eager steps through the same draws.
    eager = _trainer()
    for _ in range(3):                  # the warm-up step and two replays
        eager.sample_cf()
        masks = kgat.dropout_masks(eager.cfg.model, eager.meta.n_nodes,
                                   eager.generator, dev)
        eager.sample_kg()
    u = eager.sample_cf()[0]
    tr.cf_steps.replay()
    assert torch.equal(u, tr.cf_drawn[0]) and len(masks) == 2


def test_sparse_kg_step_captures_and_replays(dev):
    """A replayed epoch under --sparse-adam: finite losses, every step
    count advanced by the epoch's steps, the conv weights unmoved by the
    KG phase."""
    tr = _trainer(sparse_adam=True)
    n_kg = tr.n_kg_batches
    convs = [p for n, p in tr.model.named_parameters()
             if n.startswith("layers.")]
    tr.cf_steps.run(2)
    before = [p.detach().clone() for p in convs]
    total = float(tr.kg_steps.run(n_kg))
    assert math.isfinite(total) and tr.kg_steps.replays == n_kg - 1
    assert all(torch.equal(p, b) for p, b in zip(convs, before))
    assert {int(s["step"]) for s in tr.opt.state.values()} == {2 + n_kg}


def test_capture_with_a_host_sync_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing runs the step eagerly in its place."""
    x = torch.ones(4, device=dev)
    steps = train.StepGraph(lambda: x.sum() * float(x.sum()),
                            [torch.Generator(device=dev).manual_seed(0)], dev)
    with pytest.raises(RuntimeError):
        steps.run(3)
    assert steps.graph is None and steps.replays == 0
    torch.cuda.synchronize()


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The number of nodes of a captured graph, read through libcuda."""
    import ctypes
    n = ctypes.c_size_t(0)
    code = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    assert code == 0
    return n.value


def test_spans_leave_a_captured_step_as_it_was(dev, monkeypatch):
    """Spans inside a captured step's body (host and device) and around
    its run record nothing while the capture records, and leave the graph
    its nodes and calls: the same nodes, calls, losses and parameters as
    the same trainer without spans. No span synchronises: the run makes
    as many synchronising calls with spans as without."""
    from kgat_tpu_torch.utils import trace
    plain, spanned = _trainer(), _trainer()
    body = spanned.cf_steps.body

    def traced_body():
        with trace.span("test.body"), trace.span("test.dev", device=dev):
            return body()
    spanned.cf_steps.body = traced_body
    syncs = []

    def counted(owner, name):
        real = getattr(owner, name)

        def call(*a, **k):
            syncs.append(name)
            return real(*a, **k)
        monkeypatch.setattr(owner, name, call)
    counted(torch.cuda, "synchronize")
    counted(torch.cuda.Event, "synchronize")
    counted(torch.cuda.Stream, "synchronize")
    trace.reset()
    losses, made = [], []
    for tr in (plain, spanned):
        syncs.clear()
        with trace.span("test.run", device=dev):
            loss = tr.cf_steps.run(4)
        made.append(list(syncs))
        losses.append(float(loss))
    assert made[0] == made[1]
    s = trace.summary()["spans"]
    # The warm-up step ran the body eagerly; the capture recorded nothing.
    assert s["test.body"]["count"] == 1 and s["test.dev"]["count"] == 1
    assert s["test.dev"]["device_count"] == 1
    assert s["test.run"]["count"] == 2 and s["test.run"]["device_count"] == 2
    assert spanned.cf_steps.replays == plain.cf_steps.replays == 3
    assert spanned.cf_steps.calls == plain.cf_steps.calls
    assert _graph_nodes(spanned.cf_steps.graph) == _graph_nodes(
        plain.cf_steps.graph)
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for a, b in zip(plain.model.parameters(), spanned.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    trace.reset()


def test_a_device_span_agrees_with_cuda_events(dev):
    """A device span's stream time against a pair of CUDA events around the
    same work (some 50 ms of products): within 5%."""
    from kgat_tpu_torch.utils import trace
    a = torch.randn(2048, 2048, device=dev)
    for _ in range(3):
        a @ a
    tr = trace.Tracer()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    with tr.span("work", device=dev):
        for _ in range(50):
            a = (a @ a) * 1e-3
    e1.record()
    torch.cuda.synchronize()
    s = tr.summary()["spans"]["work"]
    want = e0.elapsed_time(e1) * 1e-3
    assert want > 0.01
    assert s["device_count"] == 1
    assert s["device_seconds"] == pytest.approx(want, rel=0.05)


# ---------------------------------------------------------------------------
# The partitioned trainer's captured steps.
# ---------------------------------------------------------------------------

PARTITIONED = [
    dict(halo_exchange="allgather"),
    dict(halo_exchange="ring", ring_transport="ppermute"),
    dict(halo_exchange="ring", ring_transport="dma"),
    dict(halo_exchange="ring", ring_transport="fused"),
    dict(halo_exchange="a2a"),
    dict(dp_replicas=2, halo_exchange="ring", ring_transport="fused")]


@pytest.mark.parametrize("mesh", PARTITIONED,
                         ids=lambda m: "-".join(map(str, m.values())))
def test_replayed_partitioned_steps_match_eager_steps(dev, mesh):
    """Four partitions on one card (or a (2, 2) mesh): one replay of each
    captured step against the same step run eagerly from the same
    parameters, Adam state and generator states (the trainer's and every
    partition's): the same batch, equal losses (rtol 1e-5), gradients
    within rtol 1e-4, the same step counts."""
    tr = _trainer(n_devices=4, **mesh)
    if not tr.captured:
        pytest.skip(f"not captured: {tr.capture_why}")
    assert len(tr.cf_steps.generators) == 5
    tr.cf_steps.capture()
    tr.kg_steps.capture()
    for steps, body, drawn in ((tr.cf_steps, tr._cf_body, "cf_drawn"),
                               (tr.kg_steps, tr._kg_body, "kg_drawn")):
        snap = _snapshot(tr)
        states = [g.get_state() for g in steps.generators]
        steps.loss_sum.zero_()
        steps.replay()
        loss = float(steps.loss_sum)
        batch = [t.clone() for t in getattr(tr, drawn)[:4]]
        grads = [p.grad.clone() for p in tr.model.parameters()]
        counts = [tr.opt.state[p]["step"].clone()
                  for p in tr.model.parameters()]
        _restore(tr, snap)
        for g, s in zip(steps.generators, states):
            g.set_state(s)
        eager = float(body())
        for a, b in zip(batch, getattr(tr, drawn)[:4]):
            assert torch.equal(a, b)
        assert abs(eager - loss) <= 1e-5 * abs(loss)
        for p, g, n in zip(tr.model.parameters(), grads, counts):
            torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-8)
            assert torch.equal(tr.opt.state[p]["step"], n)


@pytest.mark.parametrize("mesh", PARTITIONED,
                         ids=lambda m: "-".join(map(str, m.values())))
def test_partitioned_steps_across_cards(dev, mesh):
    """Four partitions spread over the visible cards (two or more): the
    trainer runs eager steps by the mesh's mode, says why, and one CF
    step (dropout 0) gives the single-device loss (rtol 1e-5) and
    gradients (rtol 1e-4); an eager epoch runs to finite losses."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more GPUs")
    model = kgat.KGATConfig(embed_dim=32, relation_dim=32,
                            conv_dims=(32, 16), mess_dropout=(0.0, 0.0),
                            ops_backend="hopper")
    single, tr = (_trainer(model=model, n_devices=n,
                           **(mesh if n > 1 else {})) for n in (1, 4))
    assert not tr.captured and "cards" in tr.capture_why
    assert len({str(d) for d in tr.mesh.devices}) > 1
    users = torch.arange(128, device=dev) % single.meta.n_users
    batch = (users, users % single.meta.n_items,
             (users + 7) % single.meta.n_items)
    losses, grads = [], []
    for t in (single, tr):
        losses.append(float(t.cf_grad(t.attention(), *batch)))
        grads.append([p.grad.clone() for p in t.model.parameters()])
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-7)
    assert all(math.isfinite(x) for x in tr.train_one_epoch())


# ---------------------------------------------------------------------------
# Across processes (one process per card, parallel/multihost.py).
# ---------------------------------------------------------------------------

def _spawn(mode, world, tmp_path, *args, limit=600):
    """``world`` processes of tests/torch_cuda_mp_worker.py in ``mode``;
    their outputs, each process killed past ``limit`` seconds."""
    url = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, mp_worker.__file__, mode, url, str(world), str(pid),
         str(tmp_path), *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(world)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=limit)[0])
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append(proc.communicate()[0] + "\n<killed: timeout>")
    return [p.returncode for p in procs], outs


def test_ring_kernels_across_processes(dev, tmp_path):
    """K7 and K8 store into the next (K7 also the previous) process's
    registered receive buffer through CUDA IPC, ordered by the flag
    protocol: 30 rounds eagerly and 30 replays of a CUDA graph on new data,
    every received chunk bit-exact, K8's sums within the float32 bound;
    then the link is closed and a second one registered in the same
    processes, and the 60 rounds run again. Two processes on one card
    where there is one (gloo carries only the handles), else one per
    card, up to four."""
    n = torch.cuda.device_count()
    world = 2 if n < 2 else min(4, n)
    rcs, outs = _spawn("ring", world, tmp_path, limit=300)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    for pid, out in enumerate(outs):
        assert (f"RESULT mode=ring pid={pid} device=cuda:{pid % n} "
                f"rounds=120 process_launches={{'ring_shift': 124, "
                f"'reduce_send': 62}}" in out), out[-2000:]


def test_ring_wait_without_a_peer_store_fails(dev, tmp_path):
    """A ring wait whose peer never stores ends: after the link's 2-second
    timeout the wait kernel fails the process's CUDA context, and the next
    synchronisation raises instead of hanging."""
    rcs, outs = _spawn("timeout", 2, tmp_path, limit=120)
    assert rcs[1] == 0, outs[1][-4000:]
    line = next((ln for ln in outs[0].splitlines()
                 if ln.startswith("RESULT mode=timeout")), None)
    assert line is not None, outs[0][-4000:]
    after = float(line.split("after=")[1].split()[0])
    assert 2.0 <= after < 60.0, line
    assert "error=None" not in line, line


def test_two_ranks_on_one_card_are_refused(dev, tmp_path):
    """One more NCCL process than cards: the two that would share cuda:0
    are refused before NCCL would fail on them; the others form."""
    n = torch.cuda.device_count()
    rcs, outs = _spawn("refuse", n + 1, tmp_path, limit=120)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    for pid, out in enumerate(outs):
        if pid in (0, n):
            assert "would share one card" in out, out[-2000:]
        else:
            assert f"formed rank {pid}" in out, out[-2000:]


def test_group_of_one_captures_the_gradient_all_reduce(dev, tmp_path):
    """A group of one NCCL rank holding P = 4 slots: the trainer sums its
    gradients with an all-reduce, captured inside its CUDA graphs; one
    replay of each step against the eager step from the same state, and
    the first CF step's loss and gradients against the trainer without a
    group."""
    model = kgat.KGATConfig(embed_dim=32, relation_dim=32,
                            conv_dims=(32, 16), mess_dropout=(0.0, 0.0),
                            ops_backend="hopper")
    kw = dict(n_devices=4, halo_exchange="ring", ring_transport="fused",
              model=model)
    plain = _trainer(**kw)
    users = torch.arange(128, device=dev) % plain.meta.n_users
    batch = (users, users % plain.meta.n_items,
             (users + 7) % plain.meta.n_items)
    want = float(plain.cf_grad(plain.attention(), *batch))
    want_grads = [p.grad.clone() for p in plain.model.parameters()]
    del plain
    multihost.form_group(f"file://{tmp_path}/rendezvous", 1, 0, "cuda")
    try:
        tr = _trainer(**kw)
        assert tr.sync and tr.captured and "process 0 of 1" in \
            tr.capture_why, tr.capture_why
        assert float(tr.cf_grad(tr.attention(), *batch)) == pytest.approx(
            want, rel=1e-5)
        for p, g in zip(tr.model.parameters(), want_grads):
            torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-8)
        tr.stage(tr.attention())
        tr.cf_steps.capture()
        tr.kg_steps.capture()
        for steps, body in ((tr.cf_steps, tr._cf_body),
                            (tr.kg_steps, tr._kg_body)):
            snap = _snapshot(tr)
            states = [g.get_state() for g in steps.generators]
            steps.loss_sum.zero_()
            steps.replay()
            loss = float(steps.loss_sum)
            grads = [p.grad.clone() for p in tr.model.parameters()]
            _restore(tr, snap)
            for g, s in zip(steps.generators, states):
                g.set_state(s)
            assert abs(float(body()) - loss) <= 1e-5 * abs(loss)
            for p, g in zip(tr.model.parameters(), grads):
                torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-8)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def steps_across_processes(dev, tmp_path_factory):
    """Every mesh of ``MESHES`` in turn in the same W = min(4, cards)
    processes, one per card on NCCL (P = W): the workers' output
    directory."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more GPUs: NCCL takes one rank per card")
    out_dir = tmp_path_factory.mktemp("steps")
    rcs, outs = _spawn("steps", min(4, n), out_dir, limit=600)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    return out_dir


@pytest.mark.parametrize("name", [mp_worker.mesh_name(m)
                                  for m in mp_worker.MESHES])
def test_partitioned_steps_across_processes(dev, steps_across_processes,
                                            name):
    """One process per card (W = min(4, cards), P = W) on NCCL, each
    exchange in turn in the same processes: the first CF step (dropout 0)
    and a KG step, whose losses and gradients are summed over the
    processes, against the single-device trainer (loss rtol 1e-5,
    gradients rtol 1e-4); every process holds the same; 20 replays of
    each captured step against 20 eager steps from the same state (loss
    sums rtol 1e-4)."""
    world = min(4, torch.cuda.device_count())
    single = train.Trainer(mp_worker.trainer_cfg())
    users = torch.arange(128, device=dev) % single.meta.n_users
    batch = (users, users % single.meta.n_items,
             (users + 7) % single.meta.n_items)
    want_cf = float(single.cf_grad(single.attention(), *batch))
    want_cf_grads = {k: p.grad.cpu().numpy()
                     for k, p in single.model.named_parameters()}
    files = []
    for pid in range(world):
        with np.load(steps_across_processes / f"{name}.{pid}.npz") as z:
            files.append({k: z[k] for k in z.files})
    f = files[0]
    assert float(f["cf_loss"]) == pytest.approx(want_cf, rel=1e-5), name
    for k, g in want_cf_grads.items():
        np.testing.assert_allclose(f[f"cf/{k}"], g, rtol=1e-4, atol=1e-7,
                                   err_msg=f"{name} {k}")
    kg = [torch.from_numpy(f[f"kg_batch/{i}"]).to(dev) for i in range(5)]
    assert float(f["kg_loss"]) == pytest.approx(
        float(single.kg_grad(*kg)), rel=1e-5), name
    for k, p in single.model.named_parameters():
        np.testing.assert_allclose(f[f"kg/{k}"], p.grad.cpu().numpy(),
                                   rtol=1e-4, atol=1e-7,
                                   err_msg=f"{name} {k}")
    for other in files[1:]:
        for k in f:
            np.testing.assert_array_equal(other[k], f[k], err_msg=k)
    np.testing.assert_allclose(f["replayed"], f["eager"], rtol=1e-4,
                               err_msg=name)
