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
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr, spmm_csr_plain
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
