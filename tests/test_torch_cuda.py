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
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.sddmm import sddmm_transr, sddmm_transr_plain
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr, spmm_csr_plain
from kgat_tpu_torch.ops.hopper.softmax import (segment_softmax_csr,
                                               segment_softmax_csr_plain)
from kgat_tpu_torch.recommend import disable_tf32

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the CPU the wrappers run their "
                    "plain versions (tests/test_torch_ops.py)")
    disable_tf32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hand_graph(dev):
    """Node 0 has no in-edge, node 1 one, node 2 is a hub of 5,000; a
    relation of a single edge."""
    rs = np.random.default_rng(0)
    deg = np.concatenate([[0, 1, 5000], rs.integers(0, 30, 60)])
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rs.integers(0, len(deg), len(dst))
    ety = rs.integers(0, 3, len(dst))
    ety[7] = 3
    return build_graph(src, dst, ety, n_nodes=len(deg), n_relations=4,
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
