"""Port parity: the three kernels' counterparts vs the Pallas kernels.

Each Hopper wrapper takes its plain PyTorch version for CPU tensors, so
here the port's ops run as plain torch and the JAX side runs its Pallas
kernels in interpret mode (as tests/test_pallas_ops.py does), on the same
numpy-seeded inputs over the same graph:

  K1 spmm_csr            vs pallas_backend.spmm (reaches _kernel_w)
  K2 sddmm_transr        vs kgat.attention_logits on the pallas backend
  K3 segment_softmax_csr vs softmax.segment_softmax_aligned, mapped to
                         canonical slots, and vs ref.segment_softmax
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import host_array
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.ops import ref as jref
from kgat_tpu.ops.pallas.softmax import segment_softmax_aligned
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops import get_backend, hopper_backend, ref
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.sddmm import sddmm_transr, sddmm_transr_plain
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax_csr
from kgat_tpu_torch.recommend import disable_tf32

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def graphs():
    # Default rel_block=1024 so the Pallas SDDMM's tiles line up.
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, tmeta = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg, tmeta


def _pad(a, n_pad):
    """Canonical real-edge values -> the JAX graph's padded (E_pad,)."""
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


@pytest.mark.parametrize("d", [64, 32])
def test_spmm_matches_pallas_kernel(graphs, rng, d):
    jg, _, tg, _ = graphs
    w = rng.uniform(size=tg.n_edges).astype(np.float32)
    x = rng.normal(size=(tg.n_nodes, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pb.spmm(jg, jnp.asarray(_pad(w, jg.n_edges_pad)),
                                  jnp.asarray(x)))
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    got = hopper_backend.spmm(tg, wt, xt)
    assert got.dtype == torch.float32 and got.shape == (tg.n_nodes, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.spmm(tg, wt, xt).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_spmm_bf16_values_accumulate_in_f32(graphs, rng):
    """The bf16 value stream: same products as f32 on the bf16-rounded x."""
    _, _, tg, _ = graphs
    w = torch.from_numpy(rng.uniform(size=tg.n_edges).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(tg.n_nodes, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = spmm_csr(tg.row_offsets, tg.src, w, xb)
    assert got.dtype == torch.float32
    want = ref.spmm(tg, w, xb.float())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_attention_logits_match_pallas_kernel(graphs):
    jg, jmeta, tg, _ = graphs
    params = jkgat.init_params(jax.random.key(3), jmeta.n_nodes,
                               jmeta.n_relations, jkgat.KGATConfig())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkgat.attention_logits(
            params, jg, jkgat.KGATConfig(ops_backend="pallas")))[: jg.n_edges]
    np_params = jax.tree.map(np.asarray, params)
    cfg = tkgat.KGATConfig(ops_backend="hopper")
    model = tkgat.params_from_jax(np_params, cfg)
    with torch.no_grad():
        got = tkgat.attention_logits(model, tg, cfg).numpy()
        args = (tg.rel_perm, tg.tiles, tg.src, tg.dst, model.entity_embed,
                model.w_rel, model.rel_embed)
        direct = sddmm_transr(*args)
        # Tile-derived relation ranges agree with the graph's own.
        torch.testing.assert_close(sddmm_transr_plain(*args), direct)
        ref_logits = ref.attention_logits(tg, *args[4:])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ref_logits.numpy(), want, rtol=1e-4,
                               atol=1e-5)


def test_segment_softmax_matches_pallas_kernel(graphs, rng):
    jg, _, tg, _ = graphs
    logits = (3 * rng.normal(size=tg.n_edges)).astype(np.float32)
    lay = jg.fwd_layout
    gather = host_array(lay, "gather")
    real = gather < jg.n_edges
    logits_fwd = np.zeros(len(gather), np.float32)
    logits_fwd[real] = logits[gather[real]]
    with pltpu.force_tpu_interpret_mode():
        w_fwd = np.asarray(segment_softmax_aligned(jnp.asarray(logits_fwd),
                                                   lay))
    want = np.zeros(tg.n_edges, np.float32)
    want[gather[real]] = w_fwd[real]
    want_ref = np.asarray(jref.segment_softmax(
        jg, jnp.asarray(_pad(logits, jg.n_edges_pad))))[: jg.n_edges]

    got = hopper_backend.segment_softmax(tg, torch.from_numpy(logits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-4, atol=1e-6)
    # Each non-empty row sums to one.
    sums = ref.segment_sum(tg, got).numpy()
    deg = np.diff(tg.row_offsets.numpy())
    np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_softmax_orientation_and_edge_rows(backend):
    """Hand-computed: head 0 has tails (1, 2, 3), head 4 one tail, heads
    1-3 none. Edges run t -> h and the softmax groups by dst == h. Empty
    rows get a zero SpMM output; a one-edge row gets weight 1."""
    g = build_graph(np.array([1, 2, 3, 0]), np.array([0, 0, 0, 4]),
                    np.zeros(4, np.int64), n_nodes=5, n_relations=1)
    ops = get_backend(backend)
    logits = torch.tensor([np.log(1.0), np.log(2.0), np.log(5.0), 3.21],
                          dtype=torch.float32)
    w = ops.segment_softmax(g, logits)
    torch.testing.assert_close(
        w, torch.tensor([1 / 8, 2 / 8, 5 / 8, 1.0]), rtol=1e-6, atol=0)
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    out = ops.spmm(g, w, x)
    torch.testing.assert_close(out[[1, 2, 3]], torch.zeros(3, 2))
    torch.testing.assert_close(out[4], x[0])
    torch.testing.assert_close(out[0], (x[1] + 2 * x[2] + 5 * x[3]) / 8)


def test_cpu_tensors_never_touch_the_kernel_library(graphs, monkeypatch):
    """A CPU call takes the plain version; only CUDA tensors would build
    and launch, and the launch counters do not move here."""
    _, _, tg, _ = graphs

    def no_library():
        raise AssertionError("CPU call reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    before = dict(build.launch_counts)
    logits = torch.zeros(tg.n_edges)
    w = segment_softmax_csr(tg.row_offsets, logits)
    spmm_csr(tg.row_offsets, tg.src, w, torch.ones(tg.n_nodes, 8))
    assert dict(build.launch_counts) == before


def test_wrappers_reject_unsupported_devices(graphs):
    _, _, tg, _ = graphs
    with pytest.raises(ValueError, match="unsupported device"):
        segment_softmax_csr(tg.row_offsets.to("meta"),
                            torch.zeros(tg.n_edges, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        spmm_csr(tg.row_offsets, tg.src, torch.zeros(tg.n_edges),
                 torch.zeros(tg.n_nodes, 4, device="meta"))
