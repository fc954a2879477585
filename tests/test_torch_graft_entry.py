"""Port parity: ``kgat_tpu_torch.graft_entry`` against ``__graft_entry__.py``.

``entry()``'s scores against the JAX entry's on the same parameters
(``params_from_jax``), the tiny CKG edge for edge, and
``dryrun_multichip`` on the CPU (every partition on the CPU, the plain
versions), whose comparisons must hold and must bite.
"""

import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from kgat_tpu.graph import host_array
from kgat_tpu_torch import graft_entry
from kgat_tpu_torch.models.kgat import KGATConfig, params_from_jax
from kgat_tpu_torch.parallel import halo

import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as jge  # noqa: E402

COMPARISONS = {"ring_ppermute", "ring_dma", "a2a", "mesh_2d",
               "hopper_vs_ref"}


def test_entry_matches_jax():
    jfn, (params, users, items) = jge.entry()
    want = np.asarray(jax.jit(jfn)(params, users, items))
    fn, (_, tu, ti) = graft_entry.entry(device="cpu")
    model = params_from_jax(jax.tree.map(np.asarray, params), KGATConfig())
    got = fn(model, tu, ti).detach().numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_tiny_setup_graph_matches_jax():
    _, jg, jmeta, _, _ = jge._tiny_setup()
    _, tg, tmeta, cfg, model = graft_entry._tiny_setup(device="cpu")
    assert vars(tmeta) == vars(jmeta)
    assert tg.n_edges == jg.n_edges and tg.n_nodes == jg.n_nodes
    for f in ("src", "dst", "etype"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      host_array(jg, f)[: jg.n_edges], f)
    assert (cfg.embed_dim, cfg.conv_dims, cfg.aggregator, cfg.ops_backend) \
        == (64, (64, 32, 16), "bi-interaction", "ref")
    assert model.entity_embed.shape == (tmeta.n_nodes, 64)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_holds_every_exchange(n):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert set(out["ratios"]) == COMPARISONS
    assert all(r <= 1.0 for r in out["ratios"].values()), out["ratios"]
    for key in ("cf_loss", "kg_loss", "cf_scan4", "kg_scan4", "cf_loss_2d",
                "cf_loss_hopper"):
        assert np.isfinite(out[key]), key
    # One step of BPR and of TransR from a random model: near ln 2.
    assert 0.2 < out["cf_loss"] < 1.0 and 0.4 < out["kg_loss"] < 1.0


def test_a2a_check_bites():
    """One received halo row of partition 0's layer table, moved by 1e-2,
    fails the a2a comparison."""
    tables_of = halo.Partitioned._a2a_tables

    def perturbed(self, d, egos):
        tables = tables_of(self, d, egos)
        R, N = self.info.rows_per_part, self.info.n_nodes_global
        ids = self.halos[d][0].local_ids
        slot = R + int(torch.nonzero(ids[R:] < N)[0])
        tables[0] = tables[0].clone()
        tables[0][slot] += 1e-2
        return tables

    with mock.patch.object(halo.Partitioned, "_a2a_tables", perturbed), \
            pytest.raises(AssertionError, match="^a2a: max abs err"):
        graft_entry.dryrun_multichip(4, device="cpu")


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4)


def test_main_on_the_cpu_with_an_odd_count(capsys):
    assert graft_entry.main(["--device", "cpu", "--n-devices", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "entry forward: (16,) torch.float32"
    assert lines[1].startswith("dryrun_multichip(3): ")
    assert "2d mesh skipped" in lines[1]
