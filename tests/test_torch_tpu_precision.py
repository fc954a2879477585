"""tools/tpu_default_precision.py: the three products at a TPU's DEFAULT
float32 precision (bf16-rounded operands, float32 accumulation), forward
and backward, and the trainer run through it."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kgat_tpu_torch.data import synthetic_dataset
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops import hopper_backend, ref

import torch_threads  # one intra-op thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import tpu_default_precision as tdp  # noqa: E402


def _r64(t):
    return tdp.bf16_round(t).double()


def test_bf16_round_is_nearest_even_and_idempotent():
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9])
    np.testing.assert_array_equal(tdp.bf16_round(x).numpy(),
                                  [1.0, 1.0 + 2.0 ** -6, 1.0])
    y = torch.randn(100)
    assert torch.equal(tdp.bf16_round(tdp.bf16_round(y)), tdp.bf16_round(y))


@pytest.mark.parametrize("spec,sa,sb", [("nd,de->ne", (40, 16), (16, 8)),
                                        ("bd,bdk->bk", (12, 16), (12, 16, 8))])
def test_one_pass_products_and_their_gradients(spec, sa, sb):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(sa, generator=g, requires_grad=True)
    b = torch.randn(sb, generator=g, requires_grad=True)
    out = tdp.one_pass(spec, a, b)
    want = torch.einsum(spec, _r64(a), _r64(b))
    torch.testing.assert_close(out.double(), want, rtol=1e-6, atol=1e-6)
    # Not the float32 product: the rounding is there.
    assert (out - torch.einsum(spec, a, b)).abs().max() > 1e-4
    cot = torch.randn(out.shape, generator=g)
    ga, gb = torch.autograd.grad(out, (a, b), cot)
    ins, o = spec.split("->")
    s_a, s_b = ins.split(",")
    torch.testing.assert_close(
        ga.double(), torch.einsum(f"{o},{s_b}->{s_a}", _r64(cot), _r64(b)),
        rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        gb.double(), torch.einsum(f"{s_a},{o}->{s_b}", _r64(a), _r64(cot)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["gcn", "graphsage", "bi-interaction"])
def test_aggregate_rounds_only_the_dense_products(agg):
    cfg = KGATConfig(aggregator=agg, embed_dim=16, conv_dims=(8,))
    g = torch.Generator().manual_seed(1)
    ego, side = torch.randn(30, 16, generator=g), torch.randn(30, 16,
                                                              generator=g)
    d_in = 32 if agg == "graphsage" else 16
    layer = {k: torch.randn((d_in, 8) if k[0] == "w" else (8,), generator=g)
             for k in (("w", "b") if agg != "bi-interaction"
                       else ("w1", "b1", "w2", "b2"))}
    rounded = {k: tdp.bf16_round(v) if k[0] == "w" else v
               for k, v in layer.items()}
    if agg == "graphsage":
        x = tdp.bf16_round(torch.cat([ego, side], -1))
        want = ref.leaky(x @ rounded["w"] + rounded["b"], 0.2)
    elif agg == "gcn":
        want = ref.leaky(tdp.bf16_round(ego + side) @ rounded["w"]
                           + rounded["b"], 0.2)
    else:
        want = (ref.leaky(tdp.bf16_round(ego + side) @ rounded["w1"]
                            + rounded["b1"], 0.2)
                + ref.leaky(tdp.bf16_round(ego * side) @ rounded["w2"]
                              + rounded["b2"], 0.2))
    torch.testing.assert_close(tdp.aggregate(ego, side, layer, cfg), want,
                               rtol=1e-6, atol=1e-6)


def test_kg_terms_project_with_rounded_operands(monkeypatch):
    """With ``ref.project_rows`` replaced, the row-based KG terms (the ref
    backend's and the ``--sparse-adam`` step's) are those of the rounded
    operands."""
    g = torch.Generator().manual_seed(2)
    eh, ep, en = (torch.randn(10, 16, generator=g) for _ in range(3))
    e_r, w_r = torch.randn(10, 8, generator=g), torch.randn(10, 16, 8,
                                                            generator=g)
    r = tdp.bf16_round
    want = kgat.kg_pair_terms_rows(r(eh), r(ep), r(en), e_r, r(w_r))
    monkeypatch.setattr(ref, "project_rows", tdp.project_rows)
    pair, ssq = kgat.kg_pair_terms_rows(eh, ep, en, e_r, w_r)
    torch.testing.assert_close(pair, want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssq, want[1], rtol=1e-5, atol=1e-6)


def test_hopper_kg_route_projects_with_rounded_operands(monkeypatch):
    """On the hopper backend the KG loss goes through the backend's TransR
    projection; with the tool's replacements it gives the tool's rounded
    KG terms, as on the ref backend."""
    for module, name, fn in tdp.patches():
        monkeypatch.setattr(module, name, fn)
    assert hopper_backend.kg_projection is ref.kg_projection
    cfg = KGATConfig(embed_dim=16, relation_dim=8, ops_backend="hopper")
    model = kgat.init_params(30, 5, cfg,
                             generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    h, r, tp, tn = (torch.randint(0, n, (12,), generator=g)
                    for n in (30, 5, 30, 30))
    pair, ssq = kgat.kg_pair_terms(model, h, r, tp, tn, cfg)
    emb = model.entity_embed
    want = kgat.kg_pair_terms_projected(
        *tdp.project_rows(emb[h], emb[tp], emb[tn], model.w_rel[r]),
        model.rel_embed[r])
    assert torch.equal(pair, want[0]) and torch.equal(ssq, want[1])


def test_hopper_layers_take_the_rounded_aggregator(monkeypatch):
    """With the tool's replacements the hopper backend's layer call and
    CF-loss rows are ``ref``'s (on the card they would be its float32
    layer op), so the serving forward and the CF loss reach the rounded
    aggregator once per layer, and the hopper backend's CF loss is the
    ref backend's, bit for bit."""
    for module, name, fn in tdp.patches():
        monkeypatch.setattr(module, name, fn)
    assert hopper_backend.layer is ref.layer
    assert hopper_backend.representation_rows is ref.representation_rows
    calls = []

    def counted(ego, side, layer, cfg):
        calls.append(ego.shape)
        return tdp.aggregate(ego, side, layer, cfg)
    monkeypatch.setattr(ref, "aggregate", counted)
    ds = synthetic_dataset(seed=3, n_users=40, n_items=30, n_entities=60,
                           n_relations_kg=3, n_interactions=400,
                           n_triples=300)
    graph, meta = ds.build()
    cfg = KGATConfig(embed_dim=16, relation_dim=8, conv_dims=(16, 8),
                     mess_dropout=(0.1, 0.1), ops_backend="hopper")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        att = kgat.compute_attention(model, graph, cfg)
    kgat.propagate(model, graph, att, cfg)
    assert len(calls) == 2
    gen = torch.Generator().manual_seed(6)
    u, ip, ineg = (torch.randint(0, n, (8,), generator=gen)
                   for n in (meta.n_users, meta.n_items, meta.n_items))
    masks = kgat.dropout_masks(cfg, meta.n_nodes,
                               torch.Generator().manual_seed(7), "cpu")
    loss = kgat.cf_loss(model, graph, att, meta, u, ip, ineg, cfg,
                        masks=masks)
    assert len(calls) == 4
    want = kgat.cf_loss(model, graph, att, meta, u, ip, ineg,
                        dataclasses.replace(cfg, ops_backend="ref"),
                        masks=masks)
    assert torch.equal(loss, want)


def test_trainer_runs_through_the_tool(tmp_path):
    """One CPU epoch through the script, whose log ends in an eval and a
    ``done`` event, with its replacements (the three products and the
    hopper backend's three float32 model ops, none twice) installed in its
    process and the package itself untouched here."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "tpu_default_precision.py"),
         "--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
         "--eval-every", "1", "--ops-backend", "hopper", "--compute-dtype",
         "bf16", "--log-dir", str(tmp_path), "--run-name", "tp"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=torch_threads.one_thread_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    events = [json.loads(ln) for ln in open(tmp_path / "tp.jsonl")]
    assert [e["event"] for e in events][-2:] == ["eval", "done"]
    assert np.isfinite(events[-2]["recall"])
    targets = [(m.__name__, name) for m, name, _ in tdp.patches()]
    assert sorted(targets) == sorted([
        ("kgat_tpu_torch.ops.ref", "aggregate"),
        ("kgat_tpu_torch.ops.ref", "project_rows"),
        ("kgat_tpu_torch.eval", "evaluate"),
        ("kgat_tpu_torch.ops.hopper_backend", "layer"),
        ("kgat_tpu_torch.ops.hopper_backend", "representation_rows"),
        ("kgat_tpu_torch.ops.hopper_backend", "kg_projection")])
    for module, name, fn in tdp.patches():
        assert getattr(module, name) is not fn
