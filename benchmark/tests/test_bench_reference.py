"""The reference against the port's plain path at a tiny size, part by
part: the CKG, the attention, the serving forward, and a training step's
loss and gradients."""

import numpy as np
import torch

import tiny
from benchmark import dataset, reference, train_cell, weights
from kgat_tpu_torch.graph import EdgeWeights
from kgat_tpu_torch.models import kgat


def _setup(tmp_path, compute_dtype="bf16"):
    root = tiny.make_root(tmp_path)
    ctx = tiny.context(root, "tiny-train")
    cfg = ctx.config
    cfg["model"]["compute_dtype"] = compute_dtype
    data = dataset.load(cfg["name"], cfg["data"], ctx.cache_dir)
    graph, meta = data.program_dataset().build()
    kcfg = train_cell.model_config(cfg)
    model = kgat.KGAT(meta.n_nodes, meta.n_relations, kcfg)
    w = weights.make(5, 0, weights.leaf_shapes(cfg["model"], data.n_nodes,
                                               data.n_relations), "cpu")
    weights.copy_into(model, w)
    g = train_cell.reference_graph(data, cfg["model"], "cpu")
    return cfg, data, graph, meta, kcfg, model, w, g


def _by_edge(src, dst, ety, vals):
    return {(int(a), int(b), int(c)): v
            for a, b, c, v in zip(src, dst, ety, vals)}


def test_the_ckg_and_the_attention_agree(tmp_path):
    cfg, data, graph, meta, kcfg, model, w, g = _setup(tmp_path)
    assert (data.n_nodes, data.n_relations) == (meta.n_nodes,
                                               meta.n_relations)
    with torch.no_grad():
        want = kgat.compute_attention(model, graph, kcfg).numpy()
    got = reference.attention(w, g, reference.precision_of(cfg["model"]))
    a = _by_edge(graph.src.numpy(), graph.dst.numpy(), graph.etype.numpy(),
                 want)
    b = _by_edge(*data.ckg, got.numpy())
    assert a.keys() == b.keys()
    keys = sorted(a)
    np.testing.assert_allclose([a[k] for k in keys], [b[k] for k in keys],
                               rtol=1e-5, atol=1e-7)


def test_the_serving_forward_agrees(tmp_path):
    cfg, data, graph, meta, kcfg, model, w, g = _setup(tmp_path)
    with torch.no_grad():
        want = model(graph, kcfg)
    got = reference.serve_embed(w, g, cfg["model"],
                                reference.precision_of(cfg["model"]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_a_cf_step_agrees_in_float32(tmp_path):
    """Loss and every leaf's gradient of one CF step, with the staged
    (coalesced) weights, in float32 and in the bf16 stream."""
    for dtype in (None, "bf16"):
        cfg, data, graph, meta, kcfg, model, w, g = _setup(tmp_path / str(dtype),
                                                           dtype)
        prec = reference.precision_of(cfg["model"])
        gen = torch.Generator().manual_seed(3)
        B = 64
        u = torch.randint(0, data.n_users, (B,), generator=gen)
        ip = torch.randint(0, data.n_items, (B,), generator=gen)
        ineg = torch.randint(0, data.n_items, (B,), generator=gen)
        wt = torch.ones(B)
        masks = kgat.dropout_masks(kcfg, meta.n_nodes, gen, "cpu")
        staged = kgat.attention_for_training(model, graph, kcfg)
        assert isinstance(staged, EdgeWeights)
        loss = kgat.cf_loss(model, graph, staged, meta, u, ip, ineg, kcfg,
                            train=True, weight=wt, masks=masks)
        loss.backward()
        ref = reference.train_steps(
            w, g, {"n_nodes": data.n_nodes, "n_entities": data.n_entities},
            [("cf", (u, ip, ineg, wt), masks)], cfg["model"], 1e-4, prec)
        loss = float(loss.detach())
        assert abs(loss - ref["losses"][0]) <= 1e-6 * abs(loss)
        for name, p in model.named_parameters():
            # An entry that cancels to near zero is held to the leaf's
            # scale, not to its own.
            want = torch.zeros_like(p) if p.grad is None else p.grad
            scale = float(want.abs().max())
            torch.testing.assert_close(ref["grads"][0][name], want,
                                       rtol=1e-4, atol=1e-5 * scale)
