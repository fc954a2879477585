"""Port parity of the training gradients: the SpMM's backward (K1 on the
reverse CSR), the attention's (K4, K5), the losses and one Adam step,
against ``kgat_tpu`` on the same numpy-seeded inputs.

The port runs its plain versions (CPU tensors take them); the JAX side
runs its Pallas kernels in interpret mode or its ref backend, as its own
tests do. Everything is float32 with TF32 off; tolerances are stated per
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import build_graph as jbuild_graph
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.ops import ref as jref
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import EdgeWeights, build_graph
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops import hopper_backend, l2norm, ref
from kgat_tpu_torch.ops.hopper.sddmm import sddmm_transr_bwd_plain
from kgat_tpu_torch.ops.hopper.softmax import segment_softmax_csr_bwd_plain
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.train import make_optimizer

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def graphs():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, tmeta = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg, tmeta


@pytest.fixture(scope="module")
def hand():
    """Node 0 has no in-edge, node 1 one, node 2 a hub of 300; node 3 the
    source of a third of the edges (a hub of the reverse CSR)."""
    rs = np.random.default_rng(5)
    deg = np.concatenate([[0, 1, 300], rs.integers(0, 12, 30)])
    dst = np.repeat(np.arange(len(deg)), deg)
    src = rs.integers(0, len(deg), len(dst))
    src[rs.random(len(dst)) < 0.33] = 3
    ety = rs.integers(0, 3, len(dst))
    n = len(deg)
    return (jbuild_graph(src, dst, ety, n, 3),
            build_graph(src, dst, ety, n_nodes=n, n_relations=3))


def _pad(a, n_pad):
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def test_reverse_csr_lists_each_nodes_out_edges(hand):
    _, g = hand
    src, dst = g.src.numpy(), g.dst.numpy()
    perm, off = g.rev_perm.numpy(), g.rev_row_offsets.numpy()
    assert sorted(perm.tolist()) == list(range(g.n_edges))
    np.testing.assert_array_equal(g.rev_dst.numpy(), dst[perm])
    for u in range(g.n_nodes):
        row = perm[off[u]:off[u + 1]]
        np.testing.assert_array_equal(src[row], u)
        assert (np.diff(row) > 0).all()          # stable: canonical order
    assert off[-1] == g.n_edges
    assert np.diff(off).max() == (src == 3).sum()  # the reverse hub


@pytest.mark.parametrize("d", [64, 32])
def test_spmm_gradient_matches_jax(hand, d):
    """d/dx and d/dw of <spmm(w, x), cot> against jax.grad through the
    Pallas SpMM (whose d_x is the kernel on the reverse layout). Rows: an
    empty one, a one-edge one and a hub of 300. Tolerance: rtol 1e-4,
    atol 1e-5 (float32, other summation orders)."""
    jg, tg = hand
    rs = np.random.default_rng(d)
    w = rs.uniform(size=tg.n_edges).astype(np.float32)
    x = rs.normal(size=(tg.n_nodes, d)).astype(np.float32)
    cot = rs.normal(size=(tg.n_nodes, d)).astype(np.float32)

    def f(w_pad, xx):
        return jnp.vdot(pb.spmm(jg, w_pad, xx), jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        jw, jx = jax.grad(f, argnums=(0, 1))(
            jnp.asarray(_pad(w, jg.n_edges_pad)), jnp.asarray(x))
    for ops, ew in ((hopper_backend, EdgeWeights.stage(tg, torch.tensor(w))),
                    (hopper_backend, torch.tensor(w)), (ref, torch.tensor(w))):
        wt = (ew.fwd if isinstance(ew, EdgeWeights) else ew).requires_grad_()
        xt = torch.tensor(x, requires_grad=True)
        ew = EdgeWeights(wt, ew.rev) if isinstance(ew, EdgeWeights) else wt
        (ops.spmm(tg, ew, xt) * torch.tensor(cot)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(),
                                   np.asarray(jw)[: tg.n_edges],
                                   rtol=1e-4, atol=1e-5)
    # No out-edge, no gradient.
    no_out = np.diff(tg.rev_row_offsets.numpy()) == 0
    assert not xt.grad.numpy()[no_out].any()


def test_attention_gradients_match_jax(graphs):
    """grad of <softmax(logits), cot> w.r.t. entity_embed, w_rel and
    rel_embed, against jax.grad through kgat_tpu's pallas attention (the
    SDDMM and softmax VJP kernels, interpret mode), as
    test_pallas_attention_grads_match_ref does. Tolerance: rtol 1e-3, atol
    1e-5 (float32 through tanh and exp, other summation orders)."""
    jg, jmeta, tg, _ = graphs
    params = jkgat.init_params(jax.random.key(13), jmeta.n_nodes,
                               jmeta.n_relations, jkgat.KGATConfig())
    cot = np.random.default_rng(0).normal(size=tg.n_edges).astype(np.float32)
    jcfg = jkgat.KGATConfig(ops_backend="pallas")

    def f(p):
        att = jkgat.compute_attention(p, jg, jcfg)
        return jnp.vdot(att, jnp.asarray(_pad(cot, jg.n_edges_pad)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f)(params)
    np_params = jax.tree.map(np.asarray, params)
    for backend in ("hopper", "ref"):
        cfg = tkgat.KGATConfig(ops_backend=backend)
        model = tkgat.params_from_jax(np_params, cfg)
        (tkgat.compute_attention(model, tg, cfg)
         * torch.tensor(cot)).sum().backward()
        for name in ("entity_embed", "w_rel", "rel_embed"):
            np.testing.assert_allclose(
                getattr(model, name).grad.numpy(), np.asarray(want[name]),
                rtol=1e-3, atol=1e-5, err_msg=f"{backend} {name}")


def test_plain_k4_matches_jax_vjp(graphs):
    """sddmm_transr_bwd_plain against jax.vjp of kgat_tpu's ref attention
    logits with the same cotangent. Tolerance: rtol 1e-4, atol 1e-5."""
    jg, jmeta, tg, _ = graphs
    params = jkgat.init_params(jax.random.key(4), jmeta.n_nodes,
                               jmeta.n_relations, jkgat.KGATConfig())
    g = np.random.default_rng(1).normal(size=tg.n_edges).astype(np.float32)
    keys = ("entity_embed", "w_rel", "rel_embed")
    sub = {k: params[k] for k in keys}

    def logits(p):
        return jkgat.attention_logits({**params, **p}, jg,
                                      jkgat.KGATConfig(ops_backend="ref"))

    _, vjp = jax.vjp(logits, sub)
    (want,) = vjp(jnp.asarray(_pad(g, jg.n_edges_pad)))
    got = sddmm_transr_bwd_plain(tg, torch.tensor(g),
                                 *(torch.tensor(np.asarray(params[k]))
                                   for k in keys))
    for k, a in zip(keys, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_plain_k5_matches_jax_vjp(graphs):
    """segment_softmax_csr_bwd_plain against jax.vjp of kgat_tpu's ref
    segment softmax. Tolerance: rtol 1e-5, atol 1e-7."""
    jg, _, tg, _ = graphs
    rs = np.random.default_rng(2)
    logits = (3 * rs.normal(size=tg.n_edges)).astype(np.float32)
    g = rs.normal(size=tg.n_edges).astype(np.float32)
    w, vjp = jax.vjp(lambda lg: jref.segment_softmax(jg, lg),
                     jnp.asarray(_pad(logits, jg.n_edges_pad)))
    (want,) = vjp(jnp.asarray(_pad(g, jg.n_edges_pad)))
    got = segment_softmax_csr_bwd_plain(
        tg.row_offsets, torch.tensor(np.asarray(w)[: tg.n_edges]),
        torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[: tg.n_edges],
                               rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def loss_setup(graphs):
    jg, jmeta, tg, tmeta = graphs
    jcfg = jkgat.KGATConfig(mess_dropout=(0.0, 0.0, 0.0))
    params = jkgat.init_params(jax.random.key(6), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    att = np.asarray(jkgat.compute_attention(params, jg, jcfg))
    return jg, jmeta, tg, tmeta, jcfg, params, att


@pytest.mark.parametrize("weighted", [False, True])
def test_cf_loss_and_gradients_match_jax(loss_setup, weighted):
    """cf_loss value and gradients with dropout off (train=False), with and
    without the row weights. Tolerance: loss rtol 1e-5; gradients rtol
    1e-4, atol 1e-6."""
    jg, jmeta, tg, tmeta, jcfg, params, att = loss_setup
    rs = np.random.default_rng(3)
    u = rs.integers(0, jmeta.n_users, 32)
    ip = rs.integers(0, jmeta.n_items, 32)
    ineg = rs.integers(0, jmeta.n_items, 32)
    w = (rs.random(32) < 0.8).astype(np.float32) if weighted else None
    loss, grads = jax.value_and_grad(jkgat.cf_loss)(
        params, jg, jnp.asarray(att), jmeta, jnp.asarray(u), jnp.asarray(ip),
        jnp.asarray(ineg), jcfg, train=False,
        weight=None if w is None else jnp.asarray(w))
    for backend in ("hopper", "ref"):
        cfg = tkgat.KGATConfig(mess_dropout=(0.0, 0.0, 0.0),
                               ops_backend=backend)
        model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
        ew = EdgeWeights.stage(tg, torch.tensor(att[: tg.n_edges]))
        got = tkgat.cf_loss(model, tg, ew, tmeta, torch.tensor(u),
                            torch.tensor(ip), torch.tensor(ineg), cfg,
                            train=False,
                            weight=None if w is None else torch.tensor(w))
        got.backward()
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
        _assert_grads_match(model, grads)
        assert model.w_rel.grad is None and model.rel_embed.grad is None


def _assert_grads_match(model, grads, rtol=1e-4, atol=1e-6):
    want = jax.tree.map(np.asarray, grads)
    for name, p in model.named_parameters():
        node = want
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        got = (np.zeros_like(node) if p.grad is None else p.grad.numpy())
        np.testing.assert_allclose(got, node, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_kg_loss_and_gradients_match_jax(loss_setup):
    """kg_loss value and gradients (entity_embed, w_rel, rel_embed), with
    and without row weights. Tolerance: loss rtol 1e-5; gradients rtol
    1e-4, atol 1e-6."""
    _, jmeta, _, _, jcfg, params, _ = loss_setup
    rs = np.random.default_rng(4)
    b = 64
    h, tp, tn = (rs.integers(0, jmeta.n_nodes, b) for _ in range(3))
    r = rs.integers(0, jmeta.n_relations, b)
    for w in (None, (rs.random(b) < 0.7).astype(np.float32)):
        loss, grads = jax.value_and_grad(jkgat.kg_loss)(
            params, *map(jnp.asarray, (h, r, tp, tn)), jcfg,
            weight=None if w is None else jnp.asarray(w))
        model = tkgat.params_from_jax(jax.tree.map(np.asarray, params),
                                      tkgat.KGATConfig())
        got = tkgat.kg_loss(model, *map(torch.tensor, (h, r, tp, tn)),
                            tkgat.KGATConfig(),
                            weight=None if w is None else torch.tensor(w))
        got.backward()
        np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
        _assert_grads_match(model, grads)


def test_dropout_scales_the_layer_output_before_the_norm(graphs):
    """propagate(train=True): the mask (keep 1 - p) and the 1/keep scale
    apply to the layer output that feeds the next layer; the concat holds
    its L2-normalised copy (kgat_tpu.models.kgat.propagate's order)."""
    _, _, tg, tmeta = graphs
    cfg = tkgat.KGATConfig(aggregator="gcn", conv_dims=(16,),
                           mess_dropout=(0.3,))
    model = tkgat.init_params(tmeta.n_nodes, tmeta.n_relations, cfg,
                              generator=torch.Generator().manual_seed(0))
    att = torch.rand(tg.n_edges, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = tkgat.propagate(model, tg, att, cfg, train=True,
                              generator=torch.Generator().manual_seed(2))
        full = tkgat.propagate(model, tg, att, cfg)[:, 64:]
        layer = model.layers[0]
        ego = ref.leaky((model.entity_embed + ref.spmm(tg, att,
                                                       model.entity_embed))
                        @ layer["w"] + layer["b"], cfg.leaky_relu_slope)
        keep = torch.rand(ego.shape,
                          generator=torch.Generator().manual_seed(2)) < 0.7
        want = l2norm(torch.where(keep, ego / 0.7, 0.0))
    torch.testing.assert_close(got[:, 64:], want)
    torch.testing.assert_close(l2norm(ego), full)
    assert 0.6 < keep.float().mean() < 0.8
    with pytest.raises(ValueError, match="generator"):
        tkgat.propagate(model, tg, att, cfg, train=True)


def test_adam_step_matches_optax():
    """make_optimizer's Adam against optax.adam on identical gradients over
    three steps, with one leaf whose gradient is always zero (it still
    steps: its moments decay from the first step's zero, so it stays, as
    optax's does) and one zero only at the second step. Tolerance: rtol
    1e-5, atol 1e-7 (float32; the bias corrections are applied in another
    order)."""
    rs = np.random.default_rng(0)
    p0 = {"a": rs.normal(size=(5, 3)).astype(np.float32),
          "z": rs.normal(size=4).astype(np.float32),
          "b": rs.normal(size=7).astype(np.float32)}
    grads = [{k: rs.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    for g in grads:
        g["z"][:] = 0.0
    grads[1]["b"][:] = 0.0
    opt = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = make_optimizer(tp.values(), 1e-2)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad(set_to_none=False)
        for k, p in tp.items():
            p.grad.add_(torch.tensor(g[k]))
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    steps = {int(topt.state[p]["step"]) for p in tp.values()}
    assert steps == {3} and int(state[0].count) == 3


# Leaves of the alternating-phase Adam test: the entity table, which both
# phases reach, a conv weight only the CF-like phase reaches and a relation
# table only the KG-like phase reaches.
PHASE_LEAVES = {"entity": (9, 4), "conv": (4, 3), "rel": (3, 4)}
PHASE_REACHES = {"cf": ("entity", "conv"), "kg": ("entity", "rel")}


@pytest.mark.parametrize("entity_route", ["dense", "gathered_rows"])
def test_adam_alternating_phases_match_optax(entity_route):
    """make_optimizer's Adam against optax.adam over six steps that
    alternate a CF-like and a KG-like set of reached leaves: a leaf the
    phase does not reach steps with a zero gradient (its moments decay,
    it still moves), and every leaf counts each step, as optax's one
    count does. ``gathered_rows``: the KG-like phase's entity gradient
    comes as the trainer's KG step delivers it, through
    ``hopper_backend.gather_rows`` with a sparse gradient (duplicate ids
    included) added into the persistent ``.grad``. Tolerance: rtol 1e-5
    and, for the parameters, atol 1e-6: optax rounds its bias correction
    1 - 0.999^t in float32, which loses three digits, and its updates (of
    size lr, 1e-2) drift from float64's by some 1e-7 a step here; the
    port's keep within 2e-8."""
    rs = np.random.default_rng(7)
    p0 = {k: rs.normal(size=s).astype(np.float32)
          for k, s in PHASE_LEAVES.items()}
    opt = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = make_optimizer(tp.values(), 1e-2)
    grad_ptrs = {k: p.grad.data_ptr() for k, p in tp.items()}
    for step in range(6):
        phase = ("cf", "kg")[step % 2]
        g = {k: np.zeros(s, np.float32) for k, s in PHASE_LEAVES.items()}
        for k in PHASE_REACHES[phase]:
            g[k] = rs.normal(size=PHASE_LEAVES[k]).astype(np.float32)
        topt.zero_grad(set_to_none=False)
        if phase == "kg" and entity_route == "gathered_rows":
            ids = [torch.tensor(rs.integers(0, 9, 5)) for _ in range(3)]
            ids[1][0] = ids[0][0]                    # a duplicate id
            cots = rs.normal(size=(15, 4)).astype(np.float32)
            g["entity"][:] = 0.0
            np.add.at(g["entity"], torch.cat(ids).numpy(), cots)
            rows = hopper_backend.gather_rows(tp["entity"], ids)
            (torch.cat(rows) * torch.tensor(cots)).sum().backward()
            tp["rel"].grad.add_(torch.tensor(g["rel"]))
        else:
            for k in PHASE_REACHES[phase]:
                tp[k].grad.add_(torch.tensor(g[k]))
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, upd)
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}, step {step}")
            assert tp[k].grad.layout == torch.strided
            assert tp[k].grad.data_ptr() == grad_ptrs[k]
        for k, jm in (("exp_avg", state[0].mu), ("exp_avg_sq", state[0].nu)):
            for name, p in tp.items():
                np.testing.assert_allclose(
                    topt.state[p][k].numpy(), np.asarray(jm[name]),
                    rtol=1e-5, atol=1e-12, err_msg=f"{k} {name}")
        steps = {int(topt.state[p]["step"]) for p in tp.values()}
        assert steps == {step + 1} == {int(state[0].count)}


@pytest.mark.parametrize("grad", ["none", "persistent", "flat_view"])
def test_one_gather_gives_the_three_gathers_gradient(grad):
    """``hopper_backend.gather_rows`` over (h, t+, t-) against ``emb[h]``,
    ``emb[t_pos]``, ``emb[t_neg]``: the same rows, and the same gradient,
    duplicate ids summed (ids repeat within each tensor and across
    them), into no ``.grad`` (it is then a sparse tensor), into a
    persistent dense ``.grad`` or into a view of a flat buffer, as
    ``multihost.GradSum`` makes them: both keep their address and layout,
    and the flat buffer's other entries stay as they were. Tolerance:
    float64, rtol 1e-12 (the duplicates' sums in another order)."""
    gen = torch.Generator().manual_seed(0)
    n, d, b = 12, 5, 16
    base = torch.randn(n, d, generator=gen, dtype=torch.float64)
    h, tp, tn = (torch.randint(0, n, (b,), generator=gen) for _ in range(3))
    tp[:4] = h[:4]
    cots = [torch.randn(b, d, generator=gen, dtype=torch.float64)
            for _ in range(3)]
    ref_emb = base.clone().requires_grad_()
    sum((ref_emb[i] * c).sum() for i, c in zip((h, tp, tn), cots)).backward()
    emb = base.clone().requires_grad_()
    flat = None
    if grad == "persistent":
        emb.grad = torch.zeros_like(emb)
    elif grad == "flat_view":
        flat = torch.full((3 + n * d + 2,), 7.0, dtype=torch.float64)
        emb.grad = flat[3:3 + n * d].view_as(emb).zero_()
    ptr = None if emb.grad is None else emb.grad.data_ptr()
    rows = hopper_backend.gather_rows(emb, (h, tp, tn))
    for r, i in zip(rows, (h, tp, tn)):
        assert torch.equal(r, base[i])
    sum((r * c).sum() for r, c in zip(rows, cots)).backward()
    got = emb.grad
    if ptr is None:
        assert got.is_sparse
        got = got.to_dense()
    else:
        assert got.layout == torch.strided and got.data_ptr() == ptr
    torch.testing.assert_close(got, ref_emb.grad, rtol=1e-12, atol=0)
    if flat is not None:
        assert (flat[:3] == 7.0).all() and (flat[3 + n * d:] == 7.0).all()


def test_the_adam_kernel_refuses_cpu_tensors():
    """``ops.hopper.adam.plan_for``, the Adam kernel's tables, takes float32
    tensors on one CUDA device alone: CPU tensors are refused before any
    build (``optim.make_optimizer`` keeps ``torch.optim.Adam`` there)."""
    from kgat_tpu_torch.ops.hopper import adam
    p = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        adam.plan_for([p], [torch.zeros_like(p)], [torch.zeros_like(p)],
                      [torch.zeros_like(p)], torch.zeros(()))
    assert type(make_optimizer([p.requires_grad_()], 1e-3)) is \
        torch.optim.Adam
