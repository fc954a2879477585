"""The CF step's bi-interaction layer op (``ops/hopper/bi_layer.py``) on
the CPU.

The op's plain versions, the references its kernels are held to on the
card: the forward is ``ops.ref``'s ``aggregate`` and
``apply_dropout``, and the backward, from its output's gradient given in
pieces (a dense piece, another, and rows through a slot map), is
autograd's through that chain and ``l2norm``, in float64, for the three
layer shapes of the reference recipe, with and without a mask and with
and without the value stream's copy, over a zero row and a row at
``l2norm``'s clamp. The rows-only CF loss (``bi_layer.propagate_rows``,
the hopper backend's CF rows on the card: the whole training propagation
as one op, the normalised concat formed at the batch's rows alone)
against the full concat's loss and every gradient, for a batch with
repeated users and items. The partitioned CF
step applies the masks that its partitions' generators give when drawn
again from their states. The kernels run in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import pytest
import torch

from kgat_tpu_torch import train
from kgat_tpu_torch.data import synthetic_dataset
from kgat_tpu_torch.graph import EdgeWeights
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops import hopper_backend, l2norm, ref
from kgat_tpu_torch.ops.hopper import bi_layer
from kgat_tpu_torch.utils.config import TrainConfig

import torch_threads  # noqa: F401  (one intra-op thread)

SLOPE, RATE = 0.2, 0.1
F64 = dict(dtype=torch.float64)


def _layer_inputs(d_in, d_out, n=37, seed=0):
    """x, side (n, d_in), w1, b1, w2, b2 in float64; row 0 of x and side
    is zero, and the biases are chosen so that its output is 0 (l2norm's
    clamp): b1 > 0 and b2 = -b1 / slope."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d_in, generator=g, **F64)
    side = torch.randn(n, d_in, generator=g, **F64)
    x[0] = side[0] = 0
    w1 = torch.randn(d_in, d_out, generator=g, **F64) / d_in ** 0.5
    w2 = torch.randn(d_in, d_out, generator=g, **F64) / d_in ** 0.5
    b1 = torch.rand(d_out, generator=g, **F64) + 0.1
    b2 = -b1 / SLOPE
    return x, side, w1, b1, w2, b2


def _cfg():
    return kgat.KGATConfig(aggregator="bi-interaction",
                           leaky_relu_slope=SLOPE)


@pytest.mark.parametrize("copy", [False, True], ids=["no_copy", "copy"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("d_in,d_out", [(64, 64), (64, 32), (32, 16)])
def test_plain_layer_holds_to_the_autograd_chain(d_in, d_out, masked, copy):
    x, side, w1, b1, w2, b2 = _layer_inputs(d_in, d_out)
    n = x.shape[0]
    mask = None
    if masked:
        mask = torch.rand(n, d_out, generator=torch.Generator().manual_seed(
            1)) < 1 - RATE
        mask[1] = False                    # a row dropped whole: 0
    leaves = [t.clone().requires_grad_(True) for t in
              (x, side, w1, b1, w2, b2)]
    lx, ls, lw1, lb1, lw2, lb2 = leaves
    layer = {"w1": lw1, "b1": lb1, "w2": lw2, "b2": lb2}
    y = ref.aggregate(lx, ls, layer, _cfg())
    if mask is not None:
        y = ref.apply_dropout(y, mask, RATE)
    # Today's chain: the output feeds the next layer (one cotangent) and
    # the concat through l2norm (another).
    g = torch.Generator().manual_seed(2)
    r_next = torch.randn(n, d_out, generator=g, **F64)
    r_cat = torch.randn(n, d_out, generator=g, **F64)
    normed = l2norm(y)
    assert float((y[0].detach() ** 2).sum()) < 1e-12
    loss = (y * r_next).sum() + (normed * r_cat).sum()
    want = torch.autograd.grad(loss, leaves, retain_graph=True)
    g_cat = torch.autograd.grad((normed * r_cat).sum(), y)[0]

    got, yv = bi_layer.bi_layer_forward(x, side, mask, w1, b1, w2, b2, RATE,
                                        SLOPE, torch.bfloat16 if copy
                                        else None)
    assert torch.equal(got, y.detach())
    assert torch.equal(bi_layer.bi_layer_forward_plain(
        x, side, mask, w1, b1, w2, b2, RATE, SLOPE), got)
    assert (yv is None) != copy
    if copy:
        assert torch.equal(yv, got.to(torch.bfloat16))
    # The output's gradient as the kernel takes it: the next layer's piece
    # whole; the concat's at every other row as a second piece, and at the
    # rest through the slot map into a compact table of rows (at column
    # 3 of 3 + d_out + 2).
    picked = torch.arange(0, n, 3)
    slot = torch.full((n,), -1, dtype=torch.int32)
    slot[picked] = torch.arange(picked.numel(), dtype=torch.int32)
    rows = torch.randn(picked.numel(), 3 + d_out + 2, **F64)
    rows[:, 3:3 + d_out] = g_cat[picked]
    g_b = g_cat.clone()
    g_b[picked] = 0
    side_dtype = torch.bfloat16 if copy else None
    d_x, d_s, *d_w = bi_layer.bi_layer_backward(
        x, side, mask, w1, b1, w2, b2, RATE, SLOPE, r_next, g_b, slot, rows,
        3, side_dtype)
    torch.testing.assert_close(d_x, want[0], rtol=1e-12, atol=1e-12)
    if copy:
        assert d_s.dtype == torch.bfloat16
        torch.testing.assert_close(d_s, want[1].to(torch.bfloat16))
    else:
        torch.testing.assert_close(d_s, want[1], rtol=1e-12, atol=1e-12)
    for got_w, want_w in zip(d_w, want[2:]):
        torch.testing.assert_close(got_w, want_w, rtol=1e-12, atol=1e-12)
    # The differentiable op on the CPU: the same gradients.
    leaves2 = [t.clone().requires_grad_(True) for t in
               (x, side, w1, b1, w2, b2)]
    out = bi_layer.bi_layer(leaves2[0], leaves2[1], mask, dict(zip(
        ("w1", "b1", "w2", "b2"), leaves2[2:])), RATE if masked else 0.0,
        SLOPE)
    loss2 = (out * r_next).sum() + (l2norm(out) * r_cat).sum()
    for a, b in zip(torch.autograd.grad(loss2, leaves2), want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_plain_sum_of_pieces():
    """``grad_sum`` on the CPU: the pieces added, a row the slot map leaves
    out taking the dense pieces alone, and a bf16 copy of one piece."""
    g = torch.Generator().manual_seed(0)
    a, b = (torch.randn(5, 4, generator=g) for _ in range(2))
    rows = torch.randn(2, 9, generator=g)
    slot = torch.tensor([1, -1, 0, -1, -1], dtype=torch.int32)
    got = bi_layer.grad_sum(a, b, slot, rows, 2, 5, 4)
    want = a + b
    want[0] += rows[1, 2:6]
    want[2] += rows[0, 2:6]
    torch.testing.assert_close(got, want)
    assert torch.equal(bi_layer.grad_sum(a, None, None, None, 0, 5, 4,
                                         torch.bfloat16),
                       a.to(torch.bfloat16))


def _small_setup(dtype):
    ds = synthetic_dataset(seed=3, n_users=50, n_items=40, n_entities=80,
                           n_relations_kg=4, n_interactions=600,
                           n_triples=400)
    g, meta = ds.build()
    cfg = kgat.KGATConfig(embed_dim=16, relation_dim=16,
                          conv_dims=(16, 8, 4), mess_dropout=(0.1, 0.2, 0.1),
                          ops_backend="hopper", coalesce=False)
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(0))
    model = model.to(dtype)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(4)
        for layer in model.layers:
            layer["b1"].copy_(torch.rand(layer["b1"].shape, generator=gen)
                              - 0.5)
            layer["b2"].copy_(torch.rand(layer["b2"].shape, generator=gen)
                              - 0.5)
        att = kgat.compute_attention(model, g, cfg)
    return g, meta, cfg, model, EdgeWeights.stage(g, att)


def _grads(model, loss_fn):
    model.zero_grad(set_to_none=False)
    loss = loss_fn()
    loss.backward()
    return loss.detach(), {
        n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype,compute,tol", [
    (torch.float64, None, 1e-12), (torch.float32, None, 2e-5),
    (torch.float32, torch.bfloat16, 2e-5)],
    ids=["float64", "float32", "float32_bf16_stream"])
def test_rows_only_cf_loss_matches_the_full_concat(dtype, compute, tol):
    """The loss and every parameter's gradient of the layer op's rows-only
    BPR loss (``bi_layer.propagate_rows``: the whole propagation as
    one op, its plain pieces on the CPU) against the BPR loss of
    ``propagate``'s (n_nodes, out_dim) concat, on a batch whose users and
    items repeat (a user twice, an item as two positives and as a
    negative), with weights; ``cf_loss`` with CPU tensors is that full
    concat's loss and gradients, bit for bit. Under a bf16 value stream
    the op rounds K1's reverse output to bf16 where autograd's cast of
    the stream did."""
    g, meta, cfg, model, ew = _small_setup(dtype)
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    gen = torch.Generator().manual_seed(1)
    B = 16
    u = torch.randint(0, meta.n_users, (B,), generator=gen)
    ip = torch.randint(0, meta.n_items, (B,), generator=gen)
    ineg = torch.randint(0, meta.n_items, (B,), generator=gen)
    u[1] = u[0]
    ip[2] = ip[0]
    ineg[3] = ip[0]
    w = torch.rand(B, generator=gen, dtype=dtype)
    masks = kgat.dropout_masks(cfg, meta.n_nodes,
                               torch.Generator().manual_seed(5), "cpu")

    def full_concat():
        all_embed = kgat.propagate(model, g, ew, cfg, train=True,
                                   masks=masks)
        return kgat.bpr_loss(all_embed[meta.user_node(u)], all_embed[ip],
                             all_embed[ineg], cfg, w)
    l_full, g_full = _grads(model, full_concat)
    l_cf, g_cf = _grads(model, lambda: kgat.cf_loss(
        model, g, ew, meta, u, ip, ineg, cfg, weight=w, masks=masks))
    assert torch.equal(l_cf, l_full)
    for name, want in g_full.items():
        assert torch.equal(g_cf[name], want), name
    l_rows, g_rows = _grads(model, lambda: kgat.bpr_loss(
        *bi_layer.propagate_rows(model, g, ew, cfg, masks,
                                 (meta.user_node(u), ip, ineg)),
        cfg, w))
    torch.testing.assert_close(l_rows, l_full, rtol=tol, atol=tol)
    for name, want in g_full.items():
        scale = float(want.abs().max()) or 1.0
        torch.testing.assert_close(g_rows[name], want, rtol=tol,
                                   atol=tol * scale, msg=name)


@pytest.mark.parametrize("exchange", ["allgather", "a2a"])
def test_partitioned_cf_step_applies_masks_redrawn_from_generator_states(
        monkeypatch, exchange):
    """The partitioned trainer's CF step draws each partition's (rows,
    d_out) keep mask from that partition's generator, layer by layer,
    just before the backend's layer call: the masks it applies are those
    drawn again from the generators' states saved before the step, in
    that order (as the benchmark re-draws them)."""
    P = 4
    cfg = TrainConfig(
        dataset="synthetic", epochs=1, device="cpu", log_dir=None,
        cf_batch_size=64, kg_batch_size=64, n_devices=P, seed=5,
        halo_exchange=exchange, syn_users=50, syn_items=40,
        syn_entities=80, syn_relations=3, syn_interactions=500,
        syn_triples=400, model=kgat.KGATConfig(
            embed_dim=16, relation_dim=16, conv_dims=(16, 8),
            mess_dropout=(0.1, 0.3), ops_backend="hopper"))
    tr = train.Trainer(cfg)
    applied = []
    layer = hopper_backend.layer

    def recording(x, side, params, mask, rate, mc, copy_dtype=None):
        applied.append((mask.shape[1], mask.clone()))
        return layer(x, side, params, mask, rate, mc, copy_dtype)

    monkeypatch.setattr(hopper_backend, "layer", recording)
    states = [gen.get_state() for gen in tr.part_generators]
    tr.cf_step(tr.attention(), *tr.sample_cf())
    rows = tr.part.info.rows_per_part
    redrawn = []
    gens = [torch.Generator().set_state(s) for s in states]
    for d, rate in zip(cfg.model.conv_dims, cfg.model.mess_dropout):
        for gen in gens:
            redrawn.append((d, torch.rand((rows, d), generator=gen)
                            < 1.0 - rate))
    assert len(applied) == len(redrawn) == 2 * P
    for (d_a, a), (d_b, b) in zip(applied, redrawn):
        assert d_a == d_b and torch.equal(a, b)
