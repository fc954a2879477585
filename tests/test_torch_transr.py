"""The KG step's TransR op (``ops/hopper/transr.py``) on the CPU.

The route ``models.kgat.kg_pair_terms`` takes: on the ref backend, and on
the hopper backend with CPU tensors (float32 or float64), it is the plain
path of before, value for value and gradient for gradient, the ref
backend's bit for bit; the float64 oracle of the lazy KG step asks for
the ref backend itself. The plan's plain version, the reference the kernel's
plan is held to on the card (a stable sort by relation and units of at
most U rows), on skewed batches, absent relations, one relation and
ragged sizes. The plain backward summed by relation, the reference of the
card's backward kernels, in float64 against autograd through the plain
products. The kernels run in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import transr

import torch_threads  # noqa: F401  (one intra-op thread)

N_NODES = 60


def skewed(n, n_rel, heavy, share, absent, seed):
    """n relations in [0, n_rel): ``share`` of them ``heavy``, the rest
    uniform over the relations other than ``heavy`` and ``absent``."""
    rs = np.random.default_rng(seed)
    others = [q for q in range(n_rel) if q not in (heavy, *absent)]
    r = rs.choice(others, n)
    r[rs.random(n) < share] = heavy
    return torch.from_numpy(r)


# (B, R, relations): a relation holding 80% of a batch in a run of many
# units, with two relations absent; one relation; B not a multiple of U.
BATCHES = {
    "skewed": (1000, 9, lambda: skewed(1000, 9, 2, 0.8, (5, 8), 0)),
    "one_relation": (77, 1, lambda: torch.zeros(77, dtype=torch.long)),
    "ragged": (33, 4, lambda: skewed(33, 4, 0, 0.0, (), 1)),
    "all_in_one_of_many": (70, 6, lambda: torch.full((70,), 4)),
}


def _model(cfg, dtype=torch.float32, n_rel=6):
    m = kgat.init_params(N_NODES, n_rel, cfg,
                         generator=torch.Generator().manual_seed(0))
    return m.to(dtype)


def _batch(n, n_rel, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, N_NODES, (n,), generator=g),
            torch.randint(0, n_rel, (n,), generator=g),
            torch.randint(0, N_NODES, (n,), generator=g),
            torch.randint(0, N_NODES, (n,), generator=g))


@pytest.mark.parametrize("backend,dtype", [("ref", torch.float32),
                                           ("hopper", torch.float32),
                                           ("hopper", torch.float64)])
def test_plain_route_is_the_gathered_path(backend, dtype):
    """On the CPU every backend and dtype takes the plain path: the loss,
    pair terms and gradients are bit for bit those of gathering w_rel[r]
    and rel_embed[r] per pair, and the pair terms those of the ref
    backend."""
    cfg = kgat.KGATConfig(embed_dim=16, relation_dim=8, ops_backend=backend)
    model = _model(cfg, dtype)
    h, r, tp, tn = _batch(40, 6)
    w = torch.rand(40, dtype=dtype)
    pair, ssq = kgat.kg_pair_terms(model, h, r, tp, tn, cfg)
    loss = kgat.kg_loss(model, h, r, tp, tn, cfg, weight=w)
    pair_ref, ssq_ref = kgat.kg_pair_terms(
        model, h, r, tp, tn, dataclasses.replace(cfg, ops_backend="ref"))
    assert torch.equal(pair, pair_ref) and torch.equal(ssq, ssq_ref)
    grads = torch.autograd.grad(loss, [model.entity_embed, model.rel_embed,
                                       model.w_rel])
    emb = model.entity_embed
    pair_w, ssq_w = kgat.kg_pair_terms_rows(emb[h], emb[tp], emb[tn],
                                            model.rel_embed[r],
                                            model.w_rel[r])
    loss_w = (kgat.weighted_mean(pair_w, w)
              + cfg.reg_kg * ssq_w / h.shape[0])
    grads_w = torch.autograd.grad(loss_w, [model.entity_embed,
                                           model.rel_embed, model.w_rel])
    assert torch.equal(pair, pair_w.detach()) and torch.equal(ssq, ssq_w)
    assert torch.equal(loss, loss_w)
    for a, b in zip(grads, grads_w):
        assert torch.equal(a, b)


def check_plan(plan: transr.TransRPlan, r: torch.Tensor, n_rel: int,
               unit_rows: int) -> None:
    """The plan of ``r``: perm sorts the batch by relation, stably; the
    relation offsets bound each relation's rows; each relation's units
    tile its run in order, U rows each but the last; the units past the
    last are empty, up to the static bound ceil(B / U) + R."""
    n = r.numel()
    perm = plan.perm.long()
    assert sorted(perm.tolist()) == list(range(n))
    key = r[perm] * n + perm           # stable: batch order within a relation
    assert bool((key[1:] > key[:-1]).all())
    counts = torch.bincount(r, minlength=n_rel)
    assert plan.rel_offsets.tolist() == [0, *torch.cumsum(counts, 0).tolist()]
    units = plan.units.long()
    assert units.shape == (-(-n // unit_rows) + n_rel, 4)
    uo = plan.unit_offsets.tolist()
    assert uo[0] == 0 and len(uo) == n_rel + 1
    for q in range(n_rel):
        lo, hi = plan.rel_offsets[q].item(), plan.rel_offsets[q + 1].item()
        mine = units[uo[q]:uo[q + 1]].tolist()
        want = [[q, p, min(p + unit_rows, hi), 0]
                for p in range(lo, hi, unit_rows)]
        assert mine == want, q
    assert not units[uo[-1]:].any()
    assert all(t.dtype == torch.int32 for t in (
        plan.perm, plan.rel_offsets, plan.units, plan.unit_offsets))


@pytest.mark.parametrize("unit_rows", [transr.UNIT_ROWS, 1, 7, 256])
@pytest.mark.parametrize("name", BATCHES)
def test_plain_plan(name, unit_rows):
    n, n_rel, make = BATCHES[name]
    r = make()
    assert r.numel() == n
    plan = transr.transr_plan(r, n_rel, unit_rows)
    check_plan(plan, r, n_rel, unit_rows)


def test_the_sparse_oracle_takes_the_ref_route(monkeypatch):
    """sparse_kg_step_plain, the lazy KG step's float64 oracle, computes
    its gradient on the ref backend's gathered path also when the
    trainer's config names hopper, whose kernels take float32 alone: it
    calls the ref backend's projection once and never the op."""
    from kgat_tpu_torch import optim

    def refuse(*args):
        raise AssertionError("the oracle called transr_project")
    monkeypatch.setattr(transr, "transr_project", refuse)
    calls = []
    kg_projection = ref.kg_projection

    def recording(*args):
        calls.append(args)
        return kg_projection(*args)
    monkeypatch.setattr(ref, "kg_projection", recording)
    cfg = kgat.KGATConfig(embed_dim=16, relation_dim=8, ops_backend="hopper")
    model = _model(cfg)
    opt = optim.make_optimizer(model.parameters(), 1e-2)
    h, r, tp, tn = _batch(30, 6, seed=4)
    loss, _, _ = optim.sparse_kg_step_plain(model, opt, h, r, tp, tn, cfg)
    assert len(calls) == 1
    with pytest.raises(AssertionError, match="called transr_project"):
        kgat.kg_loss(model, h, r, tp, tn, cfg)
    assert loss > 0


@pytest.mark.parametrize("name", ["skewed", "one_relation", "ragged"])
def test_plain_backward_by_relation_matches_autograd(name):
    """The card's reference (``transr_forward_plain``,
    ``transr_backward_plain``: the tables' gradients summed by relation
    with index_add_) against autograd through the gathered products,
    float64: values and every gradient; zeros for an absent relation."""
    n, n_rel, make = BATCHES[name]
    r = make()
    g = torch.Generator().manual_seed(3)
    d, k = 12, 8
    leaves = [torch.randn(n, d, generator=g, dtype=torch.float64)
              for _ in range(3)]
    leaves += [torch.randn(n_rel, k, generator=g, dtype=torch.float64),
               torch.randn(n_rel, d, k, generator=g, dtype=torch.float64)]
    cots = [torch.randn(n, k, generator=g, dtype=torch.float64)
            for _ in range(4)]
    xs = [t.clone().requires_grad_() for t in leaves]
    outs = [torch.einsum("bd,bdk->bk", e, xs[4][r]) for e in xs[:3]]
    outs.append(xs[3][r])
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)),
                               xs)
    plain = transr.transr_forward_plain(*leaves, r)
    for a, b in zip(plain, outs):
        assert torch.equal(a, b.detach())
    eh, ep, en, _, w_rel = leaves
    got = transr.transr_backward_plain(eh, ep, en, w_rel, r, *cots)
    # transr_backward_plain returns (d eh, d ep, d en, d rel_embed, d w_rel).
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    absent = torch.bincount(r, minlength=n_rel) == 0
    assert not got[3][absent].any() and not got[4][absent].any()


@pytest.mark.parametrize("d,k,ok", [(64, 64, True), (16, 8, True),
                                    (128, 128, True), (4, 256, True),
                                    (33, 20, False), (64, 30, False),
                                    (0, 64, False), (512, 4, False),
                                    (256, 256, False)])
def test_check_widths(d, k, ok):
    if ok:
        transr.check_widths(d, k)
    else:
        with pytest.raises(ValueError):
            transr.check_widths(d, k)
