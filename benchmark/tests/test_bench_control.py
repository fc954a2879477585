"""The comparison fails what it must: the control (the reference one step
down in precision in the program's place), and a run whose timed path is
broken underneath: a step that leaves its state unchanged, half of the
batch left out, a served answer altered where it is produced."""

from unittest import mock

import numpy as np
import pytest
import torch

import tiny
from benchmark import checks, train_cell
from kgat_tpu_torch import recommend
from kgat_tpu_torch.models import kgat


def _first_steps(tmp_path):
    root = tiny.make_root(tmp_path)
    ctx = tiny.context(root, "tiny-train")
    s = train_cell.setup(ctx, ctx.stages.mark)
    g = train_cell.reference_graph(s["data"], ctx.config["model"], "cpu")
    return ctx, s, g


def test_the_control_fails_the_comparison(tmp_path):
    ctx, s, g = _first_steps(tmp_path)
    data, first, init = s["data"], s["first"], s["init"]
    ref = train_cell.follow(ctx, data, first, init, g, ctx.precision)
    low = train_cell.follow(ctx, data, first, init, g, ctx.precision.lower())
    numbers = checks.train_numbers(low, ref, init)
    ok, _ = checks.verdict(numbers, ctx.limits)
    assert not ok, numbers
    sound = train_cell.compare(ctx, data, first, init, g)
    assert checks.verdict(sound, ctx.limits)[0], sound


def test_a_missing_limit_fails_and_a_null_limit_is_not_compared():
    numbers = {"loss_gap": 1e-3, "grad_gap": 1e-4}
    assert not checks.verdict(numbers, None)[0]
    assert not checks.verdict(numbers, {"grad_gap": 4e-3})[0]
    assert checks.verdict(numbers, {"loss_gap": None, "grad_gap": 4e-3})[0]
    assert not checks.verdict(numbers, {"loss_gap": None,
                                        "grad_gap": 1e-5})[0]
    assert not checks.verdict({"grad_gap": float("nan")},
                              {"grad_gap": 4e-3})[0]


def test_the_serving_control_fails_the_comparison(tmp_path):
    from benchmark import reference, serve_cell
    root = tiny.make_root(tmp_path)
    ctx = tiny.context(root, "tiny-serve")
    s = serve_cell.setup(ctx, ctx.stages.mark)
    data, mc = s["data"], ctx.config["model"]
    g = train_cell.reference_graph(data, mc, "cpu")
    ptr, items = (torch.as_tensor(a) for a in data.train_items)
    users = torch.as_tensor(s["reqs"].pool[:100])
    emb = reference.serve_embed(s["sets"][0], g, mc, ctx.precision)
    ref = reference.scores(emb, users, data.n_entities, data.n_items, ptr,
                           items, ctx.precision)
    low_p = ctx.precision.lower()
    low = reference.scores(reference.serve_embed(s["sets"][0], g, mc, low_p),
                           users, data.n_entities, data.n_items, ptr, items,
                           low_p)
    top = torch.topk(low, 20, dim=1)
    numbers = checks.serve_numbers(top.indices.numpy(), top.values.numpy(),
                                   ref)
    assert not checks.verdict(numbers, ctx.limits)[0], numbers


def _no_step(self, closure=None):
    return None


def _half_mean(terms, weight):
    half = terms.shape[0] // 2
    w = weight[:half] if weight is not None else torch.ones(half)
    return (terms[:half] * w).sum() / w.sum().clamp(min=1.0)


def _altered(all_embed, user_nodes, mask_pairs, n_items, k):
    items, scores = ORIG_SCORE_BLOCK(all_embed, user_nodes, mask_pairs,
                                     n_items, k)
    return (items + 1) % n_items, scores


ORIG_SCORE_BLOCK = recommend._score_block

FAULTS = {
    "state_unchanged": ("tiny-train",
                        mock.patch.object(torch.optim.Adam, "step", _no_step)),
    "half_batch": ("tiny-train",
                   mock.patch.object(kgat, "weighted_mean", _half_mean)),
    "answer_altered": ("tiny-serve",
                       mock.patch.object(recommend, "_score_block",
                                         _altered)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_reads_not_correct(tmp_path, fault):
    cell, patch = FAULTS[fault]
    with patch:
        line = tiny.drive(tiny.make_root(tmp_path), cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tmp_path, cuda):
    """The control at the tiny size on the card (the cell's own sizes are
    read by ``calibrate.py``)."""
    root = tiny.make_root(tmp_path)
    ctx = tiny.context(root, "tiny-train")
    ctx.device = cuda
    s = train_cell.setup(ctx, ctx.stages.mark)
    g = train_cell.reference_graph(s["data"], ctx.config["model"], cuda)
    data, first, init = s["data"], s["first"], s["init"]
    ref = train_cell.follow(ctx, data, first, init, g, ctx.precision)
    low = train_cell.follow(ctx, data, first, init, g, ctx.precision.lower())
    assert not checks.verdict(checks.train_numbers(low, ref, init),
                              ctx.limits)[0]
    assert checks.verdict(train_cell.compare(ctx, data, first, init, g),
                          ctx.limits)[0]
