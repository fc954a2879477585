"""The port's spans and counters (kgat_tpu_torch.utils.trace) on the CPU:
host totals and self time, counters, the profiler's ranges, and the spans
that the serving path and the epoch loop open."""

import sys
import threading

import numpy as np
import pytest
import torch

from kgat_tpu_torch import train
from kgat_tpu_torch.data import synthetic_dataset
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.recommend import Recommender
from kgat_tpu_torch.utils import trace
from kgat_tpu_torch.utils.config import TrainConfig

import torch_threads  # noqa: F401  (one intra-op thread)


class Clock:
    """The tracer's clock (ns), set by the test."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(trace, "_now", c)
    return c


def _spans(tr):
    return tr.summary()["spans"]


def test_nested_spans_add_their_time_and_self_time(clock):
    tr = trace.Tracer()
    with tr.span("outer"):
        clock.now = 10
        with tr.span("inner"):
            clock.now = 40
        clock.now = 50
        with tr.span("inner"):
            with tr.span("leaf"):
                clock.now = 55
            clock.now = 60
        clock.now = 100
    with tr.span("outer"):
        clock.now = 107
    s = _spans(tr)
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 2
    assert s["outer"]["seconds"] == pytest.approx(107e-9)
    # outer less its two children (30 + 10 ns); inner less its leaf.
    assert s["outer"]["self_seconds"] == pytest.approx(67e-9)
    assert s["inner"]["seconds"] == pytest.approx(40e-9)
    assert s["inner"]["self_seconds"] == pytest.approx(35e-9)
    assert s["leaf"]["self_seconds"] == pytest.approx(5e-9)


def test_a_span_closed_by_an_exception_still_counts(clock):
    tr = trace.Tracer()
    with pytest.raises(ValueError):
        with tr.span("a"):
            clock.now = 3
            raise ValueError
    with tr.span("b"):
        pass
    s = _spans(tr)
    assert s["a"]["seconds"] == pytest.approx(3e-9)
    # "a" left the stack: "b" is no child of it.
    assert s["a"]["self_seconds"] == pytest.approx(3e-9)


def test_counters_add():
    tr = trace.Tracer()
    tr.count("users", 5)
    tr.count("users")
    tr.count("pairs", 0)
    assert tr.summary()["counts"] == {"users": 6, "pairs": 0}


def test_reset_forgets_spans_and_counters():
    tr = trace.Tracer()
    with tr.span("a"):
        tr.count("n", 2)
    tr.reset()
    assert tr.summary() == {"spans": {}, "counts": {}}
    with tr.span("a"):
        pass
    assert _spans(tr)["a"]["count"] == 1


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_a_span_records_no_device_time_on_the_cpu(device):
    tr = trace.Tracer()
    with tr.span("d", device=device):
        torch.ones(8).sum()
    s = _spans(tr)["d"]
    assert s["count"] == 1 and s["seconds"] > 0
    assert s["device_seconds"] == 0.0 and s["device_count"] == 0


def test_spans_are_profiler_ranges_nested_as_opened():
    tr = trace.Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tr.span("recommend.request"):
            with tr.span("recommend.mask"):
                torch.ones(3).add(1)
            with tr.span("recommend.fetch"):
                pass
    ev = {e.name: e for e in prof.events() if e.name.startswith("recommend")}
    assert set(ev) == {"recommend.request", "recommend.mask",
                       "recommend.fetch"}
    assert ev["recommend.mask"].cpu_parent.name == "recommend.request"
    assert ev["recommend.fetch"].cpu_parent.name == "recommend.request"
    assert any(c.name == "aten::add" for c in ev["recommend.mask"]
               .cpu_children)


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    def refuse(*a):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    tr = trace.Tracer()
    with tr.span("a"):
        with tr.span("b", device="cpu"):
            pass
    assert _spans(tr)["b"]["count"] == 1


def test_threads_keep_their_own_stacks_and_lose_no_update():
    """More threads than cores, switching often: every span and count of
    every thread is in the totals, and self time never exceeds time."""
    tr = trace.Tracer()
    n_threads, n = 32, 300

    def work():
        for _ in range(n):
            with tr.span("outer"):
                with tr.span("inner"):
                    tr.count("c")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = tr.summary()
    assert s["counts"] == {"c": n_threads * n}
    for name in ("outer", "inner"):
        assert s["spans"][name]["count"] == n_threads * n
    outer = s["spans"]["outer"]
    assert outer["self_seconds"] <= outer["seconds"]
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - s["spans"]["inner"]["seconds"])


@pytest.fixture
def no_sync(monkeypatch):
    """No span may synchronise the device."""
    def refuse(*a, **k):
        raise AssertionError("a span synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    trace.reset()
    yield
    trace.reset()


TINY = dict(seed=3, n_users=20, n_items=15, n_entities=30, n_relations_kg=3,
            n_interactions=160, n_triples=90)


def test_a_request_of_three_blocks_opens_each_stage_per_block(no_sync):
    ds = synthetic_dataset(**TINY)
    graph, meta = ds.build()
    cfg = kgat.KGATConfig(embed_dim=8, relation_dim=8, conv_dims=(8, 4),
                          ops_backend="ref")
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(0))
    rec = Recommender(model, graph, meta, cfg,
                      train_user_dict=ds.train_user_dict)
    users = np.arange(5)
    rec.recommend(users, k=3, block=2)
    s = trace.summary()
    spans = s["spans"]
    assert spans["recommend.request"]["count"] == 1
    assert spans["recommend.forward"]["count"] == 1
    for stage in ("mask", "upload", "score", "fetch"):
        assert spans[f"recommend.{stage}"]["count"] == 3, stage
    assert s["counts"]["recommend.users"] == 5
    assert s["counts"]["recommend.mask_pairs"] == sum(
        len(ds.train_user_dict.get(u, ())) for u in range(5))
    # The stages and the forward lie inside the request.
    req = spans["recommend.request"]
    inside = sum(spans[f"recommend.{x}"]["seconds"] for x in
                 ("forward", "mask", "upload", "score", "fetch"))
    assert req["self_seconds"] == pytest.approx(req["seconds"] - inside)
    # A second request reuses the forward.
    rec.recommend(users[:1], k=3)
    spans = trace.summary()["spans"]
    assert spans["recommend.request"]["count"] == 2
    assert spans["recommend.forward"]["count"] == 1


def test_an_epoch_opens_each_phase_once_and_its_attention(no_sync):
    cfg = TrainConfig(
        device="cpu", dataset="synthetic", log_dir=None, seed=2, lr=1e-3,
        cf_batch_size=64, kg_batch_size=128, syn_users=30, syn_items=20,
        syn_entities=40, syn_relations=3, syn_interactions=200,
        syn_triples=120, model=kgat.KGATConfig(
            embed_dim=8, relation_dim=8, conv_dims=(8, 4),
            mess_dropout=(0.1, 0.1), ops_backend="ref"))
    trace.reset()
    tr = train.Trainer(cfg)
    s = trace.summary()["spans"]
    assert s["setup.graph"]["count"] == 1 and s["setup.tables"]["count"] == 1
    tr.train_one_epoch()
    s = trace.summary()["spans"]
    assert s["train.cf_phase"]["count"] == 1
    assert s["train.kg_phase"]["count"] == 1
    # The first epoch computes its attention, then the next epoch's.
    assert s["train.attention"]["count"] == 2
    tr.train_one_epoch()
    s = trace.summary()["spans"]
    assert s["train.cf_phase"]["count"] == 2
    assert s["train.attention"]["count"] == 3
    assert all(v["device_count"] == 0 for v in s.values())
