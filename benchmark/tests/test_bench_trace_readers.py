"""The readers of the program's spans (``source: program_span`` metrics
that read ``kgat_tpu_torch.utils.trace``) on a tracer filled with known
spans, and None where their span never ran or the program has no
tracer."""

import builtins

import pytest

from benchmark.spec import Spec
from kgat_tpu_torch.utils import trace

NEW = ("recommend.request_ms", "recommend.mask_ms", "recommend.upload_ms",
       "recommend.score_ms", "recommend.fetch_ms", "recommend.forward_ms",
       "train.cf_phase_ms", "train.kg_phase_ms", "train.attention_ms",
       "setup.graph_s", "setup.tables_s")
RUN = {"steps": {"cf": 10, "kg": 20}}


class Clock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer behind the module's functions, on a clock the test
    moves (ns)."""
    tr = trace.Tracer()
    clock = Clock()
    monkeypatch.setattr(trace, "_now", clock)
    monkeypatch.setattr(trace, "summary", tr.summary)
    return tr, clock


def _timed(tr, clock, name, ns):
    with tr.span(name):
        clock.now += ns


def _device(tr, name, seconds, n):
    """``n`` spans of ``name`` whose stream time summed to ``seconds``."""
    for _ in range(n):
        with tr.span(name, device="cpu"):
            pass
    tot = tr._thread().totals[name]
    tot.device_s, tot.device_n = seconds, n


def _read(name, run=RUN):
    return Spec().reader(name)(run)


def test_every_new_reader_has_its_entry():
    per_layer = {m["name"]: m for m in Spec().data["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] == "program_span", name


def test_the_serving_readers(tracer):
    tr, clock = tracer
    # Two requests of 3 ms and 1 ms, their stages over three blocks.
    with tr.span("recommend.request"):
        for mask, fetch in ((0.5e6, 0.9e6), (0.25e6, 0.65e6)):
            _timed(tr, clock, "recommend.mask", mask)
            _timed(tr, clock, "recommend.upload", 0.1e6)
            _timed(tr, clock, "recommend.score", 0.2e6)
            _timed(tr, clock, "recommend.fetch", fetch)
        clock.now += 0.1e6
    with tr.span("recommend.request"):
        _timed(tr, clock, "recommend.mask", 0.25e6)
        _timed(tr, clock, "recommend.upload", 0.1e6)
        _timed(tr, clock, "recommend.score", 0.2e6)
        _timed(tr, clock, "recommend.fetch", 0.45e6)
    _device(tr, "recommend.forward", 3 * 3.6e-3, 3)
    assert _read("recommend.request_ms") == pytest.approx(2.0)
    assert _read("recommend.mask_ms") == pytest.approx(0.5)
    assert _read("recommend.upload_ms") == pytest.approx(0.15)
    assert _read("recommend.score_ms") == pytest.approx(0.3)
    assert _read("recommend.fetch_ms") == pytest.approx(1.0)
    assert _read("recommend.forward_ms") == pytest.approx(3.6)


def test_the_training_and_setup_readers(tracer):
    tr, clock = tracer
    _timed(tr, clock, "setup.graph", 2e9)
    _timed(tr, clock, "setup.tables", 6e9)
    # Three epochs: 10 CF steps of 5 ms, 20 KG steps of 2 ms each.
    _device(tr, "train.cf_phase", 3 * 10 * 5e-3, 3)
    _device(tr, "train.kg_phase", 3 * 20 * 2e-3, 3)
    _device(tr, "train.attention", 4 * 7e-3, 4)
    assert _read("setup.graph_s") == pytest.approx(2.0)
    assert _read("setup.tables_s") == pytest.approx(6.0)
    assert _read("train.cf_phase_ms") == pytest.approx(5.0)
    assert _read("train.kg_phase_ms") == pytest.approx(2.0)
    assert _read("train.attention_ms") == pytest.approx(7.0)


def test_spans_without_a_reading_give_none(tracer):
    tr, clock = tracer
    for name in NEW:
        assert _read(name) is None, name
    # Host spans only (a run on the CPU): the device readers find nothing,
    # and a stage without its request reads nothing per request.
    for name in ("train.cf_phase", "train.kg_phase", "train.attention",
                 "recommend.forward", "recommend.mask"):
        _timed(tr, clock, name, 10)
    for name in ("train.cf_phase_ms", "train.kg_phase_ms",
                 "train.attention_ms", "recommend.forward_ms",
                 "recommend.mask_ms"):
        assert _read(name) is None, name
    assert _read("train.cf_phase_ms", {"steps": {}}) is None


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    """A program from before ``utils.trace``: every reader returns None
    and none raises."""
    real = builtins.__import__

    def no_tracer(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "kgat_tpu_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_tracer)
    for name in NEW:
        assert _read(name) is None, name
