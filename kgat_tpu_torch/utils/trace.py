"""Spans and counters inside the program, kept as running totals.

    from kgat_tpu_torch.utils import trace

    with trace.span("train.cf_phase", device=dev):   # host + device time
        ...
    with trace.span("recommend.mask"):               # host time
        ...
    trace.count("recommend.users", n)
    trace.summary()
    # {"spans": {name: {count, seconds, self_seconds, device_seconds,
    #                   device_count}}, "counts": {name: n}}

A span always adds to its name's host totals: how often it ran, its
seconds on ``time.perf_counter_ns`` and its self seconds (less the spans
opened inside it on the same thread). Nothing is kept per span beyond the
open spans' stack, as ``ops.hopper.build.launch_counts`` keeps counts.
Each thread adds to totals of its own, which ``summary()`` sums, so a
span takes no lock.

While a ``torch.profiler`` records, a span also opens a
``record_function`` range of its name, so it lies on the trace's own
timeline beside the kernels it launches (``--profile-epochs``, the
benchmark's traced runs). The range carries, as its one input, the
sequence number of the outermost open span on its thread (a request's
number inside ``recommend.request``), which the trace shows where the
profiler records shapes.

A span given a CUDA ``device`` also records a pair of timing
events on that device's current stream; their elapsed time, the stream's
time from the span's start to its end, goes into ``device_seconds`` once
the end event has completed. Pairs are read at the next device span that
finds them done, and ``summary()`` waits for the rest. A span never
synchronises, and records nothing while the current stream is being
captured into a CUDA graph: a captured step keeps exactly its own nodes
(a host span asks only in a process that made a ``torch.cuda.graph``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Union

import torch

# Device pairs not yet read. Beyond this many the oldest is dropped
# unread; ``device_count`` counts the pairs that were read.
MAX_PENDING = 1024

# Called on every span: looked up once.
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_cuda_in_use = torch.cuda.is_initialized
_stream_capturing = torch.cuda.is_current_stream_capturing
_graph = torch.cuda.graph


def _stream(device) -> Optional[torch.cuda.Stream]:
    """The current stream of ``device`` (a ``torch.device`` or its name),
    or None where it is no CUDA device or CUDA is not in use."""
    device = torch.device(device)
    if device.type != "cuda" or not _cuda_in_use():
        return None
    return torch.cuda.current_stream(device)


class _Totals:
    __slots__ = ("count", "ns", "self_ns", "device_s", "device_n")

    def __init__(self):
        self.count = self.ns = self.self_ns = self.device_n = 0
        self.device_s = 0.0


class _Thread:
    """One thread's open spans, span totals, counters, and a span object
    of each name to enter again."""

    __slots__ = ("stack", "totals", "counts", "spans")

    def __init__(self):
        self.stack: List["_Span"] = []
        self.totals: Dict[str, _Totals] = {}
        self.counts: Dict[str, int] = {}
        self.spans: Dict[str, "_Span"] = {}


class _Span:
    """A span of one name on one thread; while open, the stack entry of
    its thread. ``Tracer.span`` hands out the same object for a name
    again once it has closed, so a span allocates nothing."""

    __slots__ = ("tracer", "name", "device", "totals", "stack", "t0",
                 "child_ns", "extra")

    def __init__(self, tracer: "Tracer", th: _Thread, name: str):
        self.tracer, self.name, self.stack = tracer, name, th.stack
        self.totals = th.totals.get(name)
        if self.totals is None:
            self.totals = th.totals[name] = _Totals()
        self.t0 = None      # the clock at entry while open, else None

    def __enter__(self) -> "_Span":
        # Asking CUDA whether the stream captures costs a call (about
        # half a microsecond on the card's host): a host span asks only
        # once the process has made a ``torch.cuda.graph`` on its default
        # capture stream (``train.StepGraph`` does); a device span always
        # asks, since its events would become nodes of the graph.
        if ((self.device or _graph.default_capture_stream is not None)
                and _cuda_in_use() and _stream_capturing()):
            return self
        stack = self.stack
        self.child_ns = 0
        # The profiler's range and the start event with its stream, where
        # a profiler records or the span times a CUDA device.
        self.extra = None
        if self.device or _profiling():
            self.extra = self._open_extra(stack)
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> bool:
        if self.t0 is None:
            return False
        ns = _now() - self.t0
        self.t0 = None
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        tot = self.totals
        tot.count += 1
        tot.ns += ns
        tot.self_ns += ns - self.child_ns
        if self.extra is not None:
            record, start, stream = self.extra
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                self.tracer._add_pending(tot, start, end)
            if record is not None:
                torch.autograd._record_function_with_args_exit(record)
        return False

    def _open_extra(self, stack: list) -> Optional[tuple]:
        record = start = None
        if _profiling():
            # Labelled with the outermost open span's number: the spans
            # of its name this thread closed before it.
            root = stack[0] if stack else self
            record = torch.autograd._record_function_with_args_enter(
                self.name, root.totals.count)
        stream = _stream(self.device) if self.device else None
        if stream is not None:
            self.tracer._read_done()
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        return (record, start, stream)


class Tracer:
    """Totals of named spans and counters (the module's functions use one
    for the whole process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads: List[_Thread] = []
        self._pending: collections.deque = collections.deque()

    def span(self, name: str,
             device: Optional[Union[torch.device, str]] = None) -> _Span:
        """A context manager that times the work inside it (see the
        module's docstring); with a CUDA ``device``, on its current
        stream too. Enter it where it is made, on the thread that made
        it."""
        try:
            th = self._local.thread
        except AttributeError:
            th = self._thread()
        s = th.spans.get(name)
        if s is None or s.t0 is not None:
            s = _Span(self, th, name)
            if name not in th.spans:
                th.spans[name] = s
        s.device = device
        return s

    def count(self, name: str, n: int = 1) -> None:
        counts = self._thread().counts
        counts[name] = counts.get(name, 0) + n

    def summary(self) -> Dict[str, Dict]:
        """Every thread's totals summed, every device pair read (this
        waits for the pairs' end events)."""
        with self._lock:
            pending, self._pending = self._pending, collections.deque()
        for tot, start, end in pending:
            end.synchronize()
            self._add_device(tot, start, end)
        spans: Dict[str, Dict] = {}
        counts: collections.Counter = collections.Counter()
        with self._lock:
            for th in self._threads:
                for name, t in list(th.totals.items()):
                    s = spans.setdefault(name, dict.fromkeys(
                        ("count", "seconds", "self_seconds",
                         "device_seconds", "device_count"), 0))
                    s["count"] += t.count
                    s["seconds"] += t.ns * 1e-9
                    s["self_seconds"] += t.self_ns * 1e-9
                    s["device_seconds"] += t.device_s
                    s["device_count"] += t.device_n
                counts.update(dict(th.counts))
        return {"spans": spans, "counts": dict(counts)}

    def reset(self) -> None:
        """Forgets every total, counter and unread device pair."""
        with self._lock:
            for th in self._threads:
                th.totals, th.counts, th.spans = {}, {}, {}
            self._pending = collections.deque()

    def _thread(self) -> _Thread:
        try:
            return self._local.thread
        except AttributeError:
            th = self._local.thread = _Thread()
            with self._lock:
                self._threads.append(th)
            return th

    def _add_pending(self, tot, start, end) -> None:
        with self._lock:
            self._pending.append((tot, start, end))
            if len(self._pending) > MAX_PENDING:
                self._pending.popleft()

    def _add_device(self, tot, start, end) -> None:
        s = start.elapsed_time(end) * 1e-3
        with self._lock:
            tot.device_s += s
            tot.device_n += 1

    def _read_done(self) -> None:
        """Reads the pairs whose end event has completed (never waits)."""
        with self._lock:
            pending, self._pending = self._pending, collections.deque()
        left = collections.deque()
        for item in pending:
            if item[2].query():
                self._add_device(*item)
            else:
                left.append(item)
        with self._lock:
            self._pending.extendleft(reversed(left))
            while len(self._pending) > MAX_PENDING:
                self._pending.popleft()


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
summary = _TRACER.summary
reset = _TRACER.reset
