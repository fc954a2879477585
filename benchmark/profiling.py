"""The device side of a traced run, read from ``torch.profiler``.

The arithmetic of ``tools/profile_train_step.py`` at commit d0f90ce,
frozen: the device's kernels are the profiler's CUDA events whose names
are not also host events (the ranges the profiler mirrors onto the device
timeline) nor its own activity buffers, and the device's idle share is
taken against the same work's untraced wall time, since the profiler's
own host work slows a host-bound window. Busy time is the union of the
kernels' intervals, so kernels that overlap on two streams count once.

``read(prof)`` reduces a trace to a JSON-able dict that the metric
readers (``benchmark/metrics``) read:

* ``kernels``: {name: [seconds, count]} over the traced window;
* ``busy_s``: seconds in which a kernel, copy or fill ran;
* ``window_s``: the traced window's wall time (set by the caller);
* ``spans``: {benchmark range: {"seconds", "count", "kernels"}}, the
  kernels that started inside each range the benchmark marked with
  ``torch.profiler.record_function`` (its names start with ``bench.``);
* ``breakdown``: the device operations that took most time, and the idle
  gaps between kernels summed by what the host was doing then.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

MARK = "bench."
# Idle gaps shorter than this are summed together, unlabelled: between the
# kernels of one replayed step they are the device's own launch gaps.
SHORT_US = 5.0


def _device_events(prof):
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    host_keys = {e.name for e in events if e.device_type == cpu}
    kernels, host = [], []
    for e in events:
        if e.device_type == cpu:
            host.append(e)
        elif (e.name not in host_keys
              and not e.name.startswith("Activity Buffer")):
            kernels.append(e)
    return kernels, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label(host_sorted, starts, t: float) -> str:
    """The benchmark range and the innermost host op running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    mark, op = "", ""
    for j in range(i, max(-1, i - 64), -1):
        e = host_sorted[j]
        if e.time_range.end < t:
            continue
        if e.name.startswith(MARK):
            mark = mark or e.name
        else:
            op = op or e.name
        if mark and op:
            break
    return "/".join(x for x in (mark or "outside", op) if x)


def read(prof, top: int = 10) -> Dict:
    kernels, host = _device_events(prof)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    ivals = []
    for k in kernels:
        a, b = k.time_range.start, k.time_range.end
        by_name[k.name][0] += (b - a) * 1e-6
        by_name[k.name][1] += 1
        ivals.append((a, b))
    busy = _union(ivals)
    marks = [e for e in host if e.name.startswith(MARK)]
    spans: Dict[str, Dict] = {}
    kstart = sorted((k.time_range.start, k.time_range.end, k.name)
                    for k in kernels)
    ks = [s for s, _, _ in kstart]
    for m in marks:
        s = spans.setdefault(m.name[len(MARK):],
                             {"seconds": 0.0, "count": 0, "kernels": {}})
        a, b = m.time_range.start, m.time_range.end
        s["seconds"] += (b - a) * 1e-6
        s["count"] += 1
        for j in range(bisect.bisect_left(ks, a), bisect.bisect_right(ks, b)):
            _, end, name = kstart[j]
            rec = s["kernels"].setdefault(name, [0.0, 0])
            rec[0] += (end - kstart[j][0]) * 1e-6
            rec[1] += 1
    host_sorted = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_sorted]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        label = (_label(host_sorted, starts, end) if nxt - end >= SHORT_US
                 else f"gaps under {SHORT_US:g} us")
        gaps[label] += (nxt - end) * 1e-6
    ops = sorted(((n, v[0]) for n, v in by_name.items()), key=lambda x: -x[1])
    idle = sorted(gaps.items(), key=lambda x: -x[1])
    return {"kernels": {n: v for n, v in by_name.items()},
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "spans": spans,
            "breakdown": {"device_ops": [[n[:160], s] for n, s in ops[:top]],
                          "idle_gaps": [[n[:160], s] for n, s in idle[:top]]}}


def profile():
    """A profiler of host and device, as ``profile_train_step.py`` runs
    it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
