"""The program's own spans (``kgat_tpu_torch.utils.trace``), as the
``source: program_span`` readers of ``benchmark/metrics`` read them: the
totals of the process that reports (process 0 of a group), over the whole
run, set-up included. A program without the tracer has none, and its
readers find nothing.

``span(name)``: {"count", "seconds", "self_seconds", "device_seconds",
"device_count"}, or None where the span never ran.
"""

from __future__ import annotations

from typing import Dict, Optional


def span(name: str) -> Optional[Dict]:
    try:
        from kgat_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get(name)
    return s if s and s["count"] > 0 else None


def per_request_ms(stage: str) -> Optional[float]:
    """Host ms of a serving stage, summed over its blocks, per request."""
    s, req = span(stage), span("recommend.request")
    if s is None or req is None:
        return None
    return s["seconds"] / req["count"] * 1e3


def device_ms(name: str, per: int = 1) -> Optional[float]:
    """Device ms of a span, per span (and per ``per`` steps inside it)."""
    s = span(name)
    if s is None or s["device_count"] == 0:
        return None
    return s["device_seconds"] / (s["device_count"] * per) * 1e3
