"""recommend.request_ms: host ms of a request, the program's
``recommend.request`` span (``Recommender.recommend``) over its count."""

from benchmark import program_spans


def read(run):
    s = program_spans.span("recommend.request")
    return None if s is None else s["seconds"] / s["count"] * 1e3
