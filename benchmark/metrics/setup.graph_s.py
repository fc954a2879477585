"""setup.graph_s: host seconds of the program's ``setup.graph`` span
(``Dataset.build``: the graph cache read, or the CKG, its row splits and
coalesced CSRs built and written)."""

from benchmark import program_spans


def read(run):
    s = program_spans.span("setup.graph")
    return None if s is None else s["seconds"]
