"""setup.tables_s: host seconds of the program's ``setup.tables`` span
(``Trainer.__init__``: ``CFSampleTable.build`` and
``KGSampleTable.build``)."""

from benchmark import program_spans


def read(run):
    s = program_spans.span("setup.tables")
    return None if s is None else s["seconds"]
