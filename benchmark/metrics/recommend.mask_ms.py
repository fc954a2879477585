"""recommend.mask_ms: host ms a request of the program's
``recommend.mask`` span, summed over the request's blocks: the per-user lookups and the (row, item) pair array built on
the host."""

from benchmark import program_spans


def read(run):
    return program_spans.per_request_ms("recommend.mask")
