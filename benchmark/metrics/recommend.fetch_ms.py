"""recommend.fetch_ms: host ms a request of the program's
``recommend.fetch`` span, summed over the request's blocks: both copies of the top k back to the host (the first waits
for the block)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_request_ms("recommend.fetch")
