"""recommend.score_ms: host ms a request of the program's
``recommend.score`` span, summed over the request's blocks: the gather, the product, the mask scatter and the top k
enqueued."""

from benchmark import program_spans


def read(run):
    return program_spans.per_request_ms("recommend.score")
