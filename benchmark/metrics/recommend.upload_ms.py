"""recommend.upload_ms: host ms a request of the program's
``recommend.upload`` span, summed over the request's blocks: the block's user nodes and mask pairs copied to the device."""

from benchmark import program_spans


def read(run):
    return program_spans.per_request_ms("recommend.upload")
