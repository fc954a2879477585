"""recommend.forward_ms: device ms of the serving forward on a cache miss
(the program's ``recommend.forward`` span: attention, then propagation),
on the stream's clock, over its count (set-up's first forward included)."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms("recommend.forward")
