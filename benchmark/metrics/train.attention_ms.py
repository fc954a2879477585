"""train.attention_ms: device ms of an attention recompute in the epoch
loop, the program's ``train.attention`` span on the stream's clock (K2,
K3, group sums, bf16 staging; across cards, the exchange), over its
count."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms("train.attention")
