"""Stage-level timing of the port's training attention pipeline.

Port of ``bench_attention.py``: each stage of
``models.kgat.attention_for_training`` on the hopper backend, timed on
the card by :func:`kgat_tpu_torch.bench.median_time` (one call between
CUDA events, the median of ``--iters``), with its edges/s:

    python -m kgat_tpu_torch.bench_attention --preset yelp2018

Rows: the whole pipeline (logits, softmax, staging) in float32, with the
staged weights rounded to bf16, and with bf16 and multi-edge coalescing
(the training default); the logits alone, by K2 or by the dense
projection where ``att_impl="auto"`` picks it (``kgat_tpu``'s rule by
table size: the dense route at the smoke preset, K2 at yelp2018); K3's
softmax; the gather of the weights into the reverse CSR's order in
float32 and in bf16.
``bench_attention.py``'s "att->fwd scatter" and "att->fwd gather" rows
move the logits into the TPU's aligned layout; the port's logits come out
in canonical edge order, so those rows print as absent. ``--device cpu``
runs the plain versions (a check of the path, not a measurement).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from kgat_tpu_torch import bench
from kgat_tpu_torch.graph import coalesced
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.ops import hopper_backend as ops
from kgat_tpu_torch.ops.hopper import build as hopper_build
from kgat_tpu_torch.recommend import disable_tf32

ABSENT = ("absent: the port's logits come out in canonical edge order, "
          "with no aligned layout to move them into")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Stage times of kgat_tpu_torch's attention pipeline")
    p.add_argument("--preset", default="yelp2018",
                   choices=sorted(bench.PRESETS))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_attention: CUDA is not available; run on a "
                         "GPU, or pass --device cpu for the plain path")
    disable_tf32()
    _, host_graph, meta, _ = bench.build(a.preset)
    g = host_graph.to(dev)
    cfg = KGATConfig(ops_backend="hopper", coalesce=False)
    cfg_bf = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    model = bench.init_model(meta, cfg, dev)
    coalesced(g, cfg.coalesce_cap)          # the host build, untimed
    if dev.type == "cuda":
        hopper_build.library()              # the first-use nvcc build
    E = g.n_edges
    print(f"# {bench.device_name(dev)} preset={a.preset}: {E} edges, "
          f"{meta.n_nodes} nodes, {meta.n_relations} relations",
          flush=True)

    def t(name, fn):
        with torch.no_grad():
            ms = bench.median_time(fn, device=dev, iters=a.iters) * 1e3
        print(f"{name:32s} {ms:8.3f} ms   {E / (ms / 1e3) / 1e6:8.1f} "
              f"M edges/s", flush=True)

    # The whole pipeline (logits, softmax, both staged orders).
    for name, c in (("attention_for_training f32", cfg),
                    ("attention_for_training bf16", cfg_bf),
                    ("attention+coalesce bf16 (default)",
                     dataclasses.replace(cfg_bf, coalesce=True))):
        t(name, lambda c=c: kgat.attention_for_training(model, g, c))

    args = (g, model.entity_embed, model.w_rel, model.rel_embed)
    with torch.no_grad():
        if ops.use_dense_attention(g, cfg):
            name, logits_fn = "dense logits", lambda: \
                ops.attention_logits_dense(*args, cfg.att_table_dtype)
        else:
            name, logits_fn = "K2 logits (sddmm_transr)", lambda: \
                ops.attention_logits(*args)
        logits = logits_fn()
        w = ops.segment_softmax(g, logits)
    t(name, lambda: logits_fn().sum())
    for row in ("att->fwd scatter (legacy)", "att->fwd gather"):
        print(f"{row:32s} {ABSENT}", flush=True)
    t("K3 softmax (segment_softmax_csr)",
      lambda: ops.segment_softmax(g, logits).sum())
    rev = g.rev_perm.long()
    w16 = w.to(torch.bfloat16)
    t("rev gather f32", lambda: w[rev].sum())
    t("rev gather bf16", lambda: w16[rev].float().sum())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
