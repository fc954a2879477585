"""Run the port's trainer with a TPU's DEFAULT float32 matmul in the three
products where ``kgat_tpu`` sets no precision.

On a TPU, XLA computes a float32 dot that asks for no precision at
DEFAULT: one MXU pass over operands rounded to bf16, accumulated in
float32. ``kgat_tpu`` asks for HIGHEST in its attention only; three
products run at DEFAULT there:

* the aggregators' dense layers (``kgat_tpu/models/kgat.py:242-250``),
  here ``kgat_tpu_torch.ops.ref.aggregate``, the plain layer arithmetic.
  The hopper backend computes its bi-interaction layers on the card by
  its layer op (``ops/hopper/bi_layer.py``), in float32: this script
  sends that backend's ``layer`` and ``representation_rows`` to
  ``ref``'s, so that every layer of either backend is ``ref.aggregate``
  (its SpMM stays the backend's);
* the TransR projection of the KG loss (``kgat_tpu/models/kgat.py:319``),
  here ``ops.ref.project_rows`` (the ref backend's products, which the
  ``--sparse-adam`` KG step also calls). The hopper backend's
  ``kg_projection`` is its TransR op, in float32: this script sends it
  to ``ref``'s per-pair gather, whose products are ``project_rows``;
* the evaluation's scores (``kgat_tpu/eval.py:88``), here
  ``kgat_tpu_torch.eval.evaluate``.

This script replaces those functions, in its own process, by
versions whose products round both operands to bf16 (round to nearest
even) and multiply in float32, forward and backward: the product of two
bf16 values is exact in float32, so this is the MXU's one pass with
float32 accumulation. Then it runs ``kgat_tpu_torch.train.main`` on its
arguments. The replacements are made before the trainer is built, so its
captured steps (``train.StepGraph``) record them. ``kgat_tpu_torch``
itself computes these products in float32 and has no switch for this.

    python tools/tpu_default_precision.py --dataset yelp2018 \\
        --data-root datasets --ops-backend pallas --compute-dtype bf16 \\
        --epochs 2 --eval-every 2 --graph-cache runs/gcache \\
        --run-name torch-yelp2018-files-tpuprec-s1234
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kgat_tpu_torch import eval as evaluation  # noqa: E402
from kgat_tpu_torch import train  # noqa: E402
from kgat_tpu_torch.ops import hopper_backend, ref  # noqa: E402


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _OnePass(torch.autograd.Function):
    """``torch.einsum(spec, a, b)`` on bf16-rounded operands in float32;
    each backward product rounds its operands (the cotangent too), as
    XLA's transposed DEFAULT dots do."""

    @staticmethod
    def forward(ctx, spec, a, b):
        a, b = bf16_round(a), bf16_round(b)
        ctx.spec = spec
        ctx.save_for_backward(a, b)
        return torch.einsum(spec, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.spec.split("->")
        sa, sb = ins.split(",")
        g = bf16_round(g)
        ga = torch.einsum(f"{out},{sb}->{sa}", g, b)
        gb = torch.einsum(f"{sa},{out}->{sb}", a, g)
        return None, ga, gb


def one_pass(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _OnePass.apply(spec, a, b)


def aggregate(ego, side, layer, cfg):
    """``ref.aggregate`` with its dense layers at DEFAULT precision."""
    mm = lambda x, w: one_pass("nd,de->ne", x, w)  # noqa: E731
    slope = cfg.leaky_relu_slope
    if cfg.aggregator == "gcn":
        return ref.leaky(mm(ego + side, layer["w"]) + layer["b"], slope)
    if cfg.aggregator == "graphsage":
        return ref.leaky(mm(torch.cat([ego, side], -1), layer["w"])
                         + layer["b"], slope)
    return (ref.leaky(mm(ego + side, layer["w1"]) + layer["b1"], slope)
            + ref.leaky(mm(ego * side, layer["w2"]) + layer["b2"], slope))


def project_rows(eh, ep, en, w_r):
    """``ref.project_rows`` at DEFAULT precision."""
    proj = lambda e: one_pass("bd,bdk->bk", e, w_r)  # noqa: E731
    return proj(eh), proj(ep), proj(en)


_evaluate = evaluation.evaluate


def evaluate(all_embed, meta, plan, k=20, ks=()):
    """``evaluation.evaluate`` with its scores at DEFAULT precision: the
    embeddings are only read by the score product, so rounding them
    rounds both of its operands."""
    return _evaluate(bf16_round(all_embed), meta, plan, k=k, ks=ks)


def patches() -> list:
    """(module, name, replacement) of each function this script replaces,
    in the module that owns it: the three products, and the hopper
    backend's three model ops that compute them in float32, each by its
    ``ref`` counterpart, which reaches the replaced products."""
    return [(ref, "aggregate", aggregate),
            (ref, "project_rows", project_rows),
            (evaluation, "evaluate", evaluate),
            (hopper_backend, "layer", ref.layer),
            (hopper_backend, "representation_rows", ref.representation_rows),
            (hopper_backend, "kg_projection", ref.kg_projection)]


def install() -> None:
    """Replaces the functions."""
    for module, name, fn in patches():
        setattr(module, name, fn)


def main(argv=None) -> dict:
    install()
    return train.main(argv)


if __name__ == "__main__":
    main()
