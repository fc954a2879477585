"""Seeded KGAT weights, made by the benchmark on the device.

Xavier-uniform weights and zero biases (KGAT's initialisation), drawn
with one ``torch.rand`` call on a generator of the run's device and cut
into the model's leaves. The benchmark hands the same weights to the
program (copied into its model) and to the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def derive(seed: int, stream: int) -> int:
    """A 62-bit seed for stream ``stream`` of run seed ``seed`` (any
    whole number)."""
    state = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return int(state.generate_state(1, np.uint64)[0]) >> 2


def leaf_shapes(model_cfg: dict, n_nodes: int,
                n_relations: int) -> List[Tuple[str, tuple]]:
    """(name, shape) of each leaf, named and laid out as
    ``kgat_tpu_torch.models.kgat.KGAT``'s parameters: a layer weight is
    (d_in, d_out)."""
    d, k = model_cfg["embed_dim"], model_cfg["relation_dim"]
    out = [("entity_embed", (n_nodes, d)), ("rel_embed", (n_relations, k)),
           ("w_rel", (n_relations, d, k))]
    agg, d_in = model_cfg["aggregator"], d
    for i, d_out in enumerate(model_cfg["conv_dims"]):
        if agg == "bi-interaction":
            out += [(f"layers.{i}.w1", (d_in, d_out)),
                    (f"layers.{i}.b1", (d_out,)),
                    (f"layers.{i}.w2", (d_in, d_out)),
                    (f"layers.{i}.b2", (d_out,))]
        else:
            fan = 2 * d_in if agg == "graphsage" else d_in
            out += [(f"layers.{i}.w", (fan, d_out)),
                    (f"layers.{i}.b", (d_out,))]
        d_in = d_out
    return out


def make(seed: int, stream: int, shapes: List[Tuple[str, tuple]],
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor}: U(-a, a) with a = sqrt(6 / (fan_in +
    fan_out)) over the last two dims, biases (one dim) zero."""
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(derive(seed, stream))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        u = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
        else:
            a = (6.0 / (shape[-2] + shape[-1])) ** 0.5
            out[name] = (2.0 * u - 1.0) * a
    return out


def copy_into(model: torch.nn.Module, w: Dict[str, torch.Tensor]) -> None:
    """The weights copied into the program's model, in place."""
    params = dict(model.named_parameters())
    if set(params) != set(w):
        raise ValueError(f"weights {sorted(w)} do not match the model's "
                         f"{sorted(params)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(w[name])
