"""KGAT serving forward as a PyTorch module.

Port of the inference half of ``kgat_tpu/models/kgat.py``:

  (A4) attention logit   pi(h,r,t) = (W_r e_t)^T tanh(W_r e_h + e_r)
  (A5) edge softmax      per-dst segment softmax (edges oriented t -> h)
  (A1-A3) propagation    GCN / GraphSage / bi-interaction aggregators
  final representation   e* = e^(0) || norm(e^(1)) || ... || norm(e^(L))

Parameters keep the JAX package's names and layouts (``w_rel`` is
(R, d, k); a layer weight is (d_in, d_out), not ``nn.Linear``'s
transpose), so :func:`params_from_jax` is a plain copy and the two
packages can be compared array for array. The layer-output handling is
the JAX package's: the L2-normalised copy of each layer's output goes into
the concat, the initial embedding enters it unnormalised.

Message dropout, the losses and gradients belong to training, which is not
ported yet: :func:`propagate` is the eval-mode forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kgat_tpu_torch.graph import CKGMeta, Graph
from kgat_tpu_torch.ops import BACKENDS, get_backend

AGGREGATORS = ("gcn", "graphsage", "bi-interaction")


@dataclasses.dataclass(frozen=True)
class KGATConfig:
    """Reference hyperparameter recipe (the fields serving reads)."""

    embed_dim: int = 64           # entity/user embedding dim d
    relation_dim: int = 64        # relation space dim k
    conv_dims: Tuple[int, ...] = (64, 32, 16)
    aggregator: str = "bi-interaction"  # gcn | graphsage | bi-interaction
    leaky_relu_slope: float = 0.2
    ops_backend: str = "ref"            # ref | hopper
    # SpMM value-stream dtype on the hopper backend (None = float32;
    # torch.bfloat16 halves the gathered bytes, accumulation stays f32).
    compute_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if self.ops_backend not in BACKENDS:
            raise ValueError(f"unknown ops backend {self.ops_backend!r}")

    @property
    def out_dim(self) -> int:
        return self.embed_dim + sum(self.conv_dims)


def _layer_shapes(cfg: KGATConfig):
    """[{param name: shape}] per layer, in the JAX package's layouts."""
    shapes, d_in = [], cfg.embed_dim
    for d_out in cfg.conv_dims:
        if cfg.aggregator == "gcn":
            shapes.append({"w": (d_in, d_out), "b": (d_out,)})
        elif cfg.aggregator == "graphsage":
            shapes.append({"w": (2 * d_in, d_out), "b": (d_out,)})
        else:
            shapes.append({"w1": (d_in, d_out), "b1": (d_out,),
                           "w2": (d_in, d_out), "b2": (d_out,)})
        d_in = d_out
    return shapes


class KGAT(nn.Module):
    """KGAT parameters: ``entity_embed`` (n_nodes, d), ``rel_embed`` (R, k),
    ``w_rel`` (R, d, k) and ``layers[i]`` holding ``w1, b1, w2, b2``
    (bi-interaction) or ``w, b`` (gcn, graphsage). Made uninitialised;
    use :func:`init_params` or :func:`params_from_jax`."""

    def __init__(self, n_nodes: int, n_relations: int, cfg: KGATConfig, *,
                 device=None):
        super().__init__()
        d, k = cfg.embed_dim, cfg.relation_dim
        empty = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=torch.float32, device=device))
        self.entity_embed = empty(n_nodes, d)
        self.rel_embed = empty(n_relations, k)
        self.w_rel = empty(n_relations, d, k)
        self.layers = nn.ModuleList(
            nn.ParameterDict({name: empty(*shape)
                              for name, shape in layer.items()})
            for layer in _layer_shapes(cfg))

    def forward(self, graph: Graph, cfg: KGATConfig) -> torch.Tensor:
        """Serving forward: attention, then propagation -> all_embed."""
        return propagate(self, graph, compute_attention(self, graph, cfg), cfg)


def init_params(n_nodes: int, n_relations: int, cfg: KGATConfig, *,
                generator: torch.Generator, device=None) -> KGAT:
    """Xavier-uniform weights, zero biases (the JAX package's init rule;
    the numbers differ, as the generators do). Weights are drawn on the
    CPU from ``generator`` and then moved, so a seed gives the same model
    on every device."""
    model = KGAT(n_nodes, n_relations, cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[-1].startswith("b"):
                p.zero_()
            else:
                limit = (6.0 / (p.shape[-2] + p.shape[-1])) ** 0.5
                p.uniform_(-limit, limit, generator=generator)
    return model.to(device)


def params_from_jax(params: Dict[str, Any], cfg: KGATConfig, *,
                    device=None) -> KGAT:
    """A :class:`KGAT` from a ``kgat_tpu`` params pytree given as numpy
    arrays: ``{"entity_embed", "rel_embed", "w_rel", "layers": [{...}]}``
    (what ``kgat_tpu_torch.utils.checkpoint.load_params`` returns)."""
    n_nodes = np.shape(params["entity_embed"])[0]
    n_relations = np.shape(params["rel_embed"])[0]
    model = KGAT(n_nodes, n_relations, cfg, device=device)
    expected = {name for name, _ in model.named_parameters()}
    given = {"entity_embed", "rel_embed", "w_rel"} | {
        f"layers.{i}.{name}" for i, layer in enumerate(params["layers"])
        for name in layer}
    if given != expected:
        raise ValueError(f"params do not match the config: missing "
                         f"{sorted(expected - given)}, unexpected "
                         f"{sorted(given - expected)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            node = params
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            value = torch.tensor(np.asarray(node, dtype=np.float32))
            if value.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                 f"config wants {tuple(p.shape)}")
            p.copy_(value)
    return model


def numpy_params(model: KGAT) -> Dict[str, Any]:
    """The model's parameters as a ``kgat_tpu``-shaped numpy pytree (the
    inverse of :func:`params_from_jax`)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return {"entity_embed": host(model.entity_embed),
            "rel_embed": host(model.rel_embed),
            "w_rel": host(model.w_rel),
            "layers": [{name: host(p) for name, p in layer.items()}
                       for layer in model.layers]}


# ---------------------------------------------------------------------------
# Attention (A4 + A5) and propagation (A1-A3).
# ---------------------------------------------------------------------------

def attention_logits(model: KGAT, graph: Graph,
                     cfg: KGATConfig) -> torch.Tensor:
    """(E,) unnormalised TransR attention logits in canonical edge order."""
    ops = get_backend(cfg.ops_backend)
    return ops.attention_logits(graph, model.entity_embed, model.w_rel,
                                model.rel_embed)


def compute_attention(model: KGAT, graph: Graph,
                      cfg: KGATConfig) -> torch.Tensor:
    """(E,) normalised edge attention: per-dst softmax of the logits."""
    ops = get_backend(cfg.ops_backend)
    return ops.segment_softmax(graph, attention_logits(model, graph, cfg))


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def propagate(model: KGAT, graph: Graph, edge_att: torch.Tensor,
              cfg: KGATConfig) -> torch.Tensor:
    """L-layer attentive propagation -> (n_nodes, cfg.out_dim).

    SpMM per layer: e_N(h) = sum over edges (t -> h) of att * e_t.
    """
    ops = get_backend(cfg.ops_backend)
    low = cfg.compute_dtype if cfg.ops_backend == "hopper" else None
    slope = cfg.leaky_relu_slope
    ego = model.entity_embed
    outs = [ego]
    for layer in model.layers:
        side = ops.spmm(graph, edge_att, ego if low is None else ego.to(low))
        if cfg.aggregator == "gcn":
            ego = _leaky((ego + side) @ layer["w"] + layer["b"], slope)
        elif cfg.aggregator == "graphsage":
            ego = _leaky(torch.cat([ego, side], -1) @ layer["w"] + layer["b"],
                         slope)
        else:  # bi-interaction
            ego = (_leaky((ego + side) @ layer["w1"] + layer["b1"], slope)
                   + _leaky((ego * side) @ layer["w2"] + layer["b2"], slope))
        outs.append(_l2norm(ego))
    return torch.cat(outs, dim=-1)


def cf_scores(all_embed: torch.Tensor, meta: CKGMeta, users: torch.Tensor,
              items: torch.Tensor) -> torch.Tensor:
    """y(u, i) = <e*_u, e*_i> for aligned index tensors (paper eq.12)."""
    return (all_embed[meta.user_node(users)] * all_embed[items]).sum(-1)
