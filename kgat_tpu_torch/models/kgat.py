"""KGAT as a PyTorch module: the serving forward and the training losses.

Port of ``kgat_tpu/models/kgat.py``:

  (A4) attention logit   pi(h,r,t) = (W_r e_t)^T tanh(W_r e_h + e_r)
  (A5) edge softmax      per-dst segment softmax (edges oriented t -> h)
  (A1-A3) propagation    GCN / GraphSage / bi-interaction aggregators
  final representation   e* = e^(0) || norm(e^(1)) || ... || norm(e^(L))
  BPR CF loss (eq.13), TransR KG loss (eqs.1-2)

Parameters keep the JAX package's names and layouts (``w_rel`` is
(R, d, k); a layer weight is (d_in, d_out), not ``nn.Linear``'s
transpose), so :func:`params_from_jax` is a plain copy and the two
packages can be compared array for array. The layer-output handling is
the JAX package's: message dropout applies to the layer output that feeds
the next layer, the L2-normalised copy of it goes into the concat, and the
initial embedding enters the concat unnormalised.

Randomness comes from explicit ``torch.Generator``s: the dropout masks of
:func:`propagate` from the one passed in (on the graph's device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kgat_tpu_torch.graph import CKGMeta, EdgeWeights, Graph, stage_weights
from kgat_tpu_torch.ops import BACKENDS, get_backend

AGGREGATORS = ("gcn", "graphsage", "bi-interaction")
ATT_IMPLS = ("auto", "dense", "relblock")


@dataclasses.dataclass(frozen=True)
class KGATConfig:
    """Reference hyperparameter recipe (SURVEY.md §2.9)."""

    embed_dim: int = 64           # entity/user embedding dim d
    relation_dim: int = 64        # relation space dim k
    conv_dims: Tuple[int, ...] = (64, 32, 16)
    mess_dropout: Tuple[float, ...] = (0.1, 0.1, 0.1)  # per layer, training
    aggregator: str = "bi-interaction"  # gcn | graphsage | bi-interaction
    leaky_relu_slope: float = 0.2
    reg_cf: float = 1e-5
    reg_kg: float = 1e-5
    ops_backend: str = "ref"            # ref | hopper
    # SpMM value-stream dtype on the hopper backend (None = float32;
    # torch.bfloat16 halves the gathered bytes, accumulation stays f32).
    # The staged attention weights are rounded to it too, as kgat_tpu's.
    compute_dtype: Optional[torch.dtype] = None
    # The training attention's logits route on the hopper backend: 'auto'
    # (the dense projected tables when they fit kgat_tpu's size bound,
    # else the relation-tile kernel K2), 'dense' or 'relblock'
    # (hopper_backend.use_dense_attention).
    att_impl: str = "auto"
    # The dense route's table dtype (None = float32; torch.bfloat16).
    att_table_dtype: Optional[torch.dtype] = None
    # Coalesce multi-edges for the training SpMM (hopper backend, one
    # device and the all-gather's shards): the members of one (dst, src)
    # pair reduce once with their weights summed (graph.Coalesced).
    coalesce: bool = True
    # Most members of a coalesced group (a longer run splits).
    coalesce_cap: int = 8

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        if self.ops_backend not in BACKENDS:
            raise ValueError(f"unknown ops backend {self.ops_backend!r}")
        if self.att_impl not in ATT_IMPLS:
            raise ValueError(f"unknown att_impl {self.att_impl!r}")

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
                generator: torch.Generator, device=None,
                pretrain=None) -> KGAT:
    """Xavier-uniform weights, zero biases (the JAX package's init rule;
    the numbers differ, as the generators do). Weights are drawn on the
    CPU from ``generator`` and then moved, so a seed gives the same model
    on every device.

    ``pretrain``: optional ``(user_embed, item_embed, n_entities)``, the
    BPR-MF embeddings of a ``--use-pretrain`` npz (``models/bprmf.py``):
    item rows go to entity ids [0, n_items), user rows to n_entities +
    uid, as ``kgat_tpu``'s ``init_params`` places them."""
    model = KGAT(n_nodes, n_relations, cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.split(".")[-1].startswith("b"):
                p.zero_()
            else:
                limit = (6.0 / (p.shape[-2] + p.shape[-1])) ** 0.5
                p.uniform_(-limit, limit, generator=generator)
        if pretrain is not None:
            user_embed, item_embed, n_entities = pretrain
            user_embed = torch.as_tensor(np.asarray(user_embed, np.float32))
            item_embed = torch.as_tensor(np.asarray(item_embed, np.float32))
            if (user_embed.shape[1] != cfg.embed_dim
                    or item_embed.shape[1] != cfg.embed_dim):
                raise ValueError("pretrain dims do not match embed_dim")
            emb = model.entity_embed
            emb[:item_embed.shape[0]] = item_embed
            emb[n_entities:n_entities + user_embed.shape[0]] = user_embed
    return model.to(device)


def params_from_jax(params: Dict[str, Any], cfg: KGATConfig, *,
                    device=None) -> KGAT:
    """A :class:`KGAT` from a ``kgat_tpu`` params pytree given as numpy
    arrays: ``{"entity_embed", "rel_embed", "w_rel", "layers": [{...}]}``
    (what ``kgat_tpu_torch.utils.checkpoint.load_params`` returns)."""
    n_nodes = np.shape(params["entity_embed"])[0]
    n_relations = np.shape(params["rel_embed"])[0]
    model = KGAT(n_nodes, n_relations, cfg, device=device)
    copy_params_(model, params)
    return model


def copy_params_(model: KGAT, tree: Dict[str, Any],
                 of: Callable[[torch.Tensor], torch.Tensor] = lambda p: p
                 ) -> None:
    """Copies a ``kgat_tpu``-shaped numpy pytree into ``of(p)`` for each
    parameter p, in place: the parameters themselves, or for example
    their Adam moments. The tree must name every parameter, with its
    shape."""
    expected = {name for name, _ in model.named_parameters()}
    given = {"entity_embed", "rel_embed", "w_rel"} | {
        f"layers.{i}.{name}" for i, layer in enumerate(tree["layers"])
        for name in layer}
    if given != expected:
        raise ValueError(f"params do not match the config: missing "
                         f"{sorted(expected - given)}, unexpected "
                         f"{sorted(given - expected)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            value = torch.tensor(np.asarray(node, dtype=np.float32))
            if value.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                 f"config wants {tuple(p.shape)}")
            of(p).copy_(value)


def numpy_params(model: KGAT,
                 of: Callable[[torch.Tensor], torch.Tensor] = lambda p: p
                 ) -> Dict[str, Any]:
    """``of(p)`` for each parameter p (default: the parameters) as a
    ``kgat_tpu``-shaped numpy pytree (the inverse of
    :func:`params_from_jax` and :func:`copy_params_`)."""
    host = lambda t: of(t).detach().cpu().numpy()  # noqa: E731
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


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def attention_for_training(model: KGAT, graph: Graph,
                           cfg: KGATConfig) -> EdgeWeights:
    """Per-epoch attention recompute, no grad, staged for the hot loop
    (``kgat_tpu``'s ``attention_for_training``, ``models/kgat.py:
    185-199``). On the hopper backend, as ``kgat_tpu``'s pallas backend
    (``pallas_backend.attention_prepared``): the logits by the
    dense-projection route where ``cfg.att_impl`` resolves to it, else by
    K2; K3's softmax; the weights summed over the coalesced groups when
    ``cfg.coalesce``, and rounded to ``cfg.compute_dtype``. The ref
    backend stages the canonical float32 weights."""
    with torch.no_grad():
        if cfg.ops_backend != "hopper":
            return EdgeWeights.stage(graph,
                                     compute_attention(model, graph, cfg))
        ops = get_backend(cfg.ops_backend)
        if ops.use_dense_attention(graph, cfg):
            logits = ops.attention_logits_dense(
                graph, model.entity_embed, model.w_rel, model.rel_embed,
                cfg.att_table_dtype)
        else:
            logits = attention_logits(model, graph, cfg)
        return stage_weights(graph, ops.segment_softmax(graph, logits),
                             dtype=cfg.compute_dtype, coalesce=cfg.coalesce,
                             cap=cfg.coalesce_cap)


def aggregate(ego: torch.Tensor, side: torch.Tensor, layer,
              cfg: KGATConfig) -> torch.Tensor:
    """One layer's aggregator (A1-A3) over a node's own embedding ``ego``
    and its neighbourhood sum ``side``; ``layer`` maps the layer's
    parameter names to tensors."""
    slope = cfg.leaky_relu_slope
    if cfg.aggregator == "gcn":
        return _leaky((ego + side) @ layer["w"] + layer["b"], slope)
    if cfg.aggregator == "graphsage":
        return _leaky(torch.cat([ego, side], -1) @ layer["w"] + layer["b"],
                      slope)
    return (_leaky((ego + side) @ layer["w1"] + layer["b1"], slope)
            + _leaky((ego * side) @ layer["w2"] + layer["b2"], slope))


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep mask of message dropout: each entry kept with probability
    1 - rate, drawn from ``generator``."""
    if generator is None:
        raise ValueError("message dropout needs a generator")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_dropout(ego: torch.Tensor, mask: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """The kept entries scaled by 1 / (1 - rate), the others 0."""
    keep = 1.0 - rate
    return torch.where(mask, ego / keep, 0.0)


def dropout(ego: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Message dropout: each entry kept with probability 1 - rate and
    scaled by 1 / (1 - rate), with the mask drawn from ``generator``."""
    return apply_dropout(
        ego, dropout_mask(ego.shape, rate, generator, ego.device), rate)


def dropout_masks(cfg: KGATConfig, n_nodes: int,
                  generator: Optional[torch.Generator],
                  device) -> List[Optional[torch.Tensor]]:
    """The keep masks of one training forward over ``n_nodes`` nodes, one
    per layer (None where the rate is 0), drawn from ``generator`` in
    layer order: the same numbers :func:`propagate` draws when it is given
    no masks."""
    check_dropout(cfg)
    return [dropout_mask((n_nodes, d_out), rate, generator, device)
            if rate > 0 else None
            for d_out, rate in zip(cfg.conv_dims, cfg.mess_dropout)]


def check_dropout(cfg: KGATConfig) -> None:
    if len(cfg.mess_dropout) != len(cfg.conv_dims):
        raise ValueError(f"{len(cfg.mess_dropout)} dropout rates for "
                         f"{len(cfg.conv_dims)} layers")


def propagate(model: KGAT, graph: Graph, edge_att, cfg: KGATConfig, *,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              masks: Optional[Sequence[Optional[torch.Tensor]]] = None
              ) -> torch.Tensor:
    """L-layer attentive propagation -> (n_nodes, cfg.out_dim).

    SpMM per layer: e_N(h) = sum over edges (t -> h) of att * e_t.
    ``edge_att`` is canonical (E,) weights or staged :class:`EdgeWeights`.
    ``train=True`` applies message dropout, with the keep masks ``masks``
    (:func:`dropout_masks`) or, without them, masks drawn from
    ``generator`` (on the graph's device).
    """
    ops = get_backend(cfg.ops_backend)
    low = cfg.compute_dtype if cfg.ops_backend == "hopper" else None
    if train:
        check_dropout(cfg)
    ego = model.entity_embed
    outs = [ego]
    for li, layer in enumerate(model.layers):
        side = ops.spmm(graph, edge_att, ego if low is None else ego.to(low))
        ego = aggregate(ego, side, layer, cfg)
        rate = cfg.mess_dropout[li]
        if train and rate > 0:
            ego = (dropout(ego, rate, generator) if masks is None
                   else apply_dropout(ego, masks[li], rate))
        outs.append(l2norm(ego))
    return torch.cat(outs, dim=-1)


def cf_scores(all_embed: torch.Tensor, meta: CKGMeta, users: torch.Tensor,
              items: torch.Tensor) -> torch.Tensor:
    """y(u, i) = <e*_u, e*_i> for aligned index tensors (paper eq.12)."""
    return (all_embed[meta.user_node(users)] * all_embed[items]).sum(-1)


# ---------------------------------------------------------------------------
# CF (BPR) and KG (TransR) losses.
# ---------------------------------------------------------------------------

def _l2_reg_mean(*tensors: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of squares, averaged over the batch (torch-reference
    style)."""
    b = tensors[0].shape[0]
    return sum(0.5 * (t.float() ** 2).sum() for t in tensors) / b


def weighted_mean(terms: torch.Tensor,
                  weight: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``terms``, or their ``weight``-weighted mean over a
    total weight of at least 1."""
    if weight is None:
        return terms.mean()
    return (terms * weight).sum() / weight.sum().clamp(min=1.0)


def cf_loss(model: KGAT, graph: Graph, edge_att, meta: CKGMeta,
            users: torch.Tensor, pos_items: torch.Tensor,
            neg_items: torch.Tensor, cfg: KGATConfig, *,
            generator: Optional[torch.Generator] = None, train: bool = True,
            weight: Optional[torch.Tensor] = None,
            masks: Optional[Sequence[Optional[torch.Tensor]]] = None
            ) -> torch.Tensor:
    """BPR loss over a minibatch with full-graph propagation (SURVEY.md
    §3.3). ``weight`` (B,) optionally down-weights batch rows (the device
    sampler gives weight 0 to a row with no allowed negative); ``masks``
    are the dropout masks (:func:`propagate`)."""
    all_embed = propagate(model, graph, edge_att, cfg, train=train,
                          generator=generator, masks=masks)
    u = all_embed[meta.user_node(users)]
    ip = all_embed[pos_items]
    ineg = all_embed[neg_items]
    bpr = -F.logsigmoid((u * ip).sum(-1) - (u * ineg).sum(-1))
    return weighted_mean(bpr, weight) + cfg.reg_cf * _l2_reg_mean(u, ip,
                                                                   ineg)


def kg_pair_terms_rows(eh: torch.Tensor, ep: torch.Tensor, en: torch.Tensor,
                       e_r: torch.Tensor, w_r: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-based TransR core: per-pair losses and the 0.5 * sum-of-squares
    regularizer from gathered rows — eh/ep/en (B, d) head, positive and
    negative tail rows, e_r (B, k), w_r (B, d, k)."""
    proj = lambda e: torch.einsum("bd,bdk->bk", e, w_r)  # noqa: E731
    ph, pp, pn = proj(eh), proj(ep), proj(en)
    g_pos = ((ph + e_r - pp) ** 2).sum(-1)
    g_neg = ((ph + e_r - pn) ** 2).sum(-1)
    pair = -F.logsigmoid(g_neg - g_pos)
    ssq = sum(0.5 * (t.float() ** 2).sum() for t in (ph, e_r, pp, pn))
    return pair, ssq


def kg_pair_terms(model: KGAT, h: torch.Tensor, r: torch.Tensor,
                  t_pos: torch.Tensor, t_neg: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TransR per-pair loss terms and regularizer sum for index tensors."""
    emb = model.entity_embed
    return kg_pair_terms_rows(emb[h], emb[t_pos], emb[t_neg],
                              model.rel_embed[r], model.w_rel[r])


def kg_loss(model: KGAT, h: torch.Tensor, r: torch.Tensor,
            t_pos: torch.Tensor, t_neg: torch.Tensor, cfg: KGATConfig,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TransR pairwise loss (paper eqs.1-2): plausibility g(h,r,t) =
    ||W_r e_h + e_r - W_r e_t||^2, minimise -log sigmoid(g(h,r,t-) -
    g(h,r,t+)), plus ``reg_kg`` times the mean regularizer. No graph ops
    (SURVEY.md §3.4)."""
    pair, ssq = kg_pair_terms(model, h, r, t_pos, t_neg)
    return weighted_mean(pair, weight) + cfg.reg_kg * ssq / h.shape[0]
