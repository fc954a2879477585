"""The plain KGAT reference the benchmark holds the program to.

Plain PyTorch in float32 with TF32 off, written from the KGAT paper (Wang
et al., KDD 2019) and the reference recipe, and from nothing of the
program: it imports neither ``kgat_tpu``, ``kgat_tpu_torch`` nor JAX,
and works everything out from the benchmark's data (``dataset.Data``) and
weights (``weights.make``).

  attention    pi(h, r, t) = (W_r e_t)^T tanh(W_r e_h + e_r), softmax over
               the in-edges of each h (edges t -> h)
  propagation  e_N(h) = sum over edges t -> h of pi * e_t, then the
               aggregator (bi-interaction, GCN or GraphSage), message
               dropout, and e* = e0 || norm(e1) || ... || norm(eL)
  CF loss      BPR over (u, i+, i-), plus reg_cf 0.5 sum of squares / B
  KG loss      TransR, -log sigmoid(g(h, r, t-) - g(h, r, t+)) with
               g = ||W_r e_h + e_r - W_r e_t||^2, plus reg_kg likewise
  Adam         optax's arithmetic (eps outside the square root)
  serving      scores e*_u . e*_i, train items masked, top K

The configuration states its precision (``Precision``): float32 products
with TF32 off, and a value stream that the SpMM reads in bfloat16,
accumulating in float32. The reference computes exactly that: the
SpMM's features and its backward's cotangents rounded to the stream's
type, and, for training, the attention weights summed over each group
of at most ``coalesce_cap`` edges of one (dst, src) pair and the sum
rounded to it. The control (``Precision.lower``) is the same code one
step down: TF32 products, and an fp8 (e4m3, per-tensor scale) stream.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# optax.adam's defaults.
B1, B2, EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0
_LOWER = {None: "bf16", "bf16": "fp8"}


class Precision:
    """Where the arithmetic rounds: ``stream`` (None, 'bf16' or 'fp8') is
    the SpMM's value stream, ``tf32`` whether float32 products may run in
    TF32."""

    def __init__(self, stream: Optional[str], tf32: bool = False):
        if stream not in (None, "bf16", "fp8"):
            raise ValueError(f"unknown stream precision {stream!r}")
        self.stream, self.tf32 = stream, tf32

    def lower(self) -> "Precision":
        """The control: each stated precision one step down."""
        return Precision(_LOWER[self.stream], tf32=True)

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the stream's type, kept in float32."""
        if self.stream is None:
            return x
        if self.stream == "bf16":
            return x.to(torch.bfloat16).float()
        amax = x.detach().abs().max()
        if float(amax) == 0.0:
            return x
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @contextlib.contextmanager
    def products(self):
        """float32 products in the stated precision (TF32 or not)."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def precision_of(model_cfg: dict) -> Precision:
    """The precision a configuration file states."""
    return Precision(model_cfg.get("compute_dtype"), tf32=False)


class Graph:
    """The CKG's edges on the device, with each edge's coalescing group:
    the edges of one (dst, src) pair, in their order, in runs of at most
    ``cap`` (a longer run splits)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, etype: np.ndarray,
                 n_nodes: int, n_relations: int, cap: int, device):
        self.n_nodes, self.n_relations = n_nodes, n_relations
        on = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                       device=device)
        self.src, self.dst, self.etype = on(src), on(dst), on(etype)
        # The program's canonical edge order is the stable sort by dst; a
        # group is a run of one (dst, src) pair in that order.
        order = np.lexsort((np.arange(src.size), src, dst))
        s, d = src[order], dst[order]
        starts = np.ones(order.size, bool)
        starts[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        pos = np.arange(order.size)
        rank = pos - np.maximum.accumulate(np.where(starts, pos, 0))
        gid_sorted = np.cumsum(rank % cap == 0) - 1
        group = np.empty(order.size, np.int64)
        group[order] = gid_sorted
        first = np.nonzero(rank % cap == 0)[0]
        self.group = on(group)
        self.gsrc, self.gdst = on(s[first]), on(d[first])
        self.n_groups = int(first.size)
        by_rel = np.argsort(etype, kind="stable")
        bounds = np.searchsorted(etype[by_rel], np.arange(n_relations + 1))
        self.rel_edges = [on(by_rel[bounds[r]:bounds[r + 1]])
                          for r in range(n_relations)]


def segment_softmax(dst: torch.Tensor, logits: torch.Tensor,
                    n: int) -> torch.Tensor:
    m = torch.full((n,), -torch.inf, device=logits.device)
    m = m.scatter_reduce(0, dst, logits, "amax", include_self=True)
    e = torch.exp(logits - m[dst])
    s = torch.zeros(n, device=logits.device).index_add_(0, dst, e)
    return e / s[dst]


def attention(p: Dict[str, torch.Tensor], g: Graph, prec: Precision,
              chunk: int = 1 << 20) -> torch.Tensor:
    """(E,) attention weights, float32, in the edges' order."""
    emb, w_rel, rel = p["entity_embed"], p["w_rel"], p["rel_embed"]
    logits = torch.empty(g.src.shape[0], device=emb.device)
    with torch.no_grad(), prec.products():
        for r, edges in enumerate(g.rel_edges):
            for lo in range(0, edges.shape[0], chunk):
                e = edges[lo:lo + chunk]
                ph = emb[g.dst[e]] @ w_rel[r]
                pt = emb[g.src[e]] @ w_rel[r]
                logits[e] = (pt * torch.tanh(ph + rel[r])).sum(-1)
    return segment_softmax(g.dst, logits, g.n_nodes)


def training_weights(att: torch.Tensor, g: Graph, prec: Precision):
    """(src, dst, w) of the training SpMM: each group's summed weight,
    rounded to the stream's type."""
    w = torch.zeros(g.n_groups, device=att.device).index_add_(0, g.group, att)
    return g.gsrc, g.gdst, prec.round(w)


class _Spmm(torch.autograd.Function):
    """out[v] = sum over edges u -> v of w * round(x[u]), in float32; its
    gradient in x the same over the reversed edges of round(g), rounded."""

    @staticmethod
    def forward(ctx, x, w, src, dst, n, prec):
        ctx.save_for_backward(w, src, dst)
        ctx.n_in, ctx.prec = x.shape[0], prec
        xr = prec.round(x)
        return torch.zeros(n, x.shape[1], device=x.device).index_add_(
            0, dst, xr[src] * w[:, None])

    @staticmethod
    def backward(ctx, g):
        w, src, dst = ctx.saved_tensors
        gr = ctx.prec.round(g)
        dx = torch.zeros(ctx.n_in, g.shape[1], device=g.device).index_add_(
            0, src, gr[dst] * w[:, None])
        return ctx.prec.round(dx), None, None, None, None, None


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def aggregate(ego, side, p, li: int, agg: str):
    if agg == "gcn":
        return _leaky((ego + side) @ p[f"layers.{li}.w"] + p[f"layers.{li}.b"])
    if agg == "graphsage":
        return _leaky(torch.cat([ego, side], -1) @ p[f"layers.{li}.w"]
                      + p[f"layers.{li}.b"])
    return (_leaky((ego + side) @ p[f"layers.{li}.w1"] + p[f"layers.{li}.b1"])
            + _leaky((ego * side) @ p[f"layers.{li}.w2"]
                     + p[f"layers.{li}.b2"]))


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=1e-12))


def propagate(p, spmm_edges, n_nodes: int, mc: dict, prec: Precision,
              masks: Optional[Sequence[Optional[torch.Tensor]]] = None):
    """(n_nodes, d + sum(conv_dims)) final representations; ``masks``
    (keep masks per layer) applies message dropout."""
    src, dst, w = spmm_edges
    ego = p["entity_embed"]
    outs = [ego]
    with prec.products():
        for li, rate in enumerate(mc["mess_dropout"]):
            side = _Spmm.apply(ego, w, src, dst, n_nodes, prec)
            ego = aggregate(ego, side, p, li, mc["aggregator"])
            if masks is not None and rate > 0:
                ego = torch.where(masks[li], ego / (1.0 - rate), 0.0)
            outs.append(l2norm(ego))
    return torch.cat(outs, -1)


def weighted_mean(terms, weight):
    return (terms * weight).sum() / weight.sum().clamp(min=1.0)


def cf_loss(p, edges, n_nodes, n_entities, batch, masks, mc, prec):
    u, i_pos, i_neg, weight = batch
    emb = propagate(p, edges, n_nodes, mc, prec, masks)
    with prec.products():
        eu, ep, en = emb[n_entities + u], emb[i_pos], emb[i_neg]
        bpr = -F.logsigmoid((eu * ep).sum(-1) - (eu * en).sum(-1))
        reg = 0.5 * ((eu ** 2).sum() + (ep ** 2).sum() + (en ** 2).sum())
        return weighted_mean(bpr, weight) + mc["reg_cf"] * reg / u.shape[0]


def kg_loss(p, batch, mc, prec):
    h, r, t_pos, t_neg, weight = batch
    emb = p["entity_embed"]
    w_r, e_r = p["w_rel"][r], p["rel_embed"][r]
    with prec.products():
        proj = lambda e: torch.bmm(e[:, None, :], w_r)[:, 0]  # noqa: E731
        ph, pp, pn = proj(emb[h]), proj(emb[t_pos]), proj(emb[t_neg])
        g_pos = ((ph + e_r - pp) ** 2).sum(-1)
        g_neg = ((ph + e_r - pn) ** 2).sum(-1)
        pair = -F.logsigmoid(g_neg - g_pos)
        reg = 0.5 * sum((t ** 2).sum() for t in (ph, e_r, pp, pn))
        return weighted_mean(pair, weight) + mc["reg_kg"] * reg / h.shape[0]


def adam(p, m, v, g, count: int, lr: float):
    """optax.adam's update of one leaf; returns (p, m, v)."""
    m = B1 * m + (1.0 - B1) * g
    v = B2 * v + (1.0 - B2) * g * g
    mhat = m / (1.0 - B1 ** count)
    vhat = v / (1.0 - B2 ** count)
    return p - lr * mhat / (vhat.sqrt() + EPS), m, v


def train_steps(init: Dict[str, torch.Tensor], g: Graph, data_sizes: dict,
                steps: List[tuple], mc: dict, lr: float,
                prec: Precision) -> dict:
    """The trainer's first steps from ``init``: ``steps`` is a list of
    ("cf", (u, i+, i-, weight), masks) and ("kg", (h, r, t+, t-, weight),
    None). The CF steps read the attention staged from ``init``. Returns
    each step's loss, each step's gradient, the first step's gradient as
    Adam's first moment gives it back, and the parameters after the
    last step."""
    n_nodes, n_ent = data_sizes["n_nodes"], data_sizes["n_entities"]
    p = {k: t.detach().clone() for k, t in init.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    edges = training_weights(attention(p, g, prec), g, prec)
    losses, grads = [], []
    first = None
    for count, (kind, batch, masks) in enumerate(steps, start=1):
        leaves = {k: t.requires_grad_() for k, t in p.items()}
        if kind == "cf":
            loss = cf_loss(leaves, edges, n_nodes, n_ent, batch, masks, mc,
                           prec)
        else:
            loss = kg_loss(leaves, batch, mc, prec)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        grad = {k: torch.zeros_like(t) if gk is None else gk
                for (k, t), gk in zip(leaves.items(), gs)}
        losses.append(float(loss.detach()))
        grads.append(grad)
        with torch.no_grad():
            for k in p:
                p[k], m[k], v[k] = adam(p[k].detach(), m[k], v[k], grad[k],
                                        count, lr)
        if first is None:
            first = {k: m[k] / (1.0 - B1) for k in m}
    return {"losses": losses, "grads": grads, "first_grad": first,
            "params": {k: t.detach() for k, t in p.items()}}


def serve_embed(p: Dict[str, torch.Tensor], g: Graph, mc: dict,
                prec: Precision) -> torch.Tensor:
    """The serving forward: attention, then propagation over every edge
    with its own weight (no coalescing, no rounding of the weights)."""
    with torch.no_grad():
        att = attention(p, g, prec)
        return propagate(p, (g.src, g.dst, att), g.n_nodes, mc, prec)


def scores(emb: torch.Tensor, users: torch.Tensor, n_entities: int,
           n_items: int, train_ptr: torch.Tensor, train_items: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """(B, n_items) scores of ``users``, their train items set to -inf."""
    with torch.no_grad(), prec.products():
        s = emb[n_entities + users] @ emb[:n_items].T
    lo, hi = train_ptr[users], train_ptr[users + 1]
    counts = hi - lo
    rows = torch.repeat_interleave(torch.arange(users.shape[0],
                                                device=s.device), counts)
    start = torch.cumsum(counts, 0) - counts
    idx = lo[rows] + torch.arange(rows.shape[0], device=s.device) - start[rows]
    s[rows, train_items[idx]] = -torch.inf
    return s
