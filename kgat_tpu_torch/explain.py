"""Attention-based recommendation explanations (the KGAT case study).

Port of ``kgat_tpu/explain.py``. The learned edge attentions surface
*why* an item was recommended (KGAT paper §4.4, "attentive high-order
connectivity"): high-attention paths through the collaborative knowledge
graph that connect the user to the item.

    python -m kgat_tpu_torch.explain --ckpt runs/yelp_best \
        --dataset yelp2018 --user 17 --item 305 --hops 2

It loads a checkpoint (``kgat_tpu``'s format), computes the normalised
edge attentions on the card (K2, then K3), copies them to the host once
and runs a bidirectional attention-beam search there: from the user node
and from the item node, walk incoming-message edges (head -> tail, the
triples walked outward), keeping the partial paths of highest attention
product; where the two frontiers meet, the joined path is an explanation,
scored by the product of its edge attentions. Without ``--item`` the
item is the user's top recommendation (``recommend`` at k = 1, which
runs the forward: K2, K3 and K1 three times). Output is one JSON line,
the same as ``kgat_tpu.explain``'s.

The default is ``--device cuda --ops-backend hopper`` and fails without a
GPU; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kgat_tpu_torch.data import load_dataset
from kgat_tpu_torch.graph import CKGMeta, Graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops import BACKENDS
from kgat_tpu_torch.recommend import (_model_cfg_from_meta, disable_tf32,
                                      recommend)
from kgat_tpu_torch.utils.checkpoint import load_params


@dataclasses.dataclass(frozen=True)
class AttentionIndex:
    """Each node's top-``fanout`` incoming attention edges, on the host.

    Built once from the canonical (dst-sorted) edges and reused across
    explain calls. Node n's edges are ``[offsets[n], offsets[n + 1])`` of
    ``nbr`` (src node), ``rel`` (relation id) and ``att`` (normalised
    attention, float64), attention-descending; equal attentions keep
    their canonical order.
    """

    offsets: np.ndarray   # (n_nodes + 1,) int64
    nbr: np.ndarray       # (K,) int64
    rel: np.ndarray       # (K,) int64
    att: np.ndarray       # (K,) float64

    @property
    def n_nodes(self) -> int:
        return len(self.offsets) - 1

    def row(self, n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nbr, rel, att) of node n's kept in-edges."""
        lo, hi = self.offsets[n], self.offsets[n + 1]
        return self.nbr[lo:hi], self.rel[lo:hi], self.att[lo:hi]


def build_attention_index(graph: Graph, att, *, fanout: int = 16
                          ) -> AttentionIndex:
    """Group edges by dst and keep each node's top-``fanout`` by attention.

    One stable sort by (dst, -att) and a cut of each row to ``fanout``
    entries: the order of ``kgat_tpu``'s per-node stable argsort of -att
    within the canonical order, which the two packages share.
    """
    src = graph.src.cpu().numpy().astype(np.int64)
    dst = graph.dst.cpu().numpy().astype(np.int64)
    ety = graph.etype.cpu().numpy().astype(np.int64)
    offs = graph.row_offsets.cpu().numpy().astype(np.int64)
    a = np.asarray(att, dtype=np.float64)[: graph.n_edges]
    if (dst[:-1] > dst[1:]).any():
        raise ValueError("canonical edges must be dst-sorted")
    order = np.lexsort((-a, dst))           # stable: ties keep edge order
    # The sort keeps each row where it was, so position k is in row dst[k].
    keep = np.arange(len(order)) - offs[dst] < fanout
    sel = order[keep]
    counts = np.minimum(np.diff(offs), fanout)
    return AttentionIndex(
        offsets=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
        nbr=src[sel], rel=ety[sel], att=a[sel])


def _expand(index: AttentionIndex, start: int, hops: int, beam: int
            ) -> Dict[int, Tuple[float, List[Tuple[int, int, float]]]]:
    """Attention-product beam search over in-edges from ``start``.

    Returns {node: (best_weight, path)} over every node reached within
    ``hops`` steps, where path = [(from, rel, att), ...] of the steps taken
    (from = the previous node). The start node itself is included with
    weight 1.
    """
    best: Dict[int, Tuple[float, List[Tuple[int, int, float]]]] = {
        start: (1.0, [])}
    frontier = [(start, 1.0, [])]
    for _ in range(hops):
        scored = []
        for node, wgt, path in frontier:
            for s, r, a in zip(*index.row(node)):
                s = int(s)
                if s == node or s == start or any(s == p[0] for p in path):
                    continue  # simple paths only (also skips self-loops)
                scored.append((s, wgt * float(a),
                               path + [(node, int(r), float(a))]))
        scored.sort(key=lambda x: -x[1])
        frontier = scored[:beam]
        for node, wgt, path in frontier:
            if node not in best or wgt > best[node][0]:
                best[node] = (wgt, path)
    return best


def explain(graph: Graph, meta: CKGMeta, att, user: int, item: int, *,
            hops: int = 2, beam: int = 64, fanout: int = 16,
            n_paths: int = 3,
            index: Optional[AttentionIndex] = None) -> List[dict]:
    """Top attention paths connecting ``user`` and ``item``.

    Bidirectional: expand ``hops`` steps from each endpoint, join at
    meeting nodes, rank by the product of all edge attentions on the joined
    path. Returns at most ``n_paths`` dicts:
    ``{"strength", "meeting_node", "user_side", "item_side"}`` where each
    side is a list of {"from", "rel", "to", "att"} hops walking outward
    from its endpoint (triple direction: ``from --rel--> to``).
    """
    if not (0 <= user < meta.n_users):
        raise ValueError(f"user id must be in [0, {meta.n_users})")
    if not (0 <= item < meta.n_items):
        raise ValueError(f"item id must be in [0, {meta.n_items})")
    if index is None:
        index = build_attention_index(graph, att, fanout=fanout)
    u_node = int(meta.user_node(user))
    from_u = _expand(index, u_node, hops, beam)
    from_i = _expand(index, int(item), hops, beam)

    def render(path):
        return [{"from": f, "rel": r, "to": t, "att": round(a, 6)}
                for (f, r, a), t in zip(
                    path, [p[0] for p in path[1:]] + [None])]

    candidates = []
    for node in set(from_u) & set(from_i):
        wu, pu = from_u[node]
        wi, pi = from_i[node]
        if not pu and not pi:
            continue  # user == item is impossible; skip empty joins
        # keep the joined path simple: one side must not run through the
        # other side's endpoint (u -> i -> e <- i is not an explanation)
        if any(p[0] == item for p in pu) or any(p[0] == u_node for p in pi):
            continue
        candidates.append((wu * wi, node, pu, pi))
    candidates.sort(key=lambda x: -x[0])
    out = []
    for wgt, node, pu, pi in candidates[:n_paths]:
        su, si = render(pu), render(pi)
        if su:
            su[-1]["to"] = node
        if si:
            si[-1]["to"] = node
        out.append({"strength": wgt, "meeting_node": node,
                    "user_side": su, "item_side": si})
    return out


def node_kind(meta: CKGMeta, node: int) -> str:
    if node >= meta.n_entities:
        return f"user:{node - meta.n_entities}"
    if node < meta.n_items:
        return f"item:{node}"
    return f"entity:{node}"


def rel_kind(meta: CKGMeta, rel: int) -> str:
    R = meta.n_relations_kg
    if rel == meta.rel_interact:
        return "interact"
    if rel == meta.rel_interacted_by:
        return "interacted-by"
    return f"kg:{rel}" if rel < R else f"kg:{rel - R}^-1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Attention-path explanations from a kgat_tpu "
                    "checkpoint, computed with PyTorch")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--graph-cache", default=None, metavar="DIR")
    p.add_argument("--user", type=int, required=True)
    p.add_argument("--item", type=int, default=None,
                   help="item to explain; default: the user's top "
                        "recommendation")
    p.add_argument("--hops", type=int, default=2,
                   help="beam depth per side (2 covers u->i1->e<-i2<-i)")
    p.add_argument("--beam", type=int, default=64)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--n-paths", type=int, default=3)
    p.add_argument("--ops-backend", default="hopper", choices=list(BACKENDS))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    a = p.parse_args(argv)

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: explain on a GPU, or pass "
                         "--device cpu to run the plain PyTorch path")
    disable_tf32()
    params, meta_json = load_params(a.ckpt)
    dataset = a.dataset or meta_json.get("dataset")
    if not dataset or dataset == "synthetic":
        raise SystemExit("--dataset required (synthetic data is not "
                         "reconstructible from a name alone)")
    ds = load_dataset(a.data_root, dataset)
    graph, meta = ds.build(cache_dir=a.graph_cache)
    cfg = _model_cfg_from_meta(meta_json, a.ops_backend, {})
    model = kgat.params_from_jax(params, cfg, device=device)
    on_dev = graph.to(device)

    item = a.item
    if item is None:
        items, _ = recommend(model, on_dev, meta, cfg, [a.user], k=1,
                             train_user_dict=ds.train_user_dict)
        item = int(items[0][0])
    with torch.no_grad():
        att = kgat.compute_attention(model, on_dev, cfg).cpu().numpy()
    paths = explain(graph, meta, att, a.user, item, hops=a.hops,
                    beam=a.beam, fanout=a.fanout, n_paths=a.n_paths)
    for rec in paths:
        for side in ("user_side", "item_side"):
            for hop in rec[side]:
                hop["from_kind"] = node_kind(meta, hop["from"])
                hop["rel_kind"] = rel_kind(meta, hop["rel"])
                if hop["to"] is not None:
                    hop["to_kind"] = node_kind(meta, hop["to"])
    json.dump({"user": a.user, "item": item, "paths": paths}, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
