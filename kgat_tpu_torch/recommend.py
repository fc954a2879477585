"""Serving path: top-K recommendations from a checkpoint, on a GPU.

Port of ``kgat_tpu/recommend.py``. Load a checkpoint (the JAX trainer's
format), run the KGAT forward once (attention recompute + L-layer
propagation), score the requested users against every item, mask the
user's train items, and take the top K:

    python -m kgat_tpu_torch.recommend --dataset yelp2018 \
        --ckpt runs/yelp_best --users 0,17,42 --k 20

Model hyperparameters come from the checkpoint's JSON sidecar; flags can
override them. Output is one JSON line per user:
{"user": u, "items": [...], "scores": [...]}.

The default is ``--device cuda --ops-backend hopper``: the forward runs
the hand-written kernels and fails if there is no GPU. ``--device cpu``
runs the plain PyTorch versions on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from kgat_tpu_torch.graph import CKGMeta, Graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGAT, KGATConfig
from kgat_tpu_torch.ops import BACKENDS
from kgat_tpu_torch.utils import trace
from kgat_tpu_torch.utils.checkpoint import load_params


def disable_tf32() -> None:
    """Keep float32 matmuls in full float32 on the GPU: the port computes
    in float32 end to end. TF32 keeps ~3 decimal digits and would move the
    scores by far more than the parity tolerances. The JAX reference on a
    TPU asks for HIGHEST in its attention only; its dense layers, the KG
    loss's TransR projection and the scores set no precision and run at
    XLA's DEFAULT there, one MXU pass over bf16-rounded operands
    (``tools/tpu_default_precision.py`` runs the trainer so). On the CPU,
    where the parity tests run it, XLA's dot is full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _forward(cfg: KGATConfig, model: KGAT, graph: Graph) -> torch.Tensor:
    """The serving forward (no gradient): attention, then propagation."""
    with trace.span("recommend.forward", device=model.entity_embed.device), \
            torch.no_grad():
        return model(graph, cfg)


def _validate(model: KGAT, meta: CKGMeta, cfg: KGATConfig, users):
    users = np.asarray(users, dtype=np.int64).reshape(-1)
    if users.size == 0:
        raise ValueError("no users given")
    if (users < 0).any() or (users >= meta.n_users).any():
        raise ValueError(f"user ids must be in [0, {meta.n_users})")
    n_rows, d0 = model.entity_embed.shape
    if n_rows != meta.n_nodes:
        raise ValueError(
            f"checkpoint embedding table has {n_rows} rows but the built "
            f"graph has {meta.n_nodes} nodes — wrong --dataset for this "
            f"checkpoint?")
    if d0 != cfg.embed_dim:
        raise ValueError(f"checkpoint embed_dim {d0} != config "
                         f"{cfg.embed_dim}")
    return users


class Recommender:
    """Persistent serving handle: the forward is cached across
    ``recommend()`` calls and recomputed only after ``refresh()``.

        rec = Recommender(model, graph, meta, cfg,
                          train_user_dict=ds.train_user_dict)
        items, scores = rec.recommend(user_ids, k=20)   # forward runs
        items, scores = rec.recommend(more_users)       # cached
        rec.refresh(new_model)                           # on retrain
    """

    def __init__(self, model: KGAT, graph: Graph, meta: CKGMeta,
                 cfg: KGATConfig, *, train_user_dict: Optional[dict] = None):
        self.model, self.graph, self.meta, self.cfg = model, graph, meta, cfg
        self.train_user_dict = train_user_dict
        self._all_embed = None

    def refresh(self, model: Optional[KGAT] = None) -> None:
        """Invalidate the cached forward (call after the params change)."""
        if model is not None:
            self.model = model
        self._all_embed = None

    @property
    def all_embed(self) -> torch.Tensor:
        if self._all_embed is None:
            self._all_embed = _forward(self.cfg, self.model, self.graph)
        return self._all_embed

    def recommend(self, users: Sequence[int], *, k: int = 20,
                  block: int = 2048):
        with trace.span("recommend.request"):
            users = _validate(self.model, self.meta, self.cfg, users)
            return _blocked_topk(self.all_embed, self.meta, users, k,
                                 self.train_user_dict, block)


def recommend(model: KGAT, graph: Graph, meta: CKGMeta, cfg: KGATConfig,
              users: Sequence[int], *, k: int = 20,
              train_user_dict: Optional[dict] = None, block: int = 2048):
    """Top-k (items, scores) numpy arrays for each user id. One-shot: runs
    the forward every call (hold a :class:`Recommender` to reuse it).

    Users are scored ``block`` at a time (the full score matrix of all
    users would not fit). ``train_user_dict``: {user: item ids} to mask
    with -inf before ranking; None disables masking. Slots whose score is
    -inf (fewer than k unmasked items) are returned as they are; the CLI
    drops them.
    """
    with trace.span("recommend.request"):
        users = _validate(model, meta, cfg, users)
        all_embed = _forward(cfg, model, graph)
        return _blocked_topk(all_embed, meta, users, k, train_user_dict,
                             block)


def _score_block(all_embed: torch.Tensor, user_nodes: torch.Tensor,
                 mask_pairs: torch.Tensor, n_items: int, k: int):
    """One block of users scored against every item -> per-user top k
    (``kgat_tpu/recommend.py``'s ``_score_block``): (B, n_items) scores,
    the (M, 2) ``mask_pairs`` [row in the block, item] set to -inf (the
    block's train interactions), then (top_items, top_scores), each
    (B, k)."""
    with torch.no_grad():
        scores = all_embed[user_nodes] @ all_embed[:n_items].T
        scores[mask_pairs[:, 0].long(), mask_pairs[:, 1].long()] = -torch.inf
        top_scores, top_items = torch.topk(scores, k, dim=1)
    return top_items, top_scores


def _blocked_topk(all_embed: torch.Tensor, meta: CKGMeta, users: np.ndarray,
                  k: int, train_user_dict: Optional[dict], block: int):
    """Each block of users in four stages, each a span: the mask pairs
    built on the host, the users and pairs copied to the device, the
    scoring enqueued, and the top k copied back (the first copy waits for
    the block)."""
    device = all_embed.device
    out_items = np.empty((len(users), k), np.int64)
    out_scores = np.empty((len(users), k), np.float32)
    for start in range(0, len(users), block):
        u_blk = users[start:start + block]
        with trace.span("recommend.mask"):
            pairs = np.zeros((0, 2), np.int64)
            if train_user_dict:
                per_user = [np.asarray(train_user_dict.get(int(u), ()),
                                       np.int64) for u in u_blk]
                rows = np.repeat(np.arange(len(u_blk)),
                                 [len(t) for t in per_user])
                pairs = np.stack([rows, np.concatenate(per_user)], axis=1)
        with trace.span("recommend.upload"):
            nodes = torch.as_tensor(meta.user_node(u_blk), device=device)
            pairs_t = torch.as_tensor(pairs, device=device)
        with trace.span("recommend.score"):
            top_items, top_scores = _score_block(all_embed, nodes, pairs_t,
                                                 meta.n_items, k)
        with trace.span("recommend.fetch"):
            out_items[start:start + len(u_blk)] = top_items.cpu().numpy()
            out_scores[start:start + len(u_blk)] = top_scores.cpu().numpy()
        trace.count("recommend.users", len(u_blk))
        trace.count("recommend.mask_pairs", len(pairs))
    return out_items, out_scores


def _model_cfg_from_meta(meta_json: dict, ops_backend: str,
                         overrides: dict) -> KGATConfig:
    m = dict(meta_json.get("model") or {})
    m.update({k: v for k, v in overrides.items() if v is not None})
    base = KGATConfig()
    return KGATConfig(
        embed_dim=int(m.get("embed_dim", base.embed_dim)),
        relation_dim=int(m.get("relation_dim", base.relation_dim)),
        conv_dims=tuple(int(d) for d in m.get("conv_dims", base.conv_dims)),
        aggregator=str(m.get("aggregator", base.aggregator)),
        ops_backend=ops_backend)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Top-K recommendations from a kgat_tpu checkpoint, "
                    "served with PyTorch")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint base path (without .npz), e.g. "
                        "runs/<run>_best")
    p.add_argument("--dataset", default=None,
                   help="dataset name (defaults to the one recorded in "
                        "the checkpoint)")
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--graph-cache", default=None, metavar="DIR",
                   help="directory of the built-graph npz cache "
                        "(Dataset.build(cache_dir=...))")
    p.add_argument("--users", default=None,
                   help="comma-separated user ids; default: all test users")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--include-train", action="store_true",
                   help="do NOT mask the user's train items")
    p.add_argument("--ops-backend", default="hopper", choices=list(BACKENDS))
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--out", default=None, help="output JSONL (default "
                                               "stdout)")
    # Model hyperparameters: normally restored from the checkpoint's JSON
    # sidecar; these override it.
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--relation-dim", type=int, default=None)
    p.add_argument("--conv-dims", default=None,
                   help="comma-separated layer dims, e.g. 64,32,16")
    p.add_argument("--aggregator", default=None,
                   choices=["gcn", "graphsage", "bi-interaction"])
    a = p.parse_args(argv)

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: serve on a GPU, or pass "
                         "--device cpu to run the plain PyTorch path")
    disable_tf32()
    params, meta_json = load_params(a.ckpt)
    dataset = a.dataset or meta_json.get("dataset")
    if not dataset or dataset == "synthetic":
        raise SystemExit("--dataset required (checkpoint records "
                         f"{meta_json.get('dataset')!r}; synthetic data is "
                         "not reconstructible from a name alone)")
    from kgat_tpu_torch.data import load_dataset
    ds = load_dataset(a.data_root, dataset)
    graph, meta = ds.build(cache_dir=a.graph_cache)
    overrides = {"embed_dim": a.embed_dim, "relation_dim": a.relation_dim,
                 "aggregator": a.aggregator,
                 "conv_dims": ([int(x) for x in a.conv_dims.split(",")]
                               if a.conv_dims else None)}
    cfg = _model_cfg_from_meta(meta_json, a.ops_backend, overrides)
    model = kgat.params_from_jax(params, cfg, device=device)

    if a.users:
        users = [int(u) for u in a.users.split(",")]
    else:
        users = sorted(ds.test_user_dict)
    items, scores = recommend(
        model, graph.to(device), meta, cfg, users, k=a.k,
        train_user_dict=None if a.include_train else ds.train_user_dict)

    out = open(a.out, "w") if a.out else sys.stdout
    try:
        for i, u in enumerate(users):
            # Drop -inf entries: a user with fewer than k unmasked items
            # gets a shorter list, not masked train items / non-RFC
            # "-Infinity" values in the JSON.
            finite = np.isfinite(scores[i])
            out.write(json.dumps({
                "user": int(u),
                "items": [int(x) for x in items[i][finite]],
                "scores": [round(float(s), 6) for s in scores[i][finite]],
            }) + "\n")
    finally:
        if a.out:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
