"""Full-ranking evaluation: recall@K / ndcg@K against all items.

Port of ``kgat_tpu/eval.py``. Semantics (SURVEY.md §3.5): for each block
of test users, score U_block @ I^T over the final concatenated
representations, mask the user's train items, take the top K and compute
the metrics. The plan is the JAX package's: users in fixed-size blocks and
each block's (row, item) train and test pairs, built once on the host. The
blocks run on the embeddings' device; the metric sums come back to the
host once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from kgat_tpu_torch.graph import CKGMeta
from kgat_tpu_torch.utils.metrics import topk_metrics_multi


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """Host-precomputed, padded per-block index tables."""

    user_blocks: np.ndarray   # (n_blocks, block) int32, padded with -1
    train_pairs: np.ndarray   # (n_blocks, max_tr, 2) [row_in_block, item], pad -> (block, 0)
    test_pairs: np.ndarray    # (n_blocks, max_te, 2)
    block: int
    n_items: int


def make_eval_plan(train_user_dict: Dict[int, np.ndarray],
                   test_user_dict: Dict[int, np.ndarray],
                   n_items: int, block: int = 2048) -> EvalPlan:
    """The test users in blocks of ``block``, with every block's train and
    test (row, item) pairs (``kgat_tpu.eval.make_eval_plan``)."""
    test_users = np.asarray(sorted(test_user_dict), dtype=np.int32)
    n_blocks = max(1, -(-len(test_users) // block))
    ub = np.full((n_blocks, block), -1, np.int32)
    ub.flat[: len(test_users)] = test_users

    def pack(user_dict):
        empty = np.full((n_blocks, 1, 2), [block, 0], np.int32)
        keys = np.asarray(sorted(user_dict), dtype=np.int64)
        if keys.size == 0 or test_users.size == 0:
            return empty
        lists = [np.asarray(user_dict[int(u)]).ravel() for u in keys]
        counts = np.asarray([x.size for x in lists], np.int64)
        pos = np.searchsorted(test_users, keys)
        posc = np.minimum(pos, test_users.size - 1)
        valid = (pos < test_users.size) & (test_users[posc] == keys)
        if not valid.any():
            return empty
        items = np.concatenate([x for x, v in zip(lists, valid) if v])
        u_pos = np.repeat(pos[valid], counts[valid])  # nondecreasing
        b = u_pos // block
        j = u_pos % block
        blk_counts = np.bincount(b, minlength=n_blocks)
        blk_start = np.concatenate([[0], np.cumsum(blk_counts)[:-1]])
        off = np.arange(u_pos.size) - blk_start[b]
        max_rows = max(1, int(blk_counts.max()))
        out = np.full((n_blocks, max_rows, 2), [block, 0], np.int32)
        out[b, off, 0] = j
        out[b, off, 1] = items
        return out

    return EvalPlan(user_blocks=ub, train_pairs=pack(train_user_dict),
                    test_pairs=pack(test_user_dict), block=block,
                    n_items=n_items)


def _block_pairs(pairs: np.ndarray, block: int, device):
    """The real (row, item) pairs of one block as two index tensors."""
    real = pairs[pairs[:, 0] < block].astype(np.int64)
    return (torch.as_tensor(real[:, 0], device=device),
            torch.as_tensor(real[:, 1], device=device))


def evaluate(all_embed: torch.Tensor, meta: CKGMeta, plan: EvalPlan,
             k: int = 20, ks: tuple = ()) -> Dict[str, float]:
    """Run the blocked evaluation; returns the metrics averaged over test
    users, with the keys of ``kgat_tpu.eval.evaluate``.

    ``k`` is the primary cutoff (early stopping, plain-named keys); ``ks``
    adds cutoffs reported as ``recall@K``-style keys. All cutoffs share one
    ranking per block.
    """
    all_ks = tuple(dict.fromkeys((int(k), *(int(x) for x in ks))))
    dev = all_embed.device
    neg = torch.finfo(all_embed.dtype).min
    item_embed = all_embed[: plan.n_items]
    sums: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for b in range(plan.user_blocks.shape[0]):
            ub = torch.as_tensor(plan.user_blocks[b], device=dev).long()
            rows = torch.where(ub >= 0, meta.user_node(ub), 0)
            scores = all_embed[rows] @ item_embed.T             # (B, n_items)
            scores[_block_pairs(plan.train_pairs[b], plan.block, dev)] = neg
            test_mask = torch.zeros_like(scores)
            test_mask[_block_pairs(plan.test_pairs[b], plan.block, dev)] = 1.0
            m = topk_metrics_multi(scores, test_mask, all_ks)
            valid = m.pop("valid") * (ub >= 0)
            for name, v in m.items():
                sums[name] = sums.get(name, 0.0) + (v * valid).sum()
            sums["valid"] = sums.get("valid", 0.0) + valid.sum()
    n = max(float(sums.pop("valid")), 1.0)
    res = {name: float(v) / n for name, v in sums.items()}
    for name in ("recall", "ndcg", "precision", "hit"):
        res[name] = res[f"{name}@{k}"]
        if len(all_ks) == 1:
            del res[f"{name}@{k}"]
    return res
