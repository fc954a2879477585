"""Ranking metrics: recall@K, ndcg@K, precision@K, hit@K.

Port of ``kgat_tpu/utils/metrics.py``. Semantics (SURVEY.md §3.5): full
scoring against all items, train items masked, top-K, binary relevance,
log2 discount, IDCG from min(K, |test[u]|). Tensor code on the scores'
device; only the final sums go to the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def topk_metrics_multi(scores: torch.Tensor, test_mask: torch.Tensor,
                       ks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Per-user metrics at every K in ``ks`` from ONE top-max(K) ranking.

    scores: (B, n_items), train items already masked; test_mask: (B,
    n_items) bool or 0/1, the user's test positives. Each smaller K reads
    a prefix of the max(K) ranking, which is exact. Returns
    ``{"recall@20": (B,), ...}`` plus ``"valid"`` (users with a test item).
    """
    ks = tuple(int(k) for k in ks)
    kmax = max(ks)
    test_mask = test_mask.float()
    n_test = test_mask.sum(-1)                                   # (B,)
    top_idx = torch.topk(scores, kmax, dim=-1).indices           # (B, Kmax)
    hits = torch.gather(test_mask, -1, top_idx)                  # (B, Kmax)

    pos = torch.arange(kmax, dtype=torch.float32, device=scores.device)
    discounts = 1.0 / torch.log2(pos + 2.0)                      # (Kmax,)
    n_hit_pfx = hits.cumsum(-1)
    dcg_pfx = (hits * discounts).cumsum(-1)
    # IDCG@k = the sum of the first min(n_test, k) discounts.
    cum = torch.cat([discounts.new_zeros(1), discounts.cumsum(0)])

    out = {"valid": (n_test > 0).float()}
    for k in ks:
        n_hit = n_hit_pfx[:, k - 1]
        out[f"recall@{k}"] = torch.where(
            n_test > 0, n_hit / n_test.clamp(min=1.0), 0.0)
        out[f"precision@{k}"] = n_hit / k
        out[f"hit@{k}"] = (n_hit > 0).float()
        idcg = cum[torch.clamp(n_test, max=k).long()]
        out[f"ndcg@{k}"] = torch.where(
            idcg > 0, dcg_pfx[:, k - 1] / idcg.clamp(min=1e-12), 0.0)
    return out


def topk_metrics(scores: torch.Tensor, test_mask: torch.Tensor,
                 k: int) -> Dict[str, torch.Tensor]:
    """Per-user recall/ndcg/precision/hit at K for one user block, as (B,)
    tensors; users with no test item get 0s (``valid`` marks the rest)."""
    m = topk_metrics_multi(scores, test_mask, (k,))
    return {"recall": m[f"recall@{k}"], "ndcg": m[f"ndcg@{k}"],
            "precision": m[f"precision@{k}"], "hit": m[f"hit@{k}"],
            "valid": m["valid"]}
