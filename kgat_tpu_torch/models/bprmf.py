"""BPR-MF pretrainer: the npz that ``--use-pretrain`` reads.

Port of ``kgat_tpu/models/bprmf.py``. The reference workflow (SURVEY.md
§2.1 pretrain-loader row; KGAT paper §4.2) starts KGAT's user and item
embeddings from a matrix factorisation trained with the BPR loss:

    python -m kgat_tpu_torch.models.bprmf --dataset amazon-book --out mf.npz
    python -m kgat_tpu_torch.train --dataset amazon-book --use-pretrain mf.npz

A step draws a batch with the device sampler, takes the weighted BPR loss
and its gradient, and runs Adam; on CUDA the steps replay one captured
step (``train.StepGraph``). The npz (``user_embed``, ``item_embed``) is
interchangeable with ``kgat_tpu``'s both ways. ``--device cpu`` runs on
the CPU; the default is the card.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kgat_tpu_torch.optim import make_optimizer
from kgat_tpu_torch.sampler import CFSampleTable, sample_cf_batch
from kgat_tpu_torch.train import StepGraph, load_any_dataset
from kgat_tpu_torch.utils.config import TrainConfig


def init_mf_params(n_users: int, n_items: int, dim: int = 64, *,
                   generator: torch.Generator,
                   device=None) -> Dict[str, torch.Tensor]:
    """Uniform in +-sqrt(6 / (rows + dim)) per table, as ``kgat_tpu``
    draws them (the numbers differ, as the generators do), drawn on the
    CPU and then moved."""
    def table(n):
        limit = float(np.sqrt(6.0 / (n + dim)))
        t = torch.empty(n, dim).uniform_(-limit, limit, generator=generator)
        return t.to(device).requires_grad_()

    return {"user_embed": table(n_users), "item_embed": table(n_items)}


def bpr_loss(params: Dict[str, torch.Tensor], u: torch.Tensor,
             i_pos: torch.Tensor, i_neg: torch.Tensor, weight: torch.Tensor,
             reg: float = 1e-5) -> torch.Tensor:
    """Weighted BPR loss plus reg times the L2 term, both over the batch's
    total weight (``kgat_tpu/models/bprmf.py:40-49``)."""
    ue = params["user_embed"][u]
    pe = params["item_embed"][i_pos]
    ne = params["item_embed"][i_neg]
    diff = (ue * pe).sum(-1) - (ue * ne).sum(-1)
    n_valid = weight.sum().clamp(min=1.0)
    loss = (-F.logsigmoid(diff) * weight).sum() / n_valid
    l2 = 0.5 * ((ue ** 2).sum() + (pe ** 2).sum() + (ne ** 2).sum())
    return loss + reg * l2 / n_valid


def train_bprmf(cf_train: np.ndarray, n_users: int, n_items: int, *,
                dim: int = 64, lr: float = 1e-3, batch_size: int = 1024,
                epochs: int = 50, seed: int = 1234, device="cuda",
                log: Optional[Callable[[int, float], None]] = None
                ) -> Dict[str, np.ndarray]:
    """Train BPR-MF; returns {user_embed, item_embed} as numpy arrays.
    ``log(epoch, mean loss)`` is called after each epoch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pretrain on a GPU, or "
                           "pass --device cpu")
    table = CFSampleTable.build(cf_train, n_users, n_items, device=dev)
    params = init_mf_params(n_users, n_items, dim,
                            generator=torch.Generator().manual_seed(seed),
                            device=dev)
    opt = make_optimizer(params.values(), lr, capturable=dev.type == "cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step() -> torch.Tensor:
        u, i_pos, i_neg, w = sample_cf_batch(table, gen, batch_size)
        opt.zero_grad(set_to_none=False)
        loss = bpr_loss(params, u, i_pos, i_neg, w)
        loss.backward()
        opt.step()
        return loss.detach()

    steps = StepGraph(step, [gen], dev)
    n_batches = max(len(cf_train) // batch_size + 1, 1)
    for epoch in range(1, epochs + 1):
        mean = float(steps.run(n_batches)) / n_batches
        if log is not None:
            log(epoch, mean)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def save_pretrain(path: str, embeds: Dict[str, np.ndarray]) -> str:
    """Write the --use-pretrain npz (user_embed, item_embed keys)."""
    np.savez(path, user_embed=embeds["user_embed"],
             item_embed=embeds["item_embed"])
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="BPR-MF pretrainer (PyTorch)")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--out", default="mf_pretrain.npz")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for the CPU)")
    a = p.parse_args(argv)

    ds = load_any_dataset(TrainConfig(dataset=a.dataset,
                                      data_root=a.data_root))
    embeds = train_bprmf(
        ds.cf_train, ds.n_users, ds.n_items, dim=a.dim, lr=a.lr,
        batch_size=a.batch_size, epochs=a.epochs, seed=a.seed,
        device=a.device,
        log=lambda e, l: print(f"epoch {e}: bpr_loss {l:.5f}", flush=True))
    save_pretrain(a.out, embeds)
    print(f"saved {a.out}: user_embed {embeds['user_embed'].shape} "
          f"item_embed {embeds['item_embed'].shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
