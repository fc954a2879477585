"""Entry points: the flagship forward and a partitioned training dry run.

Port of ``__graft_entry__.py``, with its names:

* :func:`entry` returns the flagship model's forward (KGAT,
  bi-interaction, the reference recipe's widths) on a tiny synthetic CKG,
  with example arguments: the attention (TransR logits and the per-dst
  softmax), three propagation layers and the scores of 16 (user, item)
  pairs. A plain callable on tensors.
* :func:`dryrun_multichip` runs the edge-partitioned trainer's steps over
  ``n`` partitions in one process, as ``python -m kgat_tpu_torch.train
  --n-devices n`` runs them: partition i on ``cuda:(i % device_count)``
  (so all of them share one card), or all on the CPU through the plain
  versions. It holds the ring (plain copies and K7), the selective
  all-to-all, the (2, n/2) mesh and the kernel backend to the all-gather's
  or the single-device path's embeddings, as ``__graft_entry__.py`` does.

::

    python -m kgat_tpu_torch.graft_entry                 # on the card
    python -m kgat_tpu_torch.graft_entry --device cpu --n-devices 4

Both run on the card unless the caller asks for the CPU; without a card
they raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from kgat_tpu_torch.data import Dataset, synthetic_dataset
from kgat_tpu_torch.graph import CKGMeta, Graph
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGAT, KGATConfig
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.train import Trainer
from kgat_tpu_torch.utils.config import TrainConfig

# assert_allclose's tolerances of __graft_entry__.py:152-164, :186, :210.
RTOL = ATOL = 1e-4


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: run on a GPU, or pass "
                           "device='cpu' (--device cpu) for the plain "
                           "PyTorch path")
    return dev


def _tiny_setup(seed: int = 0, device="cuda"
                ) -> Tuple[Dataset, Graph, CKGMeta, KGATConfig, KGAT]:
    """(dataset, graph on ``device``, meta, config, model): the tiny
    synthetic CKG and the flagship config (d = 64, layers (64, 32, 16),
    bi-interaction, the ref backend), weights drawn from a generator
    seeded with ``seed``."""
    dev = _device(device)
    disable_tf32()
    ds = synthetic_dataset(seed=seed, n_users=64, n_items=48,
                           n_entities=96, n_relations_kg=4,
                           n_interactions=600, n_triples=400)
    graph, meta = ds.build()
    cfg = KGATConfig()
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(seed),
                             device=dev)
    return ds, graph.to(dev), meta, cfg, model


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(forward, (model, users, items)): the flagship forward, attention
    then propagation then the scores of users and items 0-15."""
    _, graph, meta, cfg, model = _tiny_setup(device=device)
    users = torch.arange(16, device=graph.src.device)
    items = torch.arange(16, device=graph.src.device)

    def forward(model, users, items):
        att = kgat.compute_attention(model, graph, cfg)
        all_embed = kgat.propagate(model, graph, att, cfg)
        return kgat.cf_scores(all_embed, meta, users, items)

    return forward, (model, users, items)


def held(name: str, got: torch.Tensor, want: torch.Tensor,
         rtol: float = RTOL, atol: float = ATOL) -> Tuple[float, float]:
    """(largest |got - want|, largest |got - want| / (atol + rtol |want|));
    raises AssertionError naming the comparison unless the second is at
    most 1 (numpy's ``assert_allclose``)."""
    got = got.detach().to(want.device, torch.float64)
    want = want.detach().to(torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    ratio = float((diff / (atol + rtol * want.abs())).max())
    err = float(diff.max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: max abs err {err:.3e}, "
                             f"{ratio:.3g} x the tolerance (rtol {rtol}, "
                             f"atol {atol})")
    return err, ratio


def _finite(name: str, t: torch.Tensor) -> float:
    v = float(t)
    if not math.isfinite(v):
        raise AssertionError(f"{name} is not finite: {v}")
    return v


def dryrun_multichip(n_devices: int, device="cuda") -> Dict:
    """The partitioned trainer's steps over ``n_devices`` partitions
    (``__graft_entry__.py:53-226``): one all-gather CF step (Adam, lr
    1e-3, a batch of 8 n from the device sampler), one data-parallel KG
    step (n blocks of ``dp.kg_block_loss``), four CF and four KG steps
    through the trainer's ``StepGraph``s (replayed where all partitions
    share one card), the attention restaged and an eval propagate; the
    ring (plain copies and K7) and the selective all-to-all held to the
    all-gather's embeddings, the (2, n/2) mesh (even n >= 4) to the 1D
    one, and the kernel backend (d = k = 16, two layers, no dropout, the
    coalesced shards) to the single-device ref path, each at rtol = atol =
    1e-4. Returns the losses and, under ``errors`` and ``ratios``, each
    comparison's :func:`held` numbers; prints one summary line."""
    n = n_devices
    dev = _device(device)
    ds, graph, meta, cfg, model = _tiny_setup(device=dev)
    batch = 8 * n
    tcfg = TrainConfig(model=cfg, lr=1e-3, cf_batch_size=batch,
                       kg_batch_size=batch, device=str(dev), log_dir=None,
                       seed=0, n_devices=n)
    trainer = Trainer(tcfg, ds)
    trainer.model.load_state_dict(model.state_dict())
    model = trainer.model
    out: Dict = {"errors": {}, "ratios": {}}

    def compare(name, got, want):
        out["errors"][name], out["ratios"][name] = held(name, got, want)

    # One all-gather CF step, then one data-parallel KG step.
    cf_l = trainer.cf_step(trainer.attention(), *trainer.sample_cf())
    h, r, tp, tn, w = trainer.sample_kg()
    trainer.opt.zero_grad(set_to_none=False)
    kg_l = sum(dp.kg_block_loss(model, h, r, tp, tn, cfg, w,
                                slice(p * batch // n, (p + 1) * batch // n))
               for p in range(n))
    kg_l.backward()
    # Dropped with its autograd graph: gradient accumulators kept alive
    # from an eager step break the capture below.
    kg_l = kg_l.detach()
    trainer.opt.step()
    # Four of each through the trainer's step graphs (make_cf_scan and
    # make_dp_kg_scan's chunked epochs).
    trainer.stage(trainer.attention())
    cf_sum = _finite("scan4 cf", trainer.cf_steps.run(4))
    kg_sum = _finite("scan4 kg", trainer.kg_steps.run(4))
    out.update(cf_loss=_finite("cf_loss", cf_l),
               kg_loss=_finite("kg_loss", kg_l),
               cf_scan4=cf_sum, kg_scan4=kg_sum)

    # The parameters changed: restage the attention, then evaluate.
    emb = trainer.part.propagate_eval(model, trainer.attention())
    if emb.shape[0] != meta.n_nodes or not bool(emb.isfinite().all()):
        raise AssertionError(f"eval propagate: shape {tuple(emb.shape)}, "
                             f"{meta.n_nodes} nodes, finite "
                             f"{bool(emb.isfinite().all())}")

    # The other exchanges on the same mesh and parameters.
    src, dst, ety = (graph.src.cpu().numpy(), graph.dst.cpu().numpy(),
                     graph.etype.cpu().numpy())
    shards, info = partition_graph(src, dst, ety, meta.n_nodes,
                                   meta.n_relations, n)
    buckets = build_ring_buckets(src, dst, info)
    for name, kw in (("ring_ppermute", dict(exchange="ring",
                                            ring_buckets=buckets)),
                     ("ring_dma", dict(exchange="ring", ring_buckets=buckets,
                                       ring_transport="dma")),
                     ("a2a", dict(exchange="a2a",
                                  halos=build_selective_halo(shards, info)))):
        eng = halo.Partitioned(trainer.mesh, shards, info, meta, cfg, **kw)
        compare(name, eng.propagate_eval(model, eng.attention(model)[1]),
                emb)
        eng.close()

    # The (2, n/2) mesh: its propagate held to the 1D mesh's, then one CF
    # step on its own Adam.
    msg_2d = "2d mesh skipped (needs even n_devices >= 4)"
    if n % 2 == 0 and n >= 4:
        t2 = Trainer(dataclasses.replace(tcfg, dp_replicas=2), ds)
        t2.model.load_state_dict(model.state_dict())
        staged = t2.attention()
        compare("mesh_2d", t2.part.propagate_eval(t2.model, staged), emb)
        out["cf_loss_2d"] = _finite(
            "2d cf_loss", t2.cf_step(staged, *t2.sample_cf()))
        t2.close()
        msg_2d = (f"2d (dp=2 x ep={n // 2}) mesh cf_step+propagate ok "
                  f"(cf_loss={out['cf_loss_2d']:.4f}, allclose vs 1d)")

    # The kernel backend on all n partitions, held to the single-device
    # ref path on the same parameters, then one CF step.
    cfg_k = dataclasses.replace(cfg, ops_backend="hopper", embed_dim=16,
                                relation_dim=16, conv_dims=(16, 16),
                                mess_dropout=(0.0, 0.0))
    tk = Trainer(dataclasses.replace(tcfg, model=cfg_k, seed=1), ds)
    staged = tk.attention()
    cfg_o = dataclasses.replace(cfg_k, ops_backend="ref")
    with torch.no_grad():
        emb_o = kgat.propagate(tk.model, graph, kgat.compute_attention(
            tk.model, graph, cfg_o), cfg_o)
    compare("hopper_vs_ref", tk.part.propagate_eval(tk.model, staged), emb_o)
    out["cf_loss_hopper"] = _finite("hopper cf_loss",
                                    tk.cf_step(staged, *tk.sample_cf()))
    tk.close()
    trainer.close()

    worst = max(out["errors"].values())
    print(f"dryrun_multichip({n}): edge-partitioned cf_loss="
          f"{out['cf_loss']:.4f} dp kg_loss={out['kg_loss']:.4f} "
          f"scan4 cf={cf_sum:.4f} kg={kg_sum:.4f} ring+a2a ok; {msg_2d}; "
          f"hopper backend partitioned allclose vs ref, cf_loss="
          f"{out['cf_loss_hopper']:.4f}; max abs err {worst:.3e}; "
          f"partitions on {sorted({str(d) for d in trainer.mesh.devices})}",
          flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The flagship forward, then the partitioned dry run")
    p.add_argument("--n-devices", type=int, default=8,
                   help="partitions of the dry run (default 8)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    a = p.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print(f"entry forward: {tuple(out.shape)} {out.dtype}", flush=True)
    dryrun_multichip(a.n_devices, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
