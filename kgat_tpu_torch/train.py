"""Alternating-phase KGAT trainer on one GPU.

Port of ``kgat_tpu/train.py``'s single-device path with the device
sampler and dense Adam. Per epoch (SURVEY.md §3.1): the BPR CF loss over
all CF minibatches, then the TransR KG loss over all KG minibatches, then
the edge attention recomputed with no gradient, which serves evaluation
and the next epoch's CF phase. Evaluation runs every ``eval_every``
epochs, with early stopping on recall@K and best/last checkpoints.

    python -m kgat_tpu_torch.train --dataset yelp2018 --epochs 400
    python -m kgat_tpu_torch.train --device cpu --ops-backend ref \\
        --dataset synthetic --epochs 2 --eval-every 1

The default is ``--device cuda --ops-backend hopper``: the CF step runs
the SpMM kernel forward and on the reverse CSR backward, the attention
recompute the SDDMM and softmax kernels, and it fails if there is no GPU.

``--n-devices P`` (P > 1) trains edge-partitioned, as ``kgat_tpu``'s
BASELINE config 5 does: P destination-block partitions, partition p on
``cuda:(p % device_count)`` (so four partitions share one card), the CF
phase through ``parallel.halo`` with ``--halo-exchange allgather|ring``
and ``--ring-transport ppermute|dma|fused``, the KG phase the same TransR
step on a global batch, batch sizes rounded up to a multiple of P:

    python -m kgat_tpu_torch.train --dataset yelp2018 --n-devices 4 \\
        --halo-exchange ring --ring-transport fused

PyTorch runs eagerly, so each step is its own sequence of launches; the
losses stay on the device through an epoch and are read once at its end.
One ``torch.optim.Adam`` with optax's defaults spans every parameter in
both phases, and every parameter gets a gradient at every step (zeros
where the phase does not touch it), because optax steps leaves with a
zero gradient where torch would skip a parameter whose ``.grad`` is None.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kgat_tpu_torch import eval as evaluation
from kgat_tpu_torch.data import Dataset, load_dataset, synthetic_dataset
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.sampler import (CFSampleTable, KGSampleTable,
                                    sample_cf_batch, sample_kg_batch)
from kgat_tpu_torch.utils.checkpoint import save_params
from kgat_tpu_torch.utils.config import TrainConfig, parse_args
from kgat_tpu_torch.utils.logging import RunLogger


def load_any_dataset(cfg: TrainConfig) -> Dataset:
    if cfg.dataset == "synthetic":
        return synthetic_dataset(
            seed=cfg.seed, n_users=cfg.syn_users, n_items=cfg.syn_items,
            n_entities=cfg.syn_entities, n_relations_kg=cfg.syn_relations,
            n_interactions=cfg.syn_interactions, n_triples=cfg.syn_triples)
    return load_dataset(cfg.data_root, cfg.dataset)


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """One Adam over every parameter with ``optax.adam``'s defaults (b1
    0.9, b2 0.999, eps 1e-8 outside the square root). Each parameter gets a
    zero ``.grad`` now, and the steps zero it in place (``zero_grad(
    set_to_none=False)``), so a parameter that a loss does not reach still
    takes its step, as an optax leaf whose gradient is 0 does, and all
    share one step count."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class Trainer:
    def __init__(self, cfg: TrainConfig, dataset: Optional[Dataset] = None):
        self.cfg = cfg
        self.device = dev = torch.device(cfg.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: train on a GPU, or "
                               "pass --device cpu for the plain PyTorch path")
        disable_tf32()
        self.ds = dataset if dataset is not None else load_any_dataset(cfg)
        graph, self.meta = self.ds.build()
        self.graph = graph.to(dev)
        self.logger = RunLogger(cfg.log_dir, cfg.run_name)

        # Samplers: CF over train interactions; KG over all CKG triples.
        self.cf_table = CFSampleTable.build(
            self.ds.cf_train, self.meta.n_users, self.meta.n_items,
            device=dev)
        ckg_triples = np.stack([graph.dst.numpy(), graph.etype.numpy(),
                                graph.src.numpy()], axis=1)
        self.kg_table = KGSampleTable.build(
            ckg_triples, n_entities=self.meta.n_nodes,
            n_relations=self.meta.n_relations, device=dev)
        self.eval_plan = evaluation.make_eval_plan(
            self.ds.train_user_dict, self.ds.test_user_dict,
            self.meta.n_items, block=cfg.test_block)

        # Reference batch counts: n_train // batch_size + 1.
        self.n_cf_batches = len(self.ds.cf_train) // cfg.cf_batch_size + 1
        self.n_kg_batches = graph.n_edges // cfg.kg_batch_size + 1

        # Weights are drawn on the CPU (one seed, one model on every
        # device); batches and dropout masks from a generator on the device.
        self.model = kgat.init_params(
            self.meta.n_nodes, self.meta.n_relations, cfg.model,
            generator=torch.Generator().manual_seed(cfg.seed), device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.opt = make_optimizer(self.model.parameters(), cfg.lr)
        self.cf_batch_size, self.kg_batch_size = (cfg.cf_batch_size,
                                                  cfg.kg_batch_size)
        self.n_parts = dp.n_parts_for(cfg.n_devices, dev)
        self.partitioned = self.n_parts > 1
        self.part: Optional[halo.Partitioned] = None
        if self.partitioned:
            self._build_partitioned(graph)
        self.epoch = 0
        self.best_metric = -1.0
        self.bad_evals = 0
        # Attention staged after each KG phase (reference order): it serves
        # evaluate() and the next epoch's CF phase.
        self._att = None
        self._prof = None

    def _build_partitioned(self, graph) -> None:
        """The edge-partitioned CF phase (``kgat_tpu/train.py:264-340``):
        the CKG cut into P destination blocks, the ring buckets when the
        exchange is the ring, one dropout generator per partition, and
        both batch sizes rounded up to a multiple of P. The KG phase is
        ``kg_step`` on the global batch: in one process it is the
        data-parallel TransR loss (``parallel/dp.py``)."""
        cfg, P = self.cfg, self.n_parts
        mesh = dp.make_mesh(P, self.device)
        src, dst = graph.src.numpy(), graph.dst.numpy()
        shards, self.pinfo = partition_graph(
            src, dst, graph.etype.numpy(), self.meta.n_nodes,
            self.meta.n_relations, P)
        ring = cfg.halo_exchange == "ring"
        self.part = halo.Partitioned(
            mesh, shards, self.pinfo, self.meta, cfg.model,
            exchange=cfg.halo_exchange,
            ring_buckets=build_ring_buckets(src, dst, self.pinfo)
            if ring else None, ring_transport=cfg.ring_transport)
        self.part_generators = [
            torch.Generator(device=d).manual_seed(cfg.seed + 1 + p)
            for p, d in enumerate(mesh.devices)]
        self.cf_batch_size = dp.round_batch(cfg.cf_batch_size, P)
        self.kg_batch_size = dp.round_batch(cfg.kg_batch_size, P)

    # ------------------------------------------------------------------
    def attention(self):
        """Attention recomputed with no gradient and staged for the CF
        phase: :class:`EdgeWeights`, or per partition when partitioned."""
        if self.partitioned:
            return self.part.attention(self.model)[1]
        return kgat.attention_for_training(self.model, self.graph,
                                           self.cfg.model)

    def sample_cf(self):
        """(u, i+, i-, weight) for one CF step, on the device."""
        return sample_cf_batch(self.cf_table, self.generator,
                               self.cf_batch_size)

    def sample_kg(self):
        """(h, r, t+, t-, weight) for one KG step, on the device."""
        return sample_kg_batch(self.kg_table, self.generator,
                               self.kg_batch_size)

    def cf_grad(self, att, u, i_pos, i_neg, weight=None, *,
                generator: Union[None, torch.Generator,
                                 Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """The BPR loss of one batch, with its gradient in every
        parameter's ``.grad`` (zeros for ``w_rel`` and ``rel_embed``).
        Dropout masks come from ``generator`` (default: the trainer's),
        or when partitioned from one generator per partition (default:
        ``part_generators``)."""
        self.opt.zero_grad(set_to_none=False)
        if self.partitioned:
            loss = self.part.cf_loss(
                self.model, att, u, i_pos, i_neg, weight=weight,
                generators=generator or self.part_generators)
        else:
            loss = kgat.cf_loss(self.model, self.graph, att, self.meta, u,
                                i_pos, i_neg, self.cfg.model,
                                generator=generator or self.generator,
                                train=True, weight=weight)
        loss.backward()
        return loss.detach()

    def cf_step(self, att, u, i_pos, i_neg, weight=None, *,
                generator=None) -> torch.Tensor:
        """One CF step: loss, gradient, Adam update. Returns the loss on
        the device."""
        loss = self.cf_grad(att, u, i_pos, i_neg, weight, generator=generator)
        self.opt.step()
        return loss

    def kg_grad(self, h, r, t_pos, t_neg, weight=None) -> torch.Tensor:
        """The TransR loss of one batch, with its gradient in every
        parameter's ``.grad`` (zeros for the layer weights)."""
        self.opt.zero_grad(set_to_none=False)
        loss = kgat.kg_loss(self.model, h, r, t_pos, t_neg, self.cfg.model,
                            weight=weight)
        loss.backward()
        return loss.detach()

    def kg_step(self, h, r, t_pos, t_neg, weight=None) -> torch.Tensor:
        """One KG step: loss, gradient, Adam update. Returns the loss on
        the device."""
        loss = self.kg_grad(h, r, t_pos, t_neg, weight)
        self.opt.step()
        return loss

    def train_one_epoch(self) -> Tuple[float, float]:
        att = self._att if self._att is not None else self.attention()
        self._att = None  # params are about to change
        try:
            cf_sum = torch.zeros((), device=self.device)
            for _ in range(self.n_cf_batches):
                cf_sum += self.cf_step(att, *self.sample_cf())
            kg_sum = torch.zeros((), device=self.device)
            for _ in range(self.n_kg_batches):
                kg_sum += self.kg_step(*self.sample_kg())
            return (float(cf_sum) / self.n_cf_batches,
                    float(kg_sum) / self.n_kg_batches)
        finally:
            # Reference order (SURVEY.md §3.1): attention recomputed after
            # the KG phase, reused by evaluate() and the next epoch.
            self._att = self.attention()

    def all_embed(self) -> torch.Tensor:
        """The eval-mode forward over the cached attention."""
        att = self._att if self._att is not None else self.attention()
        if self.partitioned:
            return self.part.propagate_eval(self.model, att)
        with torch.no_grad():
            return kgat.propagate(self.model, self.graph, att, self.cfg.model)

    def evaluate(self) -> dict:
        return evaluation.evaluate(self.all_embed(), self.meta,
                                   self.eval_plan, k=self.cfg.k,
                                   ks=self.cfg.ks)

    # ------------------------------------------------------------------
    def ckpt_path(self) -> str:
        if self.cfg.ckpt_path:
            return self.cfg.ckpt_path
        return f"{self.cfg.log_dir or '.'}/{self.cfg.run_name}_best"

    def last_ckpt_path(self) -> str:
        return self.ckpt_path() + "_last"

    def _save_ckpt(self, path: str) -> None:
        """Params and the JSON sidecar in ``kgat_tpu``'s format, which
        ``kgat_tpu_torch.recommend`` and ``kgat_tpu``'s ``load_params``
        read. The Adam state and the generator are not saved yet
        (``--resume`` is ROADMAP.md queue 1, item 7)."""
        mc = self.cfg.model
        save_params(path, kgat.numpy_params(self.model), {
            "epoch": self.epoch, "best_metric": float(self.best_metric),
            "bad_evals": self.bad_evals,
            "model": {"embed_dim": mc.embed_dim,
                      "relation_dim": mc.relation_dim,
                      "conv_dims": list(mc.conv_dims),
                      "aggregator": mc.aggregator,
                      "mess_dropout": list(mc.mess_dropout)},
            "dataset": self.cfg.dataset})

    def train(self) -> dict:
        cfg = self.cfg
        self.logger.log("start", dataset=self.ds.name,
                        n_nodes=self.meta.n_nodes, n_edges=self.graph.n_edges,
                        n_relations=self.meta.n_relations,
                        cf_batches=self.n_cf_batches,
                        kg_batches=self.n_kg_batches,
                        aggregator=cfg.model.aggregator,
                        backend=cfg.model.ops_backend, sampler="device")
        if cfg.profile_epochs > 0 and cfg.log_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        try:
            final = self._train_loop()
        finally:
            # Early stop and short runs still close an open trace.
            self._stop_profile()
        self.logger.log("done", best_recall=self.best_metric)
        return final

    def _stop_profile(self) -> None:
        if self._prof is None:
            return
        self._prof.stop()
        path = f"{self.cfg.log_dir}/trace_{self.cfg.run_name}.json"
        self._prof.export_chrome_trace(path)
        self._prof = None
        self.logger.log("profile_saved", dir=path)

    def _train_loop(self) -> dict:
        cfg = self.cfg
        final = {}
        while self.epoch < cfg.epochs:
            self.epoch += 1
            t0 = time.time()
            cf_l, kg_l = self.train_one_epoch()
            dt = time.time() - t0
            if self.epoch >= cfg.profile_epochs:
                self._stop_profile()
            # Propagation touches every edge per layer, fwd + bwd, per batch.
            edges = (self.n_cf_batches * len(cfg.model.conv_dims)
                     * self.graph.n_edges * 3)  # fwd + 2 bwd segment passes
            self.logger.log("epoch", epoch=self.epoch, cf_loss=cf_l,
                            kg_loss=kg_l, secs=round(dt, 3),
                            edges_per_s=round(edges / dt))
            if self.epoch % cfg.eval_every == 0 or self.epoch == cfg.epochs:
                m = self.evaluate()
                self.logger.log("eval", epoch=self.epoch, **m)
                final = m
                if m["recall"] > self.best_metric:
                    self.best_metric = m["recall"]
                    self.bad_evals = 0
                    self._save_ckpt(self.ckpt_path())
                else:
                    self.bad_evals += 1
                self._save_ckpt(self.last_ckpt_path())
                if self.bad_evals >= cfg.stopping_steps:
                    self.logger.log("early_stop", epoch=self.epoch,
                                    best=self.best_metric)
                    break
        return final


def main(argv=None) -> dict:
    """Train from command-line flags; returns the last eval's metrics."""
    return Trainer(parse_args(argv)).train()


if __name__ == "__main__":
    main()
