"""Alternating-phase KGAT trainer on one GPU.

Port of ``kgat_tpu/train.py``. Per epoch (SURVEY.md §3.1): the BPR CF
loss over all CF minibatches, then the TransR KG loss over all KG
minibatches, then the edge attention recomputed with no gradient, which
serves evaluation and the next epoch's CF phase. Evaluation runs every
``eval_every`` epochs, with early stopping on recall@K and best/last
checkpoints.

    python -m kgat_tpu_torch.train --dataset yelp2018 --epochs 400
    python -m kgat_tpu_torch.train --device cpu --ops-backend ref \\
        --dataset synthetic --epochs 2 --eval-every 1

The default is ``--device cuda --ops-backend hopper``: the CF step runs
the SpMM kernel forward and on the reverse CSR backward, the attention
recompute the SDDMM and softmax kernels, and it fails if there is no GPU.
At ``kgat_tpu``'s defaults the SpMM reduces over the multi-edge-coalesced
CSRs (``--no-coalesce`` keeps every edge), the staged attention weights
are rounded to the value stream's dtype (``--compute-dtype bf16``), and
the attention's logits take the dense-projection route where
``--att-impl auto`` picks it (``models.kgat.attention_for_training``).

``--n-devices N`` (N > 1) trains edge-partitioned, as ``kgat_tpu``'s
BASELINE config 5 does: N destination-block partitions, partition p on
``cuda:(p % device_count)`` (so four partitions share one card), the CF
phase through ``parallel.halo`` with ``--halo-exchange
allgather|ring|a2a`` and ``--ring-transport ppermute|dma|fused``, the KG
phase the same TransR step on a global batch, batch sizes rounded up to a
multiple of N. ``--dp-replicas D`` makes it a 2D (dp, ep) mesh of D rows
of N / D partitions, each row taking its own block of the CF batch:

    python -m kgat_tpu_torch.train --dataset yelp2018 --n-devices 4 \\
        --halo-exchange ring --ring-transport fused

On CUDA the device-sampled epoch replays two CUDA graphs, one CF step
and one KG step each captured once (:class:`StepGraph`, where
``kgat_tpu`` runs chunked ``lax.scan``s): one host call a step, where an
eager step makes some 400 launches (1,600 for the partitioned ring). The
partitioned trainer's steps are captured when all its partitions lie on
one card; partitions spread over several cards run eager steps, one CUDA
graph holding one card's work, and its ``epoch`` events say which
(``captured``, ``why``). The CPU and ``--sampler host`` (numpy batches
from ``kgat_tpu``'s host samplers, one step per batch) run eagerly. The
losses stay on the device through an epoch and are read once at its end.

One ``torch.optim.Adam`` with optax's defaults spans every parameter in
both phases (``optim.make_optimizer``; on CUDA one kernel launch a step,
``optim.KernelAdam``), and every parameter gets a
gradient at every step (zeros where the phase does not touch it), because
optax steps leaves with a zero gradient where torch would skip a parameter
whose ``.grad`` is None. ``--sparse-adam`` runs the KG phase's update
lazily over the rows the batch touches (``optim.sparse_kg_step``).

Checkpoints hold the full state in ``kgat_tpu``'s format (params, Adam's
moments and count, the counters, and the port's generator states), and
``--resume`` continues from the newer of the best and last ones, a
``kgat_tpu`` checkpoint too.

Launched as several processes (one per card, ``parallel/multihost.py``,
the environment of ``kgat_tpu``'s multi-host launch), the trainer forms
the process group first; each process owns N / W of the N partitions,
on its card, and draws the same global batches from identically seeded
generators. After each CF and KG backward the gradients of the
replicated parameters and the step's loss are summed over the processes
in one all-reduce of one flat buffer, so every process takes the same
Adam step. The captured steps hold the NCCL calls. Process 0 alone logs;
evaluation runs on every process and gives the same metrics, hence the
same early stop; each process writes its shard of each checkpoint.
With ``--n-devices 1`` every process trains the same single-device
replica, as ``kgat_tpu`` does. ``--use-pretrain mf.npz`` starts the user and
item rows from BPR-MF embeddings (``python -m kgat_tpu_torch.models.bprmf``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from kgat_tpu_torch import eval as evaluation
from kgat_tpu_torch.data import Dataset, load_dataset, synthetic_dataset
from kgat_tpu_torch.graph import clone_weights, coalesced, copy_weights_
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.ops.hopper import build, remote_ring
from kgat_tpu_torch.optim import (adam_count, make_optimizer, set_adam_count,
                                  sparse_kg_step)
from kgat_tpu_torch.parallel import dp, halo, multihost
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32
from kgat_tpu_torch.sampler import (CFSampleTable, HostCFSampler,
                                    HostKGSampler, KGSampleTable,
                                    sample_cf_batch, sample_kg_batch)
from kgat_tpu_torch.utils import trace
from kgat_tpu_torch.utils.checkpoint import (load_checkpoint_sharded,
                                             save_checkpoint,
                                             save_checkpoint_sharded)
from kgat_tpu_torch.utils.config import TrainConfig, parse_args
from kgat_tpu_torch.utils.logging import RunLogger


def load_any_dataset(cfg: TrainConfig) -> Dataset:
    if cfg.dataset == "synthetic":
        return synthetic_dataset(
            seed=cfg.seed, n_users=cfg.syn_users, n_items=cfg.syn_items,
            n_entities=cfg.syn_entities, n_relations_kg=cfg.syn_relations,
            n_interactions=cfg.syn_interactions, n_triples=cfg.syn_triples)
    return load_dataset(cfg.data_root, cfg.dataset)


class StepGraph:
    """Training steps replayed from a CUDA graph: the port's counterpart of
    ``kgat_tpu/train.py``'s ``_chunked_epoch``, which runs an epoch's
    steps as a few device calls.

    ``body()`` runs one step (sample, loss, backward, Adam) and returns
    its loss on the device; :meth:`run` runs n steps and returns the sum
    of their losses, still on the device. On CUDA the first step is run
    eagerly on a side stream, as a warm-up (it is a real step, the run's
    first), then one step is captured into a CUDA graph with each of
    ``generators`` registered, so that each replay draws fresh numbers
    from them; every later step is a replay, one host call. A capture
    that fails raises, and nothing runs the step eagerly in its place. On
    the CPU, which cannot capture, and where the caller asks for no
    capture (``capture=False``: a step whose work spans several cards),
    every step runs ``body()``.

    What the body reads must keep its address between replays: the
    parameters, their ``.grad``, Adam's state, and staged inputs that the
    caller refreshes with ``copy_``. What it allocates (a batch, dropout
    masks, the loss) lives in the graph's memory pool and each replay
    writes it anew, so a reference the body keeps to it shows the latest
    replay's values.
    """

    def __init__(self, body: Callable[[], torch.Tensor],
                 generators: Sequence[torch.Generator],
                 device: torch.device, capture: bool = True):
        self.body = body
        self.generators = list(generators)
        self.device = device
        self.eager = device.type != "cuda" or not capture
        self.loss_sum = torch.zeros((), device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        # Wrapper calls the capture recorded (each launches at a replay),
        # and those of them that stored into another process (K7, K8).
        self.calls: Dict[str, int] = {}
        self.process_calls: Dict[str, int] = {}
        # Under a process group, replays end within the group's timeout or
        # raise (multihost.Watch): no watchdog sees a collective in a graph.
        self._watch: Optional[multihost.Watch] = None

    def _step(self) -> None:
        self.loss_sum += self.body()

    def capture(self) -> None:
        """The warm-up step on a side stream, then the capture. Under a
        process group the warm-up creates the NCCL communicators the
        capture records; the capture waits for the warm-up to end, and
        other threads (NCCL's watchdog) may call CUDA during it."""
        if self.device.type != "cuda":
            raise RuntimeError(f"CUDA graphs need a CUDA device, not "
                               f"{self.device}")
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._step()
        stream.wait_stream(side)
        grouped = dist.is_available() and dist.is_initialized()
        if grouped:
            torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.generators:
            graph.register_generator_state(g)
        before = dict(build.launch_counts)
        before_p = dict(remote_ring.process_launches)
        with torch.cuda.graph(graph, capture_error_mode=(
                "thread_local" if grouped else "global")):
            self._step()
        graph.instantiate()
        self.calls = _counted(build.launch_counts, before)
        self.process_calls = _counted(remote_ring.process_launches, before_p)
        self.graph = graph
        self._watch = multihost.Watch(self.device) if grouped else None

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        if self._watch is not None:
            self._watch.mark()

    def run(self, n: int) -> torch.Tensor:
        """n steps; the sum of their losses on the device."""
        self.loss_sum.zero_()
        if self.eager:
            for _ in range(n):
                self._step()
            return self.loss_sum
        done = 0
        if self.graph is None and n > 0:
            self.capture()
            done = 1
        for _ in range(n - done):
            self.replay()
        if self._watch is not None:
            self._watch.drain()
        return self.loss_sum


def _counted(counts, before) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in counts.items()
            if n != before.get(k, 0)}


def reseed(seed: int, epoch: int, stream: int = 0) -> int:
    """A generator seed from (seed, epoch, stream), for a resume from a
    checkpoint that holds no torch generator state."""
    return int(np.random.SeedSequence([seed, epoch, stream])
               .generate_state(1)[0])


class Trainer:
    def __init__(self, cfg: TrainConfig, dataset: Optional[Dataset] = None):
        self.cfg = cfg
        dev = torch.device(cfg.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: train on a GPU, or "
                               "pass --device cpu for the plain PyTorch path")
        # The process group first (kgat_tpu/train.py:98-102): a no-op for
        # one process, and once only (main() may have formed it).
        multihost.initialize_distributed(device=dev)
        self.grouped = dist.is_available() and dist.is_initialized()
        self.rank, self.n_procs = multihost.world()
        self.device = dev = (multihost.process_device(dev, self.rank)
                             if self.grouped else dev)
        disable_tf32()
        self.ds = dataset if dataset is not None else load_any_dataset(cfg)
        graph, self.meta = self.ds.build(cache_dir=cfg.graph_cache)
        self.graph = graph.to(dev)
        # Process 0 alone writes the event log and prints
        # (kgat_tpu/train.py:106-109).
        p0 = self.rank == 0
        self.logger = RunLogger(cfg.log_dir if p0 else None, cfg.run_name,
                                quiet=not p0, resume=cfg.resume)

        # Samplers: CF over train interactions; KG over all CKG triples.
        with trace.span("setup.tables"):
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
        pretrain = None
        if cfg.pretrain_path:
            # The reference's --use_pretrain: a BPR-MF npz.
            with np.load(cfg.pretrain_path) as z:
                pretrain = (z["user_embed"], z["item_embed"],
                            self.meta.n_entities)
            self.logger.log("pretrain", path=cfg.pretrain_path,
                            user_rows=len(pretrain[0]),
                            item_rows=len(pretrain[1]))
        self.model = kgat.init_params(
            self.meta.n_nodes, self.meta.n_relations, cfg.model,
            generator=torch.Generator().manual_seed(cfg.seed), device=dev,
            pretrain=pretrain)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        # N devices in all, D dp rows of P partitions (D = 1: a 1D mesh).
        self.n_devices = dp.n_devices_for(cfg.n_devices, dev)
        self.dp_replicas = max(1, cfg.dp_replicas)
        self.n_parts = dp.split_devices(self.n_devices, self.dp_replicas)
        self.partitioned = self.n_devices > 1
        self.mesh = (dp.make_mesh(self.n_parts, dev, self.dp_replicas)
                     if self.partitioned else None)
        # Partitions under a process group each hold a share of a step's
        # loss and gradients, which one all-reduce sums.
        self.sync = self.grouped and self.partitioned
        self.captured, self.capture_why = self._capture_mode()
        self.opt = make_optimizer(self.model.parameters(), cfg.lr)
        # After each backward under a process group, the gradients and the
        # loss (this process's shares) are summed over the processes in one
        # all-reduce, the psum of kgat_tpu's steps. It also ends the step on
        # every process together: no process's next step stores into a
        # peer's ring buffer (K7, K8) before every peer read this step's.
        self._grad_sum = (multihost.GradSum(self.model.parameters(), dev)
                          if self.sync else None)
        self.cf_batch_size, self.kg_batch_size = (cfg.cf_batch_size,
                                                  cfg.kg_batch_size)
        self.part: Optional[halo.Partitioned] = None
        self.part_generators = []
        mc = cfg.model
        if not self.partitioned and mc.coalesces:
            # The coalesced CSRs, built here rather than in the first
            # epoch's attention (a no-op when the graph cache held them).
            coalesced(self.graph, mc.coalesce_cap)
        if self.partitioned:
            self._build_partitioned(graph)
        elif cfg.sampler == "host":
            self._host_cf = HostCFSampler(self.ds.train_user_dict,
                                          self.meta.n_items, cfg.seed)
            self._host_kg = HostKGSampler(ckg_triples, self.meta.n_nodes,
                                          cfg.seed)
        # The device-sampled steps, captured on CUDA where the mesh allows
        # it; the batch and dropout masks each one drew (cf_drawn,
        # kg_drawn; a partitioned step's masks stay inside it) and the
        # attention its CF steps read (_step_att, refreshed with copy_
        # every epoch). Every generator a CF step draws from is registered
        # with its graph: the trainer's and each partition's.
        self.cf_steps = StepGraph(self._cf_body,
                                  [self.generator, *self._own_generators()],
                                  dev, capture=self.captured)
        self.kg_steps = StepGraph(self._kg_body, [self.generator], dev,
                                  capture=self.captured)
        self.cf_drawn = self.kg_drawn = None
        self._step_att = None
        self.epoch = 0
        self.best_metric = -1.0
        self.bad_evals = 0
        # Attention staged after each KG phase (reference order): it serves
        # evaluate() and the next epoch's CF phase.
        self._att = None
        self._prof = None

    def _capture_mode(self) -> Tuple[bool, str]:
        """Whether the device-sampled steps are captured in CUDA graphs,
        and why: decided once, from the device, the mesh and the process
        group."""
        if self.device.type != "cuda":
            return False, "the CPU runs eager steps"
        if not self.partitioned:
            if self.cfg.sampler == "host":
                return False, "--sampler host runs eager steps"
            return True, f"one device, {self.device}"
        if self.mesh.owners:       # partitions under a process group
            if os.environ.get("KGAT_DP_CHECK_BATCH") == "1":
                return False, ("KGAT_DP_CHECK_BATCH=1 reads every step's "
                               "batch checksum back to the host")
            return True, (f"{len(self.mesh.local_slots())} of "
                          f"{self.n_devices} partitions on {self.device} "
                          f"in process {self.mesh.rank} of "
                          f"{self.mesh.n_procs}, the NCCL calls inside "
                          f"the graphs")
        cards = sorted({str(d) for d in self.mesh.devices})
        if len(cards) > 1:
            return False, (f"the partitions span {len(cards)} cards "
                           f"({', '.join(cards)}): a CUDA graph holds one "
                           f"card's work, so the steps run eagerly")
        return True, (f"all {self.n_devices} partitions on {cards[0]}")

    def _own_generators(self) -> list:
        """This process's partitions' dropout generators, in slot order."""
        return [g for g in self.part_generators if g is not None]

    def _kg_block(self, batch: int) -> slice:
        """This process's block of a global KG batch."""
        b = batch // self.n_procs
        return slice(self.rank * b, (self.rank + 1) * b)

    def _build_partitioned(self, graph) -> None:
        """The edge-partitioned CF phase (``kgat_tpu/train.py:264-340``):
        the CKG cut into P destination blocks, the ring buckets or the
        selective halos the exchange needs, the same shards on each of
        the D dp rows, one dropout generator per (row, partition), and
        both batch sizes rounded up to a multiple of the N = D P devices.
        The KG phase is ``kg_step`` on the global batch: in one process it
        is the data-parallel TransR loss (``parallel/dp.py``)."""
        cfg, P = self.cfg, self.n_parts
        if cfg.sparse_adam:
            raise ValueError(
                "--sparse-adam is single-device only: the data-parallel "
                "KG step updates DENSE gradient trees (parallel/dp.py); "
                "drop the flag or --n-devices")
        src, dst = graph.src.numpy(), graph.dst.numpy()
        shards, self.pinfo = partition_graph(
            src, dst, graph.etype.numpy(), self.meta.n_nodes,
            self.meta.n_relations, P)
        ex = cfg.halo_exchange
        self.part = halo.Partitioned(
            self.mesh, shards, self.pinfo, self.meta, cfg.model, exchange=ex,
            ring_buckets=build_ring_buckets(src, dst, self.pinfo)
            if ex == "ring" else None,
            halos=build_selective_halo(shards, self.pinfo)
            if ex == "a2a" else None, ring_transport=cfg.ring_transport)
        # Row d's partition p draws from seed + 1 + p + P d, as JAX folds
        # p + nP d into its dropout key (halo.py:411-413); under a process
        # group on the process that owns it (None elsewhere).
        self.part_generators = [
            None if dv is None
            else torch.Generator(device=dv).manual_seed(cfg.seed + 1 + i)
            for i, dv in enumerate(self.mesh.devices)]
        self.cf_batch_size = dp.round_batch(cfg.cf_batch_size,
                                            self.n_devices)
        self.kg_batch_size = dp.round_batch(cfg.kg_batch_size,
                                            self.n_devices)

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
                                 Sequence[torch.Generator]] = None,
                masks=None) -> torch.Tensor:
        """The BPR loss of one batch, with its gradient in every
        parameter's ``.grad`` (zeros for ``w_rel`` and ``rel_embed``).
        Dropout applies ``masks`` (``kgat.dropout_masks``) or draws its
        masks from ``generator`` (default: the trainer's), or when
        partitioned from one generator per (dp row, partition) (default:
        ``part_generators``). Under a process group the loss is the global
        batch's and the gradients are summed over the processes."""
        self.opt.zero_grad(set_to_none=False)
        if self.partitioned:
            loss = self.part.cf_loss(
                self.model, att, u, i_pos, i_neg, weight=weight,
                generators=generator or self.part_generators)
        else:
            loss = kgat.cf_loss(self.model, self.graph, att, self.meta, u,
                                i_pos, i_neg, self.cfg.model,
                                generator=generator or self.generator,
                                train=True, weight=weight, masks=masks)
        loss.backward()
        if self.sync:
            return self._grad_sum(loss)
        return loss.detach()

    def cf_step(self, att, u, i_pos, i_neg, weight=None, *,
                generator=None, masks=None) -> torch.Tensor:
        """One CF step: loss, gradient, Adam update. Returns the loss on
        the device."""
        loss = self.cf_grad(att, u, i_pos, i_neg, weight, generator=generator,
                            masks=masks)
        self.opt.step()
        return loss

    def kg_grad(self, h, r, t_pos, t_neg, weight=None) -> torch.Tensor:
        """The TransR loss of one batch, with its gradient in every
        parameter's ``.grad`` (zeros for the layer weights). Under a
        process group each process takes its block of the global batch
        (``dp.kg_block_loss``) and the all-reduce sums the blocks."""
        self.opt.zero_grad(set_to_none=False)
        if self.sync:
            loss = dp.kg_block_loss(self.model, h, r, t_pos, t_neg,
                                    self.cfg.model, weight,
                                    self._kg_block(h.shape[0]))
            loss.backward()
            return self._grad_sum(loss)
        loss = kgat.kg_loss(self.model, h, r, t_pos, t_neg, self.cfg.model,
                            weight=weight)
        loss.backward()
        return loss.detach()

    def kg_step(self, h, r, t_pos, t_neg, weight=None) -> torch.Tensor:
        """One KG step: loss, gradient, Adam update (lazy under
        ``--sparse-adam``, which leaves ``.grad`` as it is). Returns the
        loss on the device."""
        if self.cfg.sparse_adam:
            return sparse_kg_step(self.model, self.opt, h, r, t_pos, t_neg,
                                  self.cfg.model, weight)
        loss = self.kg_grad(h, r, t_pos, t_neg, weight)
        self.opt.step()
        return loss

    def _cf_body(self) -> torch.Tensor:
        """One device-sampled CF step on the staged attention: the batch,
        then the dropout masks, drawn from the trainer's generator (the
        draws :meth:`cf_step` makes given the batch alone); when
        partitioned, the masks from the partitions' generators inside the
        step."""
        u, i_pos, i_neg, weight = self.sample_cf()
        if self.partitioned:
            if self.sync:
                dp.check_batch((u, i_pos, i_neg, weight))
            self.cf_drawn = (u, i_pos, i_neg, weight, None)
            return self.cf_step(self._step_att, u, i_pos, i_neg, weight)
        masks = kgat.dropout_masks(self.cfg.model, self.meta.n_nodes,
                                   self.generator, self.device)
        self.cf_drawn = (u, i_pos, i_neg, weight, masks)
        return self.cf_step(self._step_att, u, i_pos, i_neg, weight,
                            masks=masks)

    def _kg_body(self) -> torch.Tensor:
        """One device-sampled KG step."""
        self.kg_drawn = self.sample_kg()
        if self.sync:
            dp.check_batch(self.kg_drawn)
        return self.kg_step(*self.kg_drawn)

    def stage(self, att) -> None:
        """Copies the epoch's attention (:class:`EdgeWeights`, or every dp
        row's partitions' and ring buckets' when partitioned) into the
        buffers the CF steps read, which keep their addresses, as a
        captured step needs."""
        if self._step_att is None:
            self._step_att = clone_weights(att)
        else:
            copy_weights_(self._step_att, att)

    def train_one_epoch(self) -> Tuple[float, float]:
        """One epoch: the CF phase, the KG phase (each ending in its loss's
        read-back), then the attention recompute; each is a span timed on
        the device's stream (``utils.trace``)."""
        att = self._att
        if att is None:
            with trace.span("train.attention", device=self.device):
                att = self.attention()
        self._att = None  # params are about to change
        try:
            if not self.partitioned and self.cfg.sampler == "host":
                return self._host_sampled_epoch(att)
            self.stage(att)
            with trace.span("train.cf_phase", device=self.device):
                cf = float(self.cf_steps.run(self.n_cf_batches))
            with trace.span("train.kg_phase", device=self.device):
                kg = float(self.kg_steps.run(self.n_kg_batches))
            return cf / self.n_cf_batches, kg / self.n_kg_batches
        finally:
            # Reference order (SURVEY.md §3.1): attention recomputed after
            # the KG phase, reused by evaluate() and the next epoch.
            with trace.span("train.attention", device=self.device):
                self._att = self.attention()

    def _host_sampled_epoch(self, att) -> Tuple[float, float]:
        """One eager step per batch of the host samplers, weight None
        (``kgat_tpu/train.py:371-389``)."""
        on = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        cf = [self.cf_step(att, *map(on, self._host_cf.sample(
            self.cf_batch_size))) for _ in range(self.n_cf_batches)]
        kg = [self.kg_step(*map(on, self._host_kg.sample(
            self.kg_batch_size))) for _ in range(self.n_kg_batches)]
        return float(torch.stack(cf).mean()), float(torch.stack(kg).mean())

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
        """The full state in ``kgat_tpu``'s format (``utils/checkpoint.py``):
        params, Adam's moments and count, the counters, and the port's
        generator states, which ``kgat_tpu`` ignores. ``rng`` is JAX key
        data made from (seed, epoch), not the state of a generator here:
        ``kgat_tpu`` resumes from it with a stream of its own."""
        mc, state = self.cfg.model, self.opt.state
        moments = {key: kgat.numpy_params(self.model,
                                          lambda p, key=key: state[p][key])
                   for key in ("exp_avg", "exp_avg_sq")}
        own = ({"generator": self.generator.get_state().numpy()}
               if self.rank == 0 else {})
        if self.partitioned:
            own.update({f"part_generator/{p}": g.get_state().numpy()
                        for p, g in enumerate(self.part_generators)
                        if g is not None})
        state = dict(
            path=path, params=kgat.numpy_params(self.model),
            mu=moments["exp_avg"], nu=moments["exp_avg_sq"],
            count=adam_count(self.opt), epoch=self.epoch,
            rng=np.array([self.cfg.seed % 2 ** 32, self.epoch], np.uint32),
            best_metric=self.best_metric, bad_evals=self.bad_evals, own=own,
            extra={"model": {"embed_dim": mc.embed_dim,
                             "relation_dim": mc.relation_dim,
                             "conv_dims": list(mc.conv_dims),
                             "aggregator": mc.aggregator,
                             "mess_dropout": list(mc.mess_dropout)},
                   "dataset": self.cfg.dataset})
        if self.n_procs == 1:
            save_checkpoint(**state)
            return
        # Every process its shard (kgat_tpu/train.py:413-417); the
        # barrier keeps a process from reading a shard a peer still writes.
        save_checkpoint_sharded(**state, process_index=self.rank,
                                process_count=self.n_procs)
        multihost.barrier(self.device)

    def _resume(self) -> None:
        """Restore from the newer (by epoch) of the best and last
        checkpoints, as ``kgat_tpu/train.py:430-456`` does: params, Adam's
        moments and count, epoch, best_metric and bad_evals, and the
        generators' states. A ``kgat_tpu`` checkpoint holds no torch
        generator state: the generators are then re-seeded from (seed,
        epoch), and a ``rng_reseeded`` event says so."""
        states = []
        for path in (self.ckpt_path(), self.last_ckpt_path()):
            try:
                states.append((load_checkpoint_sharded(path), path))
            except FileNotFoundError:
                pass
        if not states:
            self.logger.log("resume_missing")
            return
        state, path = max(states, key=lambda s: s[0]["meta"]["epoch"])
        opt_state = self.opt.state
        kgat.copy_params_(self.model, state["params"])
        for key, tree in (("exp_avg", state["mu"]),
                          ("exp_avg_sq", state["nu"])):
            kgat.copy_params_(self.model, tree,
                              lambda p, key=key: opt_state[p][key])
        set_adam_count(self.opt, state["count"])
        meta = state["meta"]
        self.epoch = meta["epoch"]
        self.best_metric = meta["best_metric"]
        self.bad_evals = meta["bad_evals"]
        self._att = None  # params changed; recomputed when needed
        gens, keys = [self.generator], ["generator"]
        if self.partitioned:
            for p, g in enumerate(self.part_generators):
                if g is not None:
                    gens.append(g)
                    keys.append(f"part_generator/{p}")
        self.logger.log("resume", epoch=self.epoch, best=self.best_metric,
                        bad_evals=self.bad_evals, source=path)
        if all(k in state["own"] for k in keys):
            for g, k in zip(gens, keys):
                g.set_state(torch.from_numpy(state["own"][k]))
        else:
            for i, g in enumerate(gens):
                g.manual_seed(reseed(self.cfg.seed, self.epoch, i))
            self.logger.log("rng_reseeded", seed=self.cfg.seed,
                            epoch=self.epoch)

    def train(self) -> dict:
        cfg = self.cfg
        if cfg.resume:
            self._resume()
        self.logger.log("start", dataset=self.ds.name,
                        n_nodes=self.meta.n_nodes, n_edges=self.graph.n_edges,
                        n_relations=self.meta.n_relations,
                        cf_batches=self.n_cf_batches,
                        kg_batches=self.n_kg_batches,
                        aggregator=cfg.model.aggregator,
                        backend=cfg.model.ops_backend, sampler=cfg.sampler)
        if cfg.profile_epochs > 0 and cfg.log_dir and self.rank == 0:
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

    def close(self) -> None:
        """Drops the captured steps and frees the ring links' buffers
        (``Partitioned.close``). Under a process group every process calls
        it together, after its last step."""
        self.cf_steps.graph = self.kg_steps.graph = None
        if self.part is not None:
            self.part.close()

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
            # kgat_tpu's keys, and for the partitioned trainer whether its
            # steps replayed CUDA graphs and why.
            mode = (dict(captured=self.captured, why=self.capture_why)
                    if self.partitioned else {})
            if self.grouped:
                mode.update(processes=self.n_procs, rank=self.rank)
            self.logger.log("epoch", epoch=self.epoch, cf_loss=cf_l,
                            kg_loss=kg_l, secs=round(dt, 3),
                            edges_per_s=round(edges / dt), **mode)
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
    """Train from command-line flags; returns the last eval's metrics.
    Under NUM_PROCESSES > 1 the process group forms first
    (``kgat_tpu/train.py:530-533``) and ends with the run."""
    cfg = parse_args(argv)
    multihost.initialize_distributed(device=cfg.device)
    try:
        trainer = Trainer(cfg)
        final = trainer.train()
        trainer.close()
        return final
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
