"""Partitioned execution over P destination-block partitions.

Port of ``kgat_tpu/parallel/halo.py``'s ``make_partitioned``, as the
class :class:`Partitioned`. JAX runs one
program per device under ``shard_map``; here one process drives every
partition in turn, each on its own device (``dp.Mesh``), as JAX's single
controller drives a mesh on one host. With dst partitioning:

  attention (SDDMM + edge softmax)  -> no communication: K2 and K3 on each
                                       shard
  propagation SpMM                  -> 'allgather': the layer's activations
                                       copied whole to every partition, K1
                                       on the shard's forward CSR; or
                                       'ring': P steps, each reducing the
                                       bucket whose source chunk a partition
                                       holds, then passing the chunk on
  SpMM backward feature grads       -> K1 on the shard's reverse CSR (a
                                       partial over the whole table) summed
                                       by autograd, the all-gather's
                                       transpose; on the ring, K6 on each
                                       bucket's reverse CSR and the chunks'
                                       cotangents passed back the other way
  loss and parameter gradients      -> over the global batch in one process

Ring transports, as in JAX: 'ppermute' passes a chunk with a plain tensor
copy (XLA's collective, not a kernel), 'dma' with K7
(``ops/hopper/remote_ring.ring_send``), 'fused' with K8, which reduces the
bucket and sends the chunk in one launch (``bucket_spmm_send``). The
transport picks K7 and K8 whatever the ops backend, as JAX runs its
remote-DMA kernels under either; the backend picks the bucket reduce (K6
or the plain gather and ``index_add_``).

Parameters live on partition 0's device; a partition on another device
works on differentiable ``.to()`` copies, so autograd sums its gradients
back (on one card the copies are the tensors themselves).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kgat_tpu_torch.graph import CKGMeta, EdgeWeights
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGAT, KGATConfig
from kgat_tpu_torch.ops import get_backend
from kgat_tpu_torch.ops.hopper.remote_ring import bucket_spmm_send, ring_send
from kgat_tpu_torch.parallel.dp import Mesh
from kgat_tpu_torch.parallel.partition import Bucket, PartitionInfo, Shard

EXCHANGES = ("allgather", "ring")
RING_TRANSPORTS = ("ppermute", "dma", "fused")


class Partitioned:
    """Attention, propagation and the CF loss of a model over the shards
    of :func:`kgat_tpu_torch.parallel.partition.partition_graph` (and, for
    the ring, the buckets of ``build_ring_buckets``), each placed on its
    partition's device: what ``kgat_tpu``'s ``make_partitioned`` returns,
    as methods (``attention``, ``propagate_eval``, ``cf_loss``)."""

    def __init__(self, mesh: Mesh, shards: Sequence[Shard],
                 info: PartitionInfo, meta: CKGMeta, cfg: KGATConfig, *,
                 exchange: str = "allgather",
                 ring_buckets: Optional[Sequence[Sequence[Bucket]]] = None,
                 ring_transport: str = "ppermute"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r} (the port has "
                             f"{EXCHANGES})")
        if ring_transport not in RING_TRANSPORTS:
            raise ValueError(f"unknown ring_transport {ring_transport!r}")
        if exchange == "ring" and ring_buckets is None:
            raise ValueError("exchange='ring' requires ring_buckets "
                             "(partition.build_ring_buckets)")
        if not len(shards) == mesh.n_parts == info.n_parts:
            raise ValueError(f"{len(shards)} shards, {mesh.n_parts} devices, "
                             f"{info.n_parts} partitions")
        self.info, self.meta, self.cfg = info, meta, cfg
        self.devices = mesh.devices
        self.ring = exchange == "ring"
        self.transport = ring_transport
        self.ops = get_backend(cfg.ops_backend)
        self.shards = [s.to(d) for s, d in zip(shards, self.devices)]
        self.buckets = ([[b.to(d) for b in row]
                         for row, d in zip(ring_buckets, self.devices)]
                        if self.ring else None)

    @property
    def n_parts(self) -> int:
        return self.info.n_parts

    def _on(self, t: torch.Tensor, p: int) -> torch.Tensor:
        return t.to(self.devices[p])

    # ------------------------------------------------------------------
    def attention(self, model: KGAT) -> Tuple[List[torch.Tensor], list]:
        """Shard-local attention, no gradient (``halo.py:277-319``): per
        partition, the per-dst softmax of the TransR logits in the
        shard's canonical edge order, and the weights staged for the
        SpMM: :class:`EdgeWeights` of the shard (all-gather), or per ring
        step of its bucket (ring)."""
        atts, staged = [], []
        with torch.no_grad():
            for p, shard in enumerate(self.shards):
                logits = self.ops.attention_logits(
                    shard.att_graph(), self._on(model.entity_embed, p),
                    self._on(model.w_rel, p), self._on(model.rel_embed, p))
                att = self.ops.segment_softmax(shard.graph, logits)
                atts.append(att)
                if self.ring:
                    staged.append([EdgeWeights(fwd=att[b.gather],
                                               rev=att[b.rev_gather])
                                   for b in self.buckets[p]])
                else:
                    staged.append(EdgeWeights.stage(shard.graph, att))
        return atts, staged

    # ------------------------------------------------------------------
    def _shift(self, chunks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Partition j receives partition j - 1's chunk."""
        if self.transport == "dma":
            return ring_send(chunks, 1)
        n = self.n_parts
        return [self._on(chunks[(j - 1) % n], j) for j in range(n)]

    def _ring_side(self, staged, chunks: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """One layer's ring exchange (``halo.py:331-349``): at step s
        partition p holds partition (p - s) mod P's chunk and reduces its
        bucket s; every step but the last passes the chunks one hop
        right, and under 'fused' the send rides in the reduce's launch."""
        n = self.n_parts
        sides = None
        for s in range(n):
            buckets = [self.buckets[p][s] for p in range(n)]
            ews = [staged[p][s] for p in range(n)]
            if self.transport == "fused" and s < n - 1:
                parts, chunks = bucket_spmm_send(buckets, ews, chunks)
            else:
                parts = [self.ops.bucket_spmm(b, w, c)
                         for b, w, c in zip(buckets, ews, chunks)]
                if s < n - 1:
                    chunks = self._shift(chunks)
            sides = parts if sides is None else [a + b for a, b in
                                                 zip(sides, parts)]
        return sides

    def propagate(self, model: KGAT, staged, *, train: bool = False,
                  generators: Optional[Sequence[torch.Generator]] = None
                  ) -> torch.Tensor:
        """L-layer propagation over the partitions -> (n_nodes, out_dim)
        on partition 0's device (``propagate_inner``, ``halo.py:359-435``).
        ``staged`` is :meth:`attention`'s second output. ``train=True``
        applies message dropout, independent per partition: partition p
        draws its masks from ``generators[p]``, on its device."""
        cfg, info = self.cfg, self.info
        n, R, N = self.n_parts, info.rows_per_part, info.n_nodes_global
        if train:
            kgat.check_dropout(cfg)
            if any(r > 0 for r in cfg.mess_dropout) and (
                    generators is None or len(generators) != n):
                raise ValueError(f"training dropout needs one generator per "
                                 f"partition ({n})")
        low = cfg.compute_dtype if cfg.ops_backend == "hopper" else None
        cast = (lambda v: v) if low is None else (lambda v: v.to(low))  # noqa: E731
        emb = model.entity_embed
        x = F.pad(emb, (0, 0, 0, info.n_nodes_pad - N))    # (n_pad, d)
        egos = [self._on(x[p * R:(p + 1) * R], p) for p in range(n)]
        own_outs = [[e] for e in egos]
        outs = [emb]
        for li, layer in enumerate(model.layers):
            if self.ring:
                sides = self._ring_side(staged, [cast(e) for e in egos])
            else:
                xc = cast(x)
                sides = [self.ops.spmm(shard.graph, staged[p],
                                       self._on(xc, p))
                         for p, shard in enumerate(self.shards)]
            new = []
            for p in range(n):
                lp = {k: self._on(v, p) for k, v in layer.items()}
                ego = kgat.aggregate(egos[p], sides[p], lp, cfg)
                if train and cfg.mess_dropout[li] > 0:
                    ego = kgat.dropout(ego, cfg.mess_dropout[li],
                                       generators[p])
                new.append(ego)
            egos = new
            if self.ring:
                # Rows stay owned; one all-gather of the concatenated
                # representation after the last layer.
                for p in range(n):
                    own_outs[p].append(kgat.l2norm(egos[p]))
            else:
                # One all-gather per layer.
                x = torch.cat([self._on(e, 0) for e in egos])
                outs.append(kgat.l2norm(x[:N]))
        if self.ring:
            full = torch.cat([self._on(torch.cat(o, -1), 0)
                              for o in own_outs])
            return full[:N]
        return torch.cat(outs, -1)

    def propagate_eval(self, model: KGAT, staged) -> torch.Tensor:
        """The eval-mode forward (no dropout, no gradient)."""
        with torch.no_grad():
            return self.propagate(model, staged)

    def cf_loss(self, model: KGAT, staged, users: torch.Tensor,
                pos_items: torch.Tensor, neg_items: torch.Tensor, *,
                weight: Optional[torch.Tensor] = None,
                generators: Optional[Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """BPR loss of a global batch over the partitioned propagation
        (``cf_loss_inner``, ``halo.py:437-452``): the weighted pair losses
        and the 0.5 sum-of-squares regulariser, both divided by the
        batch's total weight (the psum'd ``n_valid``)."""
        all_embed = self.propagate(model, staged, train=True,
                                   generators=generators)
        u = all_embed[self.meta.user_node(users)]
        ip = all_embed[pos_items]
        ineg = all_embed[neg_items]
        bpr = -F.logsigmoid((u * ip).sum(-1) - (u * ineg).sum(-1))
        if weight is None:
            weight = torch.ones_like(bpr)
        n_valid = weight.sum().clamp(min=1.0)
        reg = 0.5 * ((u ** 2).sum() + (ip ** 2).sum() + (ineg ** 2).sum())
        return (bpr * weight).sum() / n_valid + self.cfg.reg_cf * reg / n_valid

