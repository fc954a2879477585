"""Partitioned execution over P destination-block partitions, on D rows.

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
                                       holds, then passing the chunk on; or
                                       'a2a': each partition receives exactly
                                       the rows its edges read from each
                                       peer into a local table, and K1 runs
                                       on the shard's CSR over that table
  SpMM backward feature grads       -> K1 on the shard's reverse CSR (a
                                       partial over the whole table) summed
                                       by autograd, the all-gather's
                                       transpose; on the ring, K6 on each
                                       bucket's reverse CSR and the chunks'
                                       cotangents passed back the other way;
                                       under 'a2a', K1 on the reverse CSR
                                       over the local table, and autograd's
                                       scatter-add of the halo rows'
                                       gradients back to their owners
  loss and parameter gradients      -> over the global batch in one process

Ring transports, as in JAX: 'ppermute' passes a chunk with a plain tensor
copy (XLA's collective, not a kernel), 'dma' with K7
(``ops/hopper/remote_ring.ring_send``), 'fused' with K8, which reduces the
bucket and sends the chunk in one launch (``bucket_spmm_send``). The
transport picks K7 and K8 whatever the ops backend, as JAX runs its
remote-DMA kernels under either; the backend picks the bucket reduce (K6
or the plain gather and ``index_add_``).

A 2D (dp, ep) mesh (``dp.make_mesh(P, dp_replicas=D)``, JAX's
``dp_axis``) holds the same shards on every row's devices. The attention
is computed once, on row 0, and placed on each row's devices (on one
card, the rows share it). The CF loss cuts the global batch into D
contiguous blocks, runs row d's propagation for block d with row d's
dropout generators, and divides the sums over all rows by the batch's
total weight (``halo.py:437-452``). Evaluation runs row 0.

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
from kgat_tpu_torch.parallel.partition import (Bucket, PartitionInfo,
                                               SelectiveHalo, Shard)

EXCHANGES = ("allgather", "ring", "a2a")
RING_TRANSPORTS = ("ppermute", "dma", "fused")


def _place(staged, devices):
    """Staged weights of one row, each partition's moved to ``devices``
    (the same tensors where a device is the same)."""
    def to(w, dev):
        if isinstance(w, EdgeWeights):
            return EdgeWeights(fwd=w.fwd.to(dev), rev=w.rev.to(dev))
        return [to(x, dev) for x in w]
    return [to(w, dev) for w, dev in zip(staged, devices)]


class Partitioned:
    """Attention, propagation and the CF loss of a model over the shards
    of :func:`kgat_tpu_torch.parallel.partition.partition_graph` (and, for
    the ring, the buckets of ``build_ring_buckets``; for 'a2a', the halos
    of ``build_selective_halo``), each placed on its partition's device
    on every dp row of the mesh: what ``kgat_tpu``'s ``make_partitioned``
    returns, as methods (``attention``, ``propagate_eval``, ``cf_loss``)."""

    def __init__(self, mesh: Mesh, shards: Sequence[Shard],
                 info: PartitionInfo, meta: CKGMeta, cfg: KGATConfig, *,
                 exchange: str = "allgather",
                 ring_buckets: Optional[Sequence[Sequence[Bucket]]] = None,
                 halos: Optional[Sequence[SelectiveHalo]] = None,
                 ring_transport: str = "ppermute"):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r} (the port has "
                             f"{EXCHANGES})")
        if ring_transport not in RING_TRANSPORTS:
            raise ValueError(f"unknown ring_transport {ring_transport!r}")
        if exchange == "ring" and ring_buckets is None:
            raise ValueError("exchange='ring' requires ring_buckets "
                             "(partition.build_ring_buckets)")
        if exchange == "a2a" and halos is None:
            raise ValueError("exchange='a2a' requires halos "
                             "(partition.build_selective_halo)")
        if not len(shards) == mesh.n_parts == info.n_parts:
            raise ValueError(f"{len(shards)} shards, {mesh.n_parts} devices "
                             f"a row, {info.n_parts} partitions")
        self.info, self.meta, self.cfg = info, meta, cfg
        self.rows = [mesh.row(d) for d in range(mesh.dp_replicas)]
        self.exchange = exchange
        self.ring, self.a2a = exchange == "ring", exchange == "a2a"
        self.transport = ring_transport
        self.ops = get_backend(cfg.ops_backend)
        # [row][partition]; a device's tensors are shared by the rows on it.
        place = lambda objs: [[o.to(dv) for o, dv in zip(objs, row)]  # noqa: E731
                              for row in self.rows]
        self.shards = place(shards)
        self.buckets = ([[[b.to(dv) for b in bs]
                          for bs, dv in zip(ring_buckets, row)]
                         for row in self.rows] if self.ring else None)
        self.halos = place(halos) if self.a2a else None

    @property
    def n_parts(self) -> int:
        return self.info.n_parts

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    def _on(self, t: torch.Tensor, p: int, d: int = 0) -> torch.Tensor:
        return t.to(self.rows[d][p])

    # ------------------------------------------------------------------
    def attention(self, model: KGAT) -> Tuple[List[torch.Tensor], list]:
        """Shard-local attention, no gradient (``halo.py:277-319``): per
        partition, the per-dst softmax of the TransR logits in the
        shard's canonical edge order (row 0's), and the weights staged
        for the SpMM of every row, ``staged[d][p]``: :class:`EdgeWeights`
        of the shard (all-gather) or of its halo's CSR (a2a), or per ring
        step of its bucket (ring)."""
        atts, staged = [], []
        with torch.no_grad():
            for p, shard in enumerate(self.shards[0]):
                logits = self.ops.attention_logits(
                    shard.att_graph(), self._on(model.entity_embed, p),
                    self._on(model.w_rel, p), self._on(model.rel_embed, p))
                att = self.ops.segment_softmax(shard.graph, logits)
                atts.append(att)
                if self.ring:
                    staged.append([EdgeWeights(fwd=att[b.gather],
                                               rev=att[b.rev_gather])
                                   for b in self.buckets[0][p]])
                elif self.a2a:
                    staged.append(EdgeWeights.stage(self.halos[0][p].graph,
                                                    att))
                else:
                    staged.append(EdgeWeights.stage(shard.graph, att))
        return atts, [staged] + [_place(staged, row) for row in self.rows[1:]]

    # ------------------------------------------------------------------
    def _shift(self, chunks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Partition j receives partition j - 1's chunk."""
        if self.transport == "dma":
            return ring_send(chunks, 1)
        n = self.n_parts
        return [chunks[(j - 1) % n].to(chunks[j].device) for j in range(n)]

    def _ring_side(self, d: int, staged, chunks: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """One layer's ring exchange on row d (``halo.py:331-349``): at
        step s partition p holds partition (p - s) mod P's chunk and
        reduces its bucket s; every step but the last passes the chunks
        one hop right, and under 'fused' the send rides in the reduce's
        launch."""
        n = self.n_parts
        sides = None
        for s in range(n):
            buckets = [self.buckets[d][p][s] for p in range(n)]
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

    def _a2a_tables(self, d: int, egos: List[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """The selective exchange on row d (``_a2a_table``, ``halo.py:
        351-357``): partition p's local table is its own rows, then from
        each peer q the rows q sends it (``send_idx[p]`` of q's halo), an
        ``index_select`` on q's device copied to p's. Autograd's transpose
        adds the halo rows' gradients back into their owners' rows."""
        n, halos = self.n_parts, self.halos[d]
        return [torch.cat([egos[p]] + [
            self._on(egos[q].index_select(0, halos[q].send_idx[p]), p, d)
            for q in range(n)]) for p in range(n)]

    def _propagate_row(self, d: int, model: KGAT, staged, train: bool,
                       generators: Optional[Sequence[torch.Generator]]
                       ) -> torch.Tensor:
        """Row d's L-layer propagation -> (n_nodes, out_dim) on its
        partition 0's device (``propagate_inner``, ``halo.py:359-435``)."""
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
        if self.a2a:
            # Layer 0's table straight off the replicated embedding (no
            # exchange); the sentinel slots clamp to a row no edge reads.
            tables = [self._on(x, p, d).index_select(
                0, h.local_ids.clamp(max=info.n_nodes_pad - 1))
                for p, h in enumerate(self.halos[d])]
            egos = [t[:R] for t in tables]
        else:
            egos = [self._on(x[p * R:(p + 1) * R], p, d) for p in range(n)]
        own_outs = [[e] for e in egos]
        outs = [self._on(emb, 0, d)]
        n_layers = len(model.layers)
        for li, layer in enumerate(model.layers):
            if self.ring:
                sides = self._ring_side(d, staged, [cast(e) for e in egos])
            elif self.a2a:
                sides = [self.ops.spmm(h.graph, staged[p], cast(tables[p]))
                         for p, h in enumerate(self.halos[d])]
            else:
                xc = cast(x)
                sides = [self.ops.spmm(shard.graph, staged[p],
                                       self._on(xc, p, d))
                         for p, shard in enumerate(self.shards[d])]
            new = []
            for p in range(n):
                lp = {k: self._on(v, p, d) for k, v in layer.items()}
                ego = kgat.aggregate(egos[p], sides[p], lp, cfg)
                if train and cfg.mess_dropout[li] > 0:
                    ego = kgat.dropout(ego, cfg.mess_dropout[li],
                                       generators[p])
                new.append(ego)
            egos = new
            if self.ring or self.a2a:
                # Rows stay owned; one all-gather of the concatenated
                # representation after the last layer.
                for p in range(n):
                    own_outs[p].append(kgat.l2norm(egos[p]))
                if self.a2a and li < n_layers - 1:
                    tables = self._a2a_tables(d, egos)
            else:
                # One all-gather per layer.
                x = torch.cat([self._on(e, 0, d) for e in egos])
                outs.append(kgat.l2norm(x[:N]))
        if self.ring or self.a2a:
            full = torch.cat([self._on(torch.cat(o, -1), 0, d)
                              for o in own_outs])
            return full[:N]
        return torch.cat(outs, -1)

    def propagate(self, model: KGAT, staged, *, train: bool = False,
                  generators: Optional[Sequence[torch.Generator]] = None
                  ) -> torch.Tensor:
        """L-layer propagation over row 0's partitions -> (n_nodes,
        out_dim) on partition 0's device. ``staged`` is
        :meth:`attention`'s second output. ``train=True`` applies message
        dropout, independent per partition: partition p draws its masks
        from ``generators[p]``, on its device."""
        return self._propagate_row(0, model, staged[0], train, generators)

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
        (``cf_loss_inner``, ``halo.py:437-452``): row d of the mesh takes
        the batch's d-th contiguous block, its partition p drawing dropout
        from ``generators[d * P + p]``; the weighted pair losses and the
        0.5 sum-of-squares regulariser, summed over the rows, are divided
        by the batch's total weight (the psum'd ``n_valid``)."""
        D, P = self.n_rows, self.n_parts
        B = users.shape[0]
        if B % D:
            raise ValueError(f"a batch of {B} does not split into {D} dp "
                             f"rows")
        if generators is not None and len(generators) != D * P:
            raise ValueError(f"{len(generators)} generators for {D} dp rows "
                             f"of {P}: one generator per partition")
        if weight is None:
            weight = torch.ones(B, device=users.device)
        b, home = B // D, model.entity_embed.device
        bpr_sum = reg = None
        for d in range(D):
            rows = slice(d * b, (d + 1) * b)
            all_embed = self._propagate_row(
                d, model, staged[d], True,
                None if generators is None else generators[d * P:(d + 1) * P])
            on = lambda t: t[rows].to(all_embed.device)  # noqa: E731
            u = all_embed[self.meta.user_node(on(users))]
            ip = all_embed[on(pos_items)]
            ineg = all_embed[on(neg_items)]
            bpr = -F.logsigmoid((u * ip).sum(-1) - (u * ineg).sum(-1))
            s = (bpr * on(weight)).sum().to(home)
            r = (0.5 * ((u ** 2).sum() + (ip ** 2).sum()
                        + (ineg ** 2).sum())).to(home)
            bpr_sum = s if bpr_sum is None else bpr_sum + s
            reg = r if reg is None else reg + r
        n_valid = weight.sum().clamp(min=1.0)
        return bpr_sum / n_valid + self.cfg.reg_cf * reg / n_valid
