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

Across processes (``dp.Mesh`` under a process group, one process per
card, ``parallel/multihost.py``), each process holds its own slots'
shards, buckets and halos only, and computes their attention (on a 2D
mesh row d's processes compute what row 0's compute: the kernels are
deterministic). The exchanges of a row that spans processes are
collectives over its process group: the all-gather is
``multihost.all_gather`` (its backward a reduce-scatter); a2a one
``all_to_all`` of equal blocks (H rows for each pair of partitions); the
ring passes the chunk of a process's last partition to the next process,
by NCCL (or gloo) send/receive under 'ppermute' and by K7 or K8 storing
into the next process's registered buffer under 'dma' and 'fused'
(``ProcessRing``); its final concatenation is one all-gather. Between
the partitions of one process the paths above stay. Each process takes
its slots' block of the CF batch and divides by the whole batch's weight:
its loss and gradients are its share, which the trainer all-reduces.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kgat_tpu_torch.graph import (CKGMeta, EdgeWeights, build_coalesced,
                                  round_weights, stage_weights)
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGAT, KGATConfig
from kgat_tpu_torch.ops import get_backend, l2norm
from kgat_tpu_torch.ops.hopper.remote_ring import (ProcessRing,
                                                   bucket_spmm_send,
                                                   ring_send)
from kgat_tpu_torch.parallel import multihost
from kgat_tpu_torch.parallel.dp import Mesh
from kgat_tpu_torch.parallel.partition import (Bucket, PartitionInfo,
                                               SelectiveHalo, Shard)

EXCHANGES = ("allgather", "ring", "a2a")
RING_TRANSPORTS = ("ppermute", "dma", "fused")


def _place(staged, devices):
    """Staged weights of one row, each partition's moved to ``devices``
    (the same tensors where a device is the same; None stays None)."""
    def to(w, dev):
        if w is None:
            return None
        if isinstance(w, EdgeWeights):
            return w.with_tensors(w.fwd.to(dev), w.rev.to(dev))
        return [to(x, dev) for x in w]
    return [to(w, dev) for w, dev in zip(staged, devices)]


class Partitioned:
    """Attention, propagation and the CF loss of a model over the shards
    of :func:`kgat_tpu_torch.parallel.partition.partition_graph` (and, for
    the ring, the buckets of ``build_ring_buckets``; for 'a2a', the halos
    of ``build_selective_halo``), each placed on its partition's device
    on every dp row of the mesh: what ``kgat_tpu``'s ``make_partitioned``
    returns, as methods (``attention``, ``propagate_eval``, ``cf_loss``).
    Under a process group, only this process's slots are placed: lists
    indexed by partition hold None for another process's partitions, and
    every process must call the methods in one order (they run
    collectives)."""

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
        self.mesh = mesh
        self.info, self.meta, self.cfg = info, meta, cfg
        self.rows = [mesh.row(d) for d in range(mesh.dp_replicas)]
        self.exchange = exchange
        self.ring, self.a2a = exchange == "ring", exchange == "a2a"
        self.transport = ring_transport
        self.ops = get_backend(cfg.ops_backend)
        # The all-gather's shards reduce over their coalesced CSRs where
        # the config coalesces, as kgat_tpu/train.py:315-319 builds
        # coalesced shards for the all-gather alone; ring buckets and a2a
        # halos keep every edge. Built on the host for this process's
        # partitions.
        self.coalesce = exchange == "allgather" and cfg.coalesces
        if self.coalesce:
            mine = {p for d in mesh.local_rows() for p in mesh.local_parts(d)}
            shards = [dataclasses.replace(s, graph=dataclasses.replace(
                s.graph, co=build_coalesced(s.graph, cfg.coalesce_cap)))
                if p in mine else s for p, s in enumerate(shards)]
        # [row][partition]: this process's slots only (None elsewhere); a
        # device's tensors are shared by the rows on it.
        place = lambda objs: [multihost.place_local(objs, row)  # noqa: E731
                              for row in self.rows]
        self.shards = place(shards)
        self.buckets = ([[None if dv is None else [b.to(dv) for b in bs]
                          for bs, dv in zip(ring_buckets, row)]
                         for row in self.rows] if self.ring else None)
        self.halos = place(halos) if self.a2a else None
        # The ring neighbours (previous, next process) of each row that
        # spans processes, and its K7 / K8 link under 'dma' and 'fused'.
        self.neighbours, self.links = {}, {}
        for d in mesh.local_rows():
            if mesh.group(d) is None or not self.ring:
                continue
            ranks = mesh.row_ranks(d)
            j = ranks.index(mesh.rank)
            prev, nxt = ranks[j - 1], ranks[(j + 1) % len(ranks)]
            self.neighbours[d] = (prev, nxt)
            if ring_transport != "ppermute":
                self.links[d] = ProcessRing(
                    mesh.group(d), prev, nxt, self._home(d),
                    self._ring_keys())

    def _ring_keys(self) -> dict:
        """(layer, ring step, direction) -> the (shape, dtype) of the chunk
        (or its gradient) a process receives under it."""
        low = self.cfg.stream_dtype
        dims = (self.cfg.embed_dim, *self.cfg.conv_dims)
        R = self.info.rows_per_part
        return {(li, s, dirn): ((R, dims[li]), low or torch.float32)
                for li in range(len(self.cfg.conv_dims))
                for s in range(self.n_parts - 1) for dirn in (1, -1)}

    @property
    def n_parts(self) -> int:
        return self.info.n_parts

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    def _on(self, t: torch.Tensor, p: int, d: int = 0) -> torch.Tensor:
        return t.to(self.rows[d][p])

    def _local(self, d: int) -> range:
        """This process's partitions of row d (all of them in one
        process)."""
        return self.mesh.local_parts(d)

    def _home(self, d: int) -> torch.device:
        """Where row d's full representation lives: its first local
        partition's device (partition 0's in one process)."""
        return self.rows[d][self._local(d)[0]]

    def _spread(self, d: int, vals) -> list:
        """Values of row d's local partitions, in order, as a list indexed
        by partition (None for another process's)."""
        out = [None] * self.n_parts
        for p, v in zip(self._local(d), vals, strict=True):
            out[p] = v
        return out

    # ------------------------------------------------------------------
    def attention(self, model: KGAT) -> Tuple[List[torch.Tensor], list]:
        """Shard-local attention, no gradient (``halo.py:277-319``): per
        partition of this process's first row, the per-dst softmax of the
        TransR logits in the shard's canonical edge order, and the weights
        staged for the SpMM of every row, ``staged[d][p]``: :class:`
        EdgeWeights` of the shard (all-gather; over its coalesced groups
        when coalescing) or of its halo's CSR (a2a), or per ring step of
        its bucket (ring); None for another process's partitions and rows.
        The staged weights are rounded to ``compute_dtype``, as
        ``kgat_tpu`` stages every exchange's (``halo.py:296-297,
        :312-314``)."""
        first, *others = self.mesh.local_rows()
        atts, staged = [None] * self.n_parts, [None] * self.n_parts
        cfg = self.cfg
        with torch.no_grad():
            for p in self._local(first):
                shard = self.shards[first][p]
                logits = self.ops.attention_logits(
                    shard.att_graph(), self._on(model.entity_embed, p, first),
                    self._on(model.w_rel, p, first),
                    self._on(model.rel_embed, p, first))
                att = self.ops.segment_softmax(shard.graph, logits)
                atts[p] = att
                if self.ring:
                    w = round_weights(att, cfg.compute_dtype)
                    staged[p] = [EdgeWeights(fwd=w[b.gather],
                                             rev=w[b.rev_gather])
                                 for b in self.buckets[first][p]]
                elif self.a2a:
                    staged[p] = stage_weights(self.halos[first][p].graph,
                                              att, dtype=cfg.compute_dtype)
                else:
                    staged[p] = stage_weights(
                        shard.graph, att, dtype=cfg.compute_dtype,
                        coalesce=self.coalesce, cap=cfg.coalesce_cap)
        rows = [None] * self.n_rows
        rows[first] = staged
        for d in others:
            rows[d] = _place(staged, self.rows[d])
        return atts, rows

    # ------------------------------------------------------------------
    def _gather(self, d: int, parts: List[Optional[torch.Tensor]]
                ) -> torch.Tensor:
        """Row d's partitions' blocks concatenated, on the row's home
        device: ``.to()`` copies in one process, the row group's
        differentiable all-gather across processes."""
        group = self.mesh.group(d)
        if group is None:
            return torch.cat([t.to(self._home(d)) for t in parts])
        return multihost.all_gather(
            torch.cat([parts[p] for p in self._local(d)]), group)

    def _shift(self, d: int, key: tuple, cs: list) -> list:
        """Row d's partition j in this process receives partition j - 1's
        chunk (``cs``: the chunks of this process's partitions, in order);
        the first receives, across processes, the previous process's last.
        ``key`` is (layer, ring step)."""
        if self.transport == "dma":
            return ring_send(cs, 1, self.links.get(d), key)
        last, group = cs[-1], self.mesh.group(d)
        if group is not None:
            prev, nxt = self.neighbours[d]
            last = multihost.shift(last, nxt, prev, group)
        return [last.to(cs[0].device)] + [
            c.to(after.device) for c, after in zip(cs[:-1], cs[1:])]

    def _ring_side(self, d: int, li: int, staged, chunks: list) -> list:
        """One layer's ring exchange on row d (``halo.py:331-349``): at
        step s partition p holds partition (p - s) mod P's chunk and
        reduces its bucket s; every step but the last passes the chunks
        one hop right, and under 'fused' the send rides in the reduce's
        launch."""
        n, loc = self.n_parts, self._local(d)
        cs = [chunks[p] for p in loc]
        sides = None
        for s in range(n):
            buckets = [self.buckets[d][p][s] for p in loc]
            ews = [staged[p][s] for p in loc]
            if self.transport == "fused" and s < n - 1:
                parts, cs = bucket_spmm_send(buckets, ews, cs,
                                             self.links.get(d), (li, s))
            else:
                parts = [self.ops.bucket_spmm(b, w, c)
                         for b, w, c in zip(buckets, ews, cs)]
                if s < n - 1:
                    cs = self._shift(d, (li, s), cs)
            sides = parts if sides is None else [a + b for a, b in
                                                 zip(sides, parts)]
        return self._spread(d, sides)

    def _a2a_tables(self, d: int, egos: list) -> list:
        """The selective exchange on row d (``_a2a_table``, ``halo.py:
        351-357``): partition p's local table is its own rows, then from
        each peer q the rows q sends it (``send_idx[p]`` of q's halo). In
        one process an ``index_select`` on q's device copied to p's;
        across processes one all-to-all of the row group, H rows for each
        (sending, receiving) pair. Autograd's transpose adds the halo
        rows' gradients back into their owners' rows."""
        n, halos, group = self.n_parts, self.halos[d], self.mesh.group(d)
        if group is None:
            return [torch.cat([egos[p]] + [
                self._on(egos[q].index_select(0, halos[q].send_idx[p]), p, d)
                for q in range(n)]) for p in range(n)]
        loc = self._local(d)
        k, n_procs = len(loc), n // len(loc)
        # Block j of the send buffer goes to the row's j-th process, whose
        # partitions are [j k, (j + 1) k): for each of them, H rows of
        # each of this process's partitions.
        send = torch.cat([egos[q].index_select(0, halos[q].send_idx[p])
                          for p in range(n) for q in loc])
        got = multihost.all_to_all(send, group)
        got = got.view(n_procs, k, k, -1, send.shape[-1])
        tables = [None] * n
        for i, p in enumerate(loc):
            tables[p] = torch.cat([egos[p]] + [got[q // k, i, q % k]
                                               for q in range(n)])
        return tables

    def _propagate_row(self, d: int, model: KGAT, staged, train: bool,
                       generators: Optional[Sequence[torch.Generator]]
                       ) -> torch.Tensor:
        """Row d's L-layer propagation -> (n_nodes, out_dim) on its home
        device (``propagate_inner``, ``halo.py:359-435``)."""
        cfg, info = self.cfg, self.info
        n, R, N = self.n_parts, info.rows_per_part, info.n_nodes_global
        loc = self._local(d)
        if train:
            kgat.check_dropout(cfg)
            if any(r > 0 for r in cfg.mess_dropout) and (
                    generators is None or len(generators) != n):
                raise ValueError(f"training dropout needs one generator per "
                                 f"partition ({n})")
        low = cfg.stream_dtype
        cast = (lambda v: v) if low is None else (lambda v: v.to(low))  # noqa: E731
        emb = model.entity_embed
        x = F.pad(emb, (0, 0, 0, info.n_nodes_pad - N))    # (n_pad, d)
        egos = [None] * n
        if self.a2a:
            # Layer 0's table straight off the replicated embedding (no
            # exchange); the sentinel slots clamp to a row no edge reads.
            tables = [None] * n
            for p in loc:
                tables[p] = self._on(x, p, d).index_select(
                    0, self.halos[d][p].local_ids.clamp(
                        max=info.n_nodes_pad - 1))
                egos[p] = tables[p][:R]
        else:
            for p in loc:
                egos[p] = self._on(x[p * R:(p + 1) * R], p, d)
        own_outs = [None if e is None else [e] for e in egos]
        outs = [emb.to(self._home(d))]
        n_layers = len(model.layers)
        for li, layer in enumerate(model.layers):
            if self.ring:
                sides = self._ring_side(d, li, staged, [
                    None if e is None else cast(e) for e in egos])
            elif self.a2a:
                sides = [None] * n
                for p in loc:
                    sides[p] = self.ops.spmm(self.halos[d][p].graph,
                                             staged[p], cast(tables[p]))
            else:
                xc, sides = cast(x), [None] * n
                for p in loc:
                    sides[p] = self.ops.spmm(self.shards[d][p].graph,
                                             staged[p], self._on(xc, p, d))
            rate, new = cfg.mess_dropout[li], [None] * n
            for p in loc:
                lp = {k: self._on(v, p, d) for k, v in layer.items()}
                # Partition p's (R, d_out) keep mask, from its own
                # generator.
                mask = (kgat.dropout_mask((R, cfg.conv_dims[li]), rate,
                                          generators[p], egos[p].device)
                        if train and rate > 0 else None)
                new[p], _ = self.ops.layer(egos[p], sides[p], lp, mask,
                                           rate, cfg)
            egos = new
            if self.ring or self.a2a:
                # Rows stay owned; one all-gather of the concatenated
                # representation after the last layer.
                for p in loc:
                    own_outs[p].append(l2norm(egos[p]))
                if self.a2a and li < n_layers - 1:
                    tables = self._a2a_tables(d, egos)
            else:
                # One all-gather per layer.
                x = self._gather(d, egos)
                outs.append(l2norm(x[:N]))
        if self.ring or self.a2a:
            return self._gather(d, [None if o is None else torch.cat(o, -1)
                                    for o in own_outs])[:N]
        return torch.cat(outs, -1)

    def propagate(self, model: KGAT, staged, *, train: bool = False,
                  generators: Optional[Sequence[torch.Generator]] = None
                  ) -> torch.Tensor:
        """L-layer propagation over the partitions of this process's first
        row (row 0 in one process) -> (n_nodes, out_dim) on its home
        device. ``staged`` is :meth:`attention`'s second output.
        ``train=True`` applies message dropout, independent per partition:
        partition p draws its masks from ``generators[p]``, on its
        device."""
        d = self.mesh.local_rows()[0]
        return self._propagate_row(d, model, staged[d], train, generators)

    def propagate_eval(self, model: KGAT, staged) -> torch.Tensor:
        """The eval-mode forward (no dropout, no gradient)."""
        with torch.no_grad():
            return self.propagate(model, staged)

    def batch_rows(self, d: int, batch: int) -> slice:
        """The rows of a global batch that row d's partitions of this
        process take: in one process the batch's d-th of D blocks; under
        a process group its slots' blocks of N (one per slot)."""
        D, P = self.n_rows, self.n_parts
        if not self.mesh.owners:
            return slice(d * batch // D, (d + 1) * batch // D)
        if batch % (D * P):
            raise ValueError(f"a batch of {batch} does not split into "
                             f"{D * P} mesh slots")
        b, loc = batch // (D * P), self._local(d)
        return slice((d * P + loc[0]) * b, (d * P + loc[-1] + 1) * b)

    def cf_loss(self, model: KGAT, staged, users: torch.Tensor,
                pos_items: torch.Tensor, neg_items: torch.Tensor, *,
                weight: Optional[torch.Tensor] = None,
                generators: Optional[Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """BPR loss of a global batch over the partitioned propagation
        (``cf_loss_inner``, ``halo.py:437-452``): row d of the mesh takes
        the batch's d-th contiguous block (:meth:`batch_rows`), its
        partition p drawing dropout from ``generators[d * P + p]``; the
        weighted pair losses and the 0.5 sum-of-squares regulariser,
        summed over the rows, are divided by the batch's total weight (the
        psum'd ``n_valid``). Under a process group, this process's share:
        its rows' terms over the whole batch's weight, whose sum over the
        processes is the loss."""
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
        home = model.entity_embed.device
        bpr_sum = reg = None
        for d in self.mesh.local_rows():
            rows = self.batch_rows(d, B)
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

    def close(self) -> None:
        """Frees the ring links' buffers (:meth:`ProcessRing.close`): every
        process together, after the last step that uses them."""
        for link in self.links.values():
            link.close()
        self.links = {}
