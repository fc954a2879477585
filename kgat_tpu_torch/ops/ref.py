"""Plain PyTorch message-passing ops: the CPU path and the oracle.

Port of ``kgat_tpu/ops/ref.py``. Each op is written the straightforward
way, with gathers and ``index_add_`` / ``scatter_reduce`` over the
edges' destinations, on any device. The Hopper kernels (``ops/hopper``)
are held against these functions; their wrappers call them for tensors
that lie on the CPU. Besides the model's ops it holds DGL's
``update_all`` / ``apply_edges`` surface, as ``kgat_tpu.ops.ref`` does:
``segment_max``, ``segment_min``, ``segment_mean``, :func:`gspmm`,
:func:`gsddmm` and :func:`sddmm_dot`.

The port's graph has no pad edges, so nothing here needs an edge mask.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple, Union

import torch

from kgat_tpu_torch.graph import EdgeWeights, Graph, spmm_csr_of


def offsets_to_dst(row_offsets: torch.Tensor) -> torch.Tensor:
    """(E,) int64 destination of each edge of a CSR, from its offsets."""
    counts = (row_offsets[1:] - row_offsets[:-1]).long()
    rows = torch.arange(counts.numel(), device=row_offsets.device)
    return torch.repeat_interleave(rows, counts)


def segment_sum_coo(dst: torch.Tensor, vals: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Sum edge values into their dst rows. Returns (n_nodes, ...)."""
    out = vals.new_zeros((n_nodes,) + tuple(vals.shape[1:]))
    return out.index_add_(0, dst, vals)


def spmm_coo(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of w[e] * x[u], in float32 (in
    float64 when ``w`` or ``x`` is).

    A bfloat16 ``x`` is widened to float32 before the multiply, as the
    kernel does, so the two see the same products.
    """
    dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                             torch.float32)
    msgs = x.index_select(0, src).to(dt) * w.to(dt)[:, None]
    return segment_sum_coo(dst, msgs, n_nodes)


def segment_sum_csr(row_offsets: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """out[r] = sum over e in [row_offsets[r], row_offsets[r+1]) of
    vals[e]: the segment sum of a pre-gathered (E, d) value stream (K6's
    plain version), in float32, or float64 when ``vals`` is. A bfloat16
    stream is widened to float32 first, as the kernel does. Every row is
    written; a row with no edge is 0."""
    dt = torch.promote_types(vals.dtype, torch.float32)
    return segment_sum_coo(offsets_to_dst(row_offsets), vals.to(dt),
                           row_offsets.numel() - 1)


def _unit_edges(split, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unit, edge): the edges of the work units of ``split``
    (``ops.row_split.RowSplit``), unit after unit, and each one's unit."""
    lo, hi = split.units[:, 1:3].long().to(device).unbind(1)
    lens = hi - lo
    unit = torch.repeat_interleave(torch.arange(split.n_units,
                                                device=device), lens)
    start = torch.cumsum(lens, 0) - lens
    return unit, lo[unit] + torch.arange(unit.numel(),
                                         device=device) - start[unit]


def _slot_rows(split, device) -> torch.Tensor:
    """(n_slots,) the index into ``split.split_rows`` of each slot's row."""
    offsets = split.slot_offsets.long().to(device)
    return torch.repeat_interleave(torch.arange(split.n_split, device=device),
                                   offsets[1:] - offsets[:-1])


def split_segment_sum(split, vals: torch.Tensor) -> torch.Tensor:
    """A plain emulation of the row reduction K1, K6 and K8 run on the
    card, for the tests (no path of the package calls it): each work unit
    of ``split`` (``ops.row_split.RowSplit``) sums its edges' rows of the
    (E, d) value stream ``vals``; a one-unit row takes its unit's sum, a
    split row the sum of its units' partials in unit order. Float32, or
    float64 when ``vals`` is."""
    dt = torch.promote_types(vals.dtype, torch.float32)
    row, _, _, slot = split.units.long().to(vals.device).unbind(1)
    unit, edge = _unit_edges(split, vals.device)
    sums = segment_sum_coo(unit, vals.to(dt)[edge], split.n_units)
    out = sums.new_zeros((split.n_rows,) + tuple(vals.shape[1:]))
    whole = slot < 0
    out[row[whole]] = sums[whole]
    parts = sums.new_zeros((split.n_slots,) + tuple(vals.shape[1:]))
    parts[slot[~whole]] = sums[~whole]
    offsets = split.slot_offsets.tolist()
    for s, r in enumerate(split.split_rows.tolist()):
        acc = parts[offsets[s]]
        for k in range(offsets[s] + 1, offsets[s + 1]):
            acc = acc + parts[k]
        out[r] = acc
    return out


def ring_shift(parts: Sequence[torch.Tensor],
               step: int) -> List[torch.Tensor]:
    """Partition j receives a copy of partition (j - step) mod P's tensor,
    on partition j's device (K7's plain version). step = +1 moves data
    left to right, as ``lax.ppermute(x, axis, [(i, (i + 1) % P)])``; its
    transpose is step = -1."""
    n = len(parts)
    return [parts[(j - step) % n].to(parts[j].device, copy=True)
            for j in range(n)]


def reduce_send(row_offsets: Sequence[torch.Tensor],
                vals: Sequence[torch.Tensor],
                chunks: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One fused ring step (K8's plain version): per partition p, the
    segment sums of its bucket's value stream ``vals[p]`` over the CSR
    ``row_offsets[p]``, and the chunks sent one hop right
    (``ring_shift(chunks, 1)``)."""
    return ([segment_sum_csr(r, v) for r, v in zip(row_offsets, vals)],
            ring_shift(chunks, 1))


def segment_softmax_coo(dst: torch.Tensor, logits: torch.Tensor,
                        n_nodes: int) -> torch.Tensor:
    """Per-dst softmax of edge logits: subtract the row max, exp, divide by
    the row sum. The row max starts at the dtype's lowest value, the clamp
    ``kgat_tpu.ops.ref.segment_softmax`` applies for empty rows."""
    neg = torch.finfo(logits.dtype).min
    maxes = torch.full((n_nodes,), neg, dtype=logits.dtype,
                       device=logits.device)
    maxes.scatter_reduce_(0, dst.long(), logits, "amax", include_self=True)
    shifted = torch.exp(logits - maxes[dst.long()])
    denom = segment_sum_coo(dst, shifted, n_nodes)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return shifted / denom[dst.long()]


def segment_softmax_coo_bwd(dst: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Gradient of :func:`segment_softmax_coo` w.r.t. the logits, given its
    output ``w`` and the cotangent ``g``: w * (g - sum over the row of
    w * g) (``kgat_tpu.ops.pallas.softmax.segment_softmax_aligned_bwd``)."""
    row_sum = segment_sum_coo(dst, w * g, n_nodes)
    return w * (g - row_sum[dst.long()])


def split_segment_softmax(split, logits: torch.Tensor) -> torch.Tensor:
    """A plain emulation of K3 on the card, for the tests (no path of the
    package calls it): each work unit of ``split``
    (``ops.row_split.RowSplit``) takes the max of its logits (from the
    dtype's lowest value) and the sum of exp(l - max); a one-unit row's
    weights are exp(l - max) / sum, a split row's units combine their
    row's (max, sum) partials in slot order, max M then sum_j s_j
    exp(m_j - M). Empty rows write nothing (their entries are absent)."""
    dev = logits.device
    unit, edge = _unit_edges(split, dev)
    vals = logits[edge]
    lowest = torch.finfo(logits.dtype).min
    m = torch.full((split.n_units,), lowest, dtype=logits.dtype, device=dev)
    m.scatter_reduce_(0, unit, vals, "amax", include_self=True)
    s = segment_sum_coo(unit, torch.exp(vals - m[unit]), split.n_units)
    parts = split.units[:, 3].to(dev) >= 0
    if parts.any():
        # Slots are numbered in unit order, so m[parts] is slot 0, 1, ...
        owner = _slot_rows(split, dev)
        pm, ps = m[parts], s[parts]
        rm = torch.full((split.n_split,), lowest, dtype=logits.dtype,
                        device=dev)
        rm.scatter_reduce_(0, owner, pm, "amax", include_self=True)
        rs = segment_sum_coo(owner, ps * torch.exp(pm - rm[owner]),
                             split.n_split)
        m[parts], s[parts] = rm[owner], rs[owner]
    out = torch.empty_like(logits)
    out[edge] = torch.exp(vals - m[unit]) / s[unit]
    return out


def split_segment_softmax_bwd(split, w: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """A plain emulation of K5 on the card, for the tests (no path of the
    package calls it): each work unit of ``split`` sums w * g over its
    edges; a one-unit row's d_logit is w (g - s) with its unit's sum s, a
    split row's units take s from their row's slot partials, summed in
    slot order. Empty rows write nothing (their entries are absent)."""
    dev = w.device
    unit, edge = _unit_edges(split, dev)
    s = segment_sum_coo(unit, w[edge] * g[edge], split.n_units)
    parts = split.units[:, 3].to(dev) >= 0
    if parts.any():
        owner = _slot_rows(split, dev)   # s[parts] is slot 0, 1, ...
        s[parts] = segment_sum_coo(owner, s[parts], split.n_split)[owner]
    out = torch.empty_like(w)
    out[edge] = w[edge] * (g[edge] - s[unit])
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored mantissa bits) as
    ``cvt.rna.tf32.f32`` rounds it: to nearest on the 13 low mantissa bits,
    ties away from zero; the result is a float32 with those bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """``a @ b`` in float32 as K2 computes it on the tensor cores: each
    operand split into TF32 parts, hi = tf32(x) and lo = tf32(x - hi), and
    the products summed in float32 (a product of two TF32 values is exact
    in float32). ``passes=3`` is the kernel's a_lo b_hi + a_hi b_lo +
    a_hi b_hi; ``passes=1`` is a single TF32 product, a_hi b_hi. (The
    kernel hands the edge rows' low part to the tensor cores as a - a_hi,
    which they cut to TF32 rather than round: within 2^-21 |a| either
    way.)"""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes={passes}: 1 or 3")
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def transr_logits(rel_perm: torch.Tensor,
                  rel_ranges: Iterable[Tuple[int, int, int]],
                  src: torch.Tensor, dst: torch.Tensor, emb: torch.Tensor,
                  w_rel: torch.Tensor, rel_embed: torch.Tensor,
                  matmul=torch.matmul) -> torch.Tensor:
    """TransR attention logits in canonical edge order:
    pi(h, r, t) = (W_r e_t) . tanh(W_r e_h + e_r), head = dst, tail = src.

    Loops over relations as ``kgat_tpu.models.kgat.attention_logits``
    does: each ``(r, lo, hi)`` range of ``rel_perm`` holds relation r's
    edges, which share one W_r. (A per-edge ``w_rel[etype]`` gather would
    be an (E, d, k) tensor: 73 GB at yelp2018 scale.) ``matmul`` forms the
    two projections (:func:`tf32_matmul` emulates the kernel's).
    """
    out = torch.empty(rel_perm.shape[0],
                      dtype=torch.promote_types(emb.dtype, torch.float32),
                      device=emb.device)
    for r, lo, hi in rel_ranges:
        if hi <= lo:
            continue
        idx = rel_perm[lo:hi].long()
        w_r = w_rel[r]
        ph = matmul(emb[dst[idx].long()], w_r)
        pt = matmul(emb[src[idx].long()], w_r)
        out[idx] = (pt * torch.tanh(ph + rel_embed[r])).sum(-1)
    return out


def transr_logits_bwd(g: torch.Tensor, rel_perm: torch.Tensor,
                      rel_ranges: Iterable[Tuple[int, int, int]],
                      src: torch.Tensor, dst: torch.Tensor, emb: torch.Tensor,
                      w_rel: torch.Tensor, rel_embed: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`transr_logits` w.r.t. (emb, w_rel, rel_embed)
    given the logits' cotangent ``g``, one relation at a time
    (``kgat_tpu.ops.pallas.sddmm._bwd_kernel``'s algebra):

      s = tanh(W_r e_h + e_r);  d_pt = g s;  d_ph = g pt (1 - s^2)
      d_e_h = d_ph W_r^T;  d_e_t = d_pt W_r^T
      d_W_r = sum e_h^T d_ph + e_t^T d_pt;  d_e_r = sum d_ph
    """
    d_emb = torch.zeros_like(emb)
    d_w = torch.zeros_like(w_rel)
    d_er = torch.zeros_like(rel_embed)
    for r, lo, hi in rel_ranges:
        if hi <= lo:
            continue
        idx = rel_perm[lo:hi].long()
        h, t = dst[idx].long(), src[idx].long()
        eh, et, w_r = emb[h], emb[t], w_rel[r]
        ph, pt = eh @ w_r, et @ w_r
        s = torch.tanh(ph + rel_embed[r])
        ge = g[idx].to(emb.dtype)[:, None]
        d_pt = ge * s
        d_ph = ge * pt * (1 - s * s)
        d_emb.index_add_(0, h, d_ph @ w_r.T)
        d_emb.index_add_(0, t, d_pt @ w_r.T)
        d_w[r] = eh.T @ d_ph + et.T @ d_pt
        d_er[r] = d_ph.sum(0)
    return d_emb, d_w, d_er


def transr_bwd_tiles(g: torch.Tensor, rel_perm: torch.Tensor,
                     tiles: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     emb: torch.Tensor, w_rel: torch.Tensor,
                     rel_embed: torch.Tensor, matmul=torch.matmul
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """A plain emulation of K4's tile kernel and tile-order reduce, for the
    tests (no path of the package calls it): per relation tile of
    ``tiles`` (``Graph.tiles``), the six products of
    :func:`transr_logits_bwd` by ``matmul`` (:func:`tf32_matmul` emulates
    the kernel's three TF32 passes); d_W
    summed over 8-edge steps in edge order, each step's product formed
    apart and added in float32; d_e_r over 16-edge groups in order; a
    relation's tile partials added 32 at a time, the runs in order.
    Returns the per-edge rows d_eh and d_et (E, d) in canonical order,
    d_W and d_e_r; the fold (:func:`split_segment_sum` over the two CSRs'
    splits) makes d_emb of them."""
    mm = matmul
    n_rel, d, k = w_rel.shape
    deh = emb.new_zeros((rel_perm.shape[0], d))
    det = emb.new_zeros((rel_perm.shape[0], d))
    parts = {}
    for r, start, count in tiles.tolist():
        idx = rel_perm[start:start + count].long()
        eh, et = emb[dst[idx].long()], emb[src[idx].long()]
        w_r = w_rel[r]
        ph, pt = mm(eh, w_r), mm(et, w_r)
        s = torch.tanh(ph + rel_embed[r])
        ge = g[idx].to(emb.dtype)[:, None]
        d_pt, d_ph = ge * s, ge * pt * (1 - s * s)
        deh[idx], det[idx] = mm(d_ph, w_r.T), mm(d_pt, w_r.T)
        dw = emb.new_zeros((d, k))
        for i in range(0, count, 8):
            dw = dw + mm(eh[i:i + 8].T, d_ph[i:i + 8])
            dw = dw + mm(et[i:i + 8].T, d_pt[i:i + 8])
        der = emb.new_zeros(k)
        for i in range(0, count, 16):
            der = der + d_ph[i:i + 16].sum(0)
        parts.setdefault(r, []).append((dw, der))
    d_w, d_er = torch.zeros_like(w_rel), torch.zeros_like(rel_embed)
    for r, ps in parts.items():
        for i in range(0, len(ps), 32):
            d_w[r] += sum((p[0] for p in ps[i + 1:i + 32]), ps[i][0])
            d_er[r] += sum((p[1] for p in ps[i + 1:i + 32]), ps[i][1])
    return deh, det, d_w, d_er


# --- graph-level API (the ``ref`` backend) ---------------------------------

def segment_sum(graph: Graph, edge_vals: torch.Tensor) -> torch.Tensor:
    return segment_sum_coo(graph.dst, edge_vals, graph.n_nodes)


def spmm(graph: Graph, edge_w: Union[torch.Tensor, EdgeWeights],
         x: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over edges (u -> v) of edge_w[e] * x[u]; autograd
    differentiates the gather and ``index_add_``. ``edge_w`` may be staged
    :class:`EdgeWeights` (this path reads only their forward order, over
    the graph's coalesced groups when they are coalesced)."""
    if isinstance(edge_w, EdgeWeights):
        csr = spmm_csr_of(graph, edge_w)
        return spmm_coo(csr.src, csr.dst, edge_w.fwd, x,
                        csr.row_offsets.numel() - 1)
    return spmm_coo(graph.src, graph.dst, edge_w, x, graph.n_nodes)


def bucket_spmm(bucket, edge_w: EdgeWeights,
                x: torch.Tensor) -> torch.Tensor:
    """A ring bucket's partial (``parallel.partition.Bucket``): out[r] =
    sum over the bucket's edges (u -> r) of w * x[u], x the chunk it
    reads; autograd differentiates the gather and ``index_add_``."""
    return spmm_coo(bucket.src, bucket.dst, edge_w.fwd, x,
                    bucket.row_offsets.numel() - 1)


def segment_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    return segment_softmax_coo(graph.dst, logits, graph.n_nodes)


# --- DGL's update_all / apply_edges surface (kgat_tpu/ops/ref.py) ----------

MSG_OPS = ("copy_u", "copy_e", "u_mul_e", "u_add_e", "u_sub_e", "u_div_e")
REDUCE_OPS = ("sum", "max", "min", "mean")
SDDMM_TARGETS = ("u", "v", "e")

_BINOPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "dot": lambda a, b: (a * b).sum(-1),
}


def in_degree(graph: Graph) -> torch.Tensor:
    """(n_nodes,) int32 number of in-edges of each node."""
    return graph.row_offsets[1:] - graph.row_offsets[:-1]


def _per_row(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (n,) tensor shaped to broadcast against (n, ...) of ``ndim``."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def _segment_extreme(graph: Graph, vals: torch.Tensor, how: str,
                     empty: float) -> torch.Tensor:
    out = vals.new_full((graph.n_nodes,) + tuple(vals.shape[1:]), empty)
    idx = _per_row(graph.dst.long(), vals.dim()).expand_as(vals)
    # include_self=False: a row without edges keeps ``empty``.
    return out.scatter_reduce(0, idx, vals, how, include_self=False)


def segment_max(graph: Graph, edge_vals: torch.Tensor) -> torch.Tensor:
    """Max of edge values per dst row (-inf for a row without edges, as
    ``jax.ops.segment_max`` gives)."""
    return _segment_extreme(graph, edge_vals, "amax", -torch.inf)


def segment_min(graph: Graph, edge_vals: torch.Tensor) -> torch.Tensor:
    """Min of edge values per dst row (+inf for a row without edges)."""
    return _segment_extreme(graph, edge_vals, "amin", torch.inf)


def segment_mean(graph: Graph, edge_vals: torch.Tensor) -> torch.Tensor:
    """Mean of edge values per dst row (0 for a row without edges): the
    sum over the in-degree, clamped at 1."""
    deg = in_degree(graph).clamp(min=1).to(edge_vals.dtype)
    return segment_sum(graph, edge_vals) / _per_row(deg, edge_vals.dim())


def gspmm(graph: Graph, msg: str, reduce: str, x=None, edge_w=None
          ) -> torch.Tensor:
    """DGL's ``update_all(fn.<msg>, fn.<reduce>)``: per edge u -> v the
    message ``msg`` of x[u] and the edge's data, reduced into v.

    msg in :data:`MSG_OPS`, reduce in :data:`REDUCE_OPS`. x: (n_nodes, d)
    node features (unless msg is copy_e); edge_w: (E,) or (E, d) edge
    data (unless msg is copy_u). Returns (n_nodes, d), or (n_nodes,) for
    scalar messages; a row without edges is 0 for sum and mean, -inf for
    max and +inf for min.
    """
    if msg not in MSG_OPS:
        raise ValueError(f"msg {msg!r} not in {MSG_OPS}")
    if reduce not in REDUCE_OPS:
        raise ValueError(f"reduce {reduce!r} not in {REDUCE_OPS}")
    if msg == "copy_e":
        m = edge_w
    else:
        m = x.index_select(0, graph.src)
        if msg != "copy_u":
            w = edge_w if edge_w.dim() == m.dim() else _per_row(edge_w,
                                                                 m.dim())
            m = _BINOPS[msg[2:-2]](m, w)
    return {"sum": segment_sum, "mean": segment_mean, "max": segment_max,
            "min": segment_min}[reduce](graph, m)


def gsddmm(graph: Graph, op: str, lhs: torch.Tensor, rhs: torch.Tensor,
           lhs_target: str = "u", rhs_target: str = "v") -> torch.Tensor:
    """DGL's ``apply_edges(fn.<op>)``: per edge, ``op(lhs, rhs)`` where each
    operand lives on the edge's source (``u``), its destination (``v``)
    or the edge itself (``e``).

    op in add, sub, mul, div, dot, copy_lhs, copy_rhs; node operands are
    (n_nodes, ...), edge operands (E, ...). Returns (E, ...), or (E,) for
    dot.
    """
    def fetch(val, target):
        if target not in SDDMM_TARGETS:
            raise ValueError(f"target {target!r} not in {SDDMM_TARGETS}")
        if target == "e":
            return val
        return val.index_select(0, graph.src if target == "u" else graph.dst)
    if op == "copy_lhs":
        return fetch(lhs, lhs_target)
    if op == "copy_rhs":
        return fetch(rhs, rhs_target)
    if op not in _BINOPS:
        raise ValueError(f"op {op!r} not in {tuple(_BINOPS)} + copy_*")
    return _BINOPS[op](fetch(lhs, lhs_target), fetch(rhs, rhs_target))


def sddmm_dot(graph: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product: out[e] = <a[src_e], b[dst_e]>. (E,)."""
    return gsddmm(graph, "dot", a, b)


def attention_logits(graph: Graph, emb: torch.Tensor, w_rel: torch.Tensor,
                     rel_embed: torch.Tensor) -> torch.Tensor:
    off = graph.rel_offsets
    ranges = [(r, off[r], off[r + 1]) for r in range(graph.n_relations)]
    return transr_logits(graph.rel_perm, ranges, graph.src, graph.dst, emb,
                         w_rel, rel_embed)
