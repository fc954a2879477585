"""The bi-interaction propagation layer as one op (``csrc/bi_layer.cu``):
the aggregator, message dropout and the value stream's copy in one pass
forward, and their gradients in one pass backward.

A layer maps its input ``x`` (n, d_in) and neighbourhood sum ``side``
(K1's output) to ``y = drop(leaky((x + side) W1 + b1) + leaky((x * side)
W2 + b2))``, drop(y) = where(mask, y / (1 - rate), 0) for the layer's keep
mask (none in evaluation). It replaces no TPU kernel (``kgat_tpu``'s
``aggregate`` leaves the arithmetic to XLA). The hopper backend takes it
for CUDA tensors under the bi-interaction aggregator: :func:`bi_layer`,
the differentiable op on one layer, is its ``layer`` (the serving
forward, evaluation and the partitioned trainer's partitions);
:func:`propagate_rows`, its ``representation_rows``, the
single-card CF step's whole training propagation, K1 included, whose
backward runs from the top layer down the layer kernel and then K1's
reverse call, so that autograd adds nothing at (n, d), and whose output
is only the rows the BPR loss reads, normalised there.

CPU tensors take the plain versions (``*_plain``: the forward as
``ops.ref``'s ``aggregate`` and ``apply_dropout`` compute it, the
backward written out; the kernels' references in the tests), CUDA
tensors the kernels, which take float32 tables and bool masks alone and
raise for any other dtype. The kernels sum in a fixed order and without
atomics, so two calls give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from kgat_tpu_torch.graph import EdgeWeights, spmm_csr_of
from kgat_tpu_torch.ops import l2norm
from kgat_tpu_torch.ops.hopper import build
from kgat_tpu_torch.ops.hopper.segment_sum import spmm_csr, spmm_csr_rev
from kgat_tpu_torch.ops.ref import leaky

MAX_WIDTH = 256
# CUDA launches per wrapper call.
CUDA_LAUNCHES = {"bi_layer_forward": 1, "bi_layer_backward": 2,
                 "bi_sum": 1}
# Blocks an SM the forward and the backward kernel are sized for (their
# grid's bound): the backward keeps its weights' partials in registers
# across its tiles (over 128 a thread), so one.
BLOCKS_PER_SM = {"forward": 2, "backward": 1}

def check_widths(d_in: int, d_out: int) -> None:
    """Raise unless the kernels take a layer of these widths."""
    if not (1 <= d_in <= MAX_WIDTH and 1 <= d_out <= MAX_WIDTH):
        raise ValueError(f"the bi-interaction layer kernels take widths 1 "
                         f"to {MAX_WIDTH}, not d_in = {d_in}, d_out = "
                         f"{d_out}")


def bi_layer_forward_plain(x, side, mask, w1, b1, w2, b2, rate: float,
                           slope: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`bi_layer_forward`'s output (in
    float64 when the inputs are): the aggregator and the dropout in
    ``ops.ref``'s operations and order."""
    y = (leaky((x + side) @ w1 + b1, slope)
         + leaky((x * side) @ w2 + b2, slope))
    return y if mask is None else torch.where(mask, y / (1.0 - rate), 0.0)


def bi_layer_backward_plain(x, side, mask, w1, b1, w2, b2, rate: float,
                            slope: float, g):
    """Plain PyTorch version of :func:`bi_layer_backward` (in float64 when
    the inputs are), from the output's gradient ``g`` (n, d_out): the
    pre-activations recomputed, then (d x, d side, d w1, d b1, d w2,
    d b2)."""
    a, p = x + side, x * side
    z1, z2 = a @ w1 + b1, p @ w2 + b2
    if mask is not None:
        g = torch.where(mask, g / (1.0 - rate), 0.0)
    gz1 = torch.where(z1 >= 0, g, slope * g)
    gz2 = torch.where(z2 >= 0, g, slope * g)
    ga, gp = gz1 @ w1.T, gz2 @ w2.T
    return (ga + gp * side, ga + gp * x, a.T @ gz1, gz1.sum(0), p.T @ gz2,
            gz2.sum(0))


def grad_sum_plain(g_a, g_b, slot, rows, col0: int, n: int, d: int,
                   b_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version of :func:`grad_sum`'s float32 sum."""
    dev = (g_a if g_a is not None else g_b if g_b is not None else rows).device
    dt = (g_a if g_a is not None else g_b if g_b is not None else rows).dtype
    out = torch.zeros((n, d), dtype=dt, device=dev)
    if g_a is not None:
        out = out + g_a
    if g_b is not None:
        out = out + g_b.to(b_dtype or dt).to(dt)
    if slot is not None:
        r = slot.long()
        hit = r >= 0
        out = out + torch.where(hit[:, None],
                                rows[r.clamp(min=0), col0:col0 + d], 0.0)
    return out


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(build.stream_ptr(t.device))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` on a 16-byte boundary, as the kernels copy its rows."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _max_grid(dev: torch.device, kernel: str) -> int:
    return (BLOCKS_PER_SM[kernel]
            * torch.cuda.get_device_properties(dev).multi_processor_count)


def _check_layer(name, x, side, mask, w1, b1, w2, b2) -> Tuple[int, int]:
    """Raise unless the layer's tensors are what the kernels take;
    returns (d_in, d_out)."""
    for what, t, nd in (("x", x, 2), ("side", side, 2), ("w1", w1, 2),
                        ("b1", b1, 1), ("w2", w2, 2), ("b2", b2, 1)):
        build.check_tensor(f"{name}: {what}", t, (torch.float32,), nd)
    d_in, d_out = w1.shape
    check_widths(d_in, d_out)
    if (x.shape[1] != d_in or side.shape != x.shape or w2.shape != w1.shape
            or b1.shape != (d_out,) or b2.shape != (d_out,)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, side "
                         f"{tuple(side.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 "
                         f"{tuple(b2.shape)} disagree")
    if mask is not None:
        build.check_tensor(f"{name}: mask", mask, (torch.bool,), 2)
        if mask.shape != (x.shape[0], d_out):
            raise ValueError(f"{name}: mask {tuple(mask.shape)}, want "
                             f"{(x.shape[0], d_out)}")
    return d_in, d_out


def bi_layer_forward(x, side, mask, w1, b1, w2, b2, rate: float,
                     slope: float, copy_dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, y's copy in ``copy_dtype``, None without one): one launch over
    the layer's rows. x, side (n, d_in) float32, mask (n, d_out) bool or
    None, w1, w2 (d_in, d_out), b1, b2 (d_out,); ``copy_dtype`` None or
    bfloat16 (the next layer's K1 value stream). CPU tensors take
    :func:`bi_layer_forward_plain`."""
    ins = [t for t in (x, side, mask, w1, b1, w2, b2) if t is not None]
    if not build.use_kernel("bi_layer_forward", *ins):
        y = bi_layer_forward_plain(x, side, mask, w1, b1, w2, b2, rate,
                                   slope)
        return y, None if copy_dtype is None else y.to(copy_dtype)
    if copy_dtype not in (None, torch.bfloat16):
        raise ValueError(f"bi_layer_forward: a {copy_dtype} copy; the "
                         f"kernel writes bfloat16 copies alone")
    d_in, d_out = _check_layer("bi_layer_forward", x, side, mask, w1, b1,
                               w2, b2)
    n, dev = x.shape[0], x.device
    y = torch.empty((n, d_out), dtype=torch.float32, device=dev)
    yv = (None if copy_dtype is None
          else torch.empty((n, d_out), dtype=copy_dtype, device=dev))
    if n == 0:
        return y, yv
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_bi_layer_fwd(
            x.data_ptr(), side.data_ptr(), _ptr(mask), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), n, d_in, d_out,
            1.0 - rate, slope, y.data_ptr(), _ptr(yv),
            _max_grid(dev, "forward"), _stream(x))
    build.check_launch(lib, code, "bi_layer_forward")
    build.launch_counts["bi_layer_forward"] += 1
    return y, yv


def bi_layer_backward(x, side, mask, w1, b1, w2, b2, rate: float,
                      slope: float, g_a=None, g_b=None, slot=None, rows=None,
                      col0: int = 0, side_dtype: Optional[torch.dtype] = None,
                      b_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """(d x, d side, d w1, d b1, d w2, d b2) of :func:`bi_layer_forward`'s
    y, from y's gradient given as the sum of pieces: ``g_a`` and ``g_b``
    ((n, d_out) float32 or None) and, where ``slot[r] >= 0`` ((n,) int32
    or None), row slot[r] of ``rows``, columns col0 .. col0 + d_out;
    ``g_b`` (K1's reverse output) is first rounded to ``b_dtype`` (the
    value stream's bfloat16, as autograd's cast of the stream rounded it;
    None: as it is). The pre-activations are recomputed; d side comes in
    ``side_dtype`` (the value stream's: bfloat16, or None for x's dtype),
    d x in x's. Two launches:
    the rows and the blocks' partial weight gradients, then their fold.
    CPU tensors take :func:`bi_layer_backward_plain`."""
    ins = [t for t in (x, side, mask, w1, b1, w2, b2, g_a, g_b, slot, rows)
           if t is not None]
    if not build.use_kernel("bi_layer_backward", *ins):
        g = grad_sum_plain(g_a, g_b, slot, rows, col0, x.shape[0],
                           w1.shape[1], b_dtype)
        d_x, d_s, *grads = bi_layer_backward_plain(x, side, mask, w1, b1, w2,
                                                   b2, rate, slope, g)
        return (d_x, d_s.to(side_dtype or d_s.dtype), *grads)
    d_in, d_out = _check_layer("bi_layer_backward", x, side, mask, w1, b1,
                               w2, b2)
    n, dev = x.shape[0], x.device
    _check_pieces("bi_layer_backward", n, d_out, g_a, g_b, slot, rows, col0)
    g_a, g_b = _aligned(g_a), _aligned(g_b)
    side_dtype = side_dtype or torch.float32
    if side_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bi_layer_backward: d side in {side_dtype}")
    d_x = torch.empty((n, d_in), dtype=torch.float32, device=dev)
    d_s = torch.empty((n, d_in), dtype=side_dtype, device=dev)
    # The fold writes every gradient; with no rows they are 0.
    grads = (torch.empty if n > 0 else torch.zeros)(
        2 * d_in * d_out + 2 * d_out, dtype=torch.float32, device=dev)
    if n > 0:
        lib = build.library()
        max_grid = _max_grid(dev, "backward")
        blocks = lib.kgat_bi_layer_blocks(n, d_in, d_out, max_grid)
        partials = torch.empty((blocks, grads.numel()), dtype=torch.float32,
                               device=dev)
        with torch.cuda.device(dev):
            code = lib.kgat_bi_layer_bwd(
                x.data_ptr(), side.data_ptr(), _ptr(mask), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(g_a),
                _ptr(g_b), _ptr(slot), _ptr(rows),
                0 if rows is None else rows.shape[1], col0,
                _b_bf16(b_dtype), n, d_in, d_out,
                1.0 - rate, slope, d_x.data_ptr(), d_s.data_ptr(),
                int(side_dtype == torch.bfloat16), partials.data_ptr(),
                grads.data_ptr(), max_grid, _stream(x))
        build.check_launch(lib, code, "bi_layer_backward")
        build.launch_counts["bi_layer_backward"] += 1
    n_w = d_in * d_out
    return (d_x, d_s, grads[:n_w].view(d_in, d_out),
            grads[2 * n_w:2 * n_w + d_out], grads[n_w:2 * n_w].view(d_in,
                                                                   d_out),
            grads[2 * n_w + d_out:])


def _b_bf16(b_dtype: Optional[torch.dtype]) -> int:
    if b_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"K1's reverse output rounded to {b_dtype}")
    return int(b_dtype == torch.bfloat16)


def _check_pieces(name, n, d, g_a, g_b, slot, rows, col0) -> None:
    for what, t in (("g_a", g_a), ("g_b", g_b)):
        if t is not None:
            build.check_tensor(f"{name}: {what}", t, (torch.float32,), 2)
            if t.shape != (n, d):
                raise ValueError(f"{name}: {what} {tuple(t.shape)}, want "
                                 f"{(n, d)}")
    if (slot is None) != (rows is None):
        raise ValueError(f"{name}: slot and rows go together")
    if slot is not None:
        build.check_tensor(f"{name}: slot", slot, (torch.int32,), 1)
        build.check_tensor(f"{name}: rows", rows, (torch.float32,), 2)
        if slot.shape != (n,) or not 0 <= col0 <= rows.shape[1] - d:
            raise ValueError(f"{name}: slot {tuple(slot.shape)}, rows "
                             f"{tuple(rows.shape)}, columns {col0} .. "
                             f"{col0 + d}")


def grad_sum(g_a, g_b, slot, rows, col0: int, n: int, d: int,
             dtype: Optional[torch.dtype] = None,
             b_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(n, d) = g_a + g_b + the rows ``slot`` points at (pieces as
    :func:`bi_layer_backward` takes them, ``g_b`` rounded to ``b_dtype``),
    in ``dtype`` (bfloat16, or None for the pieces' own): the embedding's
    gradient from its pieces, or with one piece its value-stream copy. One
    launch; CPU tensors add in torch."""
    ins = [t for t in (g_a, g_b, slot, rows) if t is not None]
    if not build.use_kernel("bi_sum", *ins):
        out = grad_sum_plain(g_a, g_b, slot, rows, col0, n, d, b_dtype)
        return out.to(dtype or out.dtype)
    _check_pieces("bi_sum", n, d, g_a, g_b, slot, rows, col0)
    dtype = dtype or torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bi_sum: {dtype} output")
    dev = ins[0].device
    out = torch.empty((n, d), dtype=dtype, device=dev)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.kgat_bi_sum(
            _ptr(g_a), _ptr(g_b), _ptr(slot), _ptr(rows),
            0 if rows is None else rows.shape[1], col0, _b_bf16(b_dtype),
            n, d, out.data_ptr(), int(dtype == torch.bfloat16),
            8 * _max_grid(dev, "forward"), _stream(ins[0]))
    build.check_launch(lib, code, "bi_sum")
    build.launch_counts["bi_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# The differentiable ops.
# ---------------------------------------------------------------------------

class _BiLayer(torch.autograd.Function):
    """One layer: the forward kernel; the backward kernel over y's gradient
    and its copy's."""

    @staticmethod
    def forward(ctx, x, side, mask, w1, b1, w2, b2, rate, slope, copy_dtype):
        ctx.rate, ctx.slope = rate, slope
        ctx.save_for_backward(x, side, mask, w1, b1, w2, b2)
        y, yv = bi_layer_forward(x, side, mask, w1, b1, w2, b2, rate, slope,
                                 copy_dtype)
        return y if yv is None else (y, yv)

    @staticmethod
    def backward(ctx, g_y, g_yv=None):
        x, side, mask, w1, b1, w2, b2 = ctx.saved_tensors
        g_b = None if g_yv is None else g_yv.float().contiguous()
        d_x, d_s, *grads = bi_layer_backward(
            x, side, mask, w1, b1, w2, b2, ctx.rate, ctx.slope,
            None if g_y is None else g_y.contiguous(), g_b)
        return (d_x, d_s, None, *grads, None, None, None)


def bi_layer(x: torch.Tensor, side: torch.Tensor,
             mask: Optional[torch.Tensor], layer, rate: float, slope: float,
             copy_dtype: Optional[torch.dtype] = None):
    """One bi-interaction layer with message dropout (keep ``mask``, None
    for none), differentiable in x, side and the layer's ``w1, b1, w2,
    b2``: y, or (y, y's copy in ``copy_dtype``) for the next layer's K1.
    CPU tensors take the plain versions."""
    return _BiLayer.apply(x, side, mask, layer["w1"], layer["b1"],
                          layer["w2"], layer["b2"], rate, slope, copy_dtype)


class _BiPropagate(torch.autograd.Function):
    """The single-card training propagation, K1 included, and the gather
    of the rows the loss reads; backward from the top layer down."""

    @staticmethod
    def forward(ctx, plan, emb, *params):
        csr, w_fwd, w_rev, masks, rates, slope, low, idx = plan
        layers = [params[i:i + 4] for i in range(0, len(params), 4)]
        n = emb.shape[0]
        v = (emb if low is None
             else grad_sum(emb, None, None, None, 0, n, emb.shape[1], low))
        xs, sides = [emb], []
        for li, (w1, b1, w2, b2) in enumerate(layers):
            side = spmm_csr(csr.row_offsets, csr.src, w_fwd, v, csr.split)
            copy = low if li + 1 < len(layers) else None
            y, yv = bi_layer_forward(xs[-1], side, masks[li], w1, b1, w2, b2,
                                     rates[li], slope, copy)
            sides.append(side)
            xs.append(y)
            v = y if yv is None else yv
        slot = torch.full((n,), -1, dtype=torch.int32, device=emb.device)
        slot[idx] = torch.arange(idx.numel(), dtype=torch.int32,
                                 device=emb.device)
        ctx.plan = plan
        ctx.widths = [x.shape[1] for x in xs]
        ctx.save_for_backward(*xs[:-1], *sides, *params, slot,
                              slot[idx].long())
        return torch.cat([x.index_select(0, idx) for x in xs], 1)

    @staticmethod
    def backward(ctx, g_rows):
        csr, _, w_rev, masks, rates, slope, low, idx = ctx.plan
        saved = ctx.saved_tensors
        n_layers = len(masks)
        xs, sides = saved[:n_layers], saved[n_layers:2 * n_layers]
        params = saved[2 * n_layers:-2]
        slot, target = saved[-2:]
        # Repeated rows summed in a fixed order (a sorted, accumulating
        # index_put, not index_add_'s atomics): two steps give the same
        # bits.
        rows = torch.zeros(g_rows.shape, dtype=g_rows.dtype,
                           device=g_rows.device).index_put_(
                               (target,), g_rows, accumulate=True)
        col0 = [sum(ctx.widths[:i]) for i in range(len(ctx.widths))]
        grads = [None] * len(params)
        g_ego = g_k1 = None
        for li in reversed(range(n_layers)):
            w1, b1, w2, b2 = params[4 * li:4 * li + 4]
            d_x, d_s, *grads[4 * li:4 * li + 4] = bi_layer_backward(
                xs[li], sides[li], masks[li], w1, b1, w2, b2, rates[li],
                slope, g_ego, g_k1, slot, rows, col0[li + 1], low, low)
            g_k1 = spmm_csr_rev(csr.rev_row_offsets, csr.rev_dst, w_rev, d_s,
                                csr.rev_split)
            g_ego = d_x
        d_emb = grad_sum(g_ego, g_k1, slot, rows, 0, *xs[0].shape,
                         b_dtype=low)
        return (None, d_emb, *grads)


def propagate_rows(model, graph, edge_w, cfg,
                   masks: Sequence[Optional[torch.Tensor]],
                   ids: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The training propagation's final representations at the rows of
    each index tensor of ``ids`` only, ((len, cfg.out_dim) each),
    differentiable in every parameter of ``model``: the layer outputs at
    those rows, each layer's L2-normalised there (``l2norm`` is
    row-wise: the rows of the (n_nodes, out_dim) concat's). ``masks``
    are the layers' keep masks (``kgat.dropout_masks``; None where a rate
    is 0), ``edge_w`` the staged attention (no gradient). Per layer K1
    and the layer op; the backward from the top layer down, each layer's
    kernel then K1 on the reverse CSR, and the embedding's gradient
    summed in one pass. CPU tensors take the plain versions of every
    piece."""
    if isinstance(edge_w, EdgeWeights):
        w_fwd, w_rev = edge_w.fwd, edge_w.rev
    else:
        w_fwd, w_rev = edge_w, edge_w[graph.rev_perm.long()].contiguous()
    if w_fwd.requires_grad and torch.is_grad_enabled():
        raise ValueError("propagate_rows: the staged attention must not "
                         "need a gradient")
    params: List[torch.Tensor] = []
    for layer in model.layers:
        params += [layer["w1"], layer["b1"], layer["w2"], layer["b2"]]
    plan = (spmm_csr_of(graph, edge_w), w_fwd.detach(), w_rev.detach(),
            list(masks), list(cfg.mess_dropout), cfg.leaky_relu_slope,
            cfg.stream_dtype, torch.cat(list(ids)).long())
    rows = _BiPropagate.apply(plan, model.entity_embed, *params)
    parts = rows.split([cfg.embed_dim, *cfg.conv_dims], dim=-1)
    rows = torch.cat([parts[0], *(l2norm(p) for p in parts[1:])], dim=-1)
    return rows.split([i.numel() for i in ids])
