"""Message-passing ops: plain PyTorch path and Hopper kernels.

Two interchangeable backends with one surface, ``spmm(graph, edge_w, x)``,
``segment_softmax(graph, logits)`` and ``attention_logits(graph, emb,
w_rel, rel_embed)``, and DGL's ``gspmm``, ``gsddmm``, ``sddmm_dot`` and
``segment_sum`` / ``segment_max`` / ``segment_min`` / ``segment_mean``:

  * ``ref``    — plain PyTorch (``kgat_tpu_torch.ops.ref``): the oracle,
    on any device.
  * ``hopper`` — hand-written CUDA kernels for sm_90a
    (``kgat_tpu_torch.ops.hopper_backend``). For CUDA tensors it launches
    the kernel or raises; only tensors on the CPU take the plain version.

The model's ops are on the surface too, so that every "which
implementation" decision is the backend's: ``training_logits``,
``layer``, ``representation_rows`` (the CF loss's rows), ``kg_projection``
and ``PALLAS_STAGING`` (read by ``KGATConfig.stream_dtype`` and
``.coalesces``). :func:`representation` is the plain layer loop over a
backend's ``spmm`` and ``layer``.
"""

from typing import Optional, Sequence

import torch

BACKENDS = ("ref", "hopper")


def get_backend(name: str = "ref"):
    # Imported here, not above: ``graph`` imports ``ops.row_split``, and
    # ``ref`` imports ``graph``.
    if name == "ref":
        from kgat_tpu_torch.ops import ref
        return ref
    if name == "hopper":
        from kgat_tpu_torch.ops import hopper_backend
        return hopper_backend
    raise ValueError(f"unknown ops backend: {name!r} (choose from {BACKENDS})")


def l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Each row of ``x`` over its L2 norm (clamped at sqrt(eps))."""
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def representation(model, graph, edge_w, cfg,
                   masks: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The plain layer loop -> the final representation e* = e^(0) ||
    norm(e^(1)) || ... || norm(e^(L)), (n_nodes, cfg.out_dim). Per layer
    the SpMM over ``edge_w`` (canonical (E,) weights or staged
    ``EdgeWeights``) of the value stream, in ``cfg.stream_dtype``, then
    the layer call with its keep mask ``masks[li]`` (None: no dropout),
    both of ``cfg.ops_backend``. ``model`` holds ``entity_embed`` and
    ``layers``."""
    ops = get_backend(cfg.ops_backend)
    low = cfg.stream_dtype
    x = model.entity_embed
    value = x if low is None else x.to(low)
    outs = [x]
    n_layers = len(model.layers)
    for li, params in enumerate(model.layers):
        side = ops.spmm(graph, edge_w, value)
        x, value = ops.layer(x, side, params, masks[li],
                             cfg.mess_dropout[li], cfg,
                             low if li + 1 < n_layers else None)
        outs.append(l2norm(x))
    return torch.cat(outs, dim=-1)
