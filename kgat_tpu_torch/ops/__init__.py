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
"""

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
