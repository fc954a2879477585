"""kgat_tpu_torch — the KGAT serving path in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper GPU (sm_90a).

A port of ``kgat_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference this package is tested against. The package imports ``torch``
and ``numpy`` and never ``jax`` or ``kgat_tpu``.

Layer map (module names mirror ``kgat_tpu``):
  data      -> kgat_tpu_torch.data          (loaders, synthetic data; numpy)
  graph     -> kgat_tpu_torch.graph         (dst-sorted COO + CSR, relation tiles)
  kernels   -> kgat_tpu_torch.ops           (plain torch path + Hopper kernels)
  model     -> kgat_tpu_torch.models.kgat   (KGAT nn.Module, serving forward)
  serving   -> kgat_tpu_torch.recommend     (checkpoint -> masked top-K)
  checkpoint-> kgat_tpu_torch.utils.checkpoint (reads kgat_tpu checkpoints)

Training (samplers, losses, optimizers, the backward kernels), eval,
explain and multi-GPU are not ported yet; see ROADMAP.md.
"""

__version__ = "0.1.0"
