"""kgat_tpu_torch — KGAT serving and training in PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper GPU (sm_90a).

A port of ``kgat_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference this package is tested against. The package imports ``torch``
and ``numpy`` and never ``jax`` or ``kgat_tpu``.

Layer map (module names mirror ``kgat_tpu``):
  native    -> kgat_tpu_torch.native        (C++ parsers, counting sort)
  data      -> kgat_tpu_torch.data          (loaders, synthetic data; numpy)
  graph     -> kgat_tpu_torch.graph         (CSR both ways, relation tiles)
  kernels   -> kgat_tpu_torch.ops           (plain torch path + Hopper kernels)
  model     -> kgat_tpu_torch.models.kgat   (KGAT module, losses), models.bprmf
  samplers  -> kgat_tpu_torch.sampler       (device and host samplers)
  training  -> kgat_tpu_torch.train, optim  (captured steps, Adam, lazy Adam)
  multi-GPU -> kgat_tpu_torch.parallel      (edge partitions, one process or
                                             one per card)
  eval      -> kgat_tpu_torch.eval          (blocked full-ranking metrics)
  serving   -> kgat_tpu_torch.recommend     (checkpoint -> masked top-K)
  checkpoint-> kgat_tpu_torch.utils.checkpoint (kgat_tpu's format, both ways)
  explain   -> kgat_tpu_torch.explain       (attention paths, JSON)

What is not ported, and why, is in ROADMAP.md.
"""

__version__ = "0.1.0"
