"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  K1 segment_sum.spmm_csr           <- kgat_tpu/ops/pallas/segment_sum.py::_kernel_w
     segment_sum.spmm_csr_rev       (K1 on the reverse CSR: the SpMM's d_x)
  K2 sddmm.sddmm_transr             <- kgat_tpu/ops/pallas/sddmm.py::_kernel
  K3 softmax.segment_softmax_csr    <- kgat_tpu/ops/pallas/softmax.py::_max/_expsum/_norm_kernel
  K4 sddmm.sddmm_transr_bwd         <- kgat_tpu/ops/pallas/sddmm.py::_bwd_kernel
  K5 softmax.segment_softmax_csr_bwd <- kgat_tpu/ops/pallas/softmax.py::_wsum/_dlogit_kernel
  K6 segment_sum.segment_sum_csr    <- kgat_tpu/ops/pallas/segment_sum.py::accum_step
  K7 remote_ring.ring_shift         <- kgat_tpu/ops/pallas/remote_ring.py::_shift_kernel
  K8 remote_ring.reduce_send        <- kgat_tpu/ops/pallas/remote_ring.py::_reduce_send_kernel
     transr.transr_project          (no TPU kernel: the KG loss's TransR
                                    projection and its relation gradients)
     adam.adam_step                 (no TPU kernel: the trainer's Adam step,
                                    one launch over every parameter)
     bi_layer.bi_layer_forward      (no TPU kernel: the bi-interaction
     bi_layer.bi_layer_backward      layer, aggregator and dropout, one pass
                                    each way; bi_layer.propagate_rows, the
                                    CF step's training propagation)
     sampler.kg_draw                (no TPU kernel: the device samplers'
     sampler.cf_draw                 negative draw, gathers and rank_skip
                                    search, one launch a batch)

K1, K6, K8 and K4's fold share one row reduction (``csrc/row_reduce.cuh``),
which walks the work units of a CSR's row split (``ops/row_split.py``);
K3 walks the same units. The caller passes the split that was built with
the CSR. K2 and K4 share their TF32 products on the tensor cores
(``csrc/tf32_mma.cuh``).

Each wrapper but ``adam_step`` and the draws has a plain PyTorch version
beside it (``*_plain``), which it uses only for tensors on the CPU; Adam's
plain version is ``optim._adam``, and the CPU keeps ``torch.optim.Adam``;
the draws' are ``kgat_tpu_torch.sampler.kg_draw_plain`` and
``cf_draw_plain``, which the samplers call for CPU tables. ``build.launch_counts`` counts kernel
launches per wrapper. ``segment_sum.spmm``, ``sddmm.attention_logits`` and
``softmax.segment_softmax`` are the differentiable ops built on them.
"""
