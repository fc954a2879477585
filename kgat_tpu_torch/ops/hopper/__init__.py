"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  K1 segment_sum.spmm_csr           <- kgat_tpu/ops/pallas/segment_sum.py::_kernel_w
     segment_sum.spmm_csr_rev       (K1 on the reverse CSR: the SpMM's d_x)
  K2 sddmm.sddmm_transr             <- kgat_tpu/ops/pallas/sddmm.py::_kernel
  K3 softmax.segment_softmax_csr    <- kgat_tpu/ops/pallas/softmax.py::_max/_expsum/_norm_kernel
  K4 sddmm.sddmm_transr_bwd         <- kgat_tpu/ops/pallas/sddmm.py::_bwd_kernel
  K5 softmax.segment_softmax_csr_bwd <- kgat_tpu/ops/pallas/softmax.py::_wsum/_dlogit_kernel

Each wrapper has a plain PyTorch version beside it (``*_plain``), which it
uses only for tensors on the CPU. ``build.launch_counts`` counts kernel
launches per wrapper. ``segment_sum.spmm``, ``sddmm.attention_logits`` and
``softmax.segment_softmax`` are the differentiable ops built on them.
"""
