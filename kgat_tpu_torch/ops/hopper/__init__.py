"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

  K1 segment_sum.spmm_csr           <- kgat_tpu/ops/pallas/segment_sum.py::_kernel_w
  K2 sddmm.sddmm_transr             <- kgat_tpu/ops/pallas/sddmm.py::_kernel
  K3 softmax.segment_softmax_csr    <- kgat_tpu/ops/pallas/softmax.py::_max/_expsum/_norm_kernel

Each wrapper has a plain PyTorch version beside it (``*_plain``), which it
uses only for tensors on the CPU. ``build.launch_counts`` counts kernel
launches per wrapper.
"""
