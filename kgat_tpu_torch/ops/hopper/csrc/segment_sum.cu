// K1: weighted CSR SpMM, out[v] = sum over e in row v of w[e] * x[src[e]].
// K6: CSR segment sum of a pre-gathered value stream,
//     out[r] = sum over e in row r of vals[e].
//
// K1 replaces kgat_tpu/ops/pallas/segment_sum.py::_kernel_w (reached
// through segment_sum_packed); K6 replaces segment_sum.py::accum_step (the
// `_kernel` of segment_sum_aligned), which the partitioned ring exchange
// runs on every bucket (parallel/halo.py, forward and backward). The TPU
// kernels walk a padded block-aligned edge order and reduce with one-hot
// matmuls on the MXU; none of that is carried over. These kernels read
// plain CSR rows, through the row reduction of row_reduce.cuh, which K8
// (remote_ring.cu) shares.
//
// What bounds them on the H100: bytes. K1 reads one x row (d * 4 bytes in
// f32, d * 2 in bf16) per edge from a random source row, plus 8 bytes of
// index and weight; K6 reads its value stream in order (d * 4 or d * 2
// bytes per edge); each writes d * 4 bytes per row. The arithmetic is at
// most 2 * d flops per edge, about 0.25 flop per byte in f32: far below
// the compute line. Design for that: one warp per row, lanes across the
// feature dim, so every row read is one coalesced warp read.
//
// Known straggler: a row's edges run on one warp, so a hub row (in-degree
// 70,884 on the yelp2018-scale graph, ~2,000x the mean) serialises. That is
// correct, only slow; splitting long rows is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_reduce.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int CPL, bool GATHER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_reduce_kernel(const int* __restrict__ row_offsets,
                  const int* __restrict__ src, const float* __restrict__ w,
                  const T* __restrict__ x, float* __restrict__ out,
                  int n_rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps exit together
  kgat::reduce_row<T, CPL, GATHER, GATHER>(row_offsets, src, w, x, out, row,
                                           threadIdx.x % 32, d);
}

template <typename T, bool GATHER>
cudaError_t launch(const int* row_offsets, const int* src, const float* w,
                   const T* x, float* out, int n_rows, int d,
                   cudaStream_t stream) {
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  switch (kgat::cols_per_lane(d)) {
    case 1:
      csr_reduce_kernel<T, 1, GATHER><<<grid, block, 0, stream>>>(
          row_offsets, src, w, x, out, n_rows, d);
      break;
    case 2:
      csr_reduce_kernel<T, 2, GATHER><<<grid, block, 0, stream>>>(
          row_offsets, src, w, x, out, n_rows, d);
      break;
    case 4:
      csr_reduce_kernel<T, 4, GATHER><<<grid, block, 0, stream>>>(
          row_offsets, src, w, x, out, n_rows, d);
      break;
    case 8:
      csr_reduce_kernel<T, 8, GATHER><<<grid, block, 0, stream>>>(
          row_offsets, src, w, x, out, n_rows, d);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int kgat_spmm_csr(const void* row_offsets, const void* src,
                             const void* w, const void* x, void* out,
                             int n_rows, int d, int x_is_bf16, void* stream) {
  if (n_rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ro = static_cast<const int*>(row_offsets);
  const auto sr = static_cast<const int*>(src);
  const auto wf = static_cast<const float*>(w);
  const auto o = static_cast<float*>(out);
  if (x_is_bf16) {
    return launch<__nv_bfloat16, true>(
        ro, sr, wf, static_cast<const __nv_bfloat16*>(x), o, n_rows, d, s);
  }
  return launch<float, true>(ro, sr, wf, static_cast<const float*>(x), o,
                             n_rows, d, s);
}

extern "C" int kgat_segment_sum_csr(const void* row_offsets, const void* vals,
                                    void* out, int n_rows, int d,
                                    int vals_is_bf16, void* stream) {
  if (n_rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ro = static_cast<const int*>(row_offsets);
  const auto o = static_cast<float*>(out);
  if (vals_is_bf16) {
    return launch<__nv_bfloat16, false>(
        ro, nullptr, nullptr, static_cast<const __nv_bfloat16*>(vals), o,
        n_rows, d, s);
  }
  return launch<float, false>(ro, nullptr, nullptr,
                              static_cast<const float*>(vals), o, n_rows, d,
                              s);
}

extern "C" const char* kgat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
