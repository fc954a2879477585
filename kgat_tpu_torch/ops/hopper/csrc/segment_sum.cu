// K1: weighted CSR SpMM, out[v] = sum over e in row v of w[e] * x[src[e]].
//
// Replaces kgat_tpu/ops/pallas/segment_sum.py::_kernel_w (reached through
// segment_sum_packed). The TPU kernel walks a padded block-aligned edge
// order and reduces with one-hot matmuls on the MXU; none of that is
// carried over. This kernel reads the graph's own dst-sorted CSR.
//
// What bounds it on the H100: bytes. Each edge reads one x row (d * 4 bytes
// in f32, d * 2 in bf16) from a random source row, plus 8 bytes of index
// and weight; each row writes d * 4 bytes. The arithmetic is 2 * d flops
// per edge, about 0.25 flop per byte in f32: far below the compute line.
// Design for that: one warp per destination row, lanes across the feature
// dim, so every x-row gather is one coalesced warp read. The warp loads 32
// (src, w) pairs at once and broadcasts them with shuffles, and the edge
// loop is unrolled so several row gathers are in flight. Accumulation is in
// f32 registers, in edge order, with no atomics: the result is
// deterministic. Every row is written, an empty row as 0.
//
// Known straggler: a row's edges run on one warp, so a hub row (in-degree
// 70,884 on the yelp2018-scale graph, ~2,000x the mean) serialises. That is
// correct, only slow; splitting long rows is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// CPL: feature columns per lane (column c = lane + 32 * q, q < CPL).
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int* __restrict__ row_offsets,
                const int* __restrict__ src, const float* __restrict__ w,
                const T* __restrict__ x, float* __restrict__ out, int n_rows,
                int d) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // whole warps exit together
  const int lo = row_offsets[row];
  const int hi = row_offsets[row + 1];

  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;

  for (int base = lo; base < hi; base += 32) {
    int s = 0;
    float we = 0.f;
    if (base + lane < hi) {
      s = src[base + lane];
      we = w[base + lane];
    }
    const int n = min(32, hi - base);  // warp-uniform
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int sj = __shfl_sync(kFullMask, s, j);
      const float wj = __shfl_sync(kFullMask, we, j);
      const T* xr = x + static_cast<size_t>(sj) * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < d) acc[q] = fmaf(wj, to_f32(xr[c]), acc[q]);
      }
    }
  }

  float* orow = out + static_cast<size_t>(row) * d;
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c = lane + 32 * q;
    if (c < d) orow[c] = acc[q];
  }
}

template <typename T>
cudaError_t launch(const int* row_offsets, const int* src, const float* w,
                   const T* x, float* out, int n_rows, int d,
                   cudaStream_t stream) {
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (d <= 32) {
    spmm_csr_kernel<T, 1><<<grid, block, 0, stream>>>(row_offsets, src, w, x,
                                                      out, n_rows, d);
  } else if (d <= 64) {
    spmm_csr_kernel<T, 2><<<grid, block, 0, stream>>>(row_offsets, src, w, x,
                                                      out, n_rows, d);
  } else if (d <= 128) {
    spmm_csr_kernel<T, 4><<<grid, block, 0, stream>>>(row_offsets, src, w, x,
                                                      out, n_rows, d);
  } else if (d <= 256) {
    spmm_csr_kernel<T, 8><<<grid, block, 0, stream>>>(row_offsets, src, w, x,
                                                      out, n_rows, d);
  } else {
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
    return launch(ro, sr, wf, static_cast<const __nv_bfloat16*>(x), o, n_rows,
                  d, s);
  }
  return launch(ro, sr, wf, static_cast<const float*>(x), o, n_rows, d, s);
}

extern "C" const char* kgat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
