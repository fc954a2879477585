// The CSR row reduction shared by K1 (spmm_csr), K6 (segment_sum_csr) and
// K8 (reduce_send), so that the three reduce in one way and cannot diverge
// (the counterpart of kgat_tpu/ops/pallas/segment_sum.py::accum_step, which
// the TPU's K6 and K8 share for the same reason).
//
// One warp reduces one row: lanes across the feature dim (column
// c = lane + 32 * q, q < CPL), edges in CSR order, f32 accumulation in
// registers, no atomics, so the result is deterministic. The warp loads 32
// (index, weight) pairs at once and broadcasts them with shuffles; the edge
// loop is unrolled so several row reads are in flight. The row is always
// written, an empty row as 0.
//
//   GATHER:   the value of edge e is row src[e] of x (K1); otherwise row e
//             of a pre-gathered (E, d) value stream (K6, K8).
//   WEIGHTED: each value is scaled by w[e] (K1); otherwise by 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kgat {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int CPL, bool GATHER, bool WEIGHTED>
__device__ __forceinline__ void reduce_row(const int* __restrict__ row_offsets,
                                           const int* __restrict__ src,
                                           const float* __restrict__ w,
                                           const T* __restrict__ x,
                                           float* __restrict__ out, int row,
                                           int lane, int d) {
  const int lo = row_offsets[row];
  const int hi = row_offsets[row + 1];

  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;

  for (int base = lo; base < hi; base += 32) {
    int s = 0;
    float we = 1.f;
    if (base + lane < hi) {
      if (GATHER) s = src[base + lane];
      if (WEIGHTED) we = w[base + lane];
    }
    const int n = min(32, hi - base);  // warp-uniform
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int rj = GATHER ? __shfl_sync(kFullMask, s, j) : base + j;
      const float wj = WEIGHTED ? __shfl_sync(kFullMask, we, j) : 1.f;
      const T* xr = x + static_cast<size_t>(rj) * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < d) {
          acc[q] = WEIGHTED ? fmaf(wj, to_f32(xr[c]), acc[q])
                            : acc[q] + to_f32(xr[c]);
        }
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

// Columns per lane for a feature dim d <= 256 (0 when d is out of range).
inline int cols_per_lane(int d) {
  if (d <= 0) return 0;
  if (d <= 32) return 1;
  if (d <= 64) return 2;
  if (d <= 128) return 4;
  if (d <= 256) return 8;
  return 0;
}

}  // namespace kgat
