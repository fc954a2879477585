// K3: per-destination segment softmax of edge logits over the dst-sorted
// CSR: w[e] = exp(l[e] - max_row) / sum_row exp(l - max_row).
//
// Replaces kgat_tpu/ops/pallas/softmax.py::_max_kernel, _expsum_kernel and
// _norm_kernel (segment_softmax_aligned). The TPU form is three passes over
// a padded block-aligned layout with per-row [lo, hi) bounds tables and a
// stored exp intermediate; here nothing but the weights is written.
//
// What bounds it on the H100: bytes, and little of them. Per edge it reads
// the logit and writes the weight: 8 bytes an edge, 36 MB at yelp2018
// scale (0.011 ms at 3.35 TB/s). The first design ran one warp per CSR
// row, so the hub row (in-degree 70,884 at yelp2018 scale) held one warp
// for 2,215 steps, twice over, and set the time of the launch (0.65 ms).
// Now the kernel walks the CSR's work units (ops/row_split.py, the
// schedule of K1, K6 and K8: at most CHUNK = 256 edges of one row a unit),
// one warp a unit:
//  * a unit that is a whole row takes the row's max (a shuffle tree of
//    fmaxf over the lanes' maxima), then the sum of exp(l - max) (a
//    shuffle tree of adds), and writes exp(l - max) / sum; an empty row
//    writes nothing;
//  * a unit of a split row writes its (max, sum) into its slot. A second
//    launch, one warp per slot, combines its row's slots in slot order
//    (the max, then the sum of sum_j exp(max_j - max)), the same order in
//    every warp of the row, and writes the unit's weights.
// The max starts at -FLT_MAX, not -inf, so no inf - inf can appear: no
// NaN for a row of one edge or for the hub row; the sum is at least 1
// (the max term is exp(0)). Every order is fixed and nothing is summed
// with atomics: two calls give the same bits. One launch, two where a
// row is split. The semantics are kgat_tpu/ops/ref.py::segment_softmax's.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The weights of edges [lo, hi) of a row whose max is m and whose sum of
// exp(l - m) is s.
__device__ __forceinline__ void write_weights(const float* __restrict__ logits,
                                              float* __restrict__ out, int lo,
                                              int hi, float m, float s,
                                              int lane) {
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) out[e] = expf(logits[e] - m) / s;
}

// Unit (row, lo, hi, slot) on one warp.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_units_kernel(const int4* __restrict__ units, int n_units,
                     const float* __restrict__ logits,
                     float* __restrict__ out, float2* __restrict__ partials) {
  const int u = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (u >= n_units) return;  // whole warps exit together
  const int4 unit = units[u];
  const int lo = unit.y, hi = unit.z;
  float m = -FLT_MAX;
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) m = fmaxf(m, logits[e]);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) s += expf(logits[e] - m);
  s = warp_sum(s);
  if (unit.w < 0) {
    write_weights(logits, out, lo, hi, m, s, lane);
  } else if (lane == 0) {
    partials[unit.w] = make_float2(m, s);
  }
}

// Slot j of a split row on one warp: the row's (max, sum) from all its
// slots, then the weights of slot j's unit, edges [first + i chunk,
// first + (i + 1) chunk) of the row for the row's i-th slot.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_split_kernel(const int* __restrict__ row_offsets,
                     const int* __restrict__ split_rows,
                     const int* __restrict__ slot_offsets, int n_split,
                     int n_slots, int chunk, const float* __restrict__ logits,
                     const float2* __restrict__ partials,
                     float* __restrict__ out) {
  const int j = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (j >= n_slots) return;  // whole warps exit together
  // The split row holding slot j: the last s with slot_offsets[s] <= j.
  int a = 0, b = n_split - 1;
  while (a < b) {
    const int mid = (a + b + 1) / 2;
    if (slot_offsets[mid] <= j) a = mid; else b = mid - 1;
  }
  const int first = slot_offsets[a], last = slot_offsets[a + 1];
  float m = -FLT_MAX;
  for (int t = first + lane; t < last; t += 32) m = fmaxf(m, partials[t].x);
  m = warp_max(m);
  float s = 0.f;
  for (int t = first + lane; t < last; t += 32) {
    const float2 p = partials[t];
    s += p.y * expf(p.x - m);
  }
  s = warp_sum(s);
  const int row = split_rows[a];
  const int lo = row_offsets[row] + (j - first) * chunk;
  write_weights(logits, out, lo, min(lo + chunk, row_offsets[row + 1]), m, s,
                lane);
}

// K5: the backward of K3, d_logit[e] = w[e] * (g[e] - sum_row w * g).
//
// Replaces kgat_tpu/ops/pallas/softmax.py::_wsum_kernel and _dlogit_kernel
// (segment_softmax_aligned_bwd): two TPU passes over the aligned layout,
// with the row sums stored between them. Here one warp owns a CSR row:
// pass 1 sums w * g per lane and merges the lanes with a fixed shuffle
// tree, pass 2 writes w * (g - s). Bounded by bytes like K3 (two reads of
// w and g, one write: 20 bytes per edge); the sum order is fixed, so two
// calls are bit-identical. Empty rows own no edge and write nothing.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_softmax_csr_bwd_kernel(const int* __restrict__ row_offsets,
                               const float* __restrict__ w,
                               const float* __restrict__ g,
                               float* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // whole warps exit together
  const int lo = row_offsets[row];
  const int hi = row_offsets[row + 1];
  if (lo >= hi) return;

  float s = 0.f;
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) s = fmaf(w[e], g[e], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) out[e] = w[e] * (g[e] - s);
}

}  // namespace

// units .. n_split: the CSR's RowSplit (n_slots partials of chunk edges);
// partials: (n_slots,) float2 scratch.
extern "C" int kgat_segment_softmax_csr(const void* units, int n_units,
                                        const void* split_rows,
                                        const void* slot_offsets, int n_split,
                                        int n_slots, int chunk,
                                        const void* row_offsets,
                                        const void* logits, void* out,
                                        void* partials, void* stream) {
  if (n_units <= 0 || chunk <= 0 || (n_split > 0) != (n_slots > 0) ||
      reinterpret_cast<uintptr_t>(units) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partials) % 8 != 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto lg = static_cast<const float*>(logits);
  const auto o = static_cast<float*>(out);
  const auto p = static_cast<float2*>(partials);
  softmax_units_kernel<<<(n_units + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const int4*>(units), n_units, lg, o, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  softmax_split_kernel<<<(n_slots + kWarpsPerBlock - 1) / kWarpsPerBlock,
                         kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const int*>(row_offsets),
      static_cast<const int*>(split_rows),
      static_cast<const int*>(slot_offsets), n_split, n_slots, chunk, lg, p,
      o);
  return cudaGetLastError();
}

extern "C" int kgat_segment_softmax_csr_bwd(const void* row_offsets,
                                            const void* w, const void* g,
                                            void* out, int n_rows,
                                            void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_softmax_csr_bwd_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_offsets), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(out), n_rows);
  return cudaGetLastError();
}
