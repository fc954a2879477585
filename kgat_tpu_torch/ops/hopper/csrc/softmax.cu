// K3: per-destination segment softmax of edge logits over the dst-sorted
// CSR: w[e] = exp(l[e] - max_row) / sum_row exp(l - max_row).
//
// Replaces kgat_tpu/ops/pallas/softmax.py::_max_kernel, _expsum_kernel and
// _norm_kernel (segment_softmax_aligned). The TPU form is three passes over
// a padded block-aligned layout with per-row [lo, hi) bounds tables and a
// stored exp intermediate; here each CSR row is one warp's work, and nothing
// but the weights is written.
//
// What bounds it on the H100: bytes, and little of them. Per edge it reads
// the logit twice (4 bytes each, contiguous within a row) and writes the
// weight once: 12 bytes and two exps per edge, ~54 MB at yelp2018 scale.
// Design: one warp per row. Pass 1 keeps an online (max, sum) per lane,
// rescaling the sum when the max grows, and merges the 32 lanes with
// shuffles; pass 2 writes exp(l - max) / sum. Reads are coalesced. An empty
// row writes nothing. The row max starts at -FLT_MAX, not -inf, so no
// inf - inf can appear: no NaN for a row of one edge or for the hub row.
// The semantics are kgat_tpu/ops/ref.py::segment_softmax's. The hub row
// (in-degree 70,884 at yelp scale) again runs on one warp.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_softmax_csr_kernel(const int* __restrict__ row_offsets,
                           const float* __restrict__ logits,
                           float* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // whole warps exit together
  const int lo = row_offsets[row];
  const int hi = row_offsets[row + 1];
  if (lo >= hi) return;

  float m = -FLT_MAX, s = 0.f;
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) {
    const float v = logits[e];
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, off);
    const float s2 = __shfl_xor_sync(kFullMask, s, off);
    const float mx = fmaxf(m, m2);
    s = s * expf(m - mx) + s2 * expf(m2 - mx);
    m = mx;
  }
  // s >= 1 for a non-empty row (the max term is exp(0)).
#pragma unroll 4
  for (int e = lo + lane; e < hi; e += 32) out[e] = expf(logits[e] - m) / s;
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

extern "C" int kgat_segment_softmax_csr(const void* row_offsets,
                                        const void* logits, void* out,
                                        int n_rows, void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_softmax_csr_kernel<<<grid, kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_offsets), static_cast<const float*>(logits),
      static_cast<float*>(out), n_rows);
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
