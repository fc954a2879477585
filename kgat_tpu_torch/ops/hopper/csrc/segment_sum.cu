// K1: weighted CSR SpMM, out[v] = sum over e in row v of w[e] * x[src[e]].
// K6: CSR segment sum of a pre-gathered value stream,
//     out[r] = sum over e in row r of vals[e].
//
// K1 replaces kgat_tpu/ops/pallas/segment_sum.py::_kernel_w (reached
// through segment_sum_packed); K6 replaces segment_sum.py::accum_step (the
// `_kernel` of segment_sum_aligned), which the partitioned ring exchange
// runs on every bucket (parallel/halo.py, forward and backward). The TPU
// kernels walk a padded block-aligned edge order and reduce with one-hot
// matmuls on the MXU; none of that is carried over. These kernels walk
// the work units of a CSR through the row reduction of row_reduce.cuh,
// which K8 (remote_ring.cu) shares.
//
// What bounds them on the H100: bytes. K1 reads one x row (d * 4 bytes in
// f32, d * 2 in bf16) per edge from a random source row, plus 8 bytes of
// index and weight; K6 reads its value stream in order (d * 4 or d * 2
// bytes per edge); each writes d * 4 bytes per row. The arithmetic is at
// most 2 * d flops per edge, about 0.25 flop per byte in f32: far below
// the compute line. Design for that (row_reduce.cuh): units of at most
// CHUNK edges, so a hub row spreads over many warps and no row holds up
// the launch; 16-byte loads, 32/G edges a warp step. A call is one launch,
// or two where the CSR has a row longer than CHUNK (the second sums that
// row's partials in unit order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "row_reduce.cuh"

namespace {

using kgat::kWarpsPerBlock;

template <typename T, class L, bool GATHER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_units_kernel(const int4* __restrict__ units, int n_units,
                 const int* __restrict__ src, const float* __restrict__ w,
                 const T* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ partials, int d) {
  const int u = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (u >= n_units) return;  // whole warps exit together
  kgat::reduce_unit<T, L, GATHER>(units[u], src, w, x, out, partials, d,
                                  threadIdx.x % 32);
}

template <typename T, bool GATHER>
cudaError_t launch(const kgat::Split& s, const int* src, const float* w,
                   const T* x, float* out, float* partials, int d,
                   cudaStream_t stream) {
  const dim3 grid(kgat::unit_blocks(s));
  const bool vec = kgat::aligned16(x) && kgat::aligned16(out) &&
                   kgat::aligned16(partials);
  const cudaError_t e = kgat::with_layout<T>(d, vec, [&](auto layout) {
    csr_units_kernel<T, decltype(layout), GATHER>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(s.units, s.n_units, src,
                                                   w, x, out, partials, d);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return kgat::launch_fixup(s, partials, out, d, stream);
}

bool valid(const void* units, int n_units, int d) {
  return n_units > 0 && d > 0 && d <= 256 && kgat::aligned16(units);
}

}  // namespace

extern "C" int kgat_spmm_csr(const void* units, int n_units,
                             const void* split_rows, const void* slot_offsets,
                             int n_split, const void* src, const void* w,
                             const void* x, void* out, void* partials, int d,
                             int x_is_bf16, void* stream) {
  if (!valid(units, n_units, d)) return cudaErrorInvalidValue;
  const auto s = kgat::make_split(units, n_units, split_rows, slot_offsets,
                                  n_split);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sr = static_cast<const int*>(src);
  const auto wf = static_cast<const float*>(w);
  const auto o = static_cast<float*>(out);
  const auto p = static_cast<float*>(partials);
  if (x_is_bf16) {
    return launch<__nv_bfloat16, true>(
        s, sr, wf, static_cast<const __nv_bfloat16*>(x), o, p, d, st);
  }
  return launch<float, true>(s, sr, wf, static_cast<const float*>(x), o, p,
                             d, st);
}

extern "C" int kgat_segment_sum_csr(const void* units, int n_units,
                                    const void* split_rows,
                                    const void* slot_offsets, int n_split,
                                    const void* vals, void* out,
                                    void* partials, int d, int vals_is_bf16,
                                    void* stream) {
  if (!valid(units, n_units, d)) return cudaErrorInvalidValue;
  const auto s = kgat::make_split(units, n_units, split_rows, slot_offsets,
                                  n_split);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<float*>(out);
  const auto p = static_cast<float*>(partials);
  if (vals_is_bf16) {
    return launch<__nv_bfloat16, false>(
        s, nullptr, nullptr, static_cast<const __nv_bfloat16*>(vals), o, p,
        d, st);
  }
  return launch<float, false>(s, nullptr, nullptr,
                              static_cast<const float*>(vals), o, p, d, st);
}

extern "C" const char* kgat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
