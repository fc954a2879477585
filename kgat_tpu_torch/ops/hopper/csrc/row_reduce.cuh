// The CSR row reduction shared by K1 (spmm_csr), K6 (segment_sum_csr), K8
// (reduce_send) and K4's fold (sddmm_transr_bwd), so that they reduce in
// one way and cannot diverge
// (the counterpart of kgat_tpu/ops/pallas/segment_sum.py::accum_step, which
// the TPU's K6 and K8 share for the same reason).
//
// What bounds it on the H100: bytes, and how evenly they are spread over
// the card. Each edge reads one value row (d * 4 bytes in f32, d * 2 in
// bf16): a random row of x for K1 (x stays in the 50 MB L2 at d = 64:
// 35 MB), the next row of an in-order stream for K6 and K8. At most 2 d
// flops an edge: far below the compute line. The first design (one warp
// per row, one column per lane) missed the memory rate twice over: a row
// ran on one warp, so the hub row (70,884 edges) set the time of the whole
// launch; and a lane loaded 4 bytes of an edge's row at a time. So:
//
//  * Work units, not rows. The wrapper passes a schedule built once per CSR
//    (kgat_tpu_torch/ops/row_split.py): unit (row, lo, hi, slot) covers at
//    most CHUNK consecutive edges of one row, one warp a unit. A unit with
//    slot < 0 is a whole row and writes it (an empty row as 0). The units
//    of a longer row write f32 partial rows into slots of a scratch buffer,
//    and fixup_kernel, a second launch, sums each such row's slots in unit
//    order.
//  * Lanes sized to the row. A group of G lanes covers one edge's value
//    row with 16-byte loads (4 f32 or 8 bf16 a lane), so a warp reads 32/G
//    edges a step, and each group keeps kUnroll steps of loads in flight.
//    The groups' sums combine by an xor shuffle tree at the unit's end.
//    Where a row is not a multiple of 16 bytes, or a pointer is not 16-byte
//    aligned, lanes take single values: G = 32, a column per lane.
//
// Every order is fixed and nothing is summed with atomics: two calls give
// the same bits.
//
//   GATHER: the value of edge e is row src[e] of x scaled by w[e] (K1),
//           or unscaled where not WEIGHTED (K4's fold, src = rev_perm);
//           otherwise row e of a pre-gathered (E, d) value stream (K6, K8).
//   ACC:    a row's sum is added into out[row] rather than stored (K4's
//           fold adds its tail sums to its head sums). The addition is
//           one more rounding in a fixed order: still deterministic.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace kgat {
namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;  // one unit per warp
constexpr int kUnroll = 4;         // steps of loads in flight per group

// A row's lane layout: VEC values a load (16 bytes' worth, or 1), G lanes
// an edge, VPL loads a lane and edge.
template <int VEC_, int G_, int VPL_>
struct Layout {
  static constexpr int VEC = VEC_;
  static constexpr int G = G_;
  static constexpr int VPL = VPL_;
};

// The schedule of one CSR (row_split.RowSplit), on the device.
struct Split {
  const int4* units;        // (n_units,) (row, lo, hi, slot)
  int n_units;
  const int* split_rows;    // (n_split,)
  const int* slot_offsets;  // (n_split + 1,)
  int n_split;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One load of VEC values of T, its multiply-add into VEC f32 sums, and the
// store of VEC f32 sums.
template <typename T, int VEC>
struct Pack;

template <typename T>
struct Pack<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void fma(float* acc, Raw r, float w) {
    acc[0] = fmaf(w, to_f32(r), acc[0]);
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    p[0] = acc[0];
  }
};

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void fma(float* acc, Raw r, float w) {
    acc[0] = fmaf(w, r.x, acc[0]);
    acc[1] = fmaf(w, r.y, acc[1]);
    acc[2] = fmaf(w, r.z, acc[2]);
    acc[3] = fmaf(w, r.w, acc[3]);
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // A bf16 is the high half of the f32 of the same value; of a 32-bit
  // word, the low half is the lower column.
  static __device__ __forceinline__ void fma(float* acc, Raw r, float w) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
      acc[2 * i + 1] =
          fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    q[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

// Unit u = (row, lo, hi, slot) on one warp (lane: the thread's lane). Sums
// the values of edges [lo, hi) into out[row] when slot < 0, else into
// partials[slot]. Group g of the warp takes edges lo + g, lo + g + 32/G,
// ... in order; then the xor tree adds the groups' sums.
template <typename T, class L, bool GATHER, bool WEIGHTED = GATHER,
          bool ACC = false>
__device__ __forceinline__ void reduce_unit(const int4 u,
                                            const int* __restrict__ src,
                                            const float* __restrict__ w,
                                            const T* __restrict__ x,
                                            float* __restrict__ out,
                                            float* __restrict__ partials,
                                            int d, int lane) {
  using P = Pack<T, L::VEC>;
  constexpr int kGroups = 32 / L::G;  // edges a warp reads a step
  const int group = lane / L::G;
  const int n_loads = d / L::VEC;     // loads of one value row
  int col[L::VPL];
  bool on[L::VPL];
#pragma unroll
  for (int q = 0; q < L::VPL; ++q) {
    const int v = lane % L::G + L::G * q;
    on[q] = v < n_loads;
    col[q] = v * L::VEC;
  }
  float acc[L::VPL][L::VEC];
#pragma unroll
  for (int q = 0; q < L::VPL; ++q) {
#pragma unroll
    for (int i = 0; i < L::VEC; ++i) acc[q][i] = 0.f;
  }

  const int hi = u.z;
  int e = u.y + group;
  for (; e + (kUnroll - 1) * kGroups < hi; e += kUnroll * kGroups) {
    size_t base[kUnroll];
    float wt[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int ek = e + k * kGroups;
      base[k] = static_cast<size_t>(GATHER ? src[ek] : ek) * d;
      wt[k] = WEIGHTED ? w[ek] : 1.f;
    }
    typename P::Raw v[kUnroll][L::VPL];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int q = 0; q < L::VPL; ++q) {
        if (on[q]) v[k][q] = P::load(x + base[k] + col[q]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int q = 0; q < L::VPL; ++q) {
        if (on[q]) P::fma(acc[q], v[k][q], wt[k]);
      }
    }
  }
  for (; e < hi; e += kGroups) {
    const size_t base = static_cast<size_t>(GATHER ? src[e] : e) * d;
    const float wt = WEIGHTED ? w[e] : 1.f;
#pragma unroll
    for (int q = 0; q < L::VPL; ++q) {
      if (on[q]) P::fma(acc[q], P::load(x + base + col[q]), wt);
    }
  }

#pragma unroll
  for (int off = L::G; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < L::VPL; ++q) {
#pragma unroll
      for (int i = 0; i < L::VEC; ++i) {
        acc[q][i] += __shfl_xor_sync(kFullMask, acc[q][i], off);
      }
    }
  }
  if (group == 0) {
    float* row = u.w < 0 ? out + static_cast<size_t>(u.x) * d
                         : partials + static_cast<size_t>(u.w) * d;
#pragma unroll
    for (int q = 0; q < L::VPL; ++q) {
      if constexpr (ACC) {
        if (on[q] && u.w < 0) P::fma(acc[q], P::load(row + col[q]), 1.f);
      }
      if (on[q]) P::store(row + col[q], acc[q]);
    }
  }
}

// The second pass: split row s's partial rows, slots [slot_offsets[s],
// slot_offsets[s + 1]), summed in slot (= unit) order into out[row]. It is
// the same reduction, over the f32 partials as a value stream.
template <class L, bool ACC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fixup_kernel(const int* __restrict__ split_rows,
             const int* __restrict__ slot_offsets,
             const float* __restrict__ partials, float* __restrict__ out,
             int n_split, int d) {
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (s >= n_split) return;  // whole warps exit together
  const int4 u = make_int4(split_rows[s], slot_offsets[s],
                           slot_offsets[s + 1], -1);
  reduce_unit<float, L, false, false, ACC>(u, nullptr, nullptr, partials,
                                           out, nullptr, d, threadIdx.x % 32);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Calls f(Layout<VEC, G, VPL>{}) for rows of d values of T: 16-byte loads
// where `vec` (the pointers are 16-byte aligned) and a row is a whole
// number of them, else single values. d must be in (0, 256].
template <typename T, typename F>
cudaError_t with_layout(int d, bool vec, F&& f) {
  constexpr int V = 16 / sizeof(T);
  if (vec && d % V == 0) {
    const int n = d / V;
    if (n <= 4) return f(Layout<V, 4, 1>{});
    if (n <= 8) return f(Layout<V, 8, 1>{});
    if (n <= 16) return f(Layout<V, 16, 1>{});
    if (n <= 32) return f(Layout<V, 32, 1>{});
    if (n <= 64) return f(Layout<V, 32, 2>{});
    return cudaErrorInvalidValue;
  }
  if (d <= 0) return cudaErrorInvalidValue;
  if (d <= 32) return f(Layout<1, 32, 1>{});
  if (d <= 64) return f(Layout<1, 32, 2>{});
  if (d <= 128) return f(Layout<1, 32, 4>{});
  if (d <= 256) return f(Layout<1, 32, 8>{});
  return cudaErrorInvalidValue;
}

// Blocks of the first launch that the units need.
int unit_blocks(const Split& s) {
  return (s.n_units + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// The second launch, where a row was split (none otherwise); ACC adds
// each split row's sum into out.
template <bool ACC = false>
cudaError_t launch_fixup(const Split& s, const float* partials, float* out,
                         int d, cudaStream_t stream) {
  if (s.n_split == 0) return cudaSuccess;
  const dim3 grid((s.n_split + kWarpsPerBlock - 1) / kWarpsPerBlock);
  return with_layout<float>(
      d, aligned16(partials) && aligned16(out), [&](auto layout) {
        fixup_kernel<decltype(layout), ACC><<<grid, kWarpsPerBlock * 32, 0,
                                              stream>>>(
            s.split_rows, s.slot_offsets, partials, out, s.n_split, d);
        return cudaGetLastError();
      });
}

Split make_split(const void* units, int n_units, const void* split_rows,
                 const void* slot_offsets, int n_split) {
  return Split{static_cast<const int4*>(units), n_units,
               static_cast<const int*>(split_rows),
               static_cast<const int*>(slot_offsets), n_split};
}

}  // namespace
}  // namespace kgat
