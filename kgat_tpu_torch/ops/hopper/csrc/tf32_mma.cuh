// TF32 products on the tensor cores at float32 accuracy, and the gathers
// of edge rows that feed them: shared by K2 (sddmm.cu) and K4
// (sddmm_bwd.cu).
//
// A float32 product x w is taken in three TF32 passes, x_lo w_hi +
// x_hi w_lo + x_hi w_hi, hi = tf32(x) and lo = tf32(x - hi); each is then
// within about 2^-21 of float32's, and the dropped x_lo w_lo term is below
// 2^-22. The tensor cores add an MMA's products into its accumulator with
// truncation, so the kernels run each 8-wide reduction step from a zero
// accumulator (mma_zero) and add the steps with a rounding FADD.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 16;        // edges per warp group: the MMA's M

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The same split in three instructions for finite x, for the edge rows at
// every step: hi rounded to nearest (ties away) with an integer add and
// mask, as cvt.rna rounds, and lo = x - hi (exact) handed to the tensor
// cores as it is; they read its top 19 bits, so lo loses at most
// 2^-10 |lo| <= 2^-21 |x|.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b on the tensor cores, from a zero accumulator.
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Copies `bytes` (16 or 4) from global to shared memory, or zeros them
// where `valid` is false.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits for this thread's copies but the last group committed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Waits for all of this thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Gathers the 16 head rows (stage rows 0-15) and 16 tail rows (16-31) of
// group `first` / 16 of the staged tile into `stage`; rows past `n` are
// zeros. Lane `lane` makes copies lane, lane + 32, ... of the 32 * cpr in
// the group, at (row, q) kept incrementally.
template <int kBytes>
__device__ __forceinline__ void gather(float* stage, int stride,
                                       const float* __restrict__ emb, int d,
                                       const int* heads, const int* tails,
                                       int first, int n, int cpr, int row0,
                                       int q0, int drow, int dq) {
  constexpr int kFloats = kBytes / 4;
  int row = row0, q = q0;
  for (int j = 0; j < cpr; ++j) {
    const int e = first + (row & (kRows - 1));
    const bool valid = e < n;
    const int node = valid ? (row < kRows ? heads : tails)[e] : 0;
    cp_async<kBytes>(stage + row * stride + kFloats * q,
                     emb + static_cast<size_t>(node) * d + kFloats * q,
                     valid);
    row += drow;
    q += dq;
    if (q >= cpr) {
      q -= cpr;
      ++row;
    }
  }
  cp_async_commit();
}

}  // namespace
