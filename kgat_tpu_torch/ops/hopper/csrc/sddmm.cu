// K2: TransR attention SDDMM, one logit per edge,
//   pi(h, r, t) = sum_j (W_r e_t)_j * tanh((W_r e_h)_j + e_r,j),
// with head h = dst and tail t = src (edges run tail -> head).
//
// Replaces kgat_tpu/ops/pallas/sddmm.py::_kernel (sddmm_transr). The TPU
// kernel takes e_h/e_t rows pre-gathered by XLA into a padded
// relation-blocked order, and its logits are routed back with a scatter.
// Here the kernel gathers the rows itself by index, and stores each logit
// straight into its canonical edge slot: neither the two (E, d) gathers
// (2 x 1.14 GB at yelp2018 scale) nor the routing pass exist.
//
// What bounds it on the H100: operations. Per edge it gathers two
// embedding rows (512 bytes at d = 64, served by L2: the 35 MB table of
// the yelp2018 graph stays in the 50 MB cache) for two d x k projections,
// 4 d k = 16,384 flops at d = k = 64. On the float32 FMA units (67
// TFLOP/s) that is 1.1 ms at yelp2018 scale; the tensor cores run TF32 at
// 495 TFLOP/s, but one TF32 product keeps 11 of float32's 24 bits.
//
// Design: the projections run on the tensor cores in three TF32 passes
// (mma.sync m16n8k8), x w ~ x_hi w_hi + x_hi w_lo + x_lo w_hi, where
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna; for the edge rows, the
// tensor cores cut x - hi to TF32 themselves): each product is then
// within about 2^-21 of float32's, and the dropped x_lo w_lo term is
// below 2^-22. The tensor cores add each MMA's products into its
// accumulator with truncation, not rounding; chained over the 3 d / 8
// MMAs of a projection, those errors add up one way, to two to four times
// a float32 sum's on an H100 (about three times in the emulation of
// tests/test_torch_tf32_split.py). So each 8-wide step of d runs its three
// passes from a zero accumulator, and an FADD, which rounds, adds the
// step to the projection. One block takes a relation tile (its edges
// share W_r):
//  * W_r is staged once per tile in shared memory, split into its hi and
//    lo TF32 parts and laid out in the MMA's B-fragment order, so a lane
//    reads its {b0 hi, b1 hi, b0 lo, b1 lo} with one 16-byte load. It is
//    read in coalesced row pairs, every load of a thread in flight before
//    its first store, while the warps' first gathers are in flight. Widths
//    are zero-padded to multiples of 8 (exact), and k is taken in column
//    chunks of 8 NT, so every width the wrapper takes fits (d <= 256,
//    k <= 128); at d = k = 64 there is one chunk.
//  * Each warp takes 16 edges at a time: cp.async gathers their 16 head
//    and 16 tail rows into a double-buffered stage of its own, group g+1's
//    copies in flight while group g multiplies. A group with fewer than 16
//    edges gathers zero rows for the rest (cp.async's zero fill).
//  * The K order inside each 8-wide MMA step is permuted (logical columns
//    t and t + 4 are physical 2t and 2t + 1, in A and B alike), so a lane
//    reads its A fragment with two 8-byte loads; the row stride of the
//    stage is 8 mod 32 words, which keeps those loads free of bank
//    conflicts.
//  * The epilogue stays in registers: the head and tail accumulators of
//    the 16 edges share one fragment layout, so each lane forms
//    pt * tanh(ph + e_r) in place (the accurate tanhf), sums its columns,
//    and two xor shuffles sum each row across its quad. The logits of the
//    tile go to shared memory, then to out[rel_perm[...]].

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 256;       // edges staged per pass of a tile
constexpr int kMaxWarps = 4;     // two blocks share an SM at d = k = 64
constexpr int kBatch = 16;       // W_r row pairs a thread loads at once
constexpr int kSmemBudget = 227 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// Shared memory of a block: the fixed part, then a stage per warp.
struct Layout {
  int dp;       // d rounded up to 8
  int stride;   // words per staged row, 8 mod 32
  int chunk;    // columns of k per pass, 8 NT

  __host__ __device__ size_t w_floats() const {
    return static_cast<size_t>(dp) * chunk * 2;   // hi and lo
  }
  __host__ __device__ size_t fixed_bytes() const {
    // W_r split, e_r, then the tile's logits, edge ids, heads and tails.
    return (w_floats() + chunk + 4 * kTile) * 4;
  }
  __host__ __device__ size_t warp_floats() const {
    return static_cast<size_t>(2) * 2 * kRows * stride;  // 2 buffers
  }
};

// NT: 8-column MMA tiles of k per pass (8 NT columns).
template <int NT, int kBytes>
__global__ void __launch_bounds__(kMaxWarps * 32)
sddmm_transr_kernel(const int* __restrict__ rel_perm,
                    const int* __restrict__ tiles, const int* __restrict__ src,
                    const int* __restrict__ dst, const float* __restrict__ emb,
                    const float* __restrict__ w_rel,
                    const float* __restrict__ rel_embed,
                    float* __restrict__ out, int d, int k, Layout lay) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCols = 8 * NT;
  const int dp = lay.dp, stride = lay.stride, ks = dp / 8;
  float4* w_s = reinterpret_cast<float4*>(smem);  // (ks, NT, 32 lanes)
  float* er_s = smem + lay.w_floats();            // (kCols,)
  float* logit_s = er_s + kCols;                  // (kTile,)
  int* edge_s = reinterpret_cast<int*>(logit_s + kTile);
  int* head_s = edge_s + kTile;
  int* tail_s = head_s + kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  float* stage = smem + lay.fixed_bytes() / 4 + warp * lay.warp_floats();
  const int buf_floats = 2 * kRows * stride;

  // Columns [d, dp) of the stage stay zero: copies write columns < d.
  for (int i = lane; i < 2 * 2 * kRows * (dp - d); i += 32) {
    const int r = i / (dp - d);
    stage[r * stride + d + i % (dp - d)] = 0.f;
  }
  // A lane's copies: 32 * cpr per group, the lane's first at (row0, q0),
  // each next one 32 further on.
  const int cpr = d / (kBytes / 4);
  const int row0 = lane / cpr, q0 = lane % cpr;
  const int drow = 32 / cpr, dq = 32 % cpr;

  const int rel = tiles[3 * blockIdx.x];
  const int start = tiles[3 * blockIdx.x + 1];
  const int count = tiles[3 * blockIdx.x + 2];
  const float* w_g = w_rel + static_cast<size_t>(rel) * d * k;
  const int n_chunks = (k + kCols - 1) / kCols;

  for (int sub = 0; sub < count; sub += kTile) {
    const int n = min(kTile, count - sub);
    const int n_groups = (n + kRows - 1) / kRows;
    __syncthreads();  // the last pass is done with the tile's arrays
    // Two edges a thread at a time: both ids, then their heads and tails.
    for (int i = threadIdx.x; i < n; i += 2 * blockDim.x) {
      const int i2 = i + blockDim.x;
      const int e = rel_perm[start + sub + i];
      const int e2 = i2 < n ? rel_perm[start + sub + i2] : e;
      edge_s[i] = e;
      head_s[i] = dst[e];
      tail_s[i] = src[e];
      if (i2 < n) {
        edge_s[i2] = e2;
        head_s[i2] = dst[e2];
        tail_s[i2] = src[e2];
      }
    }
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * kCols;
      if (c > 0) __syncthreads();  // every warp is done with chunk c - 1
      if (warp < n_groups) {
        gather<kBytes>(stage, stride, emb, d, head_s, tail_s, warp * kRows, n,
                       cpr, row0, q0, drow, dq);
      }
      if (sub == 0 || n_chunks > 1) {
        // W_r's columns [c0, c0 + kCols) in fragment order: entry
        // (s, nt, lane) holds rows 8s + 2 tig and 8s + 2 tig + 1 of column
        // c0 + 8 nt + gid, hi then lo. Pair i is rows 2 (i / kCols) and
        // 2 (i / kCols) + 1 of column c0 + i % kCols.
        const int n_pairs = dp / 2 * kCols;
        for (int base = threadIdx.x; base < n_pairs;
             base += kBatch * blockDim.x) {
          float2 v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = base + j * blockDim.x;
            const int r = 2 * (i / kCols), col = c0 + i % kCols;
            v[j] = make_float2(0.f, 0.f);
            if (i < n_pairs && col < k) {
              if (r < d) v[j].x = w_g[static_cast<size_t>(r) * k + col];
              if (r + 1 < d) v[j].y = w_g[static_cast<size_t>(r + 1) * k + col];
            }
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = base + j * blockDim.x;
            if (i >= n_pairs) break;
            const int r = 2 * (i / kCols), cl = i % kCols;
            uint32_t h0, l0, h1, l1;
            split(v[j].x, h0, l0);
            split(v[j].y, h1, l1);
            w_s[((r / 8) * NT + cl / 8) * 32 + (cl % 8) * 4 + (r % 8) / 2] =
                make_float4(__uint_as_float(h0), __uint_as_float(h1),
                            __uint_as_float(l0), __uint_as_float(l1));
          }
        }
        for (int i = threadIdx.x; i < kCols; i += blockDim.x) {
          er_s[i] = c0 + i < k
                        ? rel_embed[static_cast<size_t>(rel) * k + c0 + i]
                        : 0.f;
        }
      }
      __syncthreads();

      int b = 0;
      for (int g = warp; g < n_groups; g += n_warps, b ^= 1) {
        if (g + n_warps < n_groups) {
          gather<kBytes>(stage + (b ^ 1) * buf_floats, stride, emb, d, head_s,
                         tail_s, (g + n_warps) * kRows, n, cpr, row0, q0,
                         drow, dq);
        } else {
          cp_async_commit();  // an empty group keeps the wait uniform
        }
        cp_async_wait_prior();
        __syncwarp();

        const float* hb = stage + b * buf_floats;  // rows 0-15: heads
        const float* tb = hb + kRows * stride;     // rows 0-15: tails
        float acc_h[NT][4], acc_t[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_h[nt][i] = acc_t[nt][i] = 0.f;
        }
        for (int s = 0; s < ks; ++s) {
          const int col = 8 * s + 2 * tig;
          const float2 h0 = *reinterpret_cast<const float2*>(
              hb + gid * stride + col);
          const float2 h1 = *reinterpret_cast<const float2*>(
              hb + (gid + 8) * stride + col);
          const float2 t0 = *reinterpret_cast<const float2*>(
              tb + gid * stride + col);
          const float2 t1 = *reinterpret_cast<const float2*>(
              tb + (gid + 8) * stride + col);
          uint32_t ah[4], al[4], th[4], tl[4];
          split_fast(h0.x, ah[0], al[0]);
          split_fast(h1.x, ah[1], al[1]);
          split_fast(h0.y, ah[2], al[2]);
          split_fast(h1.y, ah[3], al[3]);
          split_fast(t0.x, th[0], tl[0]);
          split_fast(t1.x, th[1], tl[1]);
          split_fast(t0.y, th[2], tl[2]);
          split_fast(t1.y, th[3], tl[3]);
          const float4* wf = w_s + static_cast<size_t>(s) * NT * 32 + lane;
          // {b0 hi, b1 hi, b0 lo, b1 lo} of each n-tile.
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float4 w = wf[nt * 32];
            bh[nt][0] = __float_as_uint(w.x);
            bh[nt][1] = __float_as_uint(w.y);
            bl[nt][0] = __float_as_uint(w.z);
            bl[nt][1] = __float_as_uint(w.w);
          }
          // The step's three passes from zero, the small terms first, each
          // pass over every n-tile before the next (2 NT independent MMAs
          // between dependent ones); then a rounding add into the
          // projection.
          float sh[NT][4], st[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_zero(sh[nt], al, bh[nt][0], bh[nt][1]);
            mma_zero(st[nt], tl, bh[nt][0], bh[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma(sh[nt], ah, bl[nt][0], bl[nt][1]);
            mma(st[nt], th, bl[nt][0], bl[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma(sh[nt], ah, bh[nt][0], bh[nt][1]);
            mma(st[nt], th, bh[nt][0], bh[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc_h[nt][i] += sh[nt][i];
              acc_t[nt][i] += st[nt][i];
            }
          }
        }

        // A lane holds rows gid and gid + 8, columns 8 nt + 2 tig + {0, 1}.
        float part0 = 0.f, part1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float e0 = er_s[8 * nt + 2 * tig];
          const float e1 = er_s[8 * nt + 2 * tig + 1];
          part0 = fmaf(acc_t[nt][0], tanhf(acc_h[nt][0] + e0), part0);
          part0 = fmaf(acc_t[nt][1], tanhf(acc_h[nt][1] + e1), part0);
          part1 = fmaf(acc_t[nt][2], tanhf(acc_h[nt][2] + e0), part1);
          part1 = fmaf(acc_t[nt][3], tanhf(acc_h[nt][3] + e1), part1);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          part0 += __shfl_xor_sync(kFullMask, part0, off);
          part1 += __shfl_xor_sync(kFullMask, part1, off);
        }
        const int r0 = g * kRows + gid, r1 = r0 + 8;
        if (tig == 0 && r0 < n) logit_s[r0] = c ? logit_s[r0] + part0 : part0;
        if (tig == 0 && r1 < n) logit_s[r1] = c ? logit_s[r1] + part1 : part1;
        __syncwarp();  // the stage is refilled two groups on
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      out[edge_s[i]] = logit_s[i];
    }
  }
}

template <int NT, int kBytes>
cudaError_t launch(const int* rel_perm, const int* tiles, const int* src,
                   const int* dst, const float* emb, const float* w_rel,
                   const float* rel_embed, float* out, int n_tiles, int d,
                   int k, cudaStream_t stream) {
  Layout lay;
  lay.dp = (d + 7) / 8 * 8;
  lay.stride = lay.dp + (40 - lay.dp % 32) % 32;
  lay.chunk = 8 * NT;
  const size_t per_warp = lay.warp_floats() * 4;
  const size_t room = kSmemBudget - lay.fixed_bytes();
  const int n_warps = static_cast<int>(
      room / per_warp < kMaxWarps ? room / per_warp : kMaxWarps);
  if (lay.fixed_bytes() > kSmemBudget || n_warps < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = lay.fixed_bytes() + n_warps * per_warp;
  auto kernel = sddmm_transr_kernel<NT, kBytes>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_tiles, n_warps * 32, smem, stream>>>(
      rel_perm, tiles, src, dst, emb, w_rel, rel_embed, out, d, k, lay);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const int* rp, const int* tl, const int* sr,
                      const int* ds, const float* em, const float* wr,
                      const float* er, float* o, int n_tiles, int d, int k,
                      cudaStream_t s) {
  // 16-byte copies where every row starts 16-byte aligned.
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(em) % 16 == 0) {
    return launch<NT, 16>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
  }
  return launch<NT, 4>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
}

}  // namespace

extern "C" int kgat_sddmm_transr(const void* rel_perm, const void* tiles,
                                 const void* src, const void* dst,
                                 const void* emb, const void* w_rel,
                                 const void* rel_embed, void* out, int n_tiles,
                                 int d, int k, void* stream) {
  if (n_tiles <= 0 || d <= 0 || d > 256 || k <= 0 || k > 128) {
    return cudaErrorInvalidValue;
  }
  const auto rp = static_cast<const int*>(rel_perm);
  const auto tl = static_cast<const int*>(tiles);
  const auto sr = static_cast<const int*>(src);
  const auto ds = static_cast<const int*>(dst);
  const auto em = static_cast<const float*>(emb);
  const auto wr = static_cast<const float*>(w_rel);
  const auto er = static_cast<const float*>(rel_embed);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // Columns of k per pass: 32 for k <= 32, else 64 (k = 100 or 128 takes
  // two passes).
  if (k <= 32) return launch_nt<4>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
  return launch_nt<8>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
}
