// The bi-interaction propagation layer of the CF step, forward and
// backward, each one pass over the layer's (n, d) rows:
//   y = drop(leaky((x + s) W1 + b1) + leaky((x * s) W2 + b2))
// with x the layer's input (n, d_in), s its neighbourhood sum (K1's
// output), leaky(z) = where(z >= 0, z, slope z) and drop(y) = where(mask,
// y / keep, 0) for the layer's keep mask (none in evaluation).
//
// Replaces no TPU kernel: kgat_tpu's aggregate (models/kgat.py) leaves the
// arithmetic to XLA, which fuses it around two GEMMs. The port's plain
// path runs it as PyTorch launches over whole tables: the sum and product,
// two float32 GEMMs, two bias adds, two leaky ReLUs of three launches each,
// the dropout's divide and where, the value stream's bf16 cast; and in the
// backward each of these again, with autograd's adds where a tensor has
// several consumers. Some fifty passes of 9-35 MB a layer at Yelp2018
// (136,880 rows): 3.9 of a 4.9-ms CF step on an H100.
//
// What bounds it: neither, closely. The three layers (64 -> 64 -> 32 ->
// 16) move some 278 MB forward and 435 MB backward read or written once
// (0.21 ms at 3.35 TB/s) and make 3.6 GFLOP forward, 10.9 backward with
// the recomputed pre-activations (0.22 ms at 67 TFLOP/s in float32 FMAs).
// Design:
//  * persistent blocks walk tiles of tm rows. A tile's rows (x and s; in
//    the backward also the output gradient's dense pieces; the mask's
//    bytes) land in shared memory by cp.async, the next tile's issued as
//    soon as this one's are taken out of the landing buffers, so the copy
//    runs under the products. Taking them out forms a = x + s and
//    p = x * s (and in the backward the output's gradient g' = mask ?
//    (pieces) / keep : 0, the loss's rows added through the slot map).
//  * products: W1 and W2 staged once a block (zero-padded to multiples of
//    4); each thread owns 4 rows x 4 columns of both products and sums
//    over the reduction with float32 FMAs, operands as float4 (rows
//    interleaved across the warp so that their loads fall in distinct
//    banks).
//  * forward: the biases, both leaky ReLUs and the mask in the epilogue;
//    y in float32 and, for the next layer's K1, its bf16 copy, stored four
//    columns at a time.
//  * backward: the pre-activations again by the forward's products in the
//    forward's order (the same bits); gz1 = g' leaky'(z1), gz2 = g'
//    leaky'(z2) into shared memory; then gz1 W1^T and gz2 W2^T (columns
//    interleaved so the W rows a warp reads fall in distinct banks), whose
//    epilogue writes d_x = ga + gp s in float32 and d_s = ga + gp x in the
//    value stream's dtype for K1's reverse call; and the block's partials
//    of a^T gz1, p^T gz2 (each thread a 4 x 4 tile of both over a slice of
//    the rows, in registers across the block's tiles) and of the bias
//    sums (a column a thread). At the end the slices are summed in order
//    and the block writes its partials; bi_fold_kernel sums the blocks' in
//    block order.
//  * bi_sum_kernel: a gradient or value copy made from pieces, for the
//    table the first layer reads (the embedding's gradient; its bf16 copy
//    for the first K1).
// Products and sums in float32 FMAs (no TF32); every sum in a fixed order,
// no atomics: two calls give the same bits. Widths 1 to 256: up to 64 x
// 64 the weights are staged, wider ones read through the cache; columns
// or rows past what a pass covers idle.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"  // cp_async, cp_async_commit, cp_async_wait_all

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 256;
constexpr int kRedStride = 33;  // a thread's 32 partials, padded

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride of a staged tile whose rows hold w4 floats (a multiple of 4):
// 4 mod 8, so that eight consecutive rows' float4s fall in distinct banks.
__host__ __device__ constexpr int stride_of(int w4) {
  return round_up(w4, 8) + 4;
}

// Row stride, in bytes, of a tile of mask bytes d_out wide.
__host__ __device__ constexpr int mask_stride(int d_out) {
  return round_up(d_out, 16);
}

// Column groups of 4 a pass over an output of `width` columns covers: a
// power of two, at most 16 (64 columns).
__host__ __device__ inline int col_groups(int width) {
  const int need = (width + 3) / 4;
  int cg = 1;
  while (cg < need && cg < 16) cg *= 2;
  return cg;
}

// Rows a pass covers: 4 per row group, kThreads / cg row groups.
__host__ __device__ inline int pass_rows(int width) {
  return 4 * (kThreads / col_groups(width));
}

// This thread's column group and row group in a pass over `width`
// columns: a warp spans min(cg, 8) column groups and 32 / that row groups.
struct Layout {
  int cg, rg, cgi, rgi;
};

__device__ inline Layout layout_for(int width) {
  Layout l;
  l.cg = col_groups(width);
  l.rg = kThreads / l.cg;
  const int cgw = l.cg < 8 ? l.cg : 8, rgw = 32 / cgw, warps_c = l.cg / cgw;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  l.cgi = (w % warps_c) * cgw + lane % cgw;
  l.rgi = (w / warps_c) * rgw + lane / cgw;
  return l;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

struct LayerArgs {
  const float* x;         // (n, d_in)
  const float* s;         // (n, d_in)
  const uint8_t* mask;    // (n, d_out) keep mask, or null
  const float* w1;        // (d_in, d_out)
  const float* b1;        // (d_out,)
  const float* w2;
  const float* b2;
  int n, d_in, d_out, tm, n_tiles;
  int vec_in;    // x, s rows copied as float4
  int vec_out;   // the outputs' (and gradient pieces') rows as float4
  int mask16;    // mask rows copied 16 bytes at a time
  float keep, slope;
};

// The pieces a layer output's gradient arrives in, summed in this order:
// a (n, d) float32 or null, b (n, d) float32 or null (K1's reverse
// output; rounded to bf16 first when b_bf16, as the value stream's
// gradient always was), and the rows of a compact table: row slot[r] (if
// >= 0) of rows, columns col0 .. col0 + d of its rows_stride.
struct Pieces {
  const float* a;
  const float* b;
  const int* slot;
  const float* rows;
  int rows_stride, col0, b_bf16;
};

__device__ __forceinline__ float piece_b(const Pieces& g, float v) {
  return g.b_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Rows r0 .. r0 + tm of the (n, w) float matrix src into shared rows of
// `st` floats, by cp.async (rows past n as zeros; columns past w are left
// as they were). 16-byte copies when `vec`, else 4-byte ones.
__device__ __forceinline__ void copy_rows(float* dst, int st,
                                          const float* __restrict__ src,
                                          int w, int r0, int n, int tm,
                                          bool vec) {
  if (vec) {
    const int q4 = w / 4;
    for (int t = threadIdx.x; t < tm * q4; t += kThreads) {
      const int r = t / q4, q = t % q4, row = r0 + r;
      cp_async<16>(dst + r * st + 4 * q,
                   src + static_cast<size_t>(min(row, n - 1)) * w + 4 * q,
                   row < n);
    }
    return;
  }
  for (int t = threadIdx.x; t < tm * w; t += kThreads) {
    const int r = t / w, k = t % w, row = r0 + r;
    cp_async<4>(dst + r * st + k,
                src + static_cast<size_t>(min(row, n - 1)) * w + k, row < n);
  }
}

// The tile's mask bytes into shared rows of mask_stride(d_out) bytes, by
// cp.async 16 bytes at a time (rows past n as zeros).
__device__ __forceinline__ void copy_mask(uint8_t* dst, const LayerArgs& a,
                                          int r0) {
  const int q16 = a.d_out / 16, ms = mask_stride(a.d_out);
  for (int t = threadIdx.x; t < a.tm * q16; t += kThreads) {
    const int r = t / q16, q = t % q16, row = r0 + r;
    cp_async<16>(reinterpret_cast<float*>(dst + r * ms + 16 * q),
                 reinterpret_cast<const float*>(
                     a.mask + static_cast<size_t>(min(row, a.n - 1)) *
                                  a.d_out + 16 * q),
                 row < a.n);
  }
}

// Mask byte (rl, col) of the tile at r0: from its landing rows, or from
// global memory where the mask is not copied (ragged widths).
__device__ __forceinline__ bool kept(const LayerArgs& a, const uint8_t* sm,
                                     int r0, int rl, int col) {
  if (a.mask16) return sm[rl * mask_stride(a.d_out) + col] != 0;
  return a.mask[static_cast<size_t>(r0 + rl) * a.d_out + col] != 0;
}

// a = x + s and p = x * s from the landing rows rx, rs into sA, sP (all
// of stride sa), rows past nr and columns past d_in zero.
__device__ __forceinline__ void form_ap(const LayerArgs& a, int nr,
                                        const float* rx, const float* rs,
                                        float* sA, float* sP) {
  const int din4 = round_up(a.d_in, 4), sa = stride_of(din4), q4 = din4 / 4;
  for (int t = threadIdx.x; t < a.tm * q4; t += kThreads) {
    const int r = t / q4, k = 4 * (t % q4);
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), pv = av;
    if (r < nr) {
      const float4 xv = *reinterpret_cast<const float4*>(rx + r * sa + k);
      const float4 sv = *reinterpret_cast<const float4*>(rs + r * sa + k);
      float aa[4], pp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k + e < a.d_in;
        aa[e] = in ? comp(xv, e) + comp(sv, e) : 0.f;
        pp[e] = in ? comp(xv, e) * comp(sv, e) : 0.f;
      }
      av = make_float4(aa[0], aa[1], aa[2], aa[3]);
      pv = make_float4(pp[0], pp[1], pp[2], pp[3]);
    }
    *reinterpret_cast<float4*>(sA + r * sa + k) = av;
    *reinterpret_cast<float4*>(sP + r * sa + k) = pv;
  }
}

// W (d_in x d_out, row-major) into shared rows of stride_of(dout4) floats,
// zero-padded to din4 x dout4.
__device__ void stage_w(const float* __restrict__ w, float* sw, int d_in,
                        int d_out) {
  const int din4 = round_up(d_in, 4), dout4 = round_up(d_out, 4);
  const int ws = stride_of(dout4);
  for (int t = threadIdx.x; t < din4 * dout4; t += kThreads) {
    const int k = t / dout4, c = t % dout4;
    sw[k * ws + c] = (k < d_in && c < d_out)
                         ? w[static_cast<size_t>(k) * d_out + c] : 0.f;
  }
}

// W[k][c .. c + 4): from the staged rows, or through the cache (columns
// and rows past the weight's read as 0).
template <bool kStaged>
__device__ __forceinline__ float4 w_row4(const float* w, int k, int c,
                                         int d_in, int d_out, int ws) {
  if (kStaged) return *reinterpret_cast<const float4*>(w + k * ws + c);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (k < d_in && c + j < d_out)
               ? __ldg(w + static_cast<size_t>(k) * d_out + c + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// W[c][k .. k + 4): row c of W read along its columns (W^T's column c).
template <bool kStaged>
__device__ __forceinline__ float4 w_col4(const float* w, int c, int k,
                                         int d_in, int d_out, int ws) {
  if (kStaged) return *reinterpret_cast<const float4*>(w + c * ws + k);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = (c < d_in && k + j < d_out)
               ? __ldg(w + static_cast<size_t>(c) * d_out + k + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// b[c .. c + 4), 0 past d_out.
__device__ __forceinline__ float4 bias4(const float* __restrict__ b, int c,
                                        int d_out) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < d_out ? b[c + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// acc1 = A W1 and acc2 = P W2 for this thread's rows rr (tile rows, within
// the staged tile) and columns c .. c + 4, summed over k in order.
template <bool kStaged>
__device__ __forceinline__ void products(const float* sA, const float* sP,
                                         int sa, const int rr[4],
                                         const float* w1, const float* w2,
                                         int ws, int c, int d_in, int d_out,
                                         float acc1[4][4], float acc2[4][4]) {
  const int din4 = round_up(d_in, 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  for (int k = 0; k < din4; k += 4) {
    float4 av[4], pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(sA + rr[i] * sa + k);
      pv[i] = *reinterpret_cast<const float4*>(sP + rr[i] * sa + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 u = w_row4<kStaged>(w1, k + kk, c, d_in, d_out, ws);
      const float4 v = w_row4<kStaged>(w2, k + kk, c, d_in, d_out, ws);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(av[i], kk), pi = comp(pv[i], kk);
        acc1[i][0] = fmaf(ai, u.x, acc1[i][0]);
        acc1[i][1] = fmaf(ai, u.y, acc1[i][1]);
        acc1[i][2] = fmaf(ai, u.z, acc1[i][2]);
        acc1[i][3] = fmaf(ai, u.w, acc1[i][3]);
        acc2[i][0] = fmaf(pi, v.x, acc2[i][0]);
        acc2[i][1] = fmaf(pi, v.y, acc2[i][1]);
        acc2[i][2] = fmaf(pi, v.z, acc2[i][2]);
        acc2[i][3] = fmaf(pi, v.w, acc2[i][3]);
      }
    }
  }
}

// acc += G[rr][k .. k + 4) W[cc][k .. k + 4)^T: four steps of G W^T for
// this thread's rows rr and (interleaved) columns cc.
template <bool kStaged>
__device__ __forceinline__ void transposed(const float* sG, int sg,
                                           const int rr[4], const float* w,
                                           int ws, const int cc[4], int k,
                                           int d_in, int d_out,
                                           float acc[4][4]) {
  float4 gv[4], wv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    gv[i] = *reinterpret_cast<const float4*>(sG + rr[i] * sg + k);
    wv[i] = w_col4<kStaged>(w, cc[i], k, d_in, d_out, ws);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gi = comp(gv[i], kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = fmaf(gi, comp(wv[j], kk), acc[i][j]);
    }
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

// Dynamic shared memory above the default 48 KB needs the kernel's leave.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The forward's shared memory: the staged weights, x and s's landing rows,
// a and p, and the mask's landing and working bytes.
struct FwdSmem {
  float *w1, *w2, *rx, *rs, *sA, *sP;
  uint8_t *rm, *wm;
};

__device__ FwdSmem fwd_smem_of(float* base, const LayerArgs& a,
                               bool staged) {
  const int din4 = round_up(a.d_in, 4), dout4 = round_up(a.d_out, 4);
  const int sa = stride_of(din4), ws = stride_of(dout4);
  const int tile = a.tm * sa, mbytes = a.tm * mask_stride(a.d_out);
  FwdSmem m;
  m.w1 = base;
  m.w2 = m.w1 + (staged ? din4 * ws : 0);
  m.rx = m.w2 + (staged ? din4 * ws : 0);
  m.rs = m.rx + tile;
  m.sA = m.rs + tile;
  m.sP = m.sA + tile;
  m.rm = reinterpret_cast<uint8_t*>(m.sP + tile);
  m.wm = m.rm + mbytes;
  return m;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
bi_fwd_kernel(LayerArgs a, float* __restrict__ y,
              __nv_bfloat16* __restrict__ yv) {
  extern __shared__ float4 fwd_smem[];
  const int din4 = round_up(a.d_in, 4), dout4 = round_up(a.d_out, 4);
  const int sa = stride_of(din4), ws = stride_of(dout4);
  const int ms = mask_stride(a.d_out);
  const FwdSmem m = fwd_smem_of(reinterpret_cast<float*>(fwd_smem), a,
                                kStaged);
  const bool copy_mask_rows = a.mask && a.mask16;
  auto issue = [&](int tile) {
    const int r0 = tile * a.tm;
    copy_rows(m.rx, sa, a.x, a.d_in, r0, a.n, a.tm, a.vec_in);
    copy_rows(m.rs, sa, a.s, a.d_in, r0, a.n, a.tm, a.vec_in);
    if (copy_mask_rows) copy_mask(m.rm, a, r0);
    cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < a.n_tiles) issue(blockIdx.x);
  if (kStaged) {
    stage_w(a.w1, m.w1, a.d_in, a.d_out);
    stage_w(a.w2, m.w2, a.d_in, a.d_out);
  }
  const float* w1 = kStaged ? m.w1 : a.w1;
  const float* w2 = kStaged ? m.w2 : a.w2;
  const Layout l = layout_for(a.d_out);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * a.tm, nr = min(a.tm, a.n - r0);
    cp_async_wait_all();
    __syncthreads();  // the tile landed; the previous tile's epilogue done
    form_ap(a, nr, m.rx, m.rs, m.sA, m.sP);
    if (copy_mask_rows)
      for (int t = threadIdx.x; t < a.tm * ms / 16; t += kThreads)
        reinterpret_cast<float4*>(m.wm)[t] =
            reinterpret_cast<const float4*>(m.rm)[t];
    __syncthreads();  // the landing rows are free
    if (tile + static_cast<int>(gridDim.x) < a.n_tiles)
      issue(tile + gridDim.x);
    for (int rp = 0; rp < a.tm; rp += 4 * l.rg) {
      for (int cp = 0; cp < dout4; cp += 4 * l.cg) {
        const int c = cp + 4 * l.cgi;
        if (c >= dout4) continue;
        int rr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rr[i] = min(rp + l.rgi + l.rg * i, a.tm - 1);
        const float4 bb1 = bias4(a.b1, c, a.d_out);
        const float4 bb2 = bias4(a.b2, c, a.d_out);
        float acc1[4][4], acc2[4][4];
        products<kStaged>(m.sA, m.sP, sa, rr, w1, w2, ws, c, a.d_in,
                          a.d_out, acc1, acc2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = rp + l.rgi + l.rg * i;
          if (rl >= nr) continue;
          const size_t base = static_cast<size_t>(r0 + rl) * a.d_out;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = leaky(acc1[i][j] + comp(bb1, j), a.slope) +
                   leaky(acc2[i][j] + comp(bb2, j), a.slope);
            if (a.mask && c + j < a.d_out)
              v[j] = kept(a, m.wm, r0, rl, c + j) ? v[j] / a.keep : 0.f;
          }
          if (a.vec_out) {
            *reinterpret_cast<float4*>(y + base + c) =
                make_float4(v[0], v[1], v[2], v[3]);
            if (yv) {
              __nv_bfloat16 h[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(v[j]);
              *reinterpret_cast<uint2*>(yv + base + c) =
                  *reinterpret_cast<const uint2*>(h);
            }
            continue;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + j >= a.d_out) continue;
            y[base + c + j] = v[j];
            if (yv) yv[base + c + j] = __float2bfloat16_rn(v[j]);
          }
        }
      }
    }
  }
}

// The backward's shared memory: the staged weights, two buffers of x and
// s's landing rows (phase two reads a tile's while the next lands), the
// gradient pieces' landing rows, the slot map's and the mask's, a and p,
// gz1 and gz2.
struct BwdSmem {
  float *w1, *w2, *rx[2], *rs[2], *ga, *gb, *sA, *sP, *sG1, *sG2;
  int* slot;
  uint8_t* rm;
};

__device__ BwdSmem bwd_smem_of(float* base, const LayerArgs& a,
                               bool staged) {
  const int din4 = round_up(a.d_in, 4), dout4 = round_up(a.d_out, 4);
  const int sa = stride_of(din4), ws = stride_of(dout4), sg = ws;
  const int tile = a.tm * sa, gtile = a.tm * sg;
  BwdSmem m;
  m.w1 = base;
  m.w2 = m.w1 + (staged ? din4 * ws : 0);
  m.rx[0] = m.w2 + (staged ? din4 * ws : 0);
  m.rs[0] = m.rx[0] + tile;
  m.rx[1] = m.rs[0] + tile;
  m.rs[1] = m.rx[1] + tile;
  m.sA = m.rs[1] + tile;
  m.sP = m.sA + tile;
  m.ga = m.sP + tile;
  m.gb = m.ga + gtile;
  m.sG1 = m.gb + gtile;
  m.sG2 = m.sG1 + gtile;
  m.slot = reinterpret_cast<int*>(m.sG2 + gtile);
  m.rm = reinterpret_cast<uint8_t*>(m.slot + a.tm);
  return m;
}

// acc1 += a[r][i0 ..] gz1[r][j0 ..]^T and acc2 += p[r][i0 ..] gz2[r][j0 ..]^T:
// row r's share of a 4 x 4 tile of the weights' gradients.
__device__ __forceinline__ void outer_row(const BwdSmem& m, int sa, int sg,
                                          int r, int i0, int j0,
                                          float acc1[4][4],
                                          float acc2[4][4]) {
  const float4 av = *reinterpret_cast<const float4*>(m.sA + r * sa + i0);
  const float4 pv = *reinterpret_cast<const float4*>(m.sP + r * sa + i0);
  const float4 u = *reinterpret_cast<const float4*>(m.sG1 + r * sg + j0);
  const float4 v = *reinterpret_cast<const float4*>(m.sG2 + r * sg + j0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc1[i][j] = fmaf(comp(av, i), comp(u, j), acc1[i][j]);
      acc2[i][j] = fmaf(comp(pv, i), comp(v, j), acc2[i][j]);
    }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
bi_bwd_kernel(LayerArgs a, Pieces g, float* __restrict__ dx,
              void* __restrict__ ds, int ds_bf16,
              float* __restrict__ partials) {
  extern __shared__ float4 bwd_smem[];
  const int din4 = round_up(a.d_in, 4), dout4 = round_up(a.d_out, 4);
  const int sa = stride_of(din4), ws = stride_of(dout4), sg = ws;
  const BwdSmem m = bwd_smem_of(reinterpret_cast<float*>(bwd_smem), a,
                                kStaged);
  const bool copy_mask_rows = a.mask && a.mask16;
  auto issue = [&](int tile, int buf) {
    const int r0 = tile * a.tm;
    copy_rows(m.rx[buf], sa, a.x, a.d_in, r0, a.n, a.tm, a.vec_in);
    copy_rows(m.rs[buf], sa, a.s, a.d_in, r0, a.n, a.tm, a.vec_in);
    if (g.a) copy_rows(m.ga, sg, g.a, a.d_out, r0, a.n, a.tm, a.vec_out);
    if (g.b) copy_rows(m.gb, sg, g.b, a.d_out, r0, a.n, a.tm, a.vec_out);
    if (g.slot)
      copy_rows(reinterpret_cast<float*>(m.slot), 1,
                reinterpret_cast<const float*>(g.slot), 1, r0, a.n, a.tm,
                false);
    if (copy_mask_rows) copy_mask(m.rm, a, r0);
    cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < a.n_tiles) issue(blockIdx.x, 0);
  if (kStaged) {
    stage_w(a.w1, m.w1, a.d_in, a.d_out);
    stage_w(a.w2, m.w2, a.d_in, a.d_out);
  }
  const float* w1 = kStaged ? m.w1 : a.w1;
  const float* w2 = kStaged ? m.w2 : a.w2;
  const size_t n_w = static_cast<size_t>(a.d_in) * a.d_out;
  const size_t n_part = 2 * n_w + 2 * a.d_out;
  float* part = partials + blockIdx.x * n_part;
  // The weight gradients' tiles: m3 of 4 x 4, each summed by `slices`
  // threads over interleaved rows, in registers across the block's tiles;
  // more tiles than threads take passes that add into the block's slot.
  const int jq = dout4 / 4, m3 = (din4 / 4) * jq;
  const bool one_pass = m3 <= kThreads;
  const int slices = one_pass ? kThreads / m3 : 1;
  const int m_own = threadIdx.x % m3, s_own = threadIdx.x / m3;
  float accw1[4][4] = {}, accw2[4][4] = {};
  float accb[2] = {0.f, 0.f};  // bias columns threadIdx.x, + kThreads
  const Layout l1 = layout_for(a.d_out), l2 = layout_for(a.d_in);
  int buf = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int r0 = tile * a.tm, nr = min(a.tm, a.n - r0);
    cp_async_wait_all();
    __syncthreads();  // the tile landed; the previous tile's phases done
    form_ap(a, nr, m.rx[buf], m.rs[buf], m.sA, m.sP);
    // The output's gradient g' into sG1: the pieces, the mask and keep.
    for (int t = threadIdx.x; t < a.tm * dout4; t += kThreads) {
      const int r = t / dout4, c = t % dout4;
      float v = 0.f;
      if (r < nr && c < a.d_out) {
        if (g.a) v += m.ga[r * sg + c];
        if (g.b) v += piece_b(g, m.gb[r * sg + c]);
        const int sl = g.slot ? m.slot[r] : -1;
        if (sl >= 0)
          v += g.rows[static_cast<size_t>(sl) * g.rows_stride + g.col0 + c];
        if (a.mask) v = kept(a, m.rm, r0, r, c) ? v / a.keep : 0.f;
      }
      m.sG1[r * sg + c] = v;
    }
    __syncthreads();  // the landing rows of the pieces and mask are free
    if (tile + static_cast<int>(gridDim.x) < a.n_tiles)
      issue(tile + gridDim.x, buf ^ 1);
    // The pre-activations again, and their gradients into sG1, sG2.
    for (int rp = 0; rp < a.tm; rp += 4 * l1.rg) {
      for (int cp = 0; cp < dout4; cp += 4 * l1.cg) {
        const int c = cp + 4 * l1.cgi;
        if (c >= dout4) continue;
        int rr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rr[i] = min(rp + l1.rgi + l1.rg * i, a.tm - 1);
        const float4 bb1 = bias4(a.b1, c, a.d_out);
        const float4 bb2 = bias4(a.b2, c, a.d_out);
        float acc1[4][4], acc2[4][4];
        products<kStaged>(m.sA, m.sP, sa, rr, w1, w2, ws, c, a.d_in,
                          a.d_out, acc1, acc2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = rp + l1.rgi + l1.rg * i;
          if (rl >= a.tm) continue;
          float4* p1 = reinterpret_cast<float4*>(m.sG1 + rl * sg + c);
          float4* p2 = reinterpret_cast<float4*>(m.sG2 + rl * sg + c);
          const float4 gy = *p1;
          float g1[4], g2[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = comp(gy, j);
            g1[j] = acc1[i][j] + comp(bb1, j) >= 0.f ? v : a.slope * v;
            g2[j] = acc2[i][j] + comp(bb2, j) >= 0.f ? v : a.slope * v;
          }
          *p1 = make_float4(g1[0], g1[1], g1[2], g1[3]);
          *p2 = make_float4(g2[0], g2[1], g2[2], g2[3]);
        }
      }
    }
    __syncthreads();
    // d_x and d_s: gz1 W1^T and gz2 W2^T, columns interleaved.
    const float* rx = m.rx[buf];
    const float* rs = m.rs[buf];
    for (int rp = 0; rp < a.tm; rp += 4 * l2.rg) {
      for (int cp = 0; cp < din4; cp += 4 * l2.cg) {
        int rr[4], cc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = min(rp + l2.rgi + l2.rg * i, a.tm - 1);
          cc[i] = min(cp + l2.cgi + l2.cg * i, din4 - 1);
        }
        float acc1[4][4] = {}, acc2[4][4] = {};
        for (int k = 0; k < dout4; k += 4) {
          transposed<kStaged>(m.sG1, sg, rr, w1, ws, cc, k, a.d_in, a.d_out,
                              acc1);
          transposed<kStaged>(m.sG2, sg, rr, w2, ws, cc, k, a.d_in, a.d_out,
                              acc2);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rl = rp + l2.rgi + l2.rg * i;
          if (rl >= nr) continue;
          const size_t base = static_cast<size_t>(r0 + rl) * a.d_in;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = cp + l2.cgi + l2.cg * j;
            if (col >= a.d_in) continue;
            const float xv = rx[rl * sa + col], sv = rs[rl * sa + col];
            dx[base + col] = acc1[i][j] + acc2[i][j] * sv;
            const float dsv = acc1[i][j] + acc2[i][j] * xv;
            if (ds_bf16)
              static_cast<__nv_bfloat16*>(ds)[base + col] =
                  __float2bfloat16_rn(dsv);
            else
              static_cast<float*>(ds)[base + col] = dsv;
          }
        }
      }
    }
    // The weights' partials: a^T gz1 and p^T gz2 over the tile's rows.
    if (one_pass) {
      if (s_own < slices) {
        const int i0 = 4 * (m_own / jq), j0 = 4 * (m_own % jq);
        for (int r = s_own; r < nr; r += slices)
          outer_row(m, sa, sg, r, i0, j0, accw1, accw2);
      }
    } else {
      for (int mm = threadIdx.x; mm < m3; mm += kThreads) {
        const int i0 = 4 * (mm / jq), j0 = 4 * (mm % jq);
        float t1[4][4] = {}, t2[4][4] = {};
        for (int r = 0; r < nr; ++r) outer_row(m, sa, sg, r, i0, j0, t1, t2);
        const bool first = tile == static_cast<int>(blockIdx.x);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (i0 + i >= a.d_in || j0 + j >= a.d_out) continue;
            const size_t o = static_cast<size_t>(i0 + i) * a.d_out + j0 + j;
            part[o] = first ? t1[i][j] : part[o] + t1[i][j];
            part[n_w + o] = first ? t2[i][j] : part[n_w + o] + t2[i][j];
          }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = threadIdx.x + t * kThreads;
      if (q >= 2 * a.d_out) continue;
      const float* col = (q < a.d_out ? m.sG1 : m.sG2) + q % a.d_out;
      float sum = 0.f;
      for (int r = 0; r < nr; ++r) sum += col[r * sg];
      accb[t] += sum;
    }
    buf ^= 1;
  }
  // The block's partials: the slices of each tile summed in slice order.
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int q = threadIdx.x + t * kThreads;
    if (q < 2 * a.d_out) part[2 * n_w + q] = accb[t];
  }
  if (!one_pass) return;
  __syncthreads();  // every tile's shared rows read
  float* red = reinterpret_cast<float*>(bwd_smem);
  if (s_own < slices) {
    float* mine = red + (s_own * m3 + m_own) * kRedStride;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mine[4 * i + j] = accw1[i][j];
        mine[16 + 4 * i + j] = accw2[i][j];
      }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < m3 * 32; o += kThreads) {
    const int mm = o / 32, e = o % 32;
    float sum = 0.f;
    for (int s = 0; s < slices; ++s) sum += red[(s * m3 + mm) * kRedStride + e];
    const int row = 4 * (mm / jq) + (e % 16) / 4, col = 4 * (mm % jq) + e % 4;
    if (row < a.d_in && col < a.d_out)
      part[(e < 16 ? 0 : n_w) + static_cast<size_t>(row) * a.d_out + col] =
          sum;
  }
}

// out[o] = the sum over the n_blocks partial slots, in block order.
__global__ void __launch_bounds__(kThreads)
bi_fold_kernel(const float* __restrict__ partials, int n_blocks, int width,
               float* __restrict__ out) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= width) return;
  float sum = 0.f;
  for (int b = 0; b < n_blocks; ++b)
    sum += partials[static_cast<size_t>(b) * width + o];
  out[o] = sum;
}

__global__ void __launch_bounds__(kThreads)
bi_sum_kernel(Pieces g, long long n, int d, float* __restrict__ out,
              __nv_bfloat16* __restrict__ out16) {
  const long long total = n * d;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = e / d;
    const int col = static_cast<int>(e % d);
    float v = 0.f;
    if (g.a) v += g.a[e];
    if (g.b) v += piece_b(g, g.b[e]);
    const int sl = g.slot ? g.slot[row] : -1;
    if (sl >= 0)
      v += g.rows[static_cast<size_t>(sl) * g.rows_stride + g.col0 + col];
    if (out16)
      out16[e] = __float2bfloat16_rn(v);
    else
      out[e] = v;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether the weights fit staged beside the tiles.
bool staged(int d_in, int d_out) {
  return 2 * sizeof(float) * round_up(d_in, 4) *
             stride_of(round_up(d_out, 4)) <= 64 * 1024;
}

// Shared bytes of a tile of tm rows (FwdSmem, BwdSmem; in the backward at
// least the slices' reduction buffer).
size_t smem_bytes(int d_in, int d_out, int tm, bool bwd) {
  const int din4 = round_up(d_in, 4), dout4 = round_up(d_out, 4);
  const size_t tile = static_cast<size_t>(tm) * stride_of(din4);
  const size_t gtile = static_cast<size_t>(tm) * stride_of(dout4);
  const size_t w = staged(d_in, d_out) ? 2 * din4 * stride_of(dout4) : 0;
  const size_t mbytes = static_cast<size_t>(tm) * mask_stride(d_out);
  if (!bwd) return (w + 4 * tile) * sizeof(float) + 2 * mbytes;
  size_t floats = w + 6 * tile + 4 * gtile + tm;
  const size_t red = static_cast<size_t>(kThreads) * kRedStride;
  if (floats < red) floats = red;
  return floats * sizeof(float) + mbytes;
}

// Two forward blocks an SM, one backward block (its weights' partials stay
// in registers): each within its share of the SM's 228 KB.
size_t smem_budget(bool bwd) { return (bwd ? 224 : 112) * 1024; }

// The largest tile, in rows, from the rows a pass covers down, whose
// shared memory fits the budget.
int tile_rows(int d_in, int d_out, bool bwd) {
  int tm = pass_rows(d_out);
  if (bwd && pass_rows(d_in) > tm) tm = pass_rows(d_in);
  while (tm > 4 && smem_bytes(d_in, d_out, tm, bwd) > smem_budget(bwd))
    tm /= 2;
  return tm;
}

bool widths_ok(int d_in, int d_out) {
  return d_in >= 1 && d_out >= 1 && d_in <= kMaxWidth && d_out <= kMaxWidth;
}

LayerArgs layer_args(const void* x, const void* s, const void* mask,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, int n, int d_in, int d_out, float keep,
                     float slope, int tm) {
  LayerArgs a;
  a.x = static_cast<const float*>(x);
  a.s = static_cast<const float*>(s);
  a.mask = static_cast<const uint8_t*>(mask);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.n = n;
  a.d_in = d_in;
  a.d_out = d_out;
  a.tm = tm;
  a.n_tiles = (n + tm - 1) / tm;
  a.vec_in = d_in % 4 == 0 && aligned(x, 16) && aligned(s, 16);
  a.vec_out = d_out % 4 == 0;
  a.mask16 = d_out % 16 == 0 && aligned(mask, 16);
  a.keep = keep;
  a.slope = slope;
  return a;
}

}  // namespace

// The partial slots the backward writes: min(max_grid, its tiles), each
// of 2 d_in d_out + 2 d_out floats. Returns -1 for widths it refuses.
extern "C" int kgat_bi_layer_blocks(int n, int d_in, int d_out,
                                    int max_grid) {
  if (!widths_ok(d_in, d_out) || n <= 0 || max_grid <= 0) return -1;
  const int tm = tile_rows(d_in, d_out, true);
  const int tiles = (n + tm - 1) / tm;
  return tiles < max_grid ? tiles : max_grid;
}

// x, s: (n, d_in) float32; mask: (n, d_out) bool or null; w1, w2:
// (d_in, d_out), b1, b2: (d_out,) float32; y: (n, d_out) float32; yv:
// (n, d_out) bfloat16 or null. keep = 1 - rate. With d_out a multiple of
// 4, y and yv must be 16- and 8-byte aligned.
extern "C" int kgat_bi_layer_fwd(const void* x, const void* s,
                                 const void* mask, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, int n, int d_in, int d_out,
                                 float keep, float slope, void* y, void* yv,
                                 int max_grid, void* stream) {
  if (!widths_ok(d_in, d_out) || n <= 0 || max_grid <= 0)
    return cudaErrorInvalidValue;
  const int tm = tile_rows(d_in, d_out, false);
  const LayerArgs a = layer_args(x, s, mask, w1, b1, w2, b2, n, d_in, d_out,
                                 keep, slope, tm);
  if (a.vec_out && (!aligned(y, 16) || !aligned(yv, 8)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d_in, d_out, tm, false);
  const int grid = a.n_tiles < max_grid ? a.n_tiles : max_grid;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (staged(d_in, d_out)) {
    err = allow_smem(bi_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    bi_fwd_kernel<true><<<grid, kThreads, smem, st>>>(
        a, static_cast<float*>(y), static_cast<__nv_bfloat16*>(yv));
  } else {
    err = allow_smem(bi_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    bi_fwd_kernel<false><<<grid, kThreads, smem, st>>>(
        a, static_cast<float*>(y), static_cast<__nv_bfloat16*>(yv));
  }
  return cudaGetLastError();
}

// The forward's inputs; the output's gradient as pieces ga, gb ((n, d_out)
// float32, either null; 16-byte aligned when d_out is a multiple of 4; gb
// rounded to bf16 first when b_bf16) and rows[slot[r] * rows_stride +
// col0 ..] (slot (n,) int32 or null); dx:
// (n, d_in) float32; ds: (n, d_in) bfloat16 when ds_bf16, else float32;
// partials: kgat_bi_layer_blocks slots; grads: (2 d_in d_out + 2 d_out,)
// float32: d w1, d w2, d b1, d b2.
extern "C" int kgat_bi_layer_bwd(const void* x, const void* s,
                                 const void* mask, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, const void* ga,
                                 const void* gb, const void* slot,
                                 const void* rows, int rows_stride, int col0,
                                 int b_bf16, int n, int d_in, int d_out,
                                 float keep,
                                 float slope, void* dx, void* ds, int ds_bf16,
                                 void* partials, void* grads, int max_grid,
                                 void* stream) {
  const int grid = kgat_bi_layer_blocks(n, d_in, d_out, max_grid);
  if (grid <= 0 || (slot && !rows)) return cudaErrorInvalidValue;
  const int tm = tile_rows(d_in, d_out, true);
  const LayerArgs a = layer_args(x, s, mask, w1, b1, w2, b2, n, d_in, d_out,
                                 keep, slope, tm);
  if (a.vec_out && (!aligned(ga, 16) || !aligned(gb, 16)))
    return cudaErrorInvalidValue;
  Pieces g;
  g.a = static_cast<const float*>(ga);
  g.b = static_cast<const float*>(gb);
  g.slot = static_cast<const int*>(slot);
  g.rows = static_cast<const float*>(rows);
  g.rows_stride = rows_stride;
  g.col0 = col0;
  g.b_bf16 = b_bf16;
  const size_t smem = smem_bytes(d_in, d_out, tm, true);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<float*>(partials);
  cudaError_t err;
  if (staged(d_in, d_out)) {
    err = allow_smem(bi_bwd_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    bi_bwd_kernel<true><<<grid, kThreads, smem, st>>>(
        a, g, static_cast<float*>(dx), ds, ds_bf16, p);
  } else {
    err = allow_smem(bi_bwd_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    bi_bwd_kernel<false><<<grid, kThreads, smem, st>>>(
        a, g, static_cast<float*>(dx), ds, ds_bf16, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = 2 * d_in * d_out + 2 * d_out;
  bi_fold_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      p, grid, width, static_cast<float*>(grads));
  return cudaGetLastError();
}

// out (n, d) = ga + gb + rows[slot[r] * rows_stride + col0 ..], each piece
// optional as in kgat_bi_layer_bwd; float32, or bfloat16 when out_bf16.
extern "C" int kgat_bi_sum(const void* ga, const void* gb, const void* slot,
                           const void* rows, int rows_stride, int col0,
                           int b_bf16, long long n, int d, void* out,
                           int out_bf16, int max_grid, void* stream) {
  if (n <= 0 || d <= 0 || max_grid <= 0 || (slot && !rows))
    return cudaErrorInvalidValue;
  Pieces g;
  g.a = static_cast<const float*>(ga);
  g.b = static_cast<const float*>(gb);
  g.slot = static_cast<const int*>(slot);
  g.rows = static_cast<const float*>(rows);
  g.rows_stride = rows_stride;
  g.col0 = col0;
  g.b_bf16 = b_bf16;
  const long long blocks = (n * d + kThreads - 1) / kThreads;
  const int grid = blocks < max_grid ? static_cast<int>(blocks) : max_grid;
  bi_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, n, d, out_bf16 ? nullptr : static_cast<float*>(out),
      out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr);
  return cudaGetLastError();
}
