// K4: the backward of K2 (TransR attention SDDMM). Given the cotangent g
// of every edge's logit pi = (W_r e_t) . tanh(W_r e_h + e_r), with head
// h = dst and tail t = src, it writes
//   d_emb (n_nodes, d)  = sum over edges headed by v of d_eh + sum over
//                         edges with tail v of d_et,
//   d_W   (R, d, k)     = sum over edges of relation r of
//                         e_h^T d_ph + e_t^T d_pt,
//   d_e_r (R, k)        = sum over edges of relation r of d_ph,
// where ph = e_h W_r, pt = e_t W_r, s = tanh(ph + e_r), d_pt = g s,
// d_ph = g pt (1 - s^2), d_eh = d_ph W_r^T and d_et = d_pt W_r^T.
//
// Replaces kgat_tpu/ops/pallas/sddmm.py::_bwd_kernel (sddmm_transr_bwd).
// The TPU kernel walks the relation tiles in order on one core and adds
// each tile's d_W into an output block it revisits, and leaves the per-edge
// rows to XLA's scatter. Blocks of a GPU run in no order, so the port
// splits the work, with no float atomic anywhere, so that two calls are
// bit-identical:
//   1. one block per relation tile (<= 256 edges of one relation, as in
//      K2): the six products of each edge on the tensor cores, d_eh and
//      d_et written per edge into canonical slots, the tile's d_W and
//      d_e_r summed in edge order into a per-tile partial;
//   2. one thread per entry of d_W / d_e_r: the relation's tile partials
//      summed in tile order (tiles of a relation are consecutive);
//   3. the fold, d_emb, on the CSR row reduction of row_reduce.cuh: the
//      d_eh stream over the forward CSR's work units (Graph.split), then
//      d_et gathered through rev_perm over the reverse CSR's units
//      (Graph.rev_split), added into d_emb. A split row's units write
//      partials that a second launch sums in unit order, so no row, the
//      hub's 70,884 head and tail edges included, runs on one warp.
//
// What bounds it on the H100: operations. 12 d k flops an edge (the two
// projections, d_ph W^T and d_pt W^T, the two outer products of d_W):
// 219 GFLOP at yelp2018 scale, 3.3 ms on the float32 FMA units; in three
// TF32 passes on the tensor cores (495 TFLOP/s) 1.33 ms. The d_eh/d_et
// rows written by step 1 and read back by step 3 (4.6 GB there, ~1.4 ms
// of HBM time) are the design's own cost, not the function's.
//
// Design of step 1, K2's arithmetic three times over (csrc/sddmm.cu):
//  * Every product runs on mma.sync m16n8k8 in three TF32 passes,
//    a_lo b_hi + a_hi b_lo + a_hi b_hi, hi = tf32(x), lo = x - hi. The
//    tensor cores add an MMA into its accumulator with truncation, so each
//    8-wide step of a reduction runs its passes from a zero accumulator and
//    a rounding FADD adds the step into the sum: the 8 d-steps of a
//    projection, the 8 k-steps of d_eh, and d_W's 8-edge steps over the
//    tile.
//  * W_r is staged once per tile, split into hi and lo, in two fragment
//    orders: as the B operand of x W (projections) and of d_p W^T (d_eh,
//    d_et), one 16-byte load a lane and fragment. Widths are zero-padded
//    (d to 16, k to 8; exact), so every width the wrapper takes runs.
//  * A warp takes 16 edges at a time (the MMA's M), a round of the block
//    one group a warp: cp.async gathers the group's head and tail rows
//    into the warp's stage. Phase A forms the projections (k in chunks of
//    64 columns) and the epilogue in registers (the accurate tanhf), and
//    writes d_ph and d_pt into the warp's shared rows and the group's
//    column sums of d_ph (a shuffle tree) for d_e_r; phase B multiplies
//    d_ph and d_pt by W_r^T (d in chunks of 64) and stores d_eh and d_et.
//  * Phase C, after a block barrier: d_W += e_h^T d_ph + e_t^T d_pt over
//    the round's edges. d_W's running sums stay in shared memory, in
//    fragment order, cut into work items of 2 x 2 MMA tiles that the
//    warps take in turn; a warp reads every warp's staged rows as A (e^T,
//    M = d) and their d_p rows as B. The sums run over the tile's edges
//    in order, so the result does not depend on the number of warps.
//  * The block is as many warps as shared memory holds, at most eight:
//    at d = k = 64 both W_r orders (64 KB), d_W's sums (16 KB) and eight
//    warps' stages and d_p rows (228 KB in all), one block a SM. On the
//    H100 (PERF.md) eight warps beat four or five that each had a second
//    stage buffer for the next round's copies, and the backward order's
//    16-byte loads made the tile kernel 5% faster than four scalar loads
//    from the forward order. The widest shapes (d * k up to 8,192) drop
//    the backward order where that fits more warps, and read W_r^T's
//    fragments from the forward one.
//  * Row strides of the stage and of the d_p rows are 4 mod 32 words, so
//    the scalar fragment loads of all three phases meet no bank conflict:
//    lanes (gid, tig) read word 4 gid + tig (phases A and B) or
//    8 tig + gid (phase C, whose 8-wide K order takes logical columns t
//    and t + 4 from rows 2t and 2t + 1).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_reduce.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 256;       // edges staged per pass of a tile
constexpr int kMaxWarps = 8;
constexpr int kNT = 8;           // n-tiles per chunk in phases A and B
constexpr int kMC = 2;           // d_W m-tiles of a phase C work item
constexpr int kNC = 2;           // d_W n-tiles of a phase C work item
constexpr int kBatch = 8;        // W_r values a thread loads at once
constexpr int kSmemBudget = 227 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// One 8-wide reduction step of two products sharing their B operands,
// x b_nt and y b_nt for the n-tiles nt < n (warp-uniform), in three passes
// from zero (the small terms first), each pass over every n-tile before
// the next (2 n independent MMAs between dependent ones); then a rounding
// add of each step into its sum. b[nt] is {b0 hi, b1 hi, b0 lo, b1 lo}.
template <int NT>
__device__ __forceinline__ void step3(float (&sx)[NT][4], float (&sy)[NT][4],
                                      const uint32_t (&xh)[4],
                                      const uint32_t (&xl)[4],
                                      const uint32_t (&yh)[4],
                                      const uint32_t (&yl)[4],
                                      const float4 (&b)[NT], int n) {
  float tx[NT][4], ty[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n) {
      const uint32_t h0 = __float_as_uint(b[nt].x), h1 = __float_as_uint(b[nt].y);
      mma_zero(tx[nt], xl, h0, h1);
      mma_zero(ty[nt], yl, h0, h1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n) {
      const uint32_t l0 = __float_as_uint(b[nt].z), l1 = __float_as_uint(b[nt].w);
      mma(tx[nt], xh, l0, l1);
      mma(ty[nt], yh, l0, l1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n) {
      const uint32_t h0 = __float_as_uint(b[nt].x), h1 = __float_as_uint(b[nt].y);
      mma(tx[nt], xh, h0, h1);
      mma(ty[nt], yh, h0, h1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sx[nt][i] += tx[nt][i];
        sy[nt][i] += ty[nt][i];
      }
    }
  }
}

// Shared memory of a block: the fixed part, then a region per warp (see
// plan()).
struct Layout {
  int dp;       // d rounded up to 16 (d_W's m-tiles)
  int kp;       // k rounded up to 8
  int s_row;    // words per staged edge row, 4 mod 32
  int s_k;      // words per d_p row, 4 mod 32
  int two_w;    // 1: W_r also staged in the backward order

  __host__ __device__ size_t w_floats() const {   // one fragment order
    return static_cast<size_t>(dp) * kp * 2;       // hi and lo
  }
  __host__ __device__ size_t zero_floats() const {
    // W_r, d_W's sums, e_r, d_e_r's sums: zeroed before a tile.
    return (1 + two_w) * w_floats() + static_cast<size_t>(dp) * kp + 2 * kp;
  }
  __host__ __device__ size_t fixed_floats() const {
    // Then the tile's edge ids, heads, tails and cotangents.
    return zero_floats() + 4 * kTile;
  }
  __host__ __device__ size_t stage_floats() const {  // 16 heads, 16 tails
    return static_cast<size_t>(2) * kRows * s_row;
  }
  __host__ __device__ size_t warp_floats() const {
    // The stage; d_ph and d_pt rows; the group's column sums of d_ph.
    return stage_floats() + static_cast<size_t>(2) * kRows * s_k + kp;
  }
};

// The A fragment of rows `r` and r + 8, columns c and c + 4 of a row-major
// block with row stride `stride`, split into hi and lo.
__device__ __forceinline__ void load_a(const float* p, int stride, int r,
                                       int c, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_fast(p[r * stride + c], hi[0], lo[0]);
  split_fast(p[(r + 8) * stride + c], hi[1], lo[1]);
  split_fast(p[r * stride + c + 4], hi[2], lo[2]);
  split_fast(p[(r + 8) * stride + c + 4], hi[3], lo[3]);
}

// Phase A for one group of 16 edges: the projections ph = e_h W_r and
// pt = e_t W_r, k in chunks of 8 kNT columns, and the epilogue, which
// writes d_ph and d_pt (16 x kp) into the warp's rows and the group's
// column sums of d_ph (a fixed shuffle tree over the 16 rows) into
// er_grp.
__device__ __forceinline__ void project(const float* hb, const float* tb,
                                        const float4* w_fwd,
                                        const float* er_s, const float* g_s,
                                        float* dph_s, float* dpt_s,
                                        float* er_grp, const Layout& lay,
                                        int lane) {
  const int gid = lane / 4, tig = lane % 4;
  const int ks = lay.dp / 8, nts = lay.kp / 8;
  const float g0 = g_s[gid], g1 = g_s[gid + 8];
  for (int c0 = 0; c0 < nts; c0 += kNT) {
    const int ntn = min(kNT, nts - c0);  // warp-uniform
    float acc_h[kNT][4], acc_t[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_h[nt][i] = acc_t[nt][i] = 0.f;
    }
    for (int s = 0; s < ks; ++s) {
      uint32_t ah[4], al[4], th[4], tl[4];
      load_a(hb, lay.s_row, gid, 8 * s + tig, ah, al);
      load_a(tb, lay.s_row, gid, 8 * s + tig, th, tl);
      const float4* wf = w_fwd + (static_cast<size_t>(s) * nts + c0) * 32 +
                         lane;
      float4 b[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < ntn) b[nt] = wf[nt * 32];
      }
      step3<kNT>(acc_h, acc_t, ah, al, th, tl, b, ntn);
    }
    // A lane holds rows gid and gid + 8, columns 8 (c0 + nt) + 2 tig + {0, 1}.
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      if (nt < ntn) {
        const int col = 8 * (c0 + nt) + 2 * tig;
        const float e[2] = {er_s[col], er_s[col + 1]};
        float dh[4], dt[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gr = i < 2 ? g0 : g1;
          const float s = tanhf(acc_h[nt][i] + e[i % 2]);
          dt[i] = gr * s;
          dh[i] = gr * acc_t[nt][i] * (1.f - s * s);
        }
        *reinterpret_cast<float2*>(dph_s + gid * lay.s_k + col) =
            make_float2(dh[0], dh[1]);
        *reinterpret_cast<float2*>(dph_s + (gid + 8) * lay.s_k + col) =
            make_float2(dh[2], dh[3]);
        *reinterpret_cast<float2*>(dpt_s + gid * lay.s_k + col) =
            make_float2(dt[0], dt[1]);
        *reinterpret_cast<float2*>(dpt_s + (gid + 8) * lay.s_k + col) =
            make_float2(dt[2], dt[3]);
        float e0 = dh[0] + dh[2], e1 = dh[1] + dh[3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          e0 += __shfl_xor_sync(kFullMask, e0, off);
          e1 += __shfl_xor_sync(kFullMask, e1, off);
        }
        if (gid == 0) {
          er_grp[col] = e0;
          er_grp[col + 1] = e1;
        }
      }
    }
  }
}

// W_r^T's B fragment (k-step s, d n-tile nt) of phase B: from the
// backward order, one 16-byte load; else from the forward order, four
// scalar loads (2-way bank conflicts).
template <bool kTwoW>
__device__ __forceinline__ float4 load_wt(const float* w, int s, int nt,
                                          int nts_k, int nts_d, int lane) {
  if constexpr (kTwoW) {
    return reinterpret_cast<const float4*>(w)[
        (static_cast<size_t>(s) * nts_d + nt) * 32 + lane];
  } else {
    const int gid = lane / 4, tig = lane % 4;
    // W[8 nt + gid][8 s + tig] and W[8 nt + gid][8 s + tig + 4] in the
    // forward order (see stage_w).
    const size_t e = (static_cast<size_t>(nt) * nts_k + s) * 32;
    const size_t f0 = (e + tig * 4 + gid % 4) * 4 + gid / 4;
    const size_t f1 = (e + (tig + 4) * 4 + gid % 4) * 4 + gid / 4;
    return make_float4(w[f0], w[f1], w[f0 + 2], w[f1 + 2]);
  }
}

// Phase B for one group: d_eh = d_ph W_r^T and d_et = d_pt W_r^T (16 x d),
// d in chunks of 8 kNT columns, stored into the edges' canonical rows.
template <bool kTwoW>
__device__ __forceinline__ void back_project(
    const float* dph_s, const float* dpt_s, const float* w_s,
    const int* edge_s, int first, int n, float* __restrict__ deh,
    float* __restrict__ det, int d, const Layout& lay, int lane) {
  const int gid = lane / 4, tig = lane % 4;
  const int ks = lay.kp / 8, nts = lay.dp / 8;
  const int r0 = first + gid, r1 = r0 + 8;
  const size_t o0 = r0 < n ? static_cast<size_t>(edge_s[r0]) * d : 0;
  const size_t o1 = r1 < n ? static_cast<size_t>(edge_s[r1]) * d : 0;
  for (int c0 = 0; c0 < nts; c0 += kNT) {
    const int ntn = min(kNT, nts - c0);  // warp-uniform
    float acc_h[kNT][4], acc_t[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_h[nt][i] = acc_t[nt][i] = 0.f;
    }
    for (int s = 0; s < ks; ++s) {
      uint32_t ah[4], al[4], th[4], tl[4];
      load_a(dph_s, lay.s_k, gid, 8 * s + tig, ah, al);
      load_a(dpt_s, lay.s_k, gid, 8 * s + tig, th, tl);
      float4 b[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < ntn) b[nt] = load_wt<kTwoW>(w_s, s, c0 + nt, ks, nts, lane);
      }
      step3<kNT>(acc_h, acc_t, ah, al, th, tl, b, ntn);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = 8 * (c0 + nt) + 2 * tig;
      if (nt < ntn && col < d) {
        // col is even; col + 1 < d unless d is odd and col = d - 1.
        const bool pair = col + 1 < d;
        if (r0 < n) {
          deh[o0 + col] = acc_h[nt][0];
          det[o0 + col] = acc_t[nt][0];
          if (pair) {
            deh[o0 + col + 1] = acc_h[nt][1];
            det[o0 + col + 1] = acc_t[nt][1];
          }
        }
        if (r1 < n) {
          deh[o1 + col] = acc_h[nt][2];
          det[o1 + col] = acc_t[nt][2];
          if (pair) {
            deh[o1 + col + 1] = acc_h[nt][3];
            det[o1 + col + 1] = acc_t[nt][3];
          }
        }
      }
    }
  }
}

// Phase C: d_W += e_h^T d_ph + e_t^T d_pt over groups [g0, g1) of the
// round, in edge order, 8 edges a step, for this warp's work items: item
// i (warp, warp + n_warps, ...) is kMC m-tiles by kNC n-tiles of d_W.
// `stages` / `dps` are the first warp's stage buffer and d_p rows; warp
// j's lie j * warp_floats further on. Sums in dw_s, entry (mt, nt, lane) a
// float4 of the lane's C fragment.
__device__ __forceinline__ void accumulate_dw(
    const float* stages, const float* dps, float4* dw_s, int g0, int g1,
    int warp, int n_warps, const Layout& lay, int lane) {
  const int gid = lane / 4, tig = lane % 4;
  const int mts = lay.dp / 16, nts = lay.kp / 8;
  const int n_items_n = (nts + kNC - 1) / kNC;
  const int n_items = (mts + kMC - 1) / kMC * n_items_n;
  const size_t wf = lay.warp_floats();
  for (int item = warp; item < n_items; item += n_warps) {
    const int m0 = item / n_items_n * kMC, n0 = item % n_items_n * kNC;
    float acc[kMC][kNC][4];
#pragma unroll
    for (int mc = 0; mc < kMC; ++mc) {
#pragma unroll
      for (int nc = 0; nc < kNC; ++nc) {
        const bool on = m0 + mc < mts && n0 + nc < nts;
        const float4 v = on ? dw_s[((m0 + mc) * nts + n0 + nc) * 32 + lane]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[mc][nc][0] = v.x;
        acc[mc][nc][1] = v.y;
        acc[mc][nc][2] = v.z;
        acc[mc][nc][3] = v.w;
      }
    }
    for (int q = g0; q < g1; ++q) {
      const float* hb = stages + (q - g0) * wf;
      const float* dh = dps + (q - g0) * wf;
      for (int half = 0; half < 2; ++half) {
        // K slot tig is edge 2 tig of the step, slot tig + 4 edge 2 tig + 1.
        const int e = 8 * half + 2 * tig;
#pragma unroll
        for (int prod = 0; prod < 2; ++prod) {
          const float* x = hb + prod * kRows * lay.s_row;  // heads, tails
          const float* p = dh + prod * kRows * lay.s_k;    // d_ph, d_pt
          uint32_t bh[kNC][2], bl[kNC][2];
#pragma unroll
          for (int nc = 0; nc < kNC; ++nc) {
            const int col = 8 * min(n0 + nc, nts - 1) + gid;
            split_fast(p[e * lay.s_k + col], bh[nc][0], bl[nc][0]);
            split_fast(p[(e + 1) * lay.s_k + col], bh[nc][1], bl[nc][1]);
          }
          uint32_t ah[kMC][4], al[kMC][4];
#pragma unroll
          for (int mc = 0; mc < kMC; ++mc) {
            const int m = 16 * min(m0 + mc, mts - 1) + gid;
            split_fast(x[e * lay.s_row + m], ah[mc][0], al[mc][0]);
            split_fast(x[e * lay.s_row + m + 8], ah[mc][1], al[mc][1]);
            split_fast(x[(e + 1) * lay.s_row + m], ah[mc][2], al[mc][2]);
            split_fast(x[(e + 1) * lay.s_row + m + 8], ah[mc][3], al[mc][3]);
          }
          // Three passes from zero, each over every tile before the next,
          // then a rounding add of the step.
          float t[kMC][kNC][4];
#pragma unroll
          for (int mc = 0; mc < kMC; ++mc) {
#pragma unroll
            for (int nc = 0; nc < kNC; ++nc) {
              if (m0 + mc < mts && n0 + nc < nts)
                mma_zero(t[mc][nc], al[mc], bh[nc][0], bh[nc][1]);
            }
          }
#pragma unroll
          for (int mc = 0; mc < kMC; ++mc) {
#pragma unroll
            for (int nc = 0; nc < kNC; ++nc) {
              if (m0 + mc < mts && n0 + nc < nts)
                mma(t[mc][nc], ah[mc], bl[nc][0], bl[nc][1]);
            }
          }
#pragma unroll
          for (int mc = 0; mc < kMC; ++mc) {
#pragma unroll
            for (int nc = 0; nc < kNC; ++nc) {
              if (m0 + mc < mts && n0 + nc < nts) {
                mma(t[mc][nc], ah[mc], bh[nc][0], bh[nc][1]);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mc][nc][i] += t[mc][nc][i];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int mc = 0; mc < kMC; ++mc) {
#pragma unroll
      for (int nc = 0; nc < kNC; ++nc) {
        if (m0 + mc < mts && n0 + nc < nts) {
          dw_s[((m0 + mc) * nts + n0 + nc) * 32 + lane] = make_float4(
              acc[mc][nc][0], acc[mc][nc][1], acc[mc][nc][2], acc[mc][nc][3]);
        }
      }
    }
  }
}

// Stages W_r (d x k, row-major in global memory), split into hi and lo,
// in the fragment orders; padded entries stay zero.
//   w_fwd (s over d, nt over k, lane): W[8s + tig][8nt + gid] and
//     W[8s + tig + 4][8nt + gid], hi then lo (B of x W);
//   w_bwd, where staged (s over k, nt over d, lane): W[8nt + gid][8s + tig]
//     and W[8nt + gid][8s + tig + 4], hi then lo (B of d_p W^T).
__device__ __forceinline__ void stage_w(const float* __restrict__ w_g,
                                        float* w_fwd, float* w_bwd, int d,
                                        int k, const Layout& lay) {
  const int dk = d * k;
  const int nts_k = lay.kp / 8, nts_d = lay.dp / 8;
  for (int base = threadIdx.x; base < dk; base += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * blockDim.x;
      v[j] = i < dk ? w_g[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * blockDim.x;
      if (i >= dk) break;
      const int r = i / k, c = i % k;
      uint32_t hi, lo;
      split(v[j], hi, lo);
      // Forward order: s = r / 8, slot (r % 8) / 4, tig = r % 4; nt = c / 8,
      // gid = c % 8.
      const size_t f = ((static_cast<size_t>(r / 8) * nts_k + c / 8) * 32 +
                        (c % 8) * 4 + r % 4) * 4 + (r % 8) / 4;
      w_fwd[f] = __uint_as_float(hi);
      w_fwd[f + 2] = __uint_as_float(lo);
      if (w_bwd) {
        // Backward order: s = c / 8, slot (c % 8) / 4, tig = c % 4;
        // nt = r / 8, gid = r % 8.
        const size_t b = ((static_cast<size_t>(c / 8) * nts_d + r / 8) * 32 +
                          (r % 8) * 4 + c % 4) * 4 + (c % 8) / 4;
        w_bwd[b] = __uint_as_float(hi);
        w_bwd[b + 2] = __uint_as_float(lo);
      }
    }
  }
}

template <int kBytes, bool kTwoW>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
sddmm_bwd_tile_kernel(const int* __restrict__ rel_perm,
                      const int* __restrict__ tiles,
                      const int* __restrict__ src, const int* __restrict__ dst,
                      const float* __restrict__ emb,
                      const float* __restrict__ w_rel,
                      const float* __restrict__ rel_embed,
                      const float* __restrict__ g, float* __restrict__ deh,
                      float* __restrict__ det, float* __restrict__ part_w,
                      float* __restrict__ part_er, int d, int k, Layout lay) {
  extern __shared__ __align__(16) float smem[];
  const int n_warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* w_fwd = smem;
  float* w_bwd = kTwoW ? w_fwd + lay.w_floats() : nullptr;
  float* w_end = w_fwd + (1 + kTwoW) * lay.w_floats();
  float4* dw_s = reinterpret_cast<float4*>(w_end);
  float* er_s = w_end + static_cast<size_t>(lay.dp) * lay.kp;
  float* er_acc = er_s + lay.kp;
  int* edge_s = reinterpret_cast<int*>(er_acc + lay.kp);
  int* head_s = edge_s + kTile;
  int* tail_s = head_s + kTile;
  float* g_s = reinterpret_cast<float*>(tail_s + kTile);
  // Warp j's region: its stage, d_ph and d_pt rows, d_ph's column sums,
  // at wbase + j * wf.
  float* wbase = smem + lay.fixed_floats();
  const size_t wf = lay.warp_floats();
  const int dp_off = static_cast<int>(lay.stage_floats());  // d_ph rows
  const int er_off = dp_off + 2 * kRows * lay.s_k;
  float* stage = wbase + warp * wf;
  float* dph_s = stage + dp_off;
  float* dpt_s = dph_s + kRows * lay.s_k;
  float* er_grp = stage + er_off;

  const int rel = tiles[3 * blockIdx.x];
  const int start = tiles[3 * blockIdx.x + 1];
  const int count = tiles[3 * blockIdx.x + 2];

  // Zeros: d_W's and d_e_r's sums; W_r's padded entries, where d or k is
  // padded; the stage columns [d, dp) (copies write columns < d only).
  const bool padded = lay.dp != d || lay.kp != k;
  for (size_t i = threadIdx.x + (padded ? 0 : (1 + kTwoW) * lay.w_floats() / 4);
       i < lay.zero_floats() / 4; i += blockDim.x)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int pad = lay.dp - d;
  for (int i = lane; i < 2 * kRows * pad; i += 32)
    stage[(i / pad) * lay.s_row + d + i % pad] = 0.f;
  __syncthreads();
  stage_w(w_rel + static_cast<size_t>(rel) * d * k, w_fwd, w_bwd, d, k, lay);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    er_s[i] = rel_embed[static_cast<size_t>(rel) * k + i];

  // A lane's copies: 32 * cpr per group, the lane's first at (row0, q0),
  // each next one 32 further on.
  const int cpr = d / (kBytes / 4);
  const int row0 = lane / cpr, q0 = lane % cpr;
  const int drow = 32 / cpr, dq = 32 % cpr;
  const int nts = lay.kp / 8;

  for (int sub = 0; sub < count; sub += kTile) {
    const int n = min(kTile, count - sub);
    const int n_groups = (n + kRows - 1) / kRows;
    __syncthreads();  // the last pass is done with the tile's arrays
    for (int i = threadIdx.x; i < n_groups * kRows; i += blockDim.x) {
      const int e = i < n ? rel_perm[start + sub + i] : 0;
      edge_s[i] = e;
      head_s[i] = i < n ? dst[e] : 0;
      tail_s[i] = i < n ? src[e] : 0;
      g_s[i] = i < n ? g[e] : 0.f;  // rows past n: d_ph = d_pt = 0
    }
    __syncthreads();
    const int n_rounds = (n_groups + n_warps - 1) / n_warps;
    for (int r = 0; r < n_rounds; ++r) {
      const int grp = r * n_warps + warp;
      if (grp < n_groups) {
        gather<kBytes>(stage, lay.s_row, emb, d, head_s, tail_s, grp * kRows,
                       n, cpr, row0, q0, drow, dq);
        cp_async_wait_all();
        __syncwarp();
        project(stage, stage + kRows * lay.s_row,
                reinterpret_cast<const float4*>(w_fwd), er_s,
                g_s + grp * kRows, dph_s, dpt_s, er_grp, lay, lane);
        __syncwarp();
        back_project<kTwoW>(dph_s, dpt_s, kTwoW ? w_bwd : w_fwd, edge_s,
                            grp * kRows, n, deh, det, d, lay, lane);
      }
      __syncthreads();  // every warp's rows and d_p of the round are in
      const int g0 = r * n_warps, g1 = min(g0 + n_warps, n_groups);
      accumulate_dw(wbase, wbase + dp_off, dw_s, g0, g1, warp, n_warps, lay,
                    lane);
      // d_e_r: the round's group sums, in group order.
      for (int c = threadIdx.x; c < k; c += blockDim.x) {
        float acc = er_acc[c];
        for (int q = g0; q < g1; ++q) acc += wbase[(q - g0) * wf + er_off + c];
        er_acc[c] = acc;
      }
      __syncthreads();  // the next round refills the stages and d_p rows
    }
  }

  // This tile's partial sums, from the fragment order of dw_s.
  float* pw = part_w + static_cast<size_t>(blockIdx.x) * d * k;
  const int mts = lay.dp / 16;
  for (int i = threadIdx.x; i < mts * nts * 32; i += blockDim.x) {
    const int l = i % 32, t = i / 32;
    const int row = 16 * (t / nts) + l / 4, col = 8 * (t % nts) + 2 * (l % 4);
    const float4 v = dw_s[i];
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = row + 8 * (j / 2), cc = col + j % 2;
      if (rr < d && cc < k) pw[rr * k + cc] = vals[j];
    }
  }
  for (int c = threadIdx.x; c < k; c += blockDim.x)
    part_er[static_cast<size_t>(blockIdx.x) * k + c] = er_acc[c];
}

constexpr int kCascade = 32;   // tile partials summed apart, then together
constexpr int kReduceWarps = 8;
constexpr int kBatchRuns = 64;  // runs summed in parallel before adding

// d_W[r] and d_e_r[r]: relation r's tile partials, in tile order,
// kCascade at a time (a run), the runs' sums added in run order: a
// relation of 4,630 tiles (yelp2018's largest) takes 176 additions into
// any one sum, not 4,630. A block takes 32 entries of one relation (grid
// (ceil((d k + k) / 32), n_rel)); its warps sum kBatchRuns runs at a
// time in parallel, a lane an entry, then warp 0 adds them in order. A
// relation without tiles gets 0.
__global__ void __launch_bounds__(kReduceWarps * 32)
sddmm_bwd_reduce_kernel(const int* __restrict__ tile_offsets,
                        const float* __restrict__ part_w,
                        const float* __restrict__ part_er,
                        float* __restrict__ d_w, float* __restrict__ d_er,
                        int d, int k) {
  __shared__ float runs[kBatchRuns][32];
  const int rel = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int idx = blockIdx.x * 32 + lane;
  const int dk = d * k;
  const bool on = idx < dk + k;
  const float* p = idx < dk ? part_w + idx : part_er + (idx - dk);
  const size_t stride = idx < dk ? dk : k;
  const int t0 = tile_offsets[rel];
  const int t1 = tile_offsets[rel + 1];
  const int n_runs = (t1 - t0 + kCascade - 1) / kCascade;
  float acc = 0.f;
  for (int r0 = 0; r0 < n_runs; r0 += kBatchRuns) {
    const int r1 = min(r0 + kBatchRuns, n_runs);
    for (int r = r0 + warp; r < r1; r += kReduceWarps) {
      const int c0 = t0 + r * kCascade, c1 = min(c0 + kCascade, t1);
      float run = 0.f;
      if (on) {
#pragma unroll 8
        for (int t = c0; t < c1; ++t) run += p[static_cast<size_t>(t) * stride];
      }
      runs[r - r0][lane] = run;
    }
    __syncthreads();
    if (warp == 0) {
      for (int r = r0; r < r1; ++r) acc += runs[r - r0][lane];
    }
    __syncthreads();  // the next batch overwrites the runs
  }
  if (warp == 0 && on) {
    if (idx < dk) {
      d_w[static_cast<size_t>(rel) * dk + idx] = acc;
    } else {
      d_er[static_cast<size_t>(rel) * k + idx - dk] = acc;
    }
  }
}

// The fold's units: the d_eh stream over the forward CSR (GATHER false:
// row e of deh is edge e's), writing d_emb; or d_et gathered through
// rev_perm over the reverse CSR (GATHER true), added into d_emb.
template <class L, bool GATHER>
__global__ void __launch_bounds__(kgat::kWarpsPerBlock * 32)
fold_units_kernel(const int4* __restrict__ units, int n_units,
                  const int* __restrict__ rev_perm,
                  const float* __restrict__ vals, float* __restrict__ d_emb,
                  float* __restrict__ partials, int d) {
  const int u = blockIdx.x * kgat::kWarpsPerBlock + threadIdx.x / 32;
  if (u >= n_units) return;  // whole warps exit together
  kgat::reduce_unit<float, L, GATHER, false, GATHER>(
      units[u], rev_perm, nullptr, vals, d_emb, partials, d,
      threadIdx.x % 32);
}

template <bool GATHER>
cudaError_t launch_fold(const kgat::Split& s, const int* rev_perm,
                        const float* vals, float* d_emb, float* partials,
                        int d, cudaStream_t stream) {
  const dim3 grid(kgat::unit_blocks(s));
  const bool vec = kgat::aligned16(vals) && kgat::aligned16(d_emb) &&
                   kgat::aligned16(partials);
  const cudaError_t e = kgat::with_layout<float>(d, vec, [&](auto layout) {
    fold_units_kernel<decltype(layout), GATHER>
        <<<grid, kgat::kWarpsPerBlock * 32, 0, stream>>>(
            s.units, s.n_units, rev_perm, vals, d_emb, partials, d);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return kgat::launch_fixup<GATHER>(s, partials, d_emb, d, stream);
}

// The block's layout for d x k: both W_r orders, unless the forward order
// alone fits more warps (at most kMaxWarps). At d = k = 64: both orders,
// eight warps (228 KB).
bool plan(int d, int k, Layout& lay, int& n_warps) {
  lay.dp = (d + 15) / 16 * 16;
  lay.kp = (k + 7) / 8 * 8;
  lay.s_row = lay.dp + (36 - lay.dp % 32) % 32;
  lay.s_k = lay.kp + (36 - lay.kp % 32) % 32;
  n_warps = 0;
  for (int two_w = 0; two_w <= 1; ++two_w) {
    Layout l = lay;
    l.two_w = two_w;
    const size_t fixed = l.fixed_floats() * 4, per_warp = l.warp_floats() * 4;
    if (fixed + per_warp > static_cast<size_t>(kSmemBudget)) continue;
    const size_t room = (kSmemBudget - fixed) / per_warp;
    const int w = static_cast<int>(room < kMaxWarps ? room : kMaxWarps);
    if (w >= n_warps) {
      n_warps = w;
      lay.two_w = two_w;
    }
  }
  return n_warps > 0;
}

template <int kBytes, bool kTwoW>
cudaError_t launch_tiles(const Layout& lay, int n_warps, const int* rel_perm,
                         const int* tiles, const int* src, const int* dst,
                         const float* emb, const float* w_rel,
                         const float* rel_embed, const float* g, float* deh,
                         float* det, float* part_w, float* part_er,
                         int n_tiles, int d, int k, cudaStream_t stream) {
  const size_t smem = (lay.fixed_floats() + n_warps * lay.warp_floats()) * 4;
  auto kernel = sddmm_bwd_tile_kernel<kBytes, kTwoW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_tiles, n_warps * 32, smem, stream>>>(
      rel_perm, tiles, src, dst, emb, w_rel, rel_embed, g, deh, det, part_w,
      part_er, d, k, lay);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers on one device. The caller allocates
// deh/det (E, d), part_w (n_tiles, d, k), part_er (n_tiles, k) and the
// fold's partials (max of the two splits' n_slots, d) as scratch.
// tile_offsets (n_rel + 1) is each relation's range of tiles; the two
// RowSplits are those of the forward and the reverse CSR.
extern "C" int kgat_sddmm_transr_bwd(
    const void* rel_perm, const void* tiles, const void* tile_offsets,
    const void* src, const void* dst, const void* units, int n_units,
    const void* split_rows, const void* slot_offsets, int n_split,
    const void* rev_units, int n_rev_units, const void* rev_split_rows,
    const void* rev_slot_offsets, int n_rev_split, const void* rev_perm,
    const void* emb, const void* w_rel, const void* rel_embed, const void* g,
    void* deh, void* det, void* part_w, void* part_er, void* partials,
    void* d_emb, void* d_w, void* d_er, int n_tiles, int n_rel, int d, int k,
    void* stream) {
  if (n_tiles < 0 || n_rel <= 0 || n_units <= 0 || n_rev_units <= 0 ||
      d <= 0 || d > 256 || k <= 0 || k > 128 || d * k > 8192 ||
      !kgat::aligned16(units) || !kgat::aligned16(rev_units))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto em = static_cast<const float*>(emb);
  const auto dh = static_cast<float*>(deh);
  const auto dt = static_cast<float*>(det);
  const auto pw = static_cast<float*>(part_w);
  const auto pe = static_cast<float*>(part_er);

  cudaError_t err = cudaSuccess;
  if (n_tiles > 0) {
    Layout lay;
    int n_warps = 0;
    if (!plan(d, k, lay, n_warps)) return cudaErrorInvalidValue;
    const auto go = [&](auto launch) {
      return launch(lay, n_warps, static_cast<const int*>(rel_perm),
                    static_cast<const int*>(tiles),
                    static_cast<const int*>(src), static_cast<const int*>(dst),
                    em, static_cast<const float*>(w_rel),
                    static_cast<const float*>(rel_embed),
                    static_cast<const float*>(g), dh, dt, pw, pe, n_tiles, d,
                    k, s);
    };
    // 16-byte copies where every row starts 16-byte aligned.
    const bool v16 = d % 4 == 0 && kgat::aligned16(em);
    if (lay.two_w) {
      err = v16 ? go(launch_tiles<16, true>) : go(launch_tiles<4, true>);
    } else {
      err = v16 ? go(launch_tiles<16, false>) : go(launch_tiles<4, false>);
    }
    if (err != cudaSuccess) return err;
  }

  const dim3 grid_r((d * k + k + 31) / 32, n_rel);
  sddmm_bwd_reduce_kernel<<<grid_r, kReduceWarps * 32, 0, s>>>(
      static_cast<const int*>(tile_offsets), pw, pe,
      static_cast<float*>(d_w), static_cast<float*>(d_er), d, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const auto fwd = kgat::make_split(units, n_units, split_rows, slot_offsets,
                                    n_split);
  const auto rev = kgat::make_split(rev_units, n_rev_units, rev_split_rows,
                                    rev_slot_offsets, n_rev_split);
  const auto de = static_cast<float*>(d_emb);
  const auto pa = static_cast<float*>(partials);
  err = launch_fold<false>(fwd, nullptr, dh, de, pa, d, s);
  if (err != cudaSuccess) return err;
  return launch_fold<true>(rev, static_cast<const int*>(rev_perm), dt, de, pa,
                           d, s);
}
