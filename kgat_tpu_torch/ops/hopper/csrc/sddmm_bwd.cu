// K4: the backward of K2 (TransR attention SDDMM). Given the cotangent g
// of every edge's logit pi = (W_r e_t) . tanh(W_r e_h + e_r), with head
// h = dst and tail t = src, it writes
//   d_emb (n_nodes, d)  = sum over edges headed by v of d_eh + sum over
//                         edges with tail v of d_et,
//   d_W   (R, d, k)     = sum over edges of relation r of
//                         e_h^T d_ph + e_t^T d_pt,
//   d_e_r (R, k)        = sum over edges of relation r of d_ph,
// where s = tanh(W_r e_h + e_r), d_pt = g s, d_ph = g pt (1 - s^2),
// d_eh = d_ph W_r^T and d_et = d_pt W_r^T.
//
// Replaces kgat_tpu/ops/pallas/sddmm.py::_bwd_kernel (sddmm_transr_bwd).
// The TPU kernel walks the relation tiles in order on one core and adds
// each tile's d_W into an output block it revisits, and leaves the per-edge
// rows to XLA's scatter. Blocks of a GPU run in no order, so the port splits
// the work into three kernels, none with a float atomic, so that two calls
// are bit-identical:
//   1. one block per relation tile (<= REL_TILE edges of one relation, as in
//      K2): W_r staged once in shared memory, the projections recomputed,
//      d_eh/d_et written per edge into canonical slots, and the tile's d_W
//      and d_e_r summed in edge order into a per-tile partial;
//   2. one thread per entry of d_W / d_e_r: the relation's tile partials
//      summed in tile order (tiles of a relation are consecutive);
//   3. one warp per node: d_eh over its forward CSR row (heads) plus d_et
//      over its reverse CSR row (tails), in row order.
//
// What bounds it on the H100: kernel 1 is K2's f32 FMA work twice over
// (projections, then d_ph W^T and d_pt W^T) plus the d_W outer products:
// ~6 d k flops per edge, ~110 GFLOP at yelp2018 scale, and it writes two
// (E, d) rows (2.3 GB there). Kernel 3 reads them back and, like K1,
// serialises the hub rows on one warp. Simple first: no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kEdges = 4;                // edges per warp per chunk
constexpr int kChunk = kWarps * kEdges;  // edges a block stages at a time
constexpr unsigned kFullMask = 0xffffffffu;

// KPL: k columns per lane (column c = lane + 32 * q, q < KPL).
// EPT: d_W entries per thread (entry idx = threadIdx.x + kThreads * q).
template <int KPL, int EPT>
__global__ void __launch_bounds__(kThreads)
sddmm_bwd_tile_kernel(const int* __restrict__ rel_perm,
                      const int* __restrict__ tiles,
                      const int* __restrict__ src, const int* __restrict__ dst,
                      const float* __restrict__ emb,
                      const float* __restrict__ w_rel,
                      const float* __restrict__ rel_embed,
                      const float* __restrict__ g, float* __restrict__ deh,
                      float* __restrict__ det, float* __restrict__ part_w,
                      float* __restrict__ part_er, int d, int k) {
  extern __shared__ float smem[];
  // W_r rows are padded to k + 1 floats: step 3 reads W_r by row with one
  // lane per row, and the padding puts the 32 lanes on 32 banks.
  const int ldw = k + 1;
  float* w_s = smem;                   // (d, ldw)
  float* er_s = w_s + d * ldw;         // (k,)
  float* eh_s = er_s + k;              // (kChunk, d) head rows
  float* et_s = eh_s + kChunk * d;     // (kChunk, d) tail rows
  float* dph_s = et_s + kChunk * d;    // (kChunk, k)
  float* dpt_s = dph_s + kChunk * k;   // (kChunk, k)

  const int tile = blockIdx.x;
  const int rel = tiles[3 * tile];
  const int start = tiles[3 * tile + 1];
  const int count = tiles[3 * tile + 2];
  const float* w_g = w_rel + static_cast<size_t>(rel) * d * k;
  for (int i = threadIdx.x; i < d * k; i += kThreads)
    w_s[(i / k) * ldw + i % k] = w_g[i];
  for (int i = threadIdx.x; i < k; i += kThreads)
    er_s[i] = rel_embed[static_cast<size_t>(rel) * k + i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dk = d * k;
  float acc_w[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) acc_w[q] = 0.f;
  float acc_er = 0.f;  // thread t < k owns column t of d_e_r

  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);  // block-uniform
    // 1. Stage this warp's rows of the chunk (zeros past the tile's end).
    int edge[kEdges];
    float ge[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      const int slot = warp * kEdges + j;
      edge[j] = 0;
      ge[j] = 0.f;
      if (slot < n) {
        edge[j] = rel_perm[start + base + slot];
        ge[j] = g[edge[j]];
        const float* h_row = emb + static_cast<size_t>(dst[edge[j]]) * d;
        const float* t_row = emb + static_cast<size_t>(src[edge[j]]) * d;
        for (int c = lane; c < d; c += 32) {
          eh_s[slot * d + c] = h_row[c];
          et_s[slot * d + c] = t_row[c];
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          eh_s[slot * d + c] = 0.f;
          et_s[slot * d + c] = 0.f;
        }
      }
    }
    __syncwarp();

    // 2. The projections, as K2 computes them, then d_ph and d_pt.
    float ph[kEdges][KPL], pt[kEdges][KPL];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
#pragma unroll
      for (int q = 0; q < KPL; ++q) ph[j][q] = pt[j][q] = 0.f;
    }
    for (int i = 0; i < d; ++i) {
      float wv[KPL];
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + 32 * q;
        wv[q] = c < k ? w_s[i * ldw + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        const float a = eh_s[(warp * kEdges + j) * d + i];
        const float b = et_s[(warp * kEdges + j) * d + i];
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          ph[j][q] = fmaf(a, wv[q], ph[j][q]);
          pt[j][q] = fmaf(b, wv[q], pt[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      const int slot = warp * kEdges + j;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + 32 * q;
        if (c < k) {
          const float s = tanhf(ph[j][q] + er_s[c]);
          dpt_s[slot * k + c] = ge[j] * s;
          dph_s[slot * k + c] = ge[j] * pt[j][q] * (1.f - s * s);
        }
      }
    }
    __syncwarp();

    // 3. d_eh = d_ph W_r^T and d_et = d_pt W_r^T, lanes across d, into the
    // edges' canonical slots.
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      const int slot = warp * kEdges + j;
      if (slot >= n) continue;  // warp-uniform
      for (int i = lane; i < d; i += 32) {
        const float* w_row = w_s + i * ldw;
        float a = 0.f, b = 0.f;
        for (int c = 0; c < k; ++c) {
          a = fmaf(dph_s[slot * k + c], w_row[c], a);
          b = fmaf(dpt_s[slot * k + c], w_row[c], b);
        }
        deh[static_cast<size_t>(edge[j]) * d + i] = a;
        det[static_cast<size_t>(edge[j]) * d + i] = b;
      }
    }
    __syncthreads();  // every warp's rows are staged

    // 4. The d_W entries this thread owns, over the chunk's edges in order.
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const int idx = threadIdx.x + kThreads * q;
      if (idx < dk) {
        const int i = idx / k;
        const int c = idx % k;
        float a = acc_w[q];
        for (int r = 0; r < n; ++r) {
          a = fmaf(eh_s[r * d + i], dph_s[r * k + c], a);
          a = fmaf(et_s[r * d + i], dpt_s[r * k + c], a);
        }
        acc_w[q] = a;
      }
    }
    if (threadIdx.x < k) {
      for (int r = 0; r < n; ++r) acc_er += dph_s[r * k + threadIdx.x];
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  // 5. This tile's partial sums.
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int idx = threadIdx.x + kThreads * q;
    if (idx < dk) part_w[static_cast<size_t>(tile) * dk + idx] = acc_w[q];
  }
  if (threadIdx.x < k) part_er[static_cast<size_t>(tile) * k + threadIdx.x] = acc_er;
}

// d_W[r] and d_e_r[r]: relation r's tile partials summed in tile order.
// Grid (ceil((d k + k) / kThreads), n_rel); a relation without tiles gets 0.
__global__ void __launch_bounds__(kThreads)
sddmm_bwd_reduce_kernel(const int* __restrict__ tile_offsets,
                        const float* __restrict__ part_w,
                        const float* __restrict__ part_er,
                        float* __restrict__ d_w, float* __restrict__ d_er,
                        int d, int k) {
  const int rel = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int dk = d * k;
  if (idx >= dk + k) return;
  const int t0 = tile_offsets[rel];
  const int t1 = tile_offsets[rel + 1];
  float acc = 0.f;
  if (idx < dk) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) acc += part_w[static_cast<size_t>(t) * dk + idx];
    d_w[static_cast<size_t>(rel) * dk + idx] = acc;
  } else {
    const int c = idx - dk;
#pragma unroll 8
    for (int t = t0; t < t1; ++t) acc += part_er[static_cast<size_t>(t) * k + c];
    d_er[static_cast<size_t>(rel) * k + c] = acc;
  }
}

// d_emb[v]: d_eh over v's forward CSR row (edges headed by v, contiguous)
// plus d_et over its reverse CSR row (edges with tail v, through rev_perm).
// CPL: feature columns per lane. Every row is written, an isolated node 0.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
sddmm_bwd_fold_kernel(const int* __restrict__ row_offsets,
                      const int* __restrict__ rev_row_offsets,
                      const int* __restrict__ rev_perm,
                      const float* __restrict__ deh,
                      const float* __restrict__ det,
                      float* __restrict__ d_emb, int n_nodes, int d) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_nodes) return;  // whole warps exit together

  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;

  const int lo = row_offsets[row];
  const int hi = row_offsets[row + 1];
#pragma unroll 4
  for (int e = lo; e < hi; ++e) {
    const float* r = deh + static_cast<size_t>(e) * d;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      if (c < d) acc[q] += r[c];
    }
  }

  const int lo2 = rev_row_offsets[row];
  const int hi2 = rev_row_offsets[row + 1];
  for (int base = lo2; base < hi2; base += 32) {
    const int pe = base + lane < hi2 ? rev_perm[base + lane] : 0;
    const int n = min(32, hi2 - base);  // warp-uniform
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int ej = __shfl_sync(kFullMask, pe, j);
      const float* r = det + static_cast<size_t>(ej) * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < d) acc[q] += r[c];
      }
    }
  }

  float* out = d_emb + static_cast<size_t>(row) * d;
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int c = lane + 32 * q;
    if (c < d) out[c] = acc[q];
  }
}

template <int KPL, int EPT>
cudaError_t launch_tiles(const int* rel_perm, const int* tiles, const int* src,
                         const int* dst, const float* emb, const float* w_rel,
                         const float* rel_embed, const float* g, float* deh,
                         float* det, float* part_w, float* part_er,
                         int n_tiles, int d, int k, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d) * (k + 1) + k +
                       2 * static_cast<size_t>(kChunk) * d +
                       2 * static_cast<size_t>(kChunk) * k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_bwd_tile_kernel<KPL, EPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sddmm_bwd_tile_kernel<KPL, EPT><<<n_tiles, kThreads, smem, stream>>>(
      rel_perm, tiles, src, dst, emb, w_rel, rel_embed, g, deh, det, part_w,
      part_er, d, k);
  return cudaGetLastError();
}

template <int KPL>
cudaError_t launch_tiles_ept(const int* rel_perm, const int* tiles,
                             const int* src, const int* dst, const float* emb,
                             const float* w_rel, const float* rel_embed,
                             const float* g, float* deh, float* det,
                             float* part_w, float* part_er, int n_tiles,
                             int d, int k, cudaStream_t stream) {
  const int ept = (d * k + kThreads - 1) / kThreads;
  if (ept <= 8)
    return launch_tiles<KPL, 8>(rel_perm, tiles, src, dst, emb, w_rel,
                                rel_embed, g, deh, det, part_w, part_er,
                                n_tiles, d, k, stream);
  if (ept <= 16)
    return launch_tiles<KPL, 16>(rel_perm, tiles, src, dst, emb, w_rel,
                                 rel_embed, g, deh, det, part_w, part_er,
                                 n_tiles, d, k, stream);
  if (ept <= 32)
    return launch_tiles<KPL, 32>(rel_perm, tiles, src, dst, emb, w_rel,
                                 rel_embed, g, deh, det, part_w, part_er,
                                 n_tiles, d, k, stream);
  return cudaErrorInvalidValue;
}

template <int CPL>
cudaError_t launch_fold(const int* row_offsets, const int* rev_row_offsets,
                        const int* rev_perm, const float* deh,
                        const float* det, float* d_emb, int n_nodes, int d,
                        cudaStream_t stream) {
  const dim3 grid((n_nodes + kWarps - 1) / kWarps);
  sddmm_bwd_fold_kernel<CPL><<<grid, kThreads, 0, stream>>>(
      row_offsets, rev_row_offsets, rev_perm, deh, det, d_emb, n_nodes, d);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers on one device; the caller allocates
// deh/det (E, d), part_w (n_tiles, d, k) and part_er (n_tiles, k) as
// scratch. tile_offsets (n_rel + 1) is each relation's range of tiles.
extern "C" int kgat_sddmm_transr_bwd(
    const void* rel_perm, const void* tiles, const void* tile_offsets,
    const void* src, const void* dst, const void* row_offsets,
    const void* rev_row_offsets, const void* rev_perm, const void* emb,
    const void* w_rel, const void* rel_embed, const void* g, void* deh,
    void* det, void* part_w, void* part_er, void* d_emb, void* d_w,
    void* d_er, int n_tiles, int n_rel, int n_nodes, int d, int k,
    void* stream) {
  if (n_tiles < 0 || n_rel <= 0 || n_nodes <= 0 || d <= 0 || d > 256 ||
      k <= 0 || k > 128 || d * k > 32 * kThreads)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rp = static_cast<const int*>(rel_perm);
  const auto tl = static_cast<const int*>(tiles);
  const auto sr = static_cast<const int*>(src);
  const auto ds = static_cast<const int*>(dst);
  const auto em = static_cast<const float*>(emb);
  const auto wr = static_cast<const float*>(w_rel);
  const auto er = static_cast<const float*>(rel_embed);
  const auto gg = static_cast<const float*>(g);
  const auto dh = static_cast<float*>(deh);
  const auto dt = static_cast<float*>(det);
  const auto pw = static_cast<float*>(part_w);
  const auto pe = static_cast<float*>(part_er);

  cudaError_t err = cudaSuccess;
  if (n_tiles > 0) {
    if (k <= 32)
      err = launch_tiles_ept<1>(rp, tl, sr, ds, em, wr, er, gg, dh, dt, pw, pe,
                                n_tiles, d, k, s);
    else if (k <= 64)
      err = launch_tiles_ept<2>(rp, tl, sr, ds, em, wr, er, gg, dh, dt, pw, pe,
                                n_tiles, d, k, s);
    else
      err = launch_tiles_ept<4>(rp, tl, sr, ds, em, wr, er, gg, dh, dt, pw, pe,
                                n_tiles, d, k, s);
    if (err != cudaSuccess) return err;
  }

  const dim3 grid_r((d * k + k + kThreads - 1) / kThreads, n_rel);
  sddmm_bwd_reduce_kernel<<<grid_r, kThreads, 0, s>>>(
      static_cast<const int*>(tile_offsets), pw, pe,
      static_cast<float*>(d_w), static_cast<float*>(d_er), d, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const auto ro = static_cast<const int*>(row_offsets);
  const auto rro = static_cast<const int*>(rev_row_offsets);
  const auto rpm = static_cast<const int*>(rev_perm);
  const auto de = static_cast<float*>(d_emb);
  if (d <= 32) return launch_fold<1>(ro, rro, rpm, dh, dt, de, n_nodes, d, s);
  if (d <= 64) return launch_fold<2>(ro, rro, rpm, dh, dt, de, n_nodes, d, s);
  if (d <= 128) return launch_fold<4>(ro, rro, rpm, dh, dt, de, n_nodes, d, s);
  return launch_fold<8>(ro, rro, rpm, dh, dt, de, n_nodes, d, s);
}
