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
// What bounds it on the H100: mostly bytes, with f32 FMA work close
// behind. Per edge it gathers two embedding rows (2 * d * 4 = 512 bytes at
// d = 64) and writes 4 bytes; it does 2 * 2 * d * k = 16,384 flops (d = k =
// 64), ~30 flop per byte. That is below the tensor-core line but near
// the line of the f32 FMA units without tensor cores, so this plain-FMA
// form may be bound by arithmetic and shared-memory reads; whether to move
// the projections to wgmma is an open question for later work.
// Design: one block per tile of rel_perm (<= REL_TILE edges of ONE
// relation), so W_r (d x k f32, 16 KB at 64 x 64) and e_r are staged in
// shared memory once per tile. Each warp takes kEdges edges at a time:
// lanes copy the head and tail rows into shared memory (coalesced), then
// each lane owns k/32 output columns and runs the d-long FMA loop for all
// kEdges edges at once, so one W_r value read from shared memory feeds
// 2 * kEdges FMAs. tanh, the row dot and a warp shuffle reduction follow.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kEdges = 4;  // edges per warp per step
constexpr unsigned kFullMask = 0xffffffffu;

// KPL: output columns per lane (column c = lane + 32 * q, q < KPL).
template <int KPL>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_transr_kernel(const int* __restrict__ rel_perm,
                    const int* __restrict__ tiles, const int* __restrict__ src,
                    const int* __restrict__ dst, const float* __restrict__ emb,
                    const float* __restrict__ w_rel,
                    const float* __restrict__ rel_embed,
                    float* __restrict__ out, int d, int k) {
  extern __shared__ float smem[];
  float* w_s = smem;        // (d, k) row-major W_r
  float* er_s = w_s + d * k;  // (k,) e_r
  float* rows = er_s + k;   // per warp: (kEdges, d) heads, (kEdges, d) tails

  const int rel = tiles[3 * blockIdx.x];
  const int start = tiles[3 * blockIdx.x + 1];
  const int count = tiles[3 * blockIdx.x + 2];
  const float* w_g = w_rel + static_cast<size_t>(rel) * d * k;
  for (int i = threadIdx.x; i < d * k; i += blockDim.x) w_s[i] = w_g[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    er_s[i] = rel_embed[static_cast<size_t>(rel) * k + i];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* eh_s = rows + static_cast<size_t>(warp) * 2 * kEdges * d;
  float* et_s = eh_s + kEdges * d;

  for (int base = warp * kEdges; base < count; base += kWarps * kEdges) {
    const int n = min(kEdges, count - base);  // warp-uniform
    int edge[kEdges];
#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      edge[j] = 0;
      if (j < n) {
        edge[j] = rel_perm[start + base + j];
        const float* h_row = emb + static_cast<size_t>(dst[edge[j]]) * d;
        const float* t_row = emb + static_cast<size_t>(src[edge[j]]) * d;
        for (int c = lane; c < d; c += 32) {
          eh_s[j * d + c] = h_row[c];
          et_s[j * d + c] = t_row[c];
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          eh_s[j * d + c] = 0.f;
          et_s[j * d + c] = 0.f;
        }
      }
    }
    __syncwarp();

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
        wv[q] = c < k ? w_s[i * k + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kEdges; ++j) {
        const float a = eh_s[j * d + i];
        const float b = et_s[j * d + i];
#pragma unroll
        for (int q = 0; q < KPL; ++q) {
          ph[j][q] = fmaf(a, wv[q], ph[j][q]);
          pt[j][q] = fmaf(b, wv[q], pt[j][q]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kEdges; ++j) {
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < KPL; ++q) {
        const int c = lane + 32 * q;
        if (c < k) part = fmaf(pt[j][q], tanhf(ph[j][q] + er_s[c]), part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFullMask, part, off);
      if (lane == 0 && j < n) out[edge[j]] = part;
    }
    __syncwarp();  // rows are rewritten by the next step
  }
}

template <int KPL>
cudaError_t launch(const int* rel_perm, const int* tiles, const int* src,
                   const int* dst, const float* emb, const float* w_rel,
                   const float* rel_embed, float* out, int n_tiles, int d,
                   int k, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d) * k + k + kWarps * 2 * kEdges * d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_transr_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sddmm_transr_kernel<KPL><<<n_tiles, kWarps * 32, smem, stream>>>(
      rel_perm, tiles, src, dst, emb, w_rel, rel_embed, out, d, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kgat_sddmm_transr(const void* rel_perm, const void* tiles,
                                 const void* src, const void* dst,
                                 const void* emb, const void* w_rel,
                                 const void* rel_embed, void* out, int n_tiles,
                                 int d, int k, void* stream) {
  if (n_tiles <= 0 || d <= 0 || k <= 0) return cudaErrorInvalidValue;
  const auto rp = static_cast<const int*>(rel_perm);
  const auto tl = static_cast<const int*>(tiles);
  const auto sr = static_cast<const int*>(src);
  const auto ds = static_cast<const int*>(dst);
  const auto em = static_cast<const float*>(emb);
  const auto wr = static_cast<const float*>(w_rel);
  const auto er = static_cast<const float*>(rel_embed);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
    case 2: return launch<2>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
    case 3: return launch<3>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
    case 4: return launch<4>(rp, tl, sr, ds, em, wr, er, o, n_tiles, d, k, s);
    default: return cudaErrorInvalidValue;
  }
}
