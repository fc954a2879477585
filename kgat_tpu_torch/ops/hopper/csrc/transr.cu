// TransR's relation projection in the KG step's loss, and its backward:
// ph = eh W_r, pp = ep W_r, pn = en W_r and e_r for a batch of (h, r, t+,
// t-) rows, W_r = w_rel[r] (d x k), e_r = rel_embed[r]; the gradients of
// the three entity rows, and of w_rel and rel_embed summed by relation.
//
// Replaces no TPU kernel. kgat_tpu's kg_loss (models/kgat.py) gathers
// w_rel[r] as a (B, d, k) tensor and leaves the products and their
// gradients to XLA; the port's plain path (kgat.kg_pair_terms_rows) does
// the same through autograd: an index, three batched products and, in the
// backward, index_put with accumulation into w_rel's and rel_embed's
// gradients. PyTorch's accumulating index_put sorts the indices and walks
// each run of equal indices on one warp, serially, and a KG batch is
// dominated by the interaction relations (about 380 and 830 of 2,048 rows
// at the Yelp2018 and Last-FM sizes), so those two launches took 0.6-1.1
// ms of a 2-ms KG step on an H100.
//
// What bounds it on the H100: neither operations nor bytes, at this size.
// A batch of B rows needs 3 B d k FMAs forward and 6 B d k backward (75
// MFLOP at B = 2,048, d = k = 64: 1.1 us at 67 TFLOP/s) and moves its rows
// and the relation tables once each (about 5 MB: 1.5 us at 3.35 TB/s). The
// launches and the serial depth of a unit set the time. Design:
//  * the plan (transr_plan_kernel, one block): a stable counting sort of
//    the batch by relation. Each row's rank within its relation comes
//    from the lanes of its relation in its 32-row chunk and the chunks
//    before it; one warp scans the relations' counts; each row's batch
//    index goes to its relation's offset plus its rank (perm). Each
//    relation's run is cut into units of at most U rows (rel, lo, hi)
//    over perm, in the manner of ops/row_split.py; their number is at
//    most ceil(B / U) + R, which the later launches take as their grid
//    (the units past the last are empty and exit at once). No host
//    synchronisation, fixed shapes: the plan is captured with the rest of
//    the step.
//  * forward (transr_fwd_kernel, a block a unit): W_r is staged in shared
//    memory once (rows of k + 4 floats), then the unit's batch indices and
//    entity rows, up to kStage rows at a time; a thread owns one output
//    column and sums over d with FMAs, the three vectors of a row at once.
//    (B, d, k) is never written; e_r is read by index.
//  * backward (transr_bwd_units_kernel, a block a unit): with W_r staged
//    as in the forward, a thread owns a row of W_r and gives
//    d eh = W_r d ph (and ep, en) for the unit's rows; then each thread
//    owns a 4 x 4 tile of the unit's partial of W_r's gradient, the sum
//    over its rows, in order, of eh d ph^T + ep d pp^T + en d pn^T, and
//    writes it, with the unit's sum of d e_r (from rows staged with the
//    other cotangents), to the unit's slot of a scratch buffer.
//    transr_bwd_fold_kernel sums each relation's slots in unit order into
//    w_rel's and rel_embed's gradients, and writes zeros for a relation
//    the batch leaves out.
// Float32 FMAs throughout (no TF32), every sum in a fixed order, no
// atomics: two calls give the same bits. Four launches a step: the plan
// and the forward, the units and the fold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kStage = 32;  // entity rows staged in shared memory at a time
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int w_stride(int k) { return k + 4; }

// Sort the batch by relation, stably, and cut each relation's run into
// units. The batch is walked in tiles of kPlanThreads rows, a warp a
// chunk of 32: the lanes of one relation in a chunk find each other
// (__match_any_sync), the lowest writes their count, and a thread a
// relation turns the tile's chunk counts into exclusive prefixes over the
// chunks, after the rows of the earlier tiles. A row's rank within its
// relation is then its chunk's prefix plus the lanes of its relation
// below it: batch order. Shared: each row's rank, the chunk counts of a
// tile, and per relation the rows so far, the row offsets and the unit
// offsets.
__global__ void __launch_bounds__(kPlanThreads)
transr_plan_kernel(const long long* __restrict__ r, int n, int n_rel,
                   int unit_rows, int n_units, int* __restrict__ perm,
                   int* __restrict__ rel_offsets, int4* __restrict__ units,
                   int* __restrict__ unit_offsets) {
  constexpr int kWarps = kPlanThreads / 32;
  extern __shared__ int plan_smem[];
  int* rank = plan_smem;                 // (n,)
  int* chunk = rank + n;                 // (kWarps, n_rel)
  int* seen = chunk + kWarps * n_rel;    // (n_rel,)
  int* off = seen + n_rel;               // (n_rel + 1,)
  int* uoff = off + n_rel + 1;           // (n_rel + 1,)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  for (int q = threadIdx.x; q < n_rel; q += kPlanThreads) seen[q] = 0;
  for (int t0 = 0; t0 < n; t0 += kPlanThreads) {
    for (int x = threadIdx.x; x < kWarps * n_rel; x += kPlanThreads)
      chunk[x] = 0;
    __syncthreads();
    const int i = t0 + threadIdx.x;
    const int v = i < n ? static_cast<int>(r[i]) : -1;
    const unsigned peers = __match_any_sync(kFullMask, v);
    if (v >= 0 && (peers & below) == 0)
      chunk[warp * n_rel + v] = __popc(peers);
    __syncthreads();
    for (int q = threadIdx.x; q < n_rel; q += kPlanThreads) {
      int run = seen[q];
      for (int w = 0; w < kWarps; ++w) {
        const int c = chunk[w * n_rel + q];
        chunk[w * n_rel + q] = run;
        run += c;
      }
      seen[q] = run;
    }
    __syncthreads();
    if (v >= 0) rank[i] = chunk[warp * n_rel + v] + __popc(peers & below);
    __syncthreads();  // the chunk counts are read before the next tile
  }
  if (warp == 0) {
    // Lane l scans relations [l per, (l + 1) per): rows and units.
    const int per = (n_rel + 31) / 32;
    const int lo = min(lane * per, n_rel), hi = min(lo + per, n_rel);
    int rows = 0, us = 0;
    for (int q = lo; q < hi; ++q) {
      rows += seen[q];
      us += (seen[q] + unit_rows - 1) / unit_rows;
    }
    int rows_in = rows, us_in = us;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFullMask, rows_in, o);
      const int b = __shfl_up_sync(kFullMask, us_in, o);
      if (lane >= o) {
        rows_in += a;
        us_in += b;
      }
    }
    rows = rows_in - rows;
    us = us_in - us;
    for (int q = lo; q < hi; ++q) {
      off[q] = rows;
      uoff[q] = us;
      rows += seen[q];
      us += (seen[q] + unit_rows - 1) / unit_rows;
    }
    if (lane == 31) {
      off[n_rel] = rows_in;
      uoff[n_rel] = us_in;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kPlanThreads)
    perm[off[r[i]] + rank[i]] = i;
  for (int rel = threadIdx.x; rel < n_rel; rel += kPlanThreads) {
    int u = uoff[rel];
    const int end = off[rel + 1];
    for (int p = off[rel]; p < end; p += unit_rows, ++u)
      units[u] = make_int4(rel, p, min(p + unit_rows, end), 0);
  }
  for (int u = uoff[n_rel] + threadIdx.x; u < n_units; u += kPlanThreads)
    units[u] = make_int4(0, 0, 0, 0);
  for (int q = threadIdx.x; q <= n_rel; q += kPlanThreads) {
    rel_offsets[q] = off[q];
    unit_offsets[q] = uoff[q];
  }
}

// W_r (d x k, row-major) into shared rows of w_stride(k) floats.
__device__ __forceinline__ void stage_w(const float* __restrict__ w,
                                        float* sw, int d, int k) {
  const int k4 = k / 4;
  for (int t = threadIdx.x; t < d * k4; t += kThreads) {
    const int j = t / k4, c = (t % k4) * 4;
    *reinterpret_cast<float4*>(sw + j * w_stride(k) + c) =
        reinterpret_cast<const float4*>(w)[t];
  }
}

// Batch rows perm[p0 .. p0 + n) into sidx[0 .. n), n <= kStage.
__device__ __forceinline__ void stage_idx(const int* __restrict__ perm,
                                          int p0, int n, int* sidx) {
  for (int q = threadIdx.x; q < n; q += kThreads) sidx[q] = perm[p0 + q];
}

// Rows sidx[0 .. n) of the nv (B, width) tensors a, b, c, e into
// dst[v][q][0 .. width), v < nv in that order, q < n <= kStage.
__device__ __forceinline__ void stage_rows(const int* sidx, int n, int nv,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const float* __restrict__ c,
                                           const float* __restrict__ e,
                                           int width, float* dst) {
  const int w4 = width / 4, per_v = n * w4;
#pragma unroll 4
  for (int t = threadIdx.x; t < nv * per_v; t += kThreads) {
    const int v = t / per_v, q = (t % per_v) / w4, x = t % w4;
    const float* src = v == 0 ? a : (v == 1 ? b : (v == 2 ? c : e));
    const size_t i = sidx[q];
    reinterpret_cast<float4*>(dst + (v * kStage + q) * width)[x] =
        reinterpret_cast<const float4*>(src + i * width)[x];
  }
}

__global__ void __launch_bounds__(kThreads)
transr_fwd_kernel(const int4* __restrict__ units, const int* __restrict__ perm,
                  const float* __restrict__ eh, const float* __restrict__ ep,
                  const float* __restrict__ en,
                  const float* __restrict__ rel_embed,
                  const float* __restrict__ w_rel, float* __restrict__ ph,
                  float* __restrict__ pp, float* __restrict__ pn,
                  float* __restrict__ er, int d, int k) {
  const int4 unit = units[blockIdx.x];
  if (unit.y >= unit.z) return;  // past the plan's last unit: the block
  extern __shared__ float4 fwd_smem[];
  const int ks = w_stride(k);
  float* sw = reinterpret_cast<float*>(fwd_smem);
  float* sx = sw + d * ks;                                 // (3, kStage, d)
  int* sidx = reinterpret_cast<int*>(sx + 3 * kStage * d);  // (kStage,)
  stage_w(w_rel + static_cast<size_t>(unit.x) * d * k, sw, d, k);
  // Thread (c, q0): output column c of rows q0, q0 + groups, ...
  const int c = threadIdx.x % k, q0 = threadIdx.x / k, groups = kThreads / k;
  const float e = rel_embed[static_cast<size_t>(unit.x) * k + c];
  for (int p0 = unit.y; p0 < unit.z; p0 += kStage) {
    const int n = min(kStage, unit.z - p0);
    __syncthreads();  // W_r staged; the previous rows read
    stage_idx(perm, p0, n, sidx);
    __syncthreads();
    stage_rows(sidx, n, 3, eh, ep, en, nullptr, d, sx);
    __syncthreads();
    if (q0 >= groups) continue;  // k does not divide the block
    for (int q = q0; q < n; q += groups) {
      const float* xh = sx + q * d;
      const float* xp = sx + (kStage + q) * d;
      const float* xn = sx + (2 * kStage + q) * d;
      float ah = 0.f, ap = 0.f, an = 0.f;
      for (int j = 0; j < d; j += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(xh + j);
        const float4 p4 = *reinterpret_cast<const float4*>(xp + j);
        const float4 n4 = *reinterpret_cast<const float4*>(xn + j);
        const float* wj = sw + j * ks + c;
        const float w0 = wj[0], w1 = wj[ks], w2 = wj[2 * ks], w3 = wj[3 * ks];
        ah = fmaf(h4.x, w0, ah); ah = fmaf(h4.y, w1, ah);
        ah = fmaf(h4.z, w2, ah); ah = fmaf(h4.w, w3, ah);
        ap = fmaf(p4.x, w0, ap); ap = fmaf(p4.y, w1, ap);
        ap = fmaf(p4.z, w2, ap); ap = fmaf(p4.w, w3, ap);
        an = fmaf(n4.x, w0, an); an = fmaf(n4.y, w1, an);
        an = fmaf(n4.z, w2, an); an = fmaf(n4.w, w3, an);
      }
      const size_t o = static_cast<size_t>(sidx[q]) * k + c;
      ph[o] = ah;
      pp[o] = ap;
      pn[o] = an;
      er[o] = e;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
transr_bwd_units_kernel(const int4* __restrict__ units,
                        const int* __restrict__ perm,
                        const float* __restrict__ eh,
                        const float* __restrict__ ep,
                        const float* __restrict__ en,
                        const float* __restrict__ w_rel,
                        const float* __restrict__ gph,
                        const float* __restrict__ gpp,
                        const float* __restrict__ gpn,
                        const float* __restrict__ ger,
                        float* __restrict__ geh, float* __restrict__ gep,
                        float* __restrict__ gen,
                        float* __restrict__ partials, int d, int k) {
  const int4 unit = units[blockIdx.x];
  if (unit.y >= unit.z) return;  // past the plan's last unit: the block
  extern __shared__ float4 bwd_smem[];
  const int ks = w_stride(k), k4 = k / 4, n_tiles = (d / 4) * k4;
  const int dk = d * k;
  float* sw = reinterpret_cast<float*>(bwd_smem);
  float* sx = sw + d * ks;            // (3, kStage, d): eh, ep, en rows
  float* sg = sx + 3 * kStage * d;    // (4, kStage, k): d ph, pp, pn, e_r
  int* sidx = reinterpret_cast<int*>(sg + 4 * kStage * k);  // (kStage,)
  float* part = partials + static_cast<size_t>(blockIdx.x) * (dk + k);
  stage_w(w_rel + static_cast<size_t>(unit.x) * dk, sw, d, k);
  // Thread (j, qa): row j of W_r, rows qa, qa + groups, ... of the unit.
  const int j = threadIdx.x % d, qa = threadIdx.x / d, groups = kThreads / d;
  float er_sum = 0.f;  // thread c < k: the unit's sum of d e_r[:, c]
  for (int p0 = unit.y; p0 < unit.z; p0 += kStage) {
    const int n = min(kStage, unit.z - p0);
    __syncthreads();  // W_r staged; the previous rows read
    stage_idx(perm, p0, n, sidx);
    __syncthreads();
    stage_rows(sidx, n, 3, eh, ep, en, nullptr, d, sx);
    stage_rows(sidx, n, 4, gph, gpp, gpn, ger, k, sg);
    __syncthreads();
    if (qa < groups) {
      const float* wr = sw + j * ks;
      for (int q = qa; q < n; q += groups) {
        const float* gh = sg + q * k;
        const float* gp = sg + (kStage + q) * k;
        const float* gn = sg + (2 * kStage + q) * k;
        float ah = 0.f, ap = 0.f, an = 0.f;
        for (int c = 0; c < k; c += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wr + c);
          const float4 h4 = *reinterpret_cast<const float4*>(gh + c);
          const float4 p4 = *reinterpret_cast<const float4*>(gp + c);
          const float4 n4 = *reinterpret_cast<const float4*>(gn + c);
          ah = fmaf(w4.x, h4.x, ah); ah = fmaf(w4.y, h4.y, ah);
          ah = fmaf(w4.z, h4.z, ah); ah = fmaf(w4.w, h4.w, ah);
          ap = fmaf(w4.x, p4.x, ap); ap = fmaf(w4.y, p4.y, ap);
          ap = fmaf(w4.z, p4.z, ap); ap = fmaf(w4.w, p4.w, ap);
          an = fmaf(w4.x, n4.x, an); an = fmaf(w4.y, n4.y, an);
          an = fmaf(w4.z, n4.z, an); an = fmaf(w4.w, n4.w, an);
        }
        const size_t o = static_cast<size_t>(sidx[q]) * d + j;
        geh[o] = ah;
        gep[o] = ap;
        gen[o] = an;
      }
    }
    // The unit's partial of W_r's gradient: 4 x 4 tiles, rows in order,
    // each row's three products in the order h, t+, t-; a later group of
    // rows adds to what the earlier wrote.
    for (int t = threadIdx.x; t < n_tiles; t += kThreads) {
      const int j0 = (t / k4) * 4, c0 = (t % k4) * 4;
      float acc[4][4] = {};
      for (int q = 0; q < n; ++q) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(sx + (v * kStage + q) * d + j0);
          const float4 g4 =
              *reinterpret_cast<const float4*>(sg + (v * kStage + q) * k + c0);
          const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
          const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(xs[a], gs[b], acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* dst = reinterpret_cast<float4*>(part + (j0 + a) * k + c0);
        float4 s = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        if (p0 > unit.y) {
          const float4 prev = *dst;
          s = make_float4(prev.x + s.x, prev.y + s.y, prev.z + s.z,
                          prev.w + s.w);
        }
        *dst = s;
      }
    }
    if (threadIdx.x < k) {
      for (int q = 0; q < n; ++q)
        er_sum += sg[(3 * kStage + q) * k + threadIdx.x];
    }
  }
  if (threadIdx.x < k) part[dk + threadIdx.x] = er_sum;
}

// Relation blockIdx.y: its units' partials summed in unit order, element
// o of the (d k + k) slot: d w_rel[rel] for o < d k, then d rel_embed[rel].
__global__ void __launch_bounds__(kThreads)
transr_bwd_fold_kernel(const int* __restrict__ unit_offsets,
                       const float* __restrict__ partials, int d, int k,
                       float* __restrict__ d_w, float* __restrict__ d_er) {
  const int rel = blockIdx.y, dk = d * k, width = dk + k;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= width) return;
  const int u1 = unit_offsets[rel + 1];
  float s = 0.f;
  for (int u = unit_offsets[rel]; u < u1; ++u)
    s += partials[static_cast<size_t>(u) * width + o];
  if (o < dk)
    d_w[static_cast<size_t>(rel) * dk + o] = s;
  else
    d_er[static_cast<size_t>(rel) * k + o - dk] = s;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool widths_ok(int d, int k) {
  return d >= 4 && k >= 4 && d % 4 == 0 && k % 4 == 0 && d <= kThreads &&
         k <= kThreads;
}

// Dynamic shared memory above the default 48 KB needs the kernel's leave.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// r: (n,) int64 relations in [0, n_rel); perm (n,), rel_offsets and
// unit_offsets (n_rel + 1,) int32; units: (n_units, 4) int32, n_units at
// least ceil(n / unit_rows) + n_rel.
extern "C" int kgat_transr_plan(const void* r, int n, int n_rel,
                                int unit_rows, int n_units, void* perm,
                                void* rel_offsets, void* units,
                                void* unit_offsets, void* stream) {
  if (n <= 0 || n_rel <= 0 || unit_rows <= 0 ||
      n_units < (n + unit_rows - 1) / unit_rows + n_rel ||
      !aligned16(units) || reinterpret_cast<uintptr_t>(r) % 8 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (static_cast<size_t>(n) +
                                     (kPlanThreads / 32 + 3) * n_rel + 2);
  cudaError_t err = allow_smem(transr_plan_kernel, smem);
  if (err != cudaSuccess) return err;
  transr_plan_kernel<<<1, kPlanThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(r), n, n_rel, unit_rows, n_units,
      static_cast<int*>(perm), static_cast<int*>(rel_offsets),
      static_cast<int4*>(units), static_cast<int*>(unit_offsets));
  return cudaGetLastError();
}

// units, perm: the plan's; eh, ep, en: (n, d); rel_embed (n_rel, k);
// w_rel (n_rel, d, k); ph, pp, pn, er: (n, k); all float32, contiguous,
// 16-byte aligned.
extern "C" int kgat_transr_fwd(const void* units, int n_units,
                               const void* perm, const void* eh,
                               const void* ep, const void* en,
                               const void* rel_embed, const void* w_rel,
                               void* ph, void* pp, void* pn, void* er, int d,
                               int k, void* stream) {
  if (n_units <= 0 || !widths_ok(d, k) || !aligned16(units) ||
      !aligned16(eh) || !aligned16(ep) || !aligned16(en) ||
      !aligned16(w_rel))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (static_cast<size_t>(d) * w_stride(k) +
                                       kStage * (3 * d + 1));
  const cudaError_t err = allow_smem(transr_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  transr_fwd_kernel<<<n_units, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(units), static_cast<const int*>(perm),
      static_cast<const float*>(eh), static_cast<const float*>(ep),
      static_cast<const float*>(en), static_cast<const float*>(rel_embed),
      static_cast<const float*>(w_rel), static_cast<float*>(ph),
      static_cast<float*>(pp), static_cast<float*>(pn),
      static_cast<float*>(er), d, k);
  return cudaGetLastError();
}

// The plan's units, unit_offsets and perm; the forward's eh, ep, en and
// w_rel; gph, gpp, gpn, ger: (n, k) cotangents; geh, gep, gen: (n, d);
// partials: (n_units, d k + k) scratch; d_w (n_rel, d, k), d_er
// (n_rel, k). All float32, contiguous, 16-byte aligned.
extern "C" int kgat_transr_bwd(const void* units, int n_units,
                               const void* unit_offsets, const void* perm,
                               const void* eh, const void* ep, const void* en,
                               const void* w_rel, const void* gph,
                               const void* gpp, const void* gpn,
                               const void* ger, void* geh, void* gep,
                               void* gen, void* partials, void* d_w,
                               void* d_er, int n_rel, int d, int k,
                               void* stream) {
  if (n_units <= 0 || n_rel <= 0 || !widths_ok(d, k) || !aligned16(units) ||
      !aligned16(eh) || !aligned16(ep) || !aligned16(en) ||
      !aligned16(w_rel) || !aligned16(gph) || !aligned16(gpp) ||
      !aligned16(gpn) || !aligned16(partials))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(d) * w_stride(k) +
                                       kStage * (3 * d + 4 * k + 1));
  cudaError_t err = allow_smem(transr_bwd_units_kernel, smem);
  if (err != cudaSuccess) return err;
  const auto p = static_cast<float*>(partials);
  transr_bwd_units_kernel<<<n_units, kThreads, smem, st>>>(
      static_cast<const int4*>(units), static_cast<const int*>(perm),
      static_cast<const float*>(eh), static_cast<const float*>(ep),
      static_cast<const float*>(en), static_cast<const float*>(w_rel),
      static_cast<const float*>(gph), static_cast<const float*>(gpp),
      static_cast<const float*>(gpn), static_cast<const float*>(ger),
      static_cast<float*>(geh), static_cast<float*>(gep),
      static_cast<float*>(gen), p, d, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((d * k + k + kThreads - 1) / kThreads, n_rel);
  transr_bwd_fold_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(unit_offsets), p, d, k,
      static_cast<float*>(d_w), static_cast<float*>(d_er));
  return cudaGetLastError();
}
