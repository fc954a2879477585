// The device samplers' negative draw: given the random numbers a KG or CF
// batch drew (torch.randint's indices, torch.rand's float64 uniforms), the
// batch's table gathers, the rank k of the negative among the allowed
// values, the rank_skip search that turns k into the value, the valid mask
// and the weight, in one launch.
//
// Replaces no TPU kernel: kgat_tpu's samplers (kgat_tpu/sampler.py) are
// jnp gathers and a lax.fori_loop bisection that XLA fuses under jit. The
// port's plain path (kgat_tpu_torch/sampler.py: kg_draw_plain,
// cf_draw_plain) runs the same integer arithmetic as separate torch ops:
// about 200 launches a KG batch (15 bisection rounds of a dozen
// elementwise ops at the Yelp2018 size, whose largest (h, r) run of
// forbidden tails is 17,837) and about 100 a CF batch, each a few
// microseconds on an H100, inside the replayed step graphs.
//
// What bounds it: latency, not bytes or operations. A KG batch of 2,048
// rows reads about 0.3 MB (the draws, five table entries a row, a few
// probes a round), 0.1 us at 3.35 TB/s; the time is the chain of dependent
// loads: the index, the table entries, then one probe a search round.
// Design:
//  * one warp a batch row. Every lane loads the row's draws and its table
//    entries (the same address across the warp: one request each, and all
//    of a level's loads in flight together), so no value has to be
//    broadcast by shuffle.
//  * the search splits 32 ways a round: lane j probes p = lo + j s, s =
//    ceil((hi - lo) / 32), with the predicate sorted_v[lo0 + p] - p <= k,
//    which holds on a prefix of [0, g) because a run holds sorted unique
//    values; __ballot_sync and __popc give the prefix's length and cut the
//    interval to under 1/32 of itself. It ends when the interval is one
//    point: ceil(log32(g + 1)) rounds for a run of g, 3 for 17,837, where
//    the plain bisection takes ceil(log2(max run + 1)) = 15 for every row.
//    The answer is rank_skip's, the least p in [0, g] at which the
//    predicate fails (p = g counts as failing), which is unique, so the
//    bits do not depend on the search.
//  * k as torch forms it: (int64)(u * (double)max(n_allowed, 1)), then
//    at most n_allowed - 1; a row with nothing allowed gets 0 and weight 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // batch rows a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

// rank_skip for one row on one warp: sorted_v[lo0, lo0 + g) is a sorted run
// of unique forbidden values, k a rank among the allowed ones; returns the
// number of forbidden values below the k-th allowed value.
__device__ __forceinline__ long long rank_skip_warp(
    const long long* __restrict__ sorted_v, long long lo0, long long g,
    long long k, int lane) {
  long long lo = 0, hi = g;
  while (lo < hi) {
    const long long s = (hi - lo + 31) >> 5;
    const long long p = lo + lane * s;
    const bool le = p < hi && sorted_v[lo0 + p] - p <= k;
    const int c = __popc(__ballot_sync(kAll, le));
    const long long top = lo + c * s;
    if (c > 0) lo += (c - 1) * s + 1;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// The negative's rank among n_allowed values from a uniform u in [0, 1),
// and the value it names.
__device__ __forceinline__ long long negative(
    const long long* __restrict__ sorted_v, long long lo0, long long g,
    long long n_allowed, double u, int lane) {
  long long k = static_cast<long long>(u * static_cast<double>(n_allowed));
  if (k > n_allowed - 1) k = n_allowed - 1;
  return k + rank_skip_warp(sorted_v, lo0, g, k, lane);
}

struct KGArgs {
  const long long* idx;       // (n,) triple indices
  const double* u01;          // (n,) uniforms
  const long long* h;         // the sampling list
  const long long* r;
  const long long* t;
  const long long* rg_lo;     // each triple's (h, r) run in t_sorted
  const long long* rg_hi;
  const long long* t_sorted;  // unique tails sorted by (h, r, t)
  long long n_entities;
  int n;
  long long* out;             // (4, n): h, r, t+, t-
  float* weight;              // (n,)
};

__global__ void __launch_bounds__(kThreads) kg_draw_kernel(KGArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n) return;  // the whole warp
  const long long i = a.idx[row];
  const double u = a.u01[row];
  const long long h = a.h[i], r = a.r[i], tp = a.t[i];
  const long long lo = a.rg_lo[i], g = a.rg_hi[i] - lo;
  const long long n_allowed = a.n_entities - g;
  const bool valid = n_allowed > 0;
  const long long tn =
      valid ? negative(a.t_sorted, lo, g, n_allowed, u, lane) : 0;
  if (lane == 0) {
    a.out[row] = h;
    a.out[a.n + row] = r;
    a.out[2LL * a.n + row] = tp;
    a.out[3LL * a.n + row] = tn;
    a.weight[row] = valid ? 1.0f : 0.0f;
  }
}

struct CFArgs {
  const long long* a_idx;         // (n,) indices into active_users
  const long long* p_bits;        // (n,) uniform bits in [0, 2^30)
  const double* u01;              // (n,) uniforms
  const long long* active_users;  // users with an item
  const long long* user_ptr;      // (n_users + 1,) offsets into items
  const long long* items;         // each user's items, sorted, unique
  long long n_items;
  int n;
  long long* out;                 // (3, n): u, i+, i-
  float* weight;                  // (n,)
};

__global__ void __launch_bounds__(kThreads) cf_draw_kernel(CFArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n) return;  // the whole warp
  const long long ai = a.a_idx[row];
  const long long bits = a.p_bits[row];
  const double u = a.u01[row];
  const long long user = a.active_users[ai];
  const long long lo = a.user_ptr[user], deg = a.user_ptr[user + 1] - lo;
  // Loaded now, used at the store: in flight during the search.
  const long long pos = a.items[lo + bits % (deg > 0 ? deg : 1)];
  const long long n_allowed = a.n_items - deg;
  const bool valid = n_allowed > 0;
  const long long neg =
      valid ? negative(a.items, lo, deg, n_allowed, u, lane) : 0;
  if (lane == 0) {
    a.out[row] = user;
    a.out[a.n + row] = pos;
    a.out[2LL * a.n + row] = neg;
    a.weight[row] = valid ? 1.0f : 0.0f;
  }
}

inline int blocks(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

// Every pointer is to a contiguous tensor on the device of the stream:
// int64 (long long) tables and indices, float64 uniforms, the int64 output
// ((4, n) for a KG batch, (3, n) for a CF batch) and the (n,) float32
// weight.
extern "C" int kgat_kg_draw(const void* idx, const void* u01, const void* h,
                            const void* r, const void* t, const void* rg_lo,
                            const void* rg_hi, const void* t_sorted,
                            long long n_entities, int n, void* out,
                            void* weight, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const KGArgs a{static_cast<const long long*>(idx),
                 static_cast<const double*>(u01),
                 static_cast<const long long*>(h),
                 static_cast<const long long*>(r),
                 static_cast<const long long*>(t),
                 static_cast<const long long*>(rg_lo),
                 static_cast<const long long*>(rg_hi),
                 static_cast<const long long*>(t_sorted),
                 n_entities,
                 n,
                 static_cast<long long*>(out),
                 static_cast<float*>(weight)};
  kg_draw_kernel<<<blocks(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" int kgat_cf_draw(const void* a_idx, const void* p_bits,
                            const void* u01, const void* active_users,
                            const void* user_ptr, const void* items,
                            long long n_items, int n, void* out, void* weight,
                            void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const CFArgs a{static_cast<const long long*>(a_idx),
                 static_cast<const long long*>(p_bits),
                 static_cast<const double*>(u01),
                 static_cast<const long long*>(active_users),
                 static_cast<const long long*>(user_ptr),
                 static_cast<const long long*>(items),
                 n_items,
                 n,
                 static_cast<long long*>(out),
                 static_cast<float*>(weight)};
  cf_draw_kernel<<<blocks(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
