// The trainer's Adam step as one launch over every parameter: optax.adam's
// arithmetic (b1, b2, eps outside the square root) on each value, its
// gradient and both moments, each read once and written once (the gradient
// only read), and the one step count that all parameters share advanced.
//
// Replaces no TPU kernel: kgat_tpu steps optax.adam under jit, where XLA
// fuses the update into one pass over each leaf. The port ran
// torch.optim.Adam's capturable multi-tensor path: some ten _foreach ops a
// step, each a pass over all 9.1 M values at Yelp2018, and two of them
// divisions by lists of 0-d tensors that run one broadcast kernel per
// tensor (0.35 device-ms of a 1.1-ms KG step on an H100). torch's fused
// Adam makes one pass but rounds b1 and b2 to float32 before it forms
// 1 - b1 and 1 - b2, so each step's second-moment increment is 1.29e-5
// too small (1 - fl(0.999) against 0.001), and it needs a second launch
// for the step counts.
//
// What bounds it: bytes. A value costs 28 bytes (p, g, m, v read; p, m, v
// written): 256 MB at Yelp2018, 76 us at 3.35 TB/s; 11 operations a
// value are nothing beside that. Design:
//  * a host-built table of the parameters (pointers to p, g, m, v, the
//    length and the first chunk) and a table of chunks of 1,024 values,
//    one block a chunk; both live on the device and keep their addresses,
//    so a CUDA graph replays the launch.
//  * each block reads the count c, forms 1 - b^(c + 1) in double once and
//    rounds it to float32; a thread then loads one float4 of each of p,
//    g, m, v and stores p, m, v. A chunk that is short (a tensor's last)
//    or not 16-byte aligned takes a scalar loop. One float4 a thread keeps
//    the kernel at 38 registers and the SMs full of warps: on an H100 at
//    Yelp2018's shapes it ran 0.096 ms (2.66 TB/s), where two a thread ran
//    0.100 and four (89 registers) 0.126; issuing the loads before the
//    counts' powers ran slower (0.113).
//  * the count: every block reads it before it arrives at a ticket
//    counter; the last block to arrive writes c + 1 and resets the
//    counter, so no block reads a count already advanced.
// Float32 in optax's order: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v,
// p = p - lr (m / c1) / (sqrt(v / c2) + eps), each operation IEEE-rounded
// (nvcc's default -prec-div and -prec-sqrt; its FMA contraction may fuse a
// product into the following sum).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4;  // values a block: a float4 a thread

struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  long long first_chunk;
};

struct Hyper {
  float lr, b1, b2, eps, one_minus_b1, one_minus_b2;
  double b1d, b2d;
};

__device__ __forceinline__ void adam_value(float& p, float g, float& m,
                                           float& v, float c1, float c2,
                                           const Hyper& h) {
  m = h.one_minus_b1 * g + h.b1 * m;
  v = h.one_minus_b2 * (g * g) + h.b2 * v;
  const float u = (m / c1) / (sqrtf(v / c2) + h.eps);
  p = p - h.lr * u;
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g,
                                         float4& m, float4& v, float c1,
                                         float c2, const Hyper& h) {
  adam_value(p.x, g.x, m.x, v.x, c1, c2, h);
  adam_value(p.y, g.y, m.y, v.y, c1, c2, h);
  adam_value(p.z, g.z, m.z, v.z, c1, c2, h);
  adam_value(p.w, g.w, m.w, v.w, c1, c2, h);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const AdamTensor* __restrict__ tensors,
                const int* __restrict__ chunk_tensor, float* step,
                unsigned int* ticket, Hyper h) {
  __shared__ float s_c1, s_c2, s_count;
  if (threadIdx.x == 0) {
    const float count = *step + 1.0f;
    s_count = count;
    s_c1 = static_cast<float>(1.0 - pow(h.b1d, static_cast<double>(count)));
    s_c2 = static_cast<float>(1.0 - pow(h.b2d, static_cast<double>(count)));
  }
  __syncthreads();
  const float c1 = s_c1, c2 = s_c2;
  const AdamTensor t = tensors[chunk_tensor[blockIdx.x]];
  const long long start =
      (static_cast<long long>(blockIdx.x) - t.first_chunk) * kChunk;
  const long long len = t.n - start < kChunk ? t.n - start : kChunk;
  float* p = t.p + start;
  const float* g = t.g + start;
  float* m = t.m + start;
  float* v = t.v + start;
  if (len == kChunk && aligned16(p) && aligned16(g) && aligned16(m) &&
      aligned16(v)) {
    const int i = threadIdx.x * 4;
    float4 P = *reinterpret_cast<const float4*>(p + i);
    const float4 G = *reinterpret_cast<const float4*>(g + i);
    float4 M = *reinterpret_cast<const float4*>(m + i);
    float4 V = *reinterpret_cast<const float4*>(v + i);
    adam_vec(P, G, M, V, c1, c2, h);
    *reinterpret_cast<float4*>(p + i) = P;
    *reinterpret_cast<float4*>(m + i) = M;
    *reinterpret_cast<float4*>(v + i) = V;
  } else {
    for (long long i = threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = m[i], vi = v[i];
      adam_value(pi, g[i], mi, vi, c1, c2, h);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      *step = s_count;
      *ticket = 0u;
    }
  }
}

}  // namespace

// The values per block: a tensor of n values takes ceil(n / chunk) blocks.
extern "C" int kgat_adam_chunk() { return kChunk; }

// tensors: n_tensors AdamTensor records (pointers to float32 p, g, m, v, n,
// first chunk), chunk_tensor: n_chunks ints (each chunk's tensor), step:
// one float32, ticket: one uint32 at 0; all on the device of the stream.
extern "C" int kgat_adam(const void* tensors, int n_tensors,
                         const void* chunk_tensor, int n_chunks, void* step,
                         void* ticket, double lr, double b1, double b2,
                         double eps, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 ||
      reinterpret_cast<uintptr_t>(tensors) % 8 != 0)
    return cudaErrorInvalidValue;
  const Hyper h{static_cast<float>(lr),        static_cast<float>(b1),
                static_cast<float>(b2),        static_cast<float>(eps),
                static_cast<float>(1.0 - b1),  static_cast<float>(1.0 - b2),
                b1,                            b2};
  adam_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamTensor*>(tensors),
      static_cast<const int*>(chunk_tensor), static_cast<float*>(step),
      static_cast<unsigned int*>(ticket), h);
  return cudaGetLastError();
}
