// K7: ring shift, one partition's (R, d) activation chunk stored into the
//     receive buffer of the partition `step` hops along the ring.
// K8: fused reduce + send, K6's row reduction of a ring bucket's value
//     stream and, in the same grid, K7's store of the chunk into the right
//     neighbour's receive buffer.
//
// K7 replaces kgat_tpu/ops/pallas/remote_ring.py::_shift_kernel (via
// _build_shift / make_ring_shift); K8 replaces ::_reduce_send_kernel (via
// make_reduce_send). On the TPU both are remote DMAs between chips with
// send/receive semaphores and a barrier. The port runs every partition in
// one process: a partition's neighbour is on the same card or on a peer
// card of the host, so the remote copy is a kernel that stores into the
// neighbour's buffer through a plain device pointer, or through a peer
// pointer over NVLink once peer access is enabled. The wrapper orders the
// receiving stream after the launch with an event: that takes the place of
// the semaphores. The receive buffer is never one that a launch of the
// same step reads (the wrapper refuses aliased buffers), which takes the
// place of the barrier.
//
// What bounds them on the H100: bytes. K7 reads and writes the chunk once
// (R * d * 4 bytes in f32) at 3.35 TB/s on one card, or at the 450 GB/s of
// one NVLink direction across cards. K8 moves K6's bytes (the bucket's
// value stream in, (R, d) f32 sums out) plus K7's. Design for that: 16-byte
// vector loads and stores, grid-stride, for the copy; K6's warp-per-row
// reduction (row_reduce.cuh) for the sums. K8 splits its grid: the first
// blocks copy, the rest reduce, so the send runs beside the reduction, as
// the TPU kernel overlaps its DMA with its MXU reduce (remote_ring.py:
// 106-113).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_reduce.cuh"

namespace {

constexpr int kCopyThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxShiftBlocks = 528;  // 4 per SM of an H100
constexpr int kMaxSendBlocks = 132;   // 1 per SM: the reduction keeps the rest

// Blocks [0, n_blocks) of the grid copy nbytes from src to dst, 16 bytes a
// thread where both pointers allow it, then the tail byte by byte.
__device__ __forceinline__ void copy_range(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           size_t nbytes, int block,
                                           int n_blocks, bool vec16) {
  const size_t tid = static_cast<size_t>(block) * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(n_blocks) * blockDim.x;
  size_t done = 0;
  if (vec16) {
    const size_t n16 = nbytes / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (size_t i = tid; i < n16; i += stride) d[i] = s[i];
    done = n16 * 16;
  }
  for (size_t i = done + tid; i < nbytes; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(kCopyThreads)
ring_shift_kernel(const char* __restrict__ src, char* __restrict__ dst,
                  size_t nbytes, bool vec16) {
  copy_range(src, dst, nbytes, blockIdx.x, gridDim.x, vec16);
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
reduce_send_kernel(const int* __restrict__ row_offsets,
                   const T* __restrict__ vals, float* __restrict__ sums,
                   int n_rows, int d, const char* __restrict__ chunk,
                   char* __restrict__ next, size_t nbytes, bool vec16,
                   int n_copy_blocks) {
  if (static_cast<int>(blockIdx.x) < n_copy_blocks) {
    copy_range(chunk, next, nbytes, blockIdx.x, n_copy_blocks, vec16);
    return;
  }
  const int row =
      (blockIdx.x - n_copy_blocks) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps exit together
  kgat::reduce_row<T, CPL, false, false>(row_offsets, nullptr, nullptr, vals,
                                         sums, row, threadIdx.x % 32, d);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

int copy_blocks(size_t nbytes, int cap) {
  const size_t per_block = static_cast<size_t>(kCopyThreads) * 16;
  const size_t n = (nbytes + per_block - 1) / per_block;
  return static_cast<int>(n < 1 ? 1 : (n > static_cast<size_t>(cap) ? cap : n));
}

template <typename T>
cudaError_t launch_reduce_send(const int* row_offsets, const T* vals,
                               float* sums, int n_rows, int d,
                               const char* chunk, char* next, size_t nbytes,
                               cudaStream_t stream) {
  const int n_copy = copy_blocks(nbytes, kMaxSendBlocks);
  const dim3 grid(n_copy + (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const bool vec16 = aligned16(chunk, next);
  switch (kgat::cols_per_lane(d)) {
    case 1:
      reduce_send_kernel<T, 1><<<grid, block, 0, stream>>>(
          row_offsets, vals, sums, n_rows, d, chunk, next, nbytes, vec16,
          n_copy);
      break;
    case 2:
      reduce_send_kernel<T, 2><<<grid, block, 0, stream>>>(
          row_offsets, vals, sums, n_rows, d, chunk, next, nbytes, vec16,
          n_copy);
      break;
    case 4:
      reduce_send_kernel<T, 4><<<grid, block, 0, stream>>>(
          row_offsets, vals, sums, n_rows, d, chunk, next, nbytes, vec16,
          n_copy);
      break;
    case 8:
      reduce_send_kernel<T, 8><<<grid, block, 0, stream>>>(
          row_offsets, vals, sums, n_rows, d, chunk, next, nbytes, vec16,
          n_copy);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int kgat_ring_shift(const void* src, void* dst, size_t nbytes,
                               void* stream) {
  if (nbytes == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<const char*>(src);
  const auto d = static_cast<char*>(dst);
  ring_shift_kernel<<<copy_blocks(nbytes, kMaxShiftBlocks), kCopyThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(s, d, nbytes,
                                                           aligned16(s, d));
  return cudaGetLastError();
}

extern "C" int kgat_reduce_send(const void* row_offsets, const void* vals,
                                void* sums, int n_rows, int d,
                                int vals_is_bf16, const void* chunk,
                                void* next, size_t nbytes, void* stream) {
  if (n_rows <= 0 || d <= 0 || nbytes == 0) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto ro = static_cast<const int*>(row_offsets);
  const auto o = static_cast<float*>(sums);
  const auto c = static_cast<const char*>(chunk);
  const auto n = static_cast<char*>(next);
  if (vals_is_bf16) {
    return launch_reduce_send(ro, static_cast<const __nv_bfloat16*>(vals), o,
                              n_rows, d, c, n, nbytes, st);
  }
  return launch_reduce_send(ro, static_cast<const float*>(vals), o, n_rows, d,
                            c, n, nbytes, st);
}

// Lets kernels on `device` store into memory of `peer` (NVLink or PCIe).
// Enabling it twice is not an error.
extern "C" int kgat_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-free error state
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return e != cudaSuccess ? e : back;
}
