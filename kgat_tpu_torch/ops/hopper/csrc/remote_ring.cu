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
// value stream in, (R, d) f32 sums out) plus K7's. Design for that: for the
// copy, each thread issues two independent 16-byte loads before its two
// stores, and K7's grid is one full wave of the card (8 blocks of 256 a
// SM), which a grid-stride loop walks over the chunk (K8 copies with
// fewer blocks); K6's reduction over
// the bucket's work units (row_reduce.cuh) for the sums. K8 splits its
// grid: the first blocks copy, the rest walk the units, so the send runs
// beside the reduction, as the TPU kernel overlaps its DMA with its MXU
// reduce (remote_ring.py:106-113). Where the bucket has a row longer than
// CHUNK, a second launch sums that row's partials; the send stays in the
// first.
//
// Across processes (one process per card, kgat_tpu_torch.parallel.
// multihost), the kernels store into a receive buffer of the neighbour
// PROCESS. Each process allocates its receive buffers and their flags in
// one cudaMalloc of its own (kgat_ipc_alloc), outside PyTorch's caching
// allocator, exports it once with cudaIpcGetMemHandle (kgat_ipc_export),
// and its neighbours open it with cudaIpcOpenMemHandle (kgat_ipc_open);
// the kernels then store through that pointer as through a peer pointer.
// The allocation lives until every peer has closed its mapping
// (kgat_ipc_close, then kgat_ipc_free). The TPU kernel's send and receive
// semaphores become a flag in the receiver's memory, one per buffer:
// after the store the sender's stream writes 1 into it (kgat_signal,
// cuStreamWriteValue32, which fences the stream's earlier writes
// system-wide first), and a one-thread kernel on the receiver's stream
// waits until it reads 1 and writes 0 back (kgat_wait) before anything
// reads the buffer. The wait is bounded: past its timeout the kernel
// traps, which fails the process's context, so a peer that never stores
// ends the run instead of hanging it. A wait on an interprocess event
// would bind to the latest record that the waiting host has seen, which
// may be the previous step's when the receiver's host runs ahead; the
// flag binds each wait to its own store, in eager steps and in CUDA
// graphs alike (the write and the wait kernel are captured as graph
// nodes). The barrier of the TPU kernel is the caller's: every buffer is
// stored into once a step, and the gradient all-reduce that ends a step
// orders one step's reads before the next step's stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdio>
#include <cstdint>
#include <cstring>

#include "row_reduce.cuh"

namespace {

constexpr int kCopyThreads = 256;
static_assert(kCopyThreads == kgat::kWarpsPerBlock * 32,
              "K8's copy and reduce blocks have one size");
constexpr int kCopyUnroll = 2;        // 16-byte loads in flight a thread
constexpr int kShiftBlocksPerSm = 8;  // K7: 2,048 threads a SM, one wave
constexpr int kMaxSendBlocks = 132;   // 1 per SM: the reduction keeps the rest

// Blocks [0, n_blocks) of the grid copy nbytes from src to dst, 16 bytes
// at a time where both pointers allow it, then the tail byte by byte. A
// block's step covers kCopyUnroll * blockDim.x 16-byte words: a thread
// loads words t, t + blockDim.x, ... (coalesced) before it stores any.
__device__ __forceinline__ void copy_range(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           size_t nbytes, int block,
                                           int n_blocks, bool vec16) {
  size_t done = 0;
  if (vec16) {
    const size_t n16 = nbytes / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    const size_t step = static_cast<size_t>(kCopyUnroll) * blockDim.x;
    for (size_t i = block * step + threadIdx.x; i < n16;
         i += n_blocks * step) {
      int4 v[kCopyUnroll];
      // Guards only in the last step: nvcc may compile guarded loads into
      // branches, one load in flight at a time.
      if (i + (kCopyUnroll - 1) * blockDim.x < n16) {
#pragma unroll
        for (int j = 0; j < kCopyUnroll; ++j) v[j] = s[i + j * blockDim.x];
#pragma unroll
        for (int j = 0; j < kCopyUnroll; ++j) d[i + j * blockDim.x] = v[j];
      } else {
#pragma unroll
        for (int j = 0; j < kCopyUnroll; ++j) {
          if (i + j * blockDim.x < n16) v[j] = s[i + j * blockDim.x];
        }
#pragma unroll
        for (int j = 0; j < kCopyUnroll; ++j) {
          if (i + j * blockDim.x < n16) d[i + j * blockDim.x] = v[j];
        }
      }
    }
    done = n16 * 16;
  }
  const size_t tid = static_cast<size_t>(block) * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(n_blocks) * blockDim.x;
  for (size_t i = done + tid; i < nbytes; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(kCopyThreads)
ring_shift_kernel(const char* __restrict__ src, char* __restrict__ dst,
                  size_t nbytes, bool vec16) {
  copy_range(src, dst, nbytes, blockIdx.x, gridDim.x, vec16);
}

template <typename T, class L>
__global__ void __launch_bounds__(kCopyThreads)
reduce_send_kernel(const int4* __restrict__ units, int n_units,
                   const T* __restrict__ vals, float* __restrict__ sums,
                   float* __restrict__ partials, int d,
                   const char* __restrict__ chunk, char* __restrict__ next,
                   size_t nbytes, bool vec16, int n_copy_blocks) {
  if (static_cast<int>(blockIdx.x) < n_copy_blocks) {
    copy_range(chunk, next, nbytes, blockIdx.x, n_copy_blocks, vec16);
    return;
  }
  const int u = (blockIdx.x - n_copy_blocks) * kgat::kWarpsPerBlock +
                threadIdx.x / 32;
  if (u >= n_units) return;  // whole warps exit together
  kgat::reduce_unit<T, L, false>(units[u], nullptr, nullptr, vals, sums,
                                 partials, d, threadIdx.x % 32);
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(b) % 16 == 0);
}

// Blocks to copy nbytes in one pass of kCopyUnroll 16-byte words a
// thread, at most cap (the grid-stride loop then takes several).
int copy_blocks(size_t nbytes, int cap) {
  const size_t per_block = static_cast<size_t>(kCopyThreads) * kCopyUnroll * 16;
  const size_t n = (nbytes + per_block - 1) / per_block;
  return static_cast<int>(n < 1 ? 1 : (n > static_cast<size_t>(cap) ? cap : n));
}

template <typename T>
cudaError_t launch_reduce_send(const kgat::Split& s, const T* vals,
                               float* sums, float* partials, int d,
                               const char* chunk, char* next, size_t nbytes,
                               cudaStream_t stream) {
  const int n_copy = copy_blocks(nbytes, kMaxSendBlocks);
  const dim3 grid(n_copy + kgat::unit_blocks(s));
  const bool vec16 = aligned16(chunk, next);
  const bool vec = kgat::aligned16(vals) && kgat::aligned16(sums) &&
                   kgat::aligned16(partials);
  const cudaError_t e = kgat::with_layout<T>(d, vec, [&](auto layout) {
    reduce_send_kernel<T, decltype(layout)><<<grid, kCopyThreads, 0, stream>>>(
        s.units, s.n_units, vals, sums, partials, d, chunk, next, nbytes,
        vec16, n_copy);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return e;
  return kgat::launch_fixup(s, partials, sums, d, stream);
}

}  // namespace

extern "C" int kgat_ring_shift(const void* src, void* dst, size_t nbytes,
                               void* stream) {
  if (nbytes == 0) return cudaErrorInvalidValue;
  const auto s = static_cast<const char*>(src);
  const auto d = static_cast<char*>(dst);
  int device = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return e;
  ring_shift_kernel<<<copy_blocks(nbytes, kShiftBlocksPerSm * n_sm),
                      kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, d, nbytes, aligned16(s, d));
  return cudaGetLastError();
}

extern "C" int kgat_reduce_send(const void* units, int n_units,
                                const void* split_rows,
                                const void* slot_offsets, int n_split,
                                const void* vals, void* sums, void* partials,
                                int d, int vals_is_bf16, const void* chunk,
                                void* next, size_t nbytes, void* stream) {
  if (n_units <= 0 || d <= 0 || d > 256 || nbytes == 0 ||
      !kgat::aligned16(units)) {
    return cudaErrorInvalidValue;
  }
  const auto s = kgat::make_split(units, n_units, split_rows, slot_offsets,
                                  n_split);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<float*>(sums);
  const auto p = static_cast<float*>(partials);
  const auto c = static_cast<const char*>(chunk);
  const auto n = static_cast<char*>(next);
  if (vals_is_bf16) {
    return launch_reduce_send(s, static_cast<const __nv_bfloat16*>(vals), o,
                              p, d, c, n, nbytes, st);
  }
  return launch_reduce_send(s, static_cast<const float*>(vals), o, p, d, c,
                            n, nbytes, st);
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

// --- across processes -------------------------------------------------------

namespace {

// kgat codes from 10000 up carry a CUresult (code - kCuError).
constexpr int kCuError = 10000;
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "kgat_ipc_* move 64 bytes");

// The libcuda entry point the signal needs, looked up in the libcuda that
// the CUDA runtime has loaded (the library is linked against the runtime
// only).
using WriteValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                  unsigned int);

WriteValue32 write_value32() {
  static const WriteValue32 fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<WriteValue32>(
                                          dlsym(lib, "cuStreamWriteValue32_v2"));
  }();
  return fn;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned int load_acquire_sys(
    const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One thread: waits until the flag reads 1 (a peer's signal), then writes
// 0 back for the buffer's next store. Past timeout_ns it traps: the
// stream's context fails, and the process's next synchronisation raises,
// so a peer that never stores ends the run instead of hanging it (inside
// a replayed CUDA graph too, where no watchdog sees the wait).
__global__ void wait_flag_kernel(unsigned int* flag,
                                 unsigned long long timeout_ns) {
  const unsigned long long start = global_ns();
  while (load_acquire_sys(flag) != 1u) {
    if (global_ns() - start > timeout_ns) {
      printf("kgat_wait: no peer store reached flag %p in %llu ns\n",
             static_cast<void*>(flag), timeout_ns);
      __trap();
    }
    __nanosleep(1000);
  }
  *flag = 0u;
}

}  // namespace

// A device allocation of its own for a process's receive buffers and
// flags (zeroed), apart from PyTorch's caching allocator: its IPC handle
// names it alone, and it lives until kgat_ipc_free.
extern "C" int kgat_ipc_alloc(size_t nbytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, nbytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, nbytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return e;
}

extern "C" int kgat_ipc_free(void* ptr) { return cudaFree(ptr); }

// The IPC handle (64 bytes into `handle`) of a kgat_ipc_alloc allocation.
extern "C" int kgat_ipc_export(const void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, const_cast<void*>(ptr));
  if (e == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  return e;
}

// Maps another process's exported allocation into this one, on the
// current device (peer access enabled as needed); *base is its start.
extern "C" int kgat_ipc_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int kgat_ipc_close(void* base) {
  return cudaIpcCloseMemHandle(base);
}

// After the stream's earlier work: 1 into the flag (a peer's, through an
// opened handle), behind a system-wide fence of the stream's writes.
extern "C" int kgat_signal(void* flag, void* stream) {
  const WriteValue32 write = write_value32();
  if (write == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const CUresult r = write(static_cast<CUstream>(stream),
                           reinterpret_cast<CUdeviceptr>(flag), 1,
                           CU_STREAM_WRITE_VALUE_DEFAULT);
  return r == CUDA_SUCCESS ? 0 : kCuError + static_cast<int>(r);
}

// The stream's later work waits until the flag reads 1, for at most
// timeout_ns (wait_flag_kernel); 0 then goes back into it.
extern "C" int kgat_wait(void* flag, unsigned long long timeout_ns,
                         void* stream) {
  wait_flag_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(flag), timeout_ns);
  return cudaGetLastError();
}
