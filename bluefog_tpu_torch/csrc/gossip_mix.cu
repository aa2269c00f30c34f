// K1 on Hopper: the fused weighted gossip reduction over rank-stacked rows.
//
// Replaces bluefog_tpu/ops/pallas_gossip.py::neighbor_allreduce_pallas (the
// "gossip" body of _make_exchange_kernel).  On the TPU each rank is a chip:
// the kernel RDMAs its tensor to rank (i + s_k) mod n for every circulant slot
// k and folds the arrivals into out = sw*x + sum_k rw[k]*recv_k in f32 on
// arrival, so no received payload is ever materialized in HBM.  Here the n
// ranks are virtual, rows of one (n, L) buffer on one card, and the exchange
// is a read of a neighbor's row:
//
//   out[i, j] = sw[i] * x[i, j] + sum_k rw[i, k] * x[recv_src[i, k], j]
//
// accumulated in f32 and stored in the wire dtype (f32, or bf16 for bf16
// leaves).  Slots whose source lies outside [0, n) are skipped.  The plain
// PyTorch version (ops/gossip_kernel.py::gossip_mix_plain) materializes one
// gathered copy per slot; this kernel never does.  Every product and every
// sum is rounded on its own (__fmul_rn / __fadd_rn, no contraction to fma), in
// slot order, so the kernel agrees bit for bit with the plain version.
//
// What bounds it: memory.  Each element of x must be read once and each
// element of out written once.  At the main path's shape (8 ranks x
// 25,557,032 f32 params of ResNet-50) that is 2 * 8 * 25,557,032 * 4 B =
// 1.64 GB, or 0.49 ms at the H100's 3.35 TB/s; the 2*(K+1) flops per element
// (24 MFLOP per 1M elements at K = 3) are far below the f32 rate.  The K
// neighbor reads of a column chunk would cost K more passes over HBM if they
// missed the cache, so the 1-D grid runs the rank fastest: the n blocks that
// share a column chunk are adjacent in launch order, the chunk of all n rows
// (n * 256 threads * 16 B = 32 KB at n = 8) is fetched from HBM once, and the
// neighbor reads hit the 50 MB L2.  Loads and stores are 16-byte vectors when
// the row length and the pointers allow it (the wrapper checks), with a masked
// tail; otherwise one element per thread.
//
// Chunking, tile padding (_pad_to_tiles) and collective-id leases of the TPU
// version are VMEM and semaphore bookkeeping that change no result, and have
// no counterpart here.
//
// The peer-memory form (gossip_mix_peer_kernel) is the counterpart of the
// TPU kernel's remote DMA when the ranks are spread over processes, each
// owning a contiguous block of m rows: a slot's source row is then an
// address, into this process's block or into a peer's block mapped here
// (CUDA IPC between processes on one card; the same address is an NVLink
// peer read across cards).  The wrapper's transport (ops/transport.py)
// orders the processes with interprocess events, so the kernel never waits
// on another process's flag: kernels of processes that share a card
// time-slice, and a spin would stall for whole slices.  Both forms run one
// body (mix_chunk), so the peer form is bit-equal to the virtual one on the
// same rows.  Its bound: each owned row and each of its K source rows read
// once, each output row written once; a neighbour's row cannot come from L2,
// as the processes' kernels do not run together.  At the main path's
// lengths, over all 8 ranks and K = 3: 5 * 8 * 25,557,032 * 4 B = 4.09 GB,
// 1.22 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Load VEC elements starting at p as floats; `remain` elements are valid.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         long long remain, float (&v)[VEC]) {
  if constexpr (VEC > 1) {
    if (remain >= VEC) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = to_float(e[j]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = j < remain ? to_float(p[j]) : 0.0f;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long long remain,
                                          const float (&v)[VEC]) {
  if constexpr (VEC > 1) {
    if (remain >= VEC) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_float<T>(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j < remain) p[j] = from_float<T>(v[j]);
  }
}

// The body both forms share: one thread's VEC elements of one output row,
// out = self_w * self + sum_k rw[k] * row_of(k), folded in f32 in slot order
// with every product and sum rounded on its own.  row_of(k) is the source
// row of slot k, or nullptr where the slot has no edge.  Keeping one body
// keeps the two forms' arithmetic identical.
template <typename T, int VEC, typename RowOf>
__device__ __forceinline__ void mix_chunk(const T* __restrict__ self_row,
                                          T* __restrict__ out_row,
                                          float self_w,
                                          const float* __restrict__ rw_row,
                                          int num_slots, long long start,
                                          long long remain, RowOf row_of) {
  float acc[VEC];
  float v[VEC];
  load_vec<T, VEC>(self_row + start, remain, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(self_w, v[j]);

  for (int k = 0; k < num_slots; ++k) {
    const T* src = row_of(k);
    if (src == nullptr) continue;  // no edge in this slot
    const float w = __ldg(rw_row + k);
    load_vec<T, VEC>(src + start, remain, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, v[j]));
  }
  store_vec<T, VEC>(out_row + start, remain, acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const float* __restrict__ sw, const float* __restrict__ rw,
                  const int* __restrict__ recv_src, int n, int num_slots,
                  long long len) {
  // rank fastest: blocks b*n .. b*n+n-1 cover column chunk b of every row
  const int rank = static_cast<int>(blockIdx.x % n);
  const long long chunk = blockIdx.x / n;
  const long long start = (chunk * kThreads + threadIdx.x) * VEC;
  if (start >= len) return;
  const int* src_row = recv_src + rank * num_slots;
  mix_chunk<T, VEC>(x + rank * len, out + rank * len, __ldg(sw + rank),
                    rw + rank * num_slots, num_slots, start, len - start,
                    [&](int k) -> const T* {
                      const int src = __ldg(src_row + k);
                      return (src < 0 || src >= n) ? nullptr : x + src * len;
                    });
}

// The peer-memory form: the source rows live in other processes' buffers,
// mapped into this one (CUDA IPC on one card, NVLink peer memory across
// cards), or in this process's own.  rows[i * num_slots + k] is the device
// address of the row slot k of owned rank i reads (nullptr: no edge); self
// and out are the owned (m, len) blocks.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gossip_mix_peer_kernel(const T* __restrict__ self, T* __restrict__ out,
                       const float* __restrict__ sw,
                       const float* __restrict__ rw,
                       const unsigned long long* __restrict__ rows, int m,
                       int num_slots, long long len) {
  const int rank = static_cast<int>(blockIdx.x % m);
  const long long chunk = blockIdx.x / m;
  const long long start = (chunk * kThreads + threadIdx.x) * VEC;
  if (start >= len) return;
  const unsigned long long* row = rows + rank * num_slots;
  mix_chunk<T, VEC>(self + rank * len, out + rank * len, __ldg(sw + rank),
                    rw + rank * num_slots, num_slots, start, len - start,
                    [&](int k) -> const T* {
                      return reinterpret_cast<const T*>(__ldg(row + k));
                    });
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const float* sw, const float* rw,
                   const int* recv_src, int n, int num_slots, long long len,
                   cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (len + per_block - 1) / per_block;
  const long long blocks = chunks * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gossip_mix_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), sw, rw, recv_src, n,
      num_slots, len);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_peer(const void* self, void* out, const float* sw,
                        const float* rw, const void* rows, int m,
                        int num_slots, long long len, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (len + per_block - 1) / per_block;
  const long long blocks = chunks * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gossip_mix_peer_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads,
                                   0, stream>>>(
      static_cast<const T*>(self), static_cast<T*>(out), sw, rw,
      static_cast<const unsigned long long*>(rows), m, num_slots, len);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of elements
// (4 for float32, 8 for bfloat16), which needs len % vec == 0 and 16-byte
// aligned x and out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int bf_gossip_mix(const void* x, void* out, const float* sw,
                             const float* rw, const int* recv_src, int n,
                             int num_slots, long long len, int dtype, int vec,
                             void* stream) {
  if (n <= 0 || len <= 0 || num_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch<float, 4>(x, out, sw, rw, recv_src, n, num_slots, len, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch<float, 1>(x, out, sw, rw, recv_src, n, num_slots, len, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(x, out, sw, rw, recv_src, n, num_slots,
                                   len, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(x, out, sw, rw, recv_src, n, num_slots,
                                   len, s);
  }
  return static_cast<int>(err);
}

// K1's peer-memory form.  self, out: the owned (m, len) blocks; rows: a
// device table of m * num_slots row addresses (0 where a slot has no edge).
// dtype and vec as for bf_gossip_mix; vec > 1 needs len % vec == 0 and every
// address 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int bf_gossip_mix_peer(const void* self, void* out, const float* sw,
                                  const float* rw, const void* rows, int m,
                                  int num_slots, long long len, int dtype,
                                  int vec, void* stream) {
  if (m <= 0 || len <= 0 || num_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = launch_peer<float, 4>(self, out, sw, rw, rows, m, num_slots, len, s);
  } else if (dtype == 0 && vec == 1) {
    err = launch_peer<float, 1>(self, out, sw, rw, rows, m, num_slots, len, s);
  } else if (dtype == 1 && vec == 8) {
    err = launch_peer<__nv_bfloat16, 8>(self, out, sw, rw, rows, m, num_slots,
                                        len, s);
  } else if (dtype == 1 && vec == 1) {
    err = launch_peer<__nv_bfloat16, 1>(self, out, sw, rw, rows, m, num_slots,
                                        len, s);
  }
  return static_cast<int>(err);
}

// Symmetric buffers for the peer-memory forms of K1 and K2.  A buffer is
// allocated with cudaMalloc, outside PyTorch's caching allocator, so that
// its IPC handle names exactly this allocation (a cached block's handle
// would name the whole segment it was carved from).  Each returns a
// cudaError_t (0 on success).

// Allocate `bytes` on `device`, zeroed, and write its 64-byte IPC handle.
extern "C" int bf_peer_alloc(long long bytes, int device, void** ptr,
                             void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(err);
}

// Map another process's buffer into this one.  A process cannot open its
// own handle: its rows are read through its own address.
extern "C" int bf_peer_open(const void* handle, int device, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int bf_peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int bf_peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}
