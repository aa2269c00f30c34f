// K2 on Hopper: one-sided window delivery into rank-stacked landing slots.
//
// Replaces bluefog_tpu/ops/pallas_gossip.py::deliver_pallas (the "put" and
// "acc" bodies of _make_exchange_kernel).  On the TPU each rank is a chip: the
// kernel RDMAs its payload into slot k of rank (i + s_k) mod n's persistent
// (K, ...) landing buffers, and the receiver keeps the arrival (put) or adds
// it to what the slot held (acc), in the wire dtype, wherever the slot has a
// live in-edge.  Here the n ranks are virtual, rows of one (n, L) payload and
// one (n, K, L) block of landing buffers on one card, so the remote write into
// a neighbour's slot becomes a read of the sender's row:
//
//   pay = to_wire(dst_weight * x[recv_src[i, k], j])
//   put: bufs[i, k, j] = pay
//   acc: bufs[i, k, j] = to_wire(bufs[i, k, j] + pay)
//
// for every rank i and slot k with mask[i, k] != 0 and a source in [0, n);
// other slots are left untouched.  The buffers hold f32, bf16, f16 or f64.
// The arithmetic runs in f32 (f64 for f64 buffers), and the payload is
// rounded to the buffers' dtype before the add, so acc matches the JAX
// path's `peers[k] + recvd` in the leaf dtype (ops/windows.py, the sender's
// _weighted rounding included); unlike K1, acc does not accumulate in f32.
// f16 thus rides an f32 wire, as deliver_pallas carries it; f64 stays f64,
// where the TPU kernel, for want of f64, rounds it through f32.  The product
// and the sum are rounded on their own (__fmul_rn / __fadd_rn, and their f64
// forms; no contraction to fma), so the kernel agrees bit for bit with the
// plain version (ops/deliver_kernel.py::window_deliver_plain).  bufs is updated in place: an out-of-place copy of a
// ResNet-50 window (8 ranks x 3 slots x 25,557,032 f32) would allocate 2.45 GB
// per put.  The wrapper refuses a payload that overlaps bufs.
//
// What bounds it: memory.  put must read the payload once and write K slots
// per rank; acc also reads the K old slots.  At the WinPut main path's shape
// (n = 8, K = 3 on Exponential-2, L = 25,557,032 f32) put moves 0.818 GB +
// 2.453 GB = 3.27 GB, 0.977 ms at the H100's 3.35 TB/s, and acc 5.72 GB,
// 1.709 ms; push-sum's acc on the directed ring (K = 1) moves 2.45 GB, 0.732
// ms.  One multiply and at most one add per element are far below the f32
// rate.  The K readers of one payload row would cost K passes over it if they
// missed the cache, so the 1-D grid runs the rank fastest, then the slot, then
// the column chunk: the n * K blocks that share a chunk are adjacent in launch
// order, the chunk of all n payload rows (n * 256 threads * 16 B = 32 KB at
// n = 8) is fetched from HBM once, and the other slots' reads hit the 50 MB
// L2.  A block covers one (rank, slot) pair, so a dead slot's block returns
// before touching memory, and put never reads the old slot.  Loads and stores
// are 16-byte vectors when the row length and the pointers allow it (the
// wrapper checks), with a masked tail; otherwise one element per thread.
//
// The TPU version's DMA semaphores, collective ids and tile padding
// (_pad_to_tiles) order the transfer and fit it to VMEM; they change no
// result.  Its barrier handshake has a counterpart in the peer-memory form
// (window_deliver_peer_kernel), where the ranks are spread over processes
// and a delivery stores into a landing slot in another process's window,
// mapped into this one (CUDA IPC on one card, NVLink peer memory across
// cards).  The transport (ops/transport.py) orders it with interprocess
// events: a sender waits for the receivers' last win_update to finish
// reading before it stores, and a receiver's win_update waits for the
// senders' stores.  Both forms run one body (deliver_chunk), so the peer
// form is bit-equal to the virtual one.  Its bound is the virtual form's:
// the payload read once and every live slot written (and, for acc, read)
// once, counted over all processes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Arithmetic type A of a buffer type T: float, or double for double.
template <typename T> struct Arith { using type = float; };
template <> struct Arith<double> { using type = double; };

__device__ __forceinline__ float to_arith(float v) { return v; }
__device__ __forceinline__ double to_arith(double v) { return v; }
__device__ __forceinline__ float to_arith(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_arith(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_arith(typename Arith<T>::type v);
template <>
__device__ __forceinline__ float from_arith<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_arith<double>(double v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_arith<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_arith<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Load VEC elements starting at p; `remain` elements are valid.  READ_ONLY
// routes the load through the read-only cache (the payload, which this
// kernel never writes); the old slot contents are read plainly.
template <typename T, int VEC, bool READ_ONLY, typename A>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         long long remain, A (&v)[VEC]) {
  if constexpr (VEC > 1) {
    if (remain >= VEC) {
      uint4 raw = READ_ONLY ? __ldg(reinterpret_cast<const uint4*>(p))
                            : *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = to_arith(e[j]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = j < remain ? to_arith(p[j]) : A(0);
}

template <typename T, int VEC, typename A>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long long remain,
                                          const A (&v)[VEC]) {
  if constexpr (VEC > 1) {
    if (remain >= VEC) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_arith<T>(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j < remain) p[j] = from_arith<T>(v[j]);
  }
}

// The body both forms share: one thread's VEC elements of one delivery,
// src_row into dst_row, put or acc.  Keeping one body keeps the two forms'
// arithmetic identical.
template <typename T, int VEC, bool ACC, typename A>
__device__ __forceinline__ void deliver_chunk(const T* __restrict__ src_row,
                                              T* __restrict__ dst_row, A w,
                                              long long start,
                                              long long remain) {
  A v[VEC];
  load_vec<T, VEC, true>(src_row + start, remain, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    // the payload is rounded to the buffers' dtype before it lands
    v[j] = to_arith(from_arith<T>(mul_rn(w, v[j])));
  }
  T* out = dst_row + start;
  if constexpr (ACC) {
    A old[VEC];
    load_vec<T, VEC, false>(out, remain, old);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = add_rn(old[j], v[j]);
  }
  store_vec<T, VEC>(out, remain, v);
}

template <typename T, int VEC, bool ACC>
__global__ void __launch_bounds__(kThreads)
window_deliver_kernel(const T* __restrict__ x, T* __restrict__ bufs,
                      const int* __restrict__ recv_src,
                      const int* __restrict__ mask,
                      typename Arith<T>::type w, int n, int num_slots,
                      long long len) {
  // rank fastest, then slot: blocks c*n*K .. c*n*K + n*K-1 cover column
  // chunk c of every (rank, slot) pair
  const int pairs = n * num_slots;
  const int pair = static_cast<int>(blockIdx.x % pairs);
  const int rank = pair % n;
  const int slot = pair / n;
  const long long chunk = blockIdx.x / pairs;
  const long long start = (chunk * kThreads + threadIdx.x) * VEC;
  if (start >= len) return;
  const int idx = rank * num_slots + slot;
  if (__ldg(mask + idx) == 0) return;  // no in-edge: the slot keeps its value
  const int src = __ldg(recv_src + idx);
  if (src < 0 || src >= n) return;
  deliver_chunk<T, VEC, ACC>(
      x + src * len,
      bufs + (static_cast<long long>(rank) * num_slots + slot) * len, w,
      start, len - start);
}

// The peer-memory form: this process's payload rows, delivered into
// landing slots that live in other processes' windows, mapped into this
// one, or in its own.  Delivery d reads owned payload row src_rows[d] and
// lands it at device address dsts[d]; the table lists only live slots.
template <typename T, int VEC, bool ACC>
__global__ void __launch_bounds__(kThreads)
window_deliver_peer_kernel(const T* __restrict__ x,
                           const unsigned long long* __restrict__ dsts,
                           const int* __restrict__ src_rows,
                           int deliveries, typename Arith<T>::type w,
                           long long len) {
  // delivery fastest: the deliveries of one payload row's chunk are
  // adjacent in launch order and read it from L2
  const int d = static_cast<int>(blockIdx.x % deliveries);
  const long long chunk = blockIdx.x / deliveries;
  const long long start = (chunk * kThreads + threadIdx.x) * VEC;
  if (start >= len) return;
  deliver_chunk<T, VEC, ACC>(
      x + static_cast<long long>(__ldg(src_rows + d)) * len,
      reinterpret_cast<T*>(__ldg(dsts + d)), w, start, len - start);
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* bufs, const int* recv_src,
                   const int* mask, double dst_weight, int n, int num_slots,
                   long long len, bool accumulate, cudaStream_t stream) {
  // the weight rounded once to the arithmetic type, as the plain version
  // rounds it
  const auto w = static_cast<typename Arith<T>::type>(dst_weight);
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (len + per_block - 1) / per_block;
  const long long blocks = chunks * n * num_slots;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (accumulate) {
    window_deliver_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(bufs), recv_src, mask, w,
        n, num_slots, len);
  } else {
    window_deliver_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(bufs), recv_src, mask, w,
        n, num_slots, len);
  }
  return cudaGetLastError();
}

// vec is 1, or 16 bytes' worth of T
template <typename T>
cudaError_t launch_any(int vec, const void* x, void* bufs,
                       const int* recv_src, const int* mask,
                       double dst_weight, int n, int num_slots, long long len,
                       bool accumulate, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return launch<T, kVec>(x, bufs, recv_src, mask, dst_weight, n, num_slots,
                           len, accumulate, stream);
  }
  if (vec == 1) {
    return launch<T, 1>(x, bufs, recv_src, mask, dst_weight, n, num_slots,
                        len, accumulate, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t launch_peer(const void* x, const void* dsts, const int* src_rows,
                        int deliveries, double dst_weight, long long len,
                        bool accumulate, cudaStream_t stream) {
  const auto w = static_cast<typename Arith<T>::type>(dst_weight);
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const long long chunks = (len + per_block - 1) / per_block;
  const long long blocks = chunks * deliveries;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  const auto* table = static_cast<const unsigned long long*>(dsts);
  if (accumulate) {
    window_deliver_peer_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), table, src_rows, deliveries, w, len);
  } else {
    window_deliver_peer_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), table, src_rows, deliveries, w, len);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_peer_any(int vec, const void* x, const void* dsts,
                            const int* src_rows, int deliveries,
                            double dst_weight, long long len, bool accumulate,
                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return launch_peer<T, kVec>(x, dsts, src_rows, deliveries, dst_weight,
                                len, accumulate, stream);
  }
  if (vec == 1) {
    return launch_peer<T, 1>(x, dsts, src_rows, deliveries, dst_weight, len,
                             accumulate, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (n, len) payload; bufs: (n, num_slots, len) landing buffers, updated in
// place; recv_src, mask: (n, num_slots) int32.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16, 3 = float64.  vec: 1, or 16 bytes' worth of
// elements (4, 8, 8, 2 by dtype), which needs len % vec == 0 and 16-byte
// aligned x and bufs.  accumulate: 0 = put, 1 = acc.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int bf_window_deliver(const void* x, void* bufs,
                                 const int* recv_src, const int* mask,
                                 double dst_weight, int n, int num_slots,
                                 long long len, int dtype, int vec,
                                 int accumulate, void* stream) {
  if (n <= 0 || num_slots <= 0 || len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      err = launch_any<float>(vec, x, bufs, recv_src, mask, dst_weight, n,
                              num_slots, len, acc, s);
      break;
    case 1:
      err = launch_any<__nv_bfloat16>(vec, x, bufs, recv_src, mask,
                                      dst_weight, n, num_slots, len, acc, s);
      break;
    case 2:
      err = launch_any<__half>(vec, x, bufs, recv_src, mask, dst_weight, n,
                               num_slots, len, acc, s);
      break;
    case 3:
      err = launch_any<double>(vec, x, bufs, recv_src, mask, dst_weight, n,
                               num_slots, len, acc, s);
      break;
  }
  return static_cast<int>(err);
}

// K2's peer-memory form.  x: the owned (m, len) payload; dsts: a device
// table of `deliveries` landing-slot addresses (this process's or mapped
// peers'); src_rows: the payload row each reads (int32).  dtype, vec and
// accumulate as for bf_window_deliver; vec > 1 needs len % vec == 0 and
// every address 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int bf_window_deliver_peer(const void* x, const void* dsts,
                                      const int* src_rows, int deliveries,
                                      double dst_weight, long long len,
                                      int dtype, int vec, int accumulate,
                                      void* stream) {
  if (deliveries <= 0 || len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      err = launch_peer_any<float>(vec, x, dsts, src_rows, deliveries,
                                   dst_weight, len, acc, s);
      break;
    case 1:
      err = launch_peer_any<__nv_bfloat16>(vec, x, dsts, src_rows,
                                           deliveries, dst_weight, len, acc,
                                           s);
      break;
    case 2:
      err = launch_peer_any<__half>(vec, x, dsts, src_rows, deliveries,
                                    dst_weight, len, acc, s);
      break;
    case 3:
      err = launch_peer_any<double>(vec, x, dsts, src_rows, deliveries,
                                    dst_weight, len, acc, s);
      break;
  }
  return static_cast<int>(err);
}
