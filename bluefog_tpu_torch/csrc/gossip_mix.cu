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
// no counterpart here.  Per-slot source rows, rather than a shift baked into
// the kernel, let the same kernel read rows received over NCCL later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const long long remain = len - start;

  float acc[VEC];
  float v[VEC];
  load_vec<T, VEC>(x + rank * len + start, remain, v);
  const float self_w = __ldg(sw + rank);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(self_w, v[j]);

  for (int k = 0; k < num_slots; ++k) {
    const int src = __ldg(recv_src + rank * num_slots + k);
    if (src < 0 || src >= n) continue;  // no edge in this slot
    const float w = __ldg(rw + rank * num_slots + k);
    load_vec<T, VEC>(x + src * len + start, remain, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(w, v[j]));
  }
  store_vec<T, VEC>(out + rank * len + start, remain, acc);
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
