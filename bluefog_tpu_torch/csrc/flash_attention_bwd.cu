// K3's backward in bf16 on Hopper: the dK/dV and dQ kernels on wgmma.
//
// Replaces, with flash_attention.cu's forward, the Pallas TPU kernel that
// bluefog_tpu/ops/ring_attention.py::local_attention calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py):
//
//   bwd_dkv_wgmma  <- _flash_attention_bwd_dkv  dK, dV
//   bwd_dq_wgmma   <- _flash_attention_bwd_dq   dQ, and di = rowsum(o * dO)
//
// The function is the library's: P = exp2(S s log2(e) - lse2) with lse2 =
// m log2(e) + log2(l) from the forward's residuals, dS = P (dP - di) s, the
// aligned causal mask (key tiles above the diagonal skipped whole, P = 0 for
// a key after its query inside the diagonal tile), and P and dS rounded to
// bf16 before P^T dO, dS^T Q and dS K, as the library rounds them.  The split
// into two kernels is the library's too: each block owns its output tile (a
// 64-key tile of dK and dV, a 64-query tile of dQ) and loops over the other
// axis, so there are no atomics and the gradients are the same run to run.
// The dQ kernel runs first and also writes di = sum(o * dO) in f32 for its
// query rows (the library computes it in XLA between its kernels); the dK/dV
// kernel reads it.
//
// Design, for one warpgroup (128 threads, 64 rows) per block:
// - Products on wgmma.mma_async m64nNk16 with f32 accumulators.  In dK/dV,
//   per query tile: S^T = K Q^T and dP^T = V dO^T with A (K or V, resident
//   for the whole loop) and B (Q or dO) from shared memory, both K-major;
//   then dV += P^T dO and dK += dS^T Q with A from registers (the S^T and
//   dP^T accumulators rounded to bf16: the m64 accumulator's per-warp layout
//   is mma.m16n8's C layout, which is the A operand's) and B MN-major (dO or
//   Q with D contiguous).  The dQ kernel does the same with S = Q K^T, dP =
//   dO V^T and dQ += dS K.  S and dP are two commit groups, so P is computed
//   while dP is still in flight; the products whose A is P or dS are issued
//   together once both are packed, and waited on before anything else runs.
//   K and V (Q and dO) stay in shared memory: held in registers as A
//   fragments across the loop, ptxas gave their registers to P and dS after
//   the first tile (dK and dV came out wrong on the card), and the dQ kernel
//   ran slower that way besides.
// - Operand tiles sit in the swizzled layout the descriptors name: columns
//   in atoms of 64 (128-byte rows, 128-byte swizzle) when D is a multiple of
//   64, else of 32 (64-byte rows, 64-byte swizzle), so D = 96 is three
//   atoms.  One layout serves both the K-major and the MN-major reads.
// - The streamed tiles (Q, dO, l, m and di in dK/dV; K and V in dQ) come
//   through a ring of stages (2 in dK/dV, 3 in dQ at D <= 64) filled by
//   cp.async, which writes the swizzled layout from any token stride that
//   is a multiple of 8 elements: the load of the tile one ring ahead is
//   issued as tile i's products start, and one block barrier per tile
//   orders both.  The wrapper copies a view whose strides or pointer are
//   not 16-byte aligned; the model's views never are.
// - The element-wise work is kept short: exp2 is one ex2.approx.ftz, and
//   only the diagonal tile pays for the causal mask.
// - The cp.async, swizzle and wgmma helpers are flash_wgmma.cuh's, shared
//   with the forward.
// - The longest causal loops first: dK/dV's key tile 0 and dQ's last query
//   tile have the most work and get the lowest block ids.
//
// What bounds it: at the transformer path's shape (B=8, H=12, T=1024, D=64,
// causal) dK/dV does 8 B H D T(T+1)/2 = 2.58e10 flops on 2.5e7 bytes and dQ
// 6 B H D T(T+1)/2 = 1.93e10 on 1.9e7 bytes: both are bound by the tensor
// cores (0.026 and 0.020 ms at 989 TFLOP/s), with exp2 on the special
// function units about half the products' time beside them.  PERF.md has
// how far from these bounds the kernels run.

#include "flash_wgmma.cuh"

namespace {

// per head dim: the rings' stages and the blocks per SM the registers are
// budgeted for (both chosen by timing on the card)
template <int D>
struct Cfg : Tile<D> {
  static constexpr int kStagesDkv = 2;
  static constexpr int kStagesDq = D <= 64 ? 3 : 2;
  static constexpr int kMinBlocksDkv = D <= 64 ? 3 : 1;
  static constexpr int kMinBlocksDq = D <= 64 ? 3 : 2;
};

enum { tQ = 0, tK, tV, tDO, tO, tDQ, tDK, tDV, kNumTensors };

struct BwdArgs {
  const uint16_t* in[5];  // q, k, v, dout, o
  uint16_t* out[3];       // dq, dk, dv
  const float* l;         // (B, H, T) f32 row sums
  const float* m;         // (B, H, T) f32 row maxima
  float* di;              // (B, H, T) f32: written by dQ, read by dK/dV
  long long st[kNumTensors][3];  // (batch, head, token) strides, elements
  int H, T, causal;
  float scale;
};

__device__ __forceinline__ const uint16_t* head(const BwdArgs& a, int which,
                                                int b, int h) {
  return a.in[which] + b * a.st[which][0] + h * a.st[which][1];
}

// P^T in place of S^T (dK/dV): rows are keys kr0 and kr0 + 8, columns the
// tile's queries 8 j + 2 t (+1) with their lse2 in shared memory; kMask:
// the diagonal tile, where a key after its query gets 0
template <bool kMask>
__device__ __forceinline__ void probs_by_column(float* p, const float* lse,
                                                float sl2, int kr0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(lse + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(p[4 * j + e] * sl2 - ((e & 1) ? ls.y : ls.x));
      const bool masked = kr0 + ((e >> 1) << 3) > qc + (e & 1);
      p[4 * j + e] = kMask && masked ? 0.f : x;
    }
  }
}

// P in place of S (dQ): rows are queries r0 and r0 + 8 with lse2 lse0 and
// lse1, columns the tile's keys 8 j + 2 t (+1); kMask as above
template <bool kMask>
__device__ __forceinline__ void probs_by_row(float* p, float lse0, float lse1,
                                             float sl2, int r0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e >> 1;
      const float x = ex2(p[4 * j + e] * sl2 - (hi ? lse1 : lse0));
      const bool masked = 8 * j + 2 * t + (e & 1) > r0 + (hi ? 8 : 0);
      p[4 * j + e] = kMask && masked ? 0.f : x;
    }
  }
}

// log2 of a row's softmax denominator: m log2(e) + log2(l), so that P =
// exp2(S s log2(e) - lse2) = exp(S s - m) / l
__device__ __forceinline__ float lse2(const float* l, const float* m,
                                      long long i) {
  return m[i] * kLog2e + log2f(l[i]);
}

// --- dK/dV ------------------------------------------------------------------
//
// Shared memory: K | V | stages x (Q | dO) | stages x f32 [l | m | di |
// lse2] of the stage's 64 queries.

template <int D>
__global__ void __launch_bounds__(kWgThreads, Cfg<D>::kMinBlocksDkv)
    bwd_dkv_wgmma(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int S = C::kStagesDkv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase;
  const uint32_t sK = aligned_base(smem_raw, &gbase);
  const uint32_t sV = sK + C::kTileBytes;
  const uint32_t sRing = sV + C::kTileBytes;
  const int float_off = (2 + 2 * S) * C::kTileBytes;
  float* sF = reinterpret_cast<float*>(gbase + float_off);
  const uint32_t sF32 = sK + float_off;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kt = blockIdx.y, k0 = kt * kRows;
  const int qt0 = a.causal ? kt : 0;
  const int n = a.T / kRows - qt0;
  const uint16_t* q = head(a, tQ, b, h);
  const uint16_t* dout = head(a, tDO, b, h);
  const long long stq = a.st[tQ][2], stdo = a.st[tDO][2];
  const long long rows = static_cast<long long>(bh) * a.T;

  // tile i of the loop (query tile qt0 + i) into stage i % S; the thread
  // that copies a query's l and m later turns them into its lse2
  auto load_stage = [&](int i) {
    const int s = i % S, q0 = (qt0 + i) * kRows;
    const uint32_t sq = sRing + s * 2 * C::kTileBytes;
    load_tile<D>(sq, q + q0 * stq, stq, tid);
    load_tile<D>(sq + C::kTileBytes, dout + q0 * stdo, stdo, tid);
    if (tid < kRows) {
      const uint32_t f = sF32 + (s * 4 * kRows + tid) * 4;
      const long long r = rows + q0 + tid;
      cp_async4(f, a.l + r);
      cp_async4(f + kRows * 4, a.m + r);
      cp_async4(f + 2 * kRows * 4, a.di + r);
    }
  };
  load_tile<D>(sK, head(a, tK, b, h) + k0 * a.st[tK][2], a.st[tK][2], tid);
  load_tile<D>(sV, head(a, tV, b, h) + k0 * a.st[tV][2], a.st[tV][2], tid);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }
  const int kr0 = warp * 16 + g;  // this thread's keys: kr0 and kr0 + 8

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    float* f = sF + s * 4 * kRows;
    cp_async_wait<S - 2>();
    if (tid < kRows) {
      f[3 * kRows + tid] = lse2(f, f + kRows, tid);
    }
    fence_proxy_async();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    if (i + S - 1 < n) load_stage(i + S - 1);
    cp_async_commit();

    const uint32_t sQ = sRing + s * 2 * C::kTileBytes;
    const uint32_t sDO = sQ + C::kTileBytes;
    float p[32], dp[32];
    pin<D / 2>(dv);
    pin<D / 2>(dk);
    wgmma_fence();
    mma_abt<D>(p, sK, sQ);  // S^T = K Q^T
    wgmma_commit();
    mma_abt<D>(dp, sV, sDO);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    pin<32>(p);

    if (a.causal && qt0 + i == kt) {
      probs_by_column<true>(p, f + 3 * kRows, sl2, kr0, t);
    } else {
      probs_by_column<false>(p, f + 3 * kRows, sl2, kr0, t);
    }
    const float* di = f + 2 * kRows;
    wgmma_wait<0>();  // dP^T is in
    pin<32>(dp);

    // dS^T = P^T (dP^T - di) s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] =
            (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * p[4 * j + e] * a.scale;
      }
    }
    // nothing runs while the products that read pa and dsa are in flight
    uint32_t pa[16], dsa[16];
    acc_to_a(pa, p);
    acc_to_a(dsa, dp);
    wgmma_fence();
    mma_ab<D>(dv, pa, sDO);  // dV += P^T dO
    mma_ab<D>(dk, dsa, sQ);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    pin<D / 2>(dv);
    pin<D / 2>(dk);
  }

  store_acc<D>(a.out[1] + b * a.st[tDK][0] + h * a.st[tDK][1], a.st[tDK][2],
               dk, k0 + kr0, t);
  store_acc<D>(a.out[2] + b * a.st[tDV][0] + h * a.st[tDV][1], a.st[tDV][2],
               dv, k0 + kr0, t);
}

// --- dQ and di --------------------------------------------------------------
//
// Shared memory: Q | dO | stages x (K | V) | f32 di of the block's queries.

template <int D>
__global__ void __launch_bounds__(kWgThreads, Cfg<D>::kMinBlocksDq)
    bwd_dq_wgmma(const BwdArgs a) {
  using C = Cfg<D>;
  constexpr int S = C::kStagesDq;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase;
  const uint32_t sQ = aligned_base(smem_raw, &gbase);
  const uint32_t sDO = sQ + C::kTileBytes;
  const uint32_t sRing = sDO + C::kTileBytes;
  float* sDi = reinterpret_cast<float*>(gbase + (2 + 2 * S) * C::kTileBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the longest causal rows first: they have the most key tiles
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kRows;
  const int n = a.causal ? qt + 1 : a.T / kRows;
  const uint16_t* k = head(a, tK, b, h);
  const uint16_t* v = head(a, tV, b, h);
  const uint16_t* dout = head(a, tDO, b, h);
  const long long stk = a.st[tK][2], stv = a.st[tV][2];
  const long long stdo = a.st[tDO][2];
  const long long rows = static_cast<long long>(bh) * a.T;

  auto load_stage = [&](int i) {  // key tile i into stage i % S
    const uint32_t sk = sRing + (i % S) * 2 * C::kTileBytes;
    load_tile<D>(sk, k + i * kRows * stk, stk, tid);
    load_tile<D>(sk + C::kTileBytes, v + i * kRows * stv, stv, tid);
  };
  load_tile<D>(sQ, head(a, tQ, b, h) + q0 * a.st[tQ][2], a.st[tQ][2], tid);
  load_tile<D>(sDO, dout + q0 * stdo, stdo, tid);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }

  // di = sum(o * dO) in f32, two threads per query row, each over half of
  // D in 16-byte vectors, while the first tiles load
  {
    const int r = tid >> 1, half = tid & 1;
    const int c0 = half * (D / 2);
    const uint16_t* orow = head(a, tO, b, h) + (q0 + r) * a.st[tO][2] + c0;
    const uint16_t* drow = dout + (q0 + r) * stdo + c0;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(orow + c));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(drow + c));
      const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yo = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(xo[j]);
        const float2 yf = __bfloat1622float2(yo[j]);
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDi[r] = acc;
      a.di[rows + q0 + r] = acc;
    }
  }
  const int r0 = warp * 16 + g;  // this thread's queries: r0 and r0 + 8
  const float lse0 = lse2(a.l, a.m, rows + q0 + r0);
  const float lse1 = lse2(a.l, a.m, rows + q0 + r0 + 8);
  __syncthreads();
  const float di0 = sDi[r0], di1 = sDi[r0 + 8];

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();  // key tile i landed; every thread is done with i - 1
    if (i + S - 1 < n) load_stage(i + S - 1);
    cp_async_commit();

    const uint32_t sK = sRing + (i % S) * 2 * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    float p[32], dp[32];
    pin<D / 2>(dq);
    wgmma_fence();
    mma_abt<D>(p, sQ, sK);  // S = Q K^T
    wgmma_commit();
    mma_abt<D>(dp, sDO, sV);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    pin<32>(p);

    if (a.causal && i == qt) {
      probs_by_row<true>(p, lse0, lse1, sl2, r0, t);
    } else {
      probs_by_row<false>(p, lse0, lse1, sl2, r0, t);
    }
    wgmma_wait<0>();  // dP is in
    pin<32>(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] = (dp[4 * j + e] - ((e >> 1) ? di1 : di0)) *
                        p[4 * j + e] * a.scale;
      }
    }
    uint32_t dsa[16];
    acc_to_a(dsa, dp);
    wgmma_fence();
    mma_ab<D>(dq, dsa, sK);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    pin<D / 2>(dq);
  }

  store_acc<D>(a.out[0] + b * a.st[tDQ][0] + h * a.st[tDQ][1], a.st[tDQ][2],
               dq, q0 + r0, t);
}

// --- launch -----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, const BwdArgs& a, int B, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * a.H, a.T / kRows);
  kernel<<<grid, kWgThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dynamic shared memory: 1 KB to align the tiles to their swizzle pattern,
// the two resident tiles and the ring, the floats
template <int D>
size_t smem_bytes(bool dq) {
  using C = Cfg<D>;
  const int stages = dq ? C::kStagesDq : C::kStagesDkv;
  const size_t tiles = 1024 + (2 + 2 * stages) * C::kTileBytes;
  return tiles + (dq ? kRows : stages * 4 * kRows) * sizeof(float);
}

template <int D>
cudaError_t launch_d(bool dq, const BwdArgs& a, int B, cudaStream_t stream) {
  if (dq) return launch(bwd_dq_wgmma<D>, a, B, smem_bytes<D>(true), stream);
  return launch(bwd_dkv_wgmma<D>, a, B, smem_bytes<D>(false), stream);
}

int run(bool dq, const BwdArgs& a, int B, int D, void* stream) {
  if (B <= 0 || a.H <= 0 || a.T <= 0 || a.T % kRows != 0 ||
      a.T / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_d<32>(dq, a, B, s));
    case 64: return static_cast<int>(launch_d<64>(dq, a, B, s));
    case 96: return static_cast<int>(launch_d<96>(dq, a, B, s));
    case 128: return static_cast<int>(launch_d<128>(dq, a, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

BwdArgs make_args(const long long* strides, const int* which, int n_tensors,
                  int H, int T, int causal, double scale) {
  BwdArgs a = {};
  for (int i = 0; i < n_tensors; ++i) {
    for (int j = 0; j < 3; ++j) a.st[which[i]][j] = strides[3 * i + j];
  }
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.scale = static_cast<float>(scale);
  return a;
}

}  // namespace

// The bf16 entry points of flash_attention.cu's bf_flash_bwd_dkv and
// bf_flash_bwd_dq.  Every input's (batch, head, token) strides are multiples
// of 8 elements and its pointer 16-byte aligned (the wrapper copies a view
// that is not); strides as there, in argument order.
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* l, const float* m,
                       const float* di, void* dk, void* dv,
                       const long long* strides, int B, int H, int T, int D,
                       int causal, double scale, void* stream) {
  const int which[] = {tQ, tK, tV, tDO, tDK, tDV};
  BwdArgs a = make_args(strides, which, 6, H, T, causal, scale);
  a.in[tQ] = static_cast<const uint16_t*>(q);
  a.in[tK] = static_cast<const uint16_t*>(k);
  a.in[tV] = static_cast<const uint16_t*>(v);
  a.in[tDO] = static_cast<const uint16_t*>(dout);
  a.out[1] = static_cast<uint16_t*>(dk);
  a.out[2] = static_cast<uint16_t*>(dv);
  a.l = l;
  a.m = m;
  a.di = const_cast<float*>(di);
  return run(false, a, B, D, stream);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const float* l,
                      const float* m, float* di, void* dq,
                      const long long* strides, int B, int H, int T, int D,
                      int causal, double scale, void* stream) {
  const int which[] = {tQ, tK, tV, tDO, tO, tDQ};
  BwdArgs a = make_args(strides, which, 6, H, T, causal, scale);
  a.in[tQ] = static_cast<const uint16_t*>(q);
  a.in[tK] = static_cast<const uint16_t*>(k);
  a.in[tV] = static_cast<const uint16_t*>(v);
  a.in[tDO] = static_cast<const uint16_t*>(dout);
  a.in[tO] = static_cast<const uint16_t*>(o);
  a.out[0] = static_cast<uint16_t*>(dq);
  a.l = l;
  a.m = m;
  a.di = di;
  return run(true, a, B, D, stream);
}
