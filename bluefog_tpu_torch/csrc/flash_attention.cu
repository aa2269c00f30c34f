// K3 on Hopper: the library flash attention, forward and backward, as three
// kernels.
//
// Replaces the Pallas TPU kernel that bluefog_tpu/ops/ring_attention.py::
// local_attention calls (jax/experimental/pallas/ops/tpu/flash_attention.py),
// with the same split into three launches:
//
//   flash_fwd      <- _flash_attention_impl     O = softmax(Q K^T s) V, l, m
//   flash_bwd_dkv  <- _flash_attention_bwd_dkv  dK, dV
//   flash_bwd_dq   <- _flash_attention_bwd_dq   dQ, and D_i = rowsum(O * dO)
//
// with s the softmax scale, l the row sum exp(S s - m) and m the row max of
// S s, both f32 (B, H, T): the library's residuals, which it broadcasts over
// 128 lanes and which are kept one value per row here.  The TPU kernel walks a
// sequential grid and carries its running max, sum and accumulator in VMEM
// scratch across grid steps; here each block owns one tile of rows and loops
// over the other axis itself (FlashAttention-2's shape), since CUDA blocks run
// in parallel, in no order:
//
// - forward: one block per (batch*head, 64-row query tile) loops over the
//   64-key tiles (up to the diagonal when causal): S = Q K^T s, an online
//   softmax in f32 (running max and sum per row), O += P V with P rounded to
//   the input dtype, as the library rounds it.  O is stored in the input
//   dtype, l and m in f32.
// - dQ, launched first: one block per query tile computes D_i = rowsum(O *
//   dO) of its rows (the library computes it in XLA between its kernels),
//   writes it, and loops over the key tiles: dS = P (dO V^T - D_i) s, dQ +=
//   dS K.
// - dK/dV: one block per key tile loops over the query tiles (from the
//   diagonal when causal), rebuilds P = exp(Q K^T s - m) / l, and accumulates
//   dV += P^T dO and dK += dS^T Q with dQ's D_i.  No block writes what
//   another reads, so there are no atomics and the gradients are the same
//   from run to run.
//
// The causal mask is the aligned one: key tiles above the diagonal are
// skipped whole, and inside the diagonal tile a key after its query gets
// probability 0 (the library adds -0.7 * FLT_MAX to its score, which exp
// takes to 0).  Tensors are (B, H, T, D) with any batch, head and token
// strides and D contiguous: the model's q, k and v are views of its fused
// qkv projection, read in place.
//
// This file holds the forward in both dtypes and the f32 backward; the bf16
// backward is flash_attention_bwd.cu (wgmma, pipelined cp.async tile loads),
// which states its own design and bound.  The bf16 forward runs on the
// tensor cores: mma.sync.m16n8k16 with f32 accumulation, four warps per
// block, each warp owning 16 rows of the tile; S stays in registers, and its
// accumulator fragment is reused as the A operand of P V (FA2's register
// reuse).  Head dims 32, 64, 96 and 128 are instantiated.  f32 runs on plain
// f32 FMA (32-row tiles in shared memory, any head dim up to 128), never in
// TF32.
//
// What bounds it: at the transformer path's shape (B=8, H=12, T=1024, D=64,
// causal) the forward does 4 B H D T(T+1)/2 = 1.29e10 flops against 5.1e7
// bytes of q, k, v, o, l and m: 0.013 ms at 989 TFLOP/s against 0.015 ms at
// 3.35 TB/s, so the two bounds nearly meet.  The forward is still the simple
// first version: mma.sync from padded shared memory (row stride D + 8
// halves, free of bank conflicts for the fragment loads), synchronous tile
// loads, no wgmma, TMA, pipelining or warp specialisation; it reaches a
// fraction of the bound, and PERF.md records how much.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // four warps
constexpr int kTile = 64;            // rows per tile, tensor-core kernels
constexpr int kTile32 = 32;          // rows per tile, f32 kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum { kQ = 0, kK, kV, kDO, kO, kDQ, kDK, kDV, kNumTensors };

struct Args {
  const void* in[5];     // q, k, v, dout, o (an input of dQ)
  void* out[4];          // o, dq, dk, dv
  float* l;              // (B, H, T) f32 row sums
  float* m;              // (B, H, T) f32 row maxima
  float* di;             // (B, H, T) f32: written by dQ, read by dK/dV
  long long st[kNumTensors][3];  // (batch, head, token) strides, elements
  int B, H, T, D, causal, vec;
  float scale;
};

// element offset of (b, h, token 0) in tensor `which`
__device__ __forceinline__ long long base_off(const Args& a, int which, int b,
                                              int h) {
  return b * a.st[which][0] + h * a.st[which][1];
}

// --- bf16 -------------------------------------------------------------------

struct BF16 {
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// two values rounded to the element type, the first in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(E::bits(lo)) |
         (static_cast<uint32_t>(E::bits(hi)) << 16);
}

// A 64 x D tile of 16-bit elements from global rows (row stride `st`) into
// shared memory rows of stride D + 8; 16-byte vectors when `vec`.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* g,
                                          long long st, int vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int V = D / 8;
    for (int i = threadIdx.x; i < kTile * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      *reinterpret_cast<uint4*>(s + r * LD + c) =
          __ldg(reinterpret_cast<const uint4*>(g + r * st + c));
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      s[r * LD + c] = g[r * st + c];
    }
  }
}

// mma.m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// lane = 4 g + t.  A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..).  B (16 x 8): b0 (k = 2t..2t+1, n = g),
// b1 (k = 2t+8.., n = g).  C (16 x 8, f32): c0 c1 (g, 2t..2t+1), c2 c3 (g+8,
// 2t..2t+1).

// A fragment from rows row0.. and columns col0.. of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s,
                                       int row0, int col0, int g, int t) {
  const uint16_t* p = s + (row0 + g) * LD + col0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragment with B[k][n] = s[n0 + n][k0 + k]: the tile's rows are B's columns
template <int LD>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2],
                                            const uint16_t* s, int n0, int k0,
                                            int g, int t) {
  const uint16_t* p = s + (n0 + g) * LD + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = s[k0 + k][n0 + n]: the tile's rows are B's rows
template <int LD>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[2],
                                            const uint16_t* s, int k0, int n0,
                                            int g, int t) {
  const uint16_t* p = s + (k0 + 2 * t) * LD + n0 + g;
  b[0] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
  b[1] = static_cast<uint32_t>(p[8 * LD]) |
         (static_cast<uint32_t>(p[9 * LD]) << 16);
}

// A fragment (16 rows x 16 columns) from the C fragments of two adjacent
// n8 column tiles, rounded to the element type
template <typename E>
__device__ __forceinline__ void frag_a_from_c(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack<E>(c0[0], c0[1]);
  a[1] = pack<E>(c0[2], c0[3]);
  a[2] = pack<E>(c1[0], c1[1]);
  a[3] = pack<E>(c1[2], c1[3]);
}

// C fragments (16 rows x D) stored to global rows of stride st at row gi
template <typename E, int D>
__device__ __forceinline__ void store_rows(uint16_t* g, long long st,
                                           const float (&c)[D / 8][4],
                                           float scale0, float scale1, int gi,
                                           int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(g + gi * st + col) =
        pack<E>(c[n][0] * scale0, c[n][1] * scale0);
    *reinterpret_cast<uint32_t*>(g + (gi + 8) * st + col) =
        pack<E>(c[n][2] * scale1, c[n][3] * scale1);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --- tensor-core kernels (bf16) ---------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) fwd_mma(Args a) {
  constexpr int LD = D + 8;
  extern __shared__ uint4 smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + kTile * LD;
  uint16_t* sV = sK + kTile * LD;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the longest causal rows first: they have the most key tiles
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const uint16_t* q = static_cast<const uint16_t*>(a.in[kQ]) +
                      base_off(a, kQ, b, h);
  const uint16_t* k = static_cast<const uint16_t*>(a.in[kK]) +
                      base_off(a, kK, b, h);
  const uint16_t* v = static_cast<const uint16_t*>(a.in[kV]) +
                      base_off(a, kV, b, h);
  load_tile<D>(sQ, q + q0 * a.st[kQ][2], a.st[kQ][2], a.vec);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const int n_kt = a.causal ? qt + 1 : a.T / kTile;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile<D>(sK, k + kt * kTile * a.st[kK][2], a.st[kK][2], a.vec);
    load_tile<D>(sV, v + kt * kTile * a.st[kV][2], a.st[kV][2], a.vec);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      frag_a<LD>(af, sQ, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t bf[2];
        frag_b_rows<LD>(bf, sK, n * 8, kk * 16, g, t);
        E::mma(s[n], af, bf);
      }
    }
    // scores in the log2 domain, causal mask, row max over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kt * kTile + n * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? row0 : row1;
        float x = s[n][i] * sl2;
        if (a.causal && col > row) x = -INFINITY;
        s[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // every row sees at least one key per tile: the diagonal tile holds
    // its own key, and earlier tiles are unmasked
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + quad_sum(sum0);
    l1 = l1 * alpha1 + quad_sum(sum1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
    // O += P V, P rounded to the element type
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      frag_a_from_c<E>(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        frag_b_cols<LD>(bf, sV, kk * 16, n * 8, g, t);
        E::mma(o[n], af, bf);
      }
    }
  }

  uint16_t* out = static_cast<uint16_t*>(a.out[0]) + base_off(a, kO, b, h);
  store_rows<E, D>(out, a.st[kO][2], o, 1.f / l0, 1.f / l1, row0, t);
  if (t == 0) {
    const long long r = static_cast<long long>(bh) * a.T;
    a.l[r + row0] = l0;
    a.l[r + row1] = l1;
    a.m[r + row0] = m0 * kLn2;
    a.m[r + row1] = m1 * kLn2;
  }
}

// --- f32 kernels (plain FMA, 32-row tiles, any D <= 128) --------------------

// rows x D f32 tile from global rows (stride st) into shared rows of D + 1
__device__ __forceinline__ void load_tile32(float* s, const float* g,
                                            long long st, int D) {
  for (int i = threadIdx.x; i < kTile32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s[r * (D + 1) + c] = g[r * st + c];
  }
}

__device__ __forceinline__ float dot_rows(const float* x, const float* y,
                                          int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads) fwd_f32(Args a) {
  extern __shared__ uint4 smem_raw[];
  const int D = a.D, LD = D + 1, R = kTile32;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + R * LD;
  float* sV = sK + R * LD;
  float* sO = sV + R * LD;
  float* sS = sO + R * LD;  // R x (R + 1)
  float* sM = sS + R * (R + 1);
  float* sL = sM + R;
  float* sA = sL + R;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * R;
  const float* q = static_cast<const float*>(a.in[kQ]) + base_off(a, kQ, b, h);
  const float* k = static_cast<const float*>(a.in[kK]) + base_off(a, kK, b, h);
  const float* v = static_cast<const float*>(a.in[kV]) + base_off(a, kV, b, h);
  load_tile32(sQ, q + q0 * a.st[kQ][2], a.st[kQ][2], D);
  for (int i = threadIdx.x; i < R * LD; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  const int n_kt = a.causal ? qt + 1 : a.T / R;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile32(sK, k + kt * R * a.st[kK][2], a.st[kK][2], D);
    load_tile32(sV, v + kt * R * a.st[kV][2], a.st[kV][2], D);
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R;
      float x = dot_rows(sQ + r * LD, sK + c * LD, D) * a.scale;
      if (a.causal && kt * R + c > q0 + r) x = -INFINITY;
      sS[r * (R + 1) + c] = x;
    }
    __syncthreads();
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      float* row = sS + r * (R + 1);
      float mx = sM[r];
      for (int c = 0; c < R; ++c) mx = fmaxf(mx, row[c]);
      const float alpha = expf(sM[r] - mx);
      float sum = 0.f;
      for (int c = 0; c < R; ++c) {
        row[c] = expf(row[c] - mx);
        sum += row[c];
      }
      sL[r] = sL[r] * alpha + sum;
      sM[r] = mx;
      sA[r] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* row = sS + r * (R + 1);
      float acc = sO[r * LD + d] * sA[r];
      for (int c = 0; c < R; ++c) acc = fmaf(row[c], sV[c * LD + d], acc);
      sO[r * LD + d] = acc;
    }
  }
  __syncthreads();
  float* out = static_cast<float*>(a.out[0]) + base_off(a, kO, b, h);
  const long long so = a.st[kO][2];
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    out[(q0 + r) * so + d] = sO[r * LD + d] / sL[r];
  }
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const long long r = static_cast<long long>(bh) * a.T + q0 + i;
    a.l[r] = sL[i];
    a.m[r] = sM[i];
  }
}

// P = exp(S s - m) / l for query r of a tile (scores against keys c), with
// m and 1 / l of the tile's rows in sM and sIL, as the library computes it
__global__ void __launch_bounds__(kThreads) bwd_dkv_f32(Args a) {
  extern __shared__ uint4 smem_raw[];
  const int D = a.D, LD = D + 1, R = kTile32;
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + R * LD;
  float* sdK = sV + R * LD;
  float* sdV = sdK + R * LD;
  float* sQ = sdV + R * LD;
  float* sO = sQ + R * LD;  // dO
  float* sP = sO + R * LD;  // R x (R + 1), rows = queries
  float* sS = sP + R * (R + 1);  // dS, rows = queries
  float* sM = sS + R * (R + 1);
  float* sIL = sM + R;
  float* sDi = sIL + R;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kt = blockIdx.y, k0 = kt * R;
  const float* q = static_cast<const float*>(a.in[kQ]) + base_off(a, kQ, b, h);
  const float* k = static_cast<const float*>(a.in[kK]) + base_off(a, kK, b, h);
  const float* v = static_cast<const float*>(a.in[kV]) + base_off(a, kV, b, h);
  const float* dout = static_cast<const float*>(a.in[kDO]) +
                      base_off(a, kDO, b, h);
  const long long rows = static_cast<long long>(bh) * a.T;
  load_tile32(sK, k + k0 * a.st[kK][2], a.st[kK][2], D);
  load_tile32(sV, v + k0 * a.st[kV][2], a.st[kV][2], D);
  for (int i = threadIdx.x; i < R * LD; i += kThreads) sdK[i] = sdV[i] = 0.f;

  for (int qt = a.causal ? kt : 0; qt < a.T / R; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_tile32(sQ, q + q0 * a.st[kQ][2], a.st[kQ][2], D);
    load_tile32(sO, dout + q0 * a.st[kDO][2], a.st[kDO][2], D);
    for (int i = threadIdx.x; i < R; i += kThreads) {
      sM[i] = a.m[rows + q0 + i];
      sIL[i] = 1.f / a.l[rows + q0 + i];
      sDi[i] = a.di[rows + q0 + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R;  // query r, key c
      float p = expf(dot_rows(sQ + r * LD, sK + c * LD, D) * a.scale - sM[r]) *
                sIL[r];
      if (a.causal && k0 + c > q0 + r) p = 0.f;
      const float dp = dot_rows(sO + r * LD, sV + c * LD, D);
      sP[r * (R + 1) + c] = p;
      sS[r * (R + 1) + c] = (dp - sDi[r]) * p * a.scale;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int c = i / D, d = i % D;  // key c
      float acc_v = sdV[c * LD + d], acc_k = sdK[c * LD + d];
      for (int r = 0; r < R; ++r) {
        acc_v = fmaf(sP[r * (R + 1) + c], sO[r * LD + d], acc_v);
        acc_k = fmaf(sS[r * (R + 1) + c], sQ[r * LD + d], acc_k);
      }
      sdV[c * LD + d] = acc_v;
      sdK[c * LD + d] = acc_k;
    }
  }
  __syncthreads();
  float* gdk = static_cast<float*>(a.out[2]) + base_off(a, kDK, b, h);
  float* gdv = static_cast<float*>(a.out[3]) + base_off(a, kDV, b, h);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int c = i / D, d = i % D;
    gdk[(k0 + c) * a.st[kDK][2] + d] = sdK[c * LD + d];
    gdv[(k0 + c) * a.st[kDV][2] + d] = sdV[c * LD + d];
  }
}

// dQ, and di = sum(o * dO) of the block's rows, which it writes for the
// dK/dV kernel, as the bf16 dQ kernel does
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(Args a) {
  extern __shared__ uint4 smem_raw[];
  const int D = a.D, LD = D + 1, R = kTile32;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sO = sQ + R * LD;  // dO
  float* sdQ = sO + R * LD;
  float* sK = sdQ + R * LD;
  float* sV = sK + R * LD;
  float* sS = sV + R * LD;  // dS, R x (R + 1)
  float* sM = sS + R * (R + 1);
  float* sIL = sM + R;
  float* sDi = sIL + R;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * R;
  const float* q = static_cast<const float*>(a.in[kQ]) + base_off(a, kQ, b, h);
  const float* k = static_cast<const float*>(a.in[kK]) + base_off(a, kK, b, h);
  const float* v = static_cast<const float*>(a.in[kV]) + base_off(a, kV, b, h);
  const float* dout = static_cast<const float*>(a.in[kDO]) +
                      base_off(a, kDO, b, h);
  const float* o = static_cast<const float*>(a.in[kO]) + base_off(a, kO, b, h);
  const long long rows = static_cast<long long>(bh) * a.T;
  load_tile32(sQ, q + q0 * a.st[kQ][2], a.st[kQ][2], D);
  load_tile32(sO, dout + q0 * a.st[kDO][2], a.st[kDO][2], D);
  for (int i = threadIdx.x; i < R * LD; i += kThreads) sdQ[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += kThreads) {
    sM[i] = a.m[rows + q0 + i];
    sIL[i] = 1.f / a.l[rows + q0 + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const float* orow = o + (q0 + i) * a.st[kO][2];
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(orow[d], sO[i * LD + d], acc);
    sDi[i] = acc;
    a.di[rows + q0 + i] = acc;
  }
  const int n_kt = a.causal ? qt + 1 : a.T / R;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile32(sK, k + kt * R * a.st[kK][2], a.st[kK][2], D);
    load_tile32(sV, v + kt * R * a.st[kV][2], a.st[kV][2], D);
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R, c = i % R;
      float p = expf(dot_rows(sQ + r * LD, sK + c * LD, D) * a.scale - sM[r]) *
                sIL[r];
      if (a.causal && kt * R + c > q0 + r) p = 0.f;
      const float dp = dot_rows(sO + r * LD, sV + c * LD, D);
      sS[r * (R + 1) + c] = (dp - sDi[r]) * p * a.scale;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float acc = sdQ[r * LD + d];
      for (int c = 0; c < R; ++c) {
        acc = fmaf(sS[r * (R + 1) + c], sK[c * LD + d], acc);
      }
      sdQ[r * LD + d] = acc;
    }
  }
  __syncthreads();
  float* gdq = static_cast<float*>(a.out[1]) + base_off(a, kDQ, b, h);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    gdq[(q0 + r) * a.st[kDQ][2] + d] = sdQ[r * LD + d];
  }
}

// --- launch -----------------------------------------------------------------

enum Kind { kFwd = 0, kDkv = 1, kDq = 2 };

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int rows, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.T / rows);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_mma(const Args& a, cudaStream_t stream) {
  return launch(fwd_mma<BF16, D>, a, kTile,
                3 * sizeof(uint16_t) * kTile * (D + 8), stream);
}

cudaError_t launch_fwd_bf16(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_fwd_mma<32>(a, stream);
    case 64: return launch_fwd_mma<64>(a, stream);
    case 96: return launch_fwd_mma<96>(a, stream);
    case 128: return launch_fwd_mma<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32(Kind kind, const Args& a, cudaStream_t stream) {
  const size_t tile = sizeof(float) * kTile32 * (a.D + 1);
  const size_t scores = sizeof(float) * kTile32 * (kTile32 + 1);
  const size_t rows = sizeof(float) * kTile32;
  switch (kind) {
    case kFwd:
      return launch(fwd_f32, a, kTile32, 4 * tile + scores + 3 * rows, stream);
    case kDkv:
      return launch(bwd_dkv_f32, a, kTile32, 6 * tile + 2 * scores + 3 * rows,
                    stream);
    default:
      return launch(bwd_dq_f32, a, kTile32, 5 * tile + scores + 3 * rows,
                    stream);
  }
}

// strides: host array of (batch, head, token) element strides, three per
// tensor in the order the entry point lists its tensors; bf16 reaches here
// for the forward only
int run(Kind kind, const Args& base, const long long* strides,
        const int* which, int n_tensors, int dtype, void* stream) {
  Args a = base;
  for (int i = 0; i < n_tensors; ++i) {
    for (int j = 0; j < 3; ++j) a.st[which[i]][j] = strides[3 * i + j];
  }
  const int rows = dtype == 0 ? kTile32 : kTile;
  if (a.B <= 0 || a.H <= 0 || a.T <= 0 || a.T % rows != 0 || a.D <= 0 ||
      a.D > 128 || a.T / rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_f32(kind, a, s);
  } else if (dtype == 1 && kind == kFwd) {
    err = launch_fwd_bf16(a, s);
  }
  return static_cast<int>(err);
}

Args make_args(int B, int H, int T, int D, int causal, double scale,
               int vec) {
  Args a = {};
  a.B = B;
  a.H = H;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.scale = static_cast<float>(scale);
  a.vec = vec;
  return a;
}

}  // namespace

// the bf16 backward kernels, in flash_attention_bwd.cu
int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* l, const float* m,
                       const float* di, void* dk, void* dv,
                       const long long* strides, int B, int H, int T, int D,
                       int causal, double scale, void* stream);
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* o, const float* l,
                      const float* m, float* di, void* dq,
                      const long long* strides, int B, int H, int T, int D,
                      int causal, double scale, void* stream);

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, o and the outputs are
// (B, H, T, D) with D contiguous; strides (host int64) hold (batch, head,
// token) element strides per tensor, in argument order.  l, m and di are
// contiguous (B, H, T) f32.  vec = 1 allows the forward 16-byte loads of the
// inputs (bf16, every input stride a multiple of 8 elements, pointers
// 16-byte aligned); the bf16 backward needs them so aligned.  T must be a
// multiple of 64 (bf16) or 32 (f32); D one of 32, 64, 96, 128 for bf16, at
// most 128 for f32.  Each returns the cudaError_t of the launch (0 on
// success).
extern "C" int bf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* l, float* m,
                            const long long* strides, int B, int H, int T,
                            int D, int causal, double scale, int dtype,
                            int vec, void* stream) {
  Args a = make_args(B, H, T, D, causal, scale, vec);
  a.in[kQ] = q;
  a.in[kK] = k;
  a.in[kV] = v;
  a.out[0] = o;
  a.l = l;
  a.m = m;
  const int which[] = {kQ, kK, kV, kO};
  return run(kFwd, a, strides, which, 4, dtype, stream);
}

// dK and dV from di, which bf_flash_bwd_dq wrote
extern "C" int bf_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, float* l, float* m,
                                const float* di, void* dk, void* dv,
                                const long long* strides, int B, int H, int T,
                                int D, int causal, double scale, int dtype,
                                void* stream) {
  if (dtype == 1) {
    return flash_bwd_dkv_bf16(q, k, v, dout, l, m, di, dk, dv, strides, B, H,
                              T, D, causal, scale, stream);
  }
  Args a = make_args(B, H, T, D, causal, scale, 0);
  a.in[kQ] = q;
  a.in[kK] = k;
  a.in[kV] = v;
  a.in[kDO] = dout;
  a.out[2] = dk;
  a.out[3] = dv;
  a.l = l;
  a.m = m;
  a.di = const_cast<float*>(di);
  const int which[] = {kQ, kK, kV, kDO, kDK, kDV};
  return run(kDkv, a, strides, which, 6, dtype, stream);
}

// dQ, and di = sum(o * dout) in f32
extern "C" int bf_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* o, float* l,
                               float* m, float* di, void* dq,
                               const long long* strides, int B, int H, int T,
                               int D, int causal, double scale, int dtype,
                               void* stream) {
  if (dtype == 1) {
    return flash_bwd_dq_bf16(q, k, v, dout, o, l, m, di, dq, strides, B, H, T,
                             D, causal, scale, stream);
  }
  Args a = make_args(B, H, T, D, causal, scale, 0);
  a.in[kQ] = q;
  a.in[kK] = k;
  a.in[kV] = v;
  a.in[kDO] = dout;
  a.in[kO] = o;
  a.out[1] = dq;
  a.l = l;
  a.m = m;
  a.di = di;
  const int which[] = {kQ, kK, kV, kDO, kO, kDQ};
  return run(kDq, a, strides, which, 6, dtype, stream);
}
