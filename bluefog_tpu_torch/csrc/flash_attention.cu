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
// - forward: each 64-row query tile loops over the 64-key tiles (up to the
//   diagonal when causal): S = Q K^T s, an online softmax in f32 (running
//   max and sum per row), O += P V with P rounded to the input dtype, as the
//   library rounds it.  O is stored in the input dtype, l and m in f32.
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
// backward is flash_attention_bwd.cu, and the wgmma, swizzle and cp.async
// helpers both bf16 files use are flash_wgmma.cuh.  f32 runs on plain f32
// FMA (32-row tiles in shared memory, any head dim up to 128), never in
// TF32.
//
// The bf16 forward (fwd_wgmma, head dims 32, 64, 96 and 128) on Hopper:
// - One warpgroup (128 threads) a block owns 64 query rows.  S = Q K^T runs
//   on wgmma.mma_async m64n64k16 with Q (resident for the whole loop) and K
//   from shared memory, both K-major; the online softmax works on the
//   accumulator in registers (the quad of threads that holds a row reduces
//   its max with two shuffles, and its sum once, at the end); P, rounded to
//   bf16, is the A operand of O += P V straight from registers, with V read
//   MN-major (D contiguous) from the same swizzled tile layout.
// - Step j issues S_j and the previous tile's P V back to back, eight
//   products in one batch, and runs tile j's softmax once S_j is in (the
//   shape of FlashAttention-3's overlap within a warpgroup; ptxas still
//   waits for P V before the softmax, so the two take turns, and PERF.md
//   has what that costs).  Both products are waited on inside the step,
//   and the first and last steps are peeled, so every wgmma pipeline is
//   straight-line code: ptxas serialises the products of a pipeline that
//   spans a branch (its note C7520), which made each product wait for the
//   one before.
// - K and V come through two slots each, filled by cp.async one tile ahead
//   (V a step after its K); one block barrier per step orders the loads and
//   the products.  The wrapper copies a q, k or v whose strides or pointer
//   refuse 16-byte loads; the model's views never do.
// - Each row's maximum is taken on the unscaled scores and each exponent
//   is one FMA and one ex2.approx.ftz, the scale folded into log2(e) (the
//   wrapper folds a negative scale into q); O is rescaled only when a
//   warp's maxima moved; only the diagonal tile pays for the causal mask;
//   the longest causal rows get the lowest block ids; the launch asks for
//   the largest shared-memory carveout, which the four blocks an SM that
//   the registers allow at D = 64 need (4 x 41 KB).
//
// What bounds it: at the transformer path's shape (B=8, H=12, T=1024, D=64,
// causal) the forward does 4 B H D T(T+1)/2 = 1.29e10 flops against 5.1e7
// bytes of q, k, v, o, l and m: 0.013 ms at 989 TFLOP/s against 0.015 ms at
// 3.35 TB/s, so the two bounds nearly meet; the exponentials (one per
// score, on the special function units) take about as long as the products
// beside them.  PERF.md has how far from the bound it runs.

#include "flash_wgmma.cuh"

namespace {

constexpr int kThreads = 128;        // f32 kernels: four warps
constexpr int kTile32 = 32;          // rows per tile, f32 kernels
constexpr float kLn2 = 0.6931471805599453f;

enum { kQ = 0, kK, kV, kDO, kO, kDQ, kDK, kDV, kNumTensors };

struct Args {
  const void* in[5];     // q, k, v, dout, o (an input of dQ)
  void* out[4];          // o, dq, dk, dv
  float* l;              // (B, H, T) f32 row sums
  float* m;              // (B, H, T) f32 row maxima
  float* di;             // (B, H, T) f32: written by dQ, read by dK/dV
  long long st[kNumTensors][3];  // (batch, head, token) strides, elements
  int B, H, T, D, causal;
  float scale;
};

// element offset of (b, h, token 0) in tensor `which`
__device__ __forceinline__ long long base_off(const Args& a, int which, int b,
                                              int h) {
  return b * a.st[which][0] + h * a.st[which][1];
}

// --- bf16 forward (wgmma) ---------------------------------------------------

// per head dim: the blocks per SM the registers are budgeted for (chosen
// by timing on the card)
template <int D>
struct FwdCfg : Tile<D> {
  static constexpr int kMinBlocks = D <= 64 ? 4 : 2;
};

// One key tile's online softmax for this thread's rows r0 and r0 + 8
// (acc[4 j + e] is key 8 j + 2 t + (e & 1) of row r0 + 8 (e >> 1)): the
// scores s become P = 2^(S s log2(e) - m) at the rows' new running maxima m
// (log2 units), and the row sums l (this thread's keys only: the quad's
// partial sums are added once, at the end) are rescaled to those maxima
// before they gain P's sums; alpha gets the factors that rescale the output
// accumulator.  The scale sl2 = s log2(e) is not negative (the wrapper
// folds a negative one into q), so the maxima are taken on the raw scores
// and each exponent is one FMA.  kMask: the diagonal tile, where a key
// after its query gets P = 0.  Every row keeps at least one key in every
// tile it runs (the diagonal tile holds its own), so the maxima are finite
// from the first tile on, and a first tile's factor is 2^-inf = 0.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* alpha, float sl2, int r0,
                                             int t) {
  auto masked = [&](int i) {
    return kMask && i / 4 * 8 + 2 * t + (i & 1) > r0 + ((i >> 1) & 1) * 8;
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!masked(i)) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
    s[i] = masked(i) ? 0.f : p;
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// One step of the forward's loop: with kS, issue S = Q K^T on the key tile
// at sK; with kPV, issue O += P V with the previous tile's P (pa) and V
// (sV); with kS, run the tile's softmax once S is in, then rescale O and
// pack the tile's P into pa once both products are done.  Every product is
// issued and waited on inside the step, in straight-line code.
template <int D, bool kS, bool kPV, bool kMask>
__device__ __forceinline__ void fwd_step(float* s, float* o, uint32_t* pa,
                                         float* m, float* l, uint32_t sQ,
                                         uint32_t sK, uint32_t sV, float sl2,
                                         int r0, int t) {
  float alpha[2];
  if constexpr (kS) {
    pin<32>(s);
    wgmma_fence();
    mma_abt<D>(s, sQ, sK);  // S = Q K^T
    wgmma_commit();
  }
  if constexpr (kPV) {
    pin<D / 2>(o);
    pin_u32<16>(pa);
    wgmma_fence();
    mma_ab<D>(o, pa, sV);  // O += P V, the previous tile's
    wgmma_commit();
  }
  if constexpr (kS) {
    if constexpr (kPV) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    pin<32>(s);
    softmax_tile<kMask>(s, m, l, alpha, sl2, r0, t);
  }
  wgmma_wait<0>();
  pin<D / 2>(o);
  pin_u32<16>(pa);
  if constexpr (kS) {
    // once the maxima settle, most tiles leave every factor 1
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
    }
    acc_to_a(pa, s);  // P rounded to bf16
  }
}

// Shared memory: Q | K slots 0, 1 | V slots 0, 1.  Step j issues S_j = Q
// K_j^T and then O += P_{j-1} V_{j-1}, and loads K_{j+1} and V_j, each into
// the slot its predecessor two tiles back has left.  One block barrier per
// step orders the loads and the products.
template <int D>
__global__ void __launch_bounds__(kWgThreads, FwdCfg<D>::kMinBlocks)
    fwd_wgmma(const Args a) {
  using C = FwdCfg<D>;
  extern __shared__ uint8_t fwd_smem[];  // the f32 kernels' is uint4
  uint8_t* gbase;
  const uint32_t sQ = aligned_base(fwd_smem, &gbase);
  const uint32_t sK0 = sQ + C::kTileBytes, sV0 = sK0 + 2 * C::kTileBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // the longest causal rows first: they have the most key tiles
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int n = a.causal ? qt + 1 : a.T / kRows;
  const uint16_t* q = static_cast<const uint16_t*>(a.in[kQ]) +
                      base_off(a, kQ, b, h);
  const uint16_t* k = static_cast<const uint16_t*>(a.in[kK]) +
                      base_off(a, kK, b, h);
  const uint16_t* v = static_cast<const uint16_t*>(a.in[kV]) +
                      base_off(a, kV, b, h);
  const long long stk = a.st[kK][2], stv = a.st[kV][2];
  auto kslot = [&](int i) { return sK0 + (i & 1) * C::kTileBytes; };
  auto vslot = [&](int i) { return sV0 + (i & 1) * C::kTileBytes; };
  // tile i's K (step i - 1 loads it) and V (step i): every earlier load
  // landed, and every thread is past the previous step
  auto next = [&](int i) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (i + 1 < n) {
      load_tile<D>(kslot(i + 1), k + (i + 1) * kRows * stk, stk, tid);
    }
    if (i < n) load_tile<D>(vslot(i), v + i * kRows * stv, stv, tid);
    cp_async_commit();
  };

  load_tile<D>(sQ, q + qt * kRows * a.st[kQ][2], a.st[kQ][2], tid);
  load_tile<D>(kslot(0), k, stk, tid);
  cp_async_commit();

  float o[D / 2], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  // tile 0 (the diagonal one when it is the only one), tiles 1 .. n - 2,
  // tile n - 1 (the diagonal one when causal), then the last P V; each
  // branch holds whole products
  next(0);
  if (n > 1 || !a.causal) {
    fwd_step<D, true, false, false>(s, o, pa, m, l, sQ, kslot(0), 0, sl2,
                                    r0, t);
  } else {
    fwd_step<D, true, false, true>(s, o, pa, m, l, sQ, kslot(0), 0, sl2,
                                   r0, t);
  }
  for (int j = 1; j < n - 1; ++j) {
    next(j);
    fwd_step<D, true, true, false>(s, o, pa, m, l, sQ, kslot(j),
                                   vslot(j - 1), sl2, r0, t);
  }
  if (n > 1) {
    next(n - 1);
    if (a.causal) {
      fwd_step<D, true, true, true>(s, o, pa, m, l, sQ, kslot(n - 1),
                                    vslot(n - 2), sl2, r0, t);
    } else {
      fwd_step<D, true, true, false>(s, o, pa, m, l, sQ, kslot(n - 1),
                                     vslot(n - 2), sl2, r0, t);
    }
  }
  next(n);
  fwd_step<D, false, true, false>(s, o, pa, m, l, sQ, 0, vslot(n - 1), sl2,
                                  r0, t);

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const int row = qt * kRows + r0;
  uint16_t* out = static_cast<uint16_t*>(a.out[0]) + base_off(a, kO, b, h);
  store_acc<D>(out, a.st[kO][2], o, row, t, 1.f / l0, 1.f / l1);
  if (t == 0) {
    const long long r = static_cast<long long>(bh) * a.T + row;
    a.l[r] = l0;
    a.l[r + 8] = l1;
    a.m[r] = m[0] * kLn2;
    a.m[r + 8] = m[1] * kLn2;
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
cudaError_t launch(Kernel kernel, const Args& a, dim3 grid, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dynamic shared memory: 1 KB to align the tiles to their swizzle pattern,
// Q, and two slots each for K and V
template <int D>
cudaError_t launch_fwd_wgmma(const Args& a, cudaStream_t stream) {
  using C = FwdCfg<D>;
  const size_t smem = 1024 + 5 * C::kTileBytes;
  // the largest shared-memory carveout, so that as many blocks run on an
  // SM as the registers allow: left to the driver, the carveout it picked
  // for the same kernel varied, and with it the blocks per SM
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(fwd_wgmma<D>, a, dim3(a.B * a.H, a.T / kRows), kWgThreads,
                smem, stream);
}

cudaError_t launch_fwd_bf16(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_fwd_wgmma<32>(a, stream);
    case 64: return launch_fwd_wgmma<64>(a, stream);
    case 96: return launch_fwd_wgmma<96>(a, stream);
    case 128: return launch_fwd_wgmma<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32(Kind kind, const Args& a, cudaStream_t stream) {
  const size_t tile = sizeof(float) * kTile32 * (a.D + 1);
  const size_t scores = sizeof(float) * kTile32 * (kTile32 + 1);
  const size_t rows = sizeof(float) * kTile32;
  const dim3 grid(a.B * a.H, a.T / kTile32);
  switch (kind) {
    case kFwd:
      return launch(fwd_f32, a, grid, kThreads, 4 * tile + scores + 3 * rows,
                    stream);
    case kDkv:
      return launch(bwd_dkv_f32, a, grid, kThreads,
                    6 * tile + 2 * scores + 3 * rows, stream);
    default:
      return launch(bwd_dq_f32, a, grid, kThreads,
                    5 * tile + scores + 3 * rows, stream);
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
  const int rows = dtype == 0 ? kTile32 : kRows;
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

Args make_args(int B, int H, int T, int D, int causal, double scale) {
  Args a = {};
  a.B = B;
  a.H = H;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.scale = static_cast<float>(scale);
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
// contiguous (B, H, T) f32.  The bf16 kernels read 16-byte vectors: every
// bf16 input's strides are multiples of 8 elements and its pointer 16-byte
// aligned (the wrappers copy a view that is not).  T must be a multiple of
// 64 (bf16) or 32 (f32); D one of 32, 64, 96, 128 for bf16, at most 128 for
// f32.  Each returns the cudaError_t of the launch (0 on success).
extern "C" int bf_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* l, float* m,
                            const long long* strides, int B, int H, int T,
                            int D, int causal, double scale, int dtype,
                            void* stream) {
  Args a = make_args(B, H, T, D, causal, scale);
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
  Args a = make_args(B, H, T, D, causal, scale);
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
  Args a = make_args(B, H, T, D, causal, scale);
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
