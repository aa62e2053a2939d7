// Fused SwiGLU FFN backward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `_bwd` (`_dx_kernel` :258,
// `_dw_kernel` :284, the shared `_act_grads` :239; pallas_calls at :333 and
// :368) — kernel A4, the gradient of A3 in the training step.
//
// What it computes, for x [R, d], w1/w3 [d, f], w2 [f, d] and the output
// gradient do [R, d] (bf16 or f32, sums in f32):
//   u = x w1, v = x w3, dg = do w2^T, sg = sigmoid(u)
//   du = dg * v * sg * (1 + u * (1 - sg)),  dv = dg * u * sg,  g = u*sg * v
//   dx = du w1^T + dv w3^T,  dw1 = x^T du,  dw3 = x^T dv,  dw2 = g^T do
// with dx in x's type and the weight gradients in the weights' type.
//
// Bound on the H100: operations. At R = 4096, d = 4096, f = 11008 the
// eight products take 2.95 TFLOP (2.99 ms at 989 TFLOP/s in bf16) against
// 0.64 GB of operands and gradients.
//
// Design. The reference recomputes u and v inside both of its launches and
// never stores [R, f]: on the TPU that recompute is cheap. On the GPU a
// block that owns a (d, f) tile of dw1 would need the whole d-contraction
// for u, so the launch is three kernels that pass scratch of R * f * 4
// bytes each for du, dv and g:
//   1. act: per tile of [R, f], the three d-deep products u, v and dg,
//      then the elementwise epilogue writes du, dv and g;
//   2. dx: per tile of [R, d], du w1^T + dv w3^T, one f-deep sum;
//   3. dw: per 128 x 128 tile of dw1, dw3 or dw2 (grid z picks the
//      product), an R-deep sum.
// Every output tile is owned by one block and its sum runs in a fixed
// order: no atomics and no split over rows, so the gradients are the same
// on every run.
//
// bf16: every product on the tensor cores, through the wgmma core of
// `gemm_sm90.cuh` (a producer warpgroup streams 64-deep stages of
// 128-byte-swizzled tiles in by TMA through a ring of four; consumer
// warpgroups of 64 rows issue wgmma from shared memory into f32
// accumulators; TMA's zero fill covers rows past R and the depth past d,
// f or R). du, dv and g are written as bf16 planes hi = bf16(t) and lo =
// bf16(t - hi), in the bytes of an f32 scratch, and every product that
// reads them walks both planes against one tile of the other operand, so
// they enter at ~2^-16 relative as the f32 reference has them (a single
// bf16 du would add 2^-9 of each term and break the one-ulp rule near 0).
//   - act: three accumulators, u and v (x K-major, w1/w3 MN-major) and dg
//     (do K-major, w2's rows K-major); 64 columns of f a tile, as three
//     64 x 128 f32 accumulators would take 192 registers a thread;
//   - dx: du's planes (K-major) against w1's rows (K-major), then dv's
//     against w3's: one walk over two segments into one accumulator;
//   - dw: x^T du, x^T dv and g^T do read both operands MN-major (x and g
//     are [R, *], the depth runs down them): the A tile's boxes sit side
//     by side, one per consumer warpgroup. Tiles walk d's 32 columns
//     fastest, so a wave of blocks shares the strips of x (or do) in L2.
// The product units (64^3 multiply-adds; `fused_ffn_bwd_units`): act 3,
// dx 4 and dw 6 per (64-tile of output, 64 deep) step: 4.80 TFLOP at
// R = 4096 against the 2.95 the math needs.
//
// f32 (the agreement checks): the CUDA-core kernels, 16-deep f32 slices
// staged in shared memory and FMAs, each thread an 8 x 8 (or 4 x 4)
// patch.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16; thread (ty, tx)
constexpr int kBK = 16;        // reduction depth of a staged slice

// C[m0 .. m0+BM, n0 .. n0+BN] += op(A) op(B) over k in [0, K), summed in
// order of k. A is [M, K] row-major, or [K, M] when A_T; B is [K, N]
// row-major, or [N, K] when B_T. The contiguous dimension of each operand
// must be a multiple of 8; the other is bounds-checked per row. Thread
// (ty, tx) owns rows h*64 + ty*4 + (0..3) and columns h*64 + tx*4 + (0..3)
// of the tile for each 64-wide half h.
template <int BM, int BN, bool A_T, bool B_T, typename TA, typename TB>
struct TileProduct {
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int kAVecs = BM * kBK / 8, kBVecs = BN * kBK / 8;
  static_assert(kAVecs <= kThreads && kBVecs <= kThreads, "one vector each");

  float* as;  // [kBK][BM]
  float* bs;  // [kBK][BN]
  Vec8<TA> a;
  Vec8<TB> b;

  // a thread's A vector: 8 consecutive k of row m (A row-major) or 8
  // consecutive m of row k (A_T); consecutive threads take consecutive m
  // (row-major) or consecutive chunks of one k row (A_T)
  __device__ void fetch(const TA* __restrict__ A, int lda,
                        const TB* __restrict__ B, int ldb, int M, int N,
                        int K, int m0, int n0, int k0) {
    const int t = threadIdx.x;
    if (t < kAVecs) {
      int m, k;
      if (A_T) { m = (t % (BM / 8)) * 8; k = t / (BM / 8); }
      else     { m = t % BM; k = (t / BM) * 8; }
      const bool ok = m0 + m < M && k0 + k < K;
      if (ok)
        a.load(A_T ? A + (size_t)(k0 + k) * lda + m0 + m
                   : A + (size_t)(m0 + m) * lda + k0 + k);
      else
        a.zero();
    }
    if (t < kBVecs) {
      int n, k;
      if (B_T) { n = t % BN; k = (t / BN) * 8; }
      else     { n = (t % (BN / 8)) * 8; k = t / (BN / 8); }
      const bool ok = n0 + n < N && k0 + k < K;
      if (ok)
        b.load(B_T ? B + (size_t)(n0 + n) * ldb + k0 + k
                   : B + (size_t)(k0 + k) * ldb + n0 + n);
      else
        b.zero();
    }
  }

  __device__ void stash() {
    const int t = threadIdx.x;
    float f[8];
    if (t < kAVecs) {
      a.to_floats(f);
      if (A_T) {
        float* d = as + (t / (BM / 8)) * BM + (t % (BM / 8)) * 8;
        reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
      } else {
        const int m = t % BM, k = (t / BM) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) as[(k + e) * BM + m] = f[e];
      }
    }
    if (t < kBVecs) {
      b.to_floats(f);
      if (B_T) {
        const int n = t % BN, k = (t / BN) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) bs[(k + e) * BN + n] = f[e];
      } else {
        float* d = bs + (t / (BN / 8)) * BN + (t % (BN / 8)) * 8;
        reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }

  __device__ void run(float (&acc)[TM][TN], const TA* __restrict__ A,
                      int lda, const TB* __restrict__ B, int ldb, int M,
                      int N, int K, int m0, int n0) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    fetch(A, lda, B, ldb, M, N, K, m0, n0, 0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // the previous slice's readers are done
      stash();
      __syncthreads();
      if (k0 + kBK < K) fetch(A, lda, B, ldb, M, N, K, m0, n0, k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int hh = 0; hh < TM / 4; ++hh) {
          const float4 t4 =
              *reinterpret_cast<const float4*>(as + kk * BM + hh * 64 + ty * 4);
          av[hh * 4] = t4.x; av[hh * 4 + 1] = t4.y;
          av[hh * 4 + 2] = t4.z; av[hh * 4 + 3] = t4.w;
        }
#pragma unroll
        for (int hh = 0; hh < TN / 4; ++hh) {
          const float4 t4 =
              *reinterpret_cast<const float4*>(bs + kk * BN + hh * 64 + tx * 4);
          bv[hh * 4] = t4.x; bv[hh * 4 + 1] = t4.y;
          bv[hh * 4 + 2] = t4.z; bv[hh * 4 + 3] = t4.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  // row and column of acc[i][j] in the output
  __device__ static int row(int m0, int i) {
    return m0 + (i / 4) * 64 + (threadIdx.x >> 4) * 4 + (i & 3);
  }
  __device__ static int col(int n0, int j) {
    return n0 + (j / 4) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
  }
};

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// 1. du, dv, g [R, f] f32 from u = x w1, v = x w3, dg = do w2^T
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w3, const T* __restrict__ w2,
                   const T* __restrict__ dout, float* __restrict__ du,
                   float* __restrict__ dv, float* __restrict__ g, int R,
                   int d, int f) {
  __shared__ __align__(16) float as[kBK * 64];
  __shared__ __align__(16) float bs[kBK * 64];
  using NN = TileProduct<64, 64, false, false, T, T>;
  using NT = TileProduct<64, 64, false, true, T, T>;
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64;
  float u[4][4], v[4][4], dg[4][4];
  zero(u); zero(v); zero(dg);
  NN p1{as, bs};
  p1.run(u, x, d, w1, f, R, f, d, m0, n0);
  p1.run(v, x, d, w3, f, R, f, d, m0, n0);
  NT p2{as, bs};
  p2.run(dg, dout, d, w2, d, R, f, d, m0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = NN::row(m0, i);
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = NN::col(n0, j);
      if (c >= f) continue;
      const float uu = u[i][j], vv = v[i][j], gg = dg[i][j];
      const float sg = 1.f / (1.f + expf(-uu));
      const size_t o = (size_t)r * f + c;
      du[o] = gg * vv * (sg * (1.f + uu * (1.f - sg)));
      dv[o] = gg * (uu * sg);
      g[o] = (uu * sg) * vv;
    }
  }
}

// 2. dx [R, d] = du w1^T + dv w3^T (w1, w3 are [d, f]: B_T with N = d)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dx_kernel(const float* __restrict__ du, const float* __restrict__ dv,
                  const T* __restrict__ w1, const T* __restrict__ w3,
                  T* __restrict__ dx, int R, int d, int f) {
  __shared__ __align__(16) float as[kBK * 128];
  __shared__ __align__(16) float bs[kBK * 128];
  using P = TileProduct<128, 128, false, true, float, T>;
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * 128;
  float acc[8][8];
  zero(acc);
  P p{as, bs};
  p.run(acc, du, f, w1, f, R, d, f, m0, n0);
  p.run(acc, dv, f, w3, f, R, d, f, m0, n0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = P::row(m0, i);
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = P::col(n0, j);
      if (c < d) dx[(size_t)r * d + c] = from_float<T>(acc[i][j]);
    }
  }
}

// 3. z = 0: dw1 [d, f] = x^T du; z = 1: dw3 = x^T dv; z = 2: dw2 [f, d] =
// g^T do. blockIdx.x enumerates the output's 128 x 128 tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                  const float* __restrict__ du, const float* __restrict__ dv,
                  const float* __restrict__ g, T* __restrict__ dw1,
                  T* __restrict__ dw3, T* __restrict__ dw2, int R, int d,
                  int f) {
  __shared__ __align__(16) float as[kBK * 128];
  __shared__ __align__(16) float bs[kBK * 128];
  const int z = blockIdx.z;
  const int M = z < 2 ? d : f, N = z < 2 ? f : d;
  const int tiles_n = (N + 127) / 128;
  const int m0 = (blockIdx.x / tiles_n) * 128, n0 = (blockIdx.x % tiles_n) * 128;
  float acc[8][8];
  zero(acc);
  T* out;
  if (z < 2) {
    TileProduct<128, 128, true, false, T, float> p{as, bs};
    p.run(acc, x, d, z == 0 ? du : dv, f, M, N, R, m0, n0);
    out = z == 0 ? dw1 : dw3;
  } else {
    TileProduct<128, 128, true, false, float, T> p{as, bs};
    p.run(acc, g, f, dout, d, M, N, R, m0, n0);
    out = dw2;
  }
  using P = TileProduct<128, 128, true, false, T, float>;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = P::row(m0, i);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = P::col(n0, j);
      if (c < N) out[(size_t)r * N + c] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* dout, void* du, void* dv, void* g, void* dx, void* dw1,
           void* dw3, void* dw2, int R, int d, int f, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w3p = static_cast<const T*>(w3);
  const T* dop = static_cast<const T*>(dout);
  float* dup = static_cast<float*>(du);
  float* dvp = static_cast<float*>(dv);
  float* gp = static_cast<float*>(g);
  dim3 g1((f + 63) / 64, (R + 63) / 64);
  ffn_bwd_act_kernel<T><<<g1, kThreads, 0, stream>>>(
      xp, w1p, w3p, static_cast<const T*>(w2), dop, dup, dvp, gp, R, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((d + 127) / 128, (R + 127) / 128);
  ffn_bwd_dx_kernel<T><<<g2, kThreads, 0, stream>>>(
      dup, dvp, w1p, w3p, static_cast<T*>(dx), R, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g3(((d + 127) / 128) * ((f + 127) / 128), 1, 3);
  ffn_bwd_dw_kernel<T><<<g3, kThreads, 0, stream>>>(
      xp, dop, dup, dvp, gp, static_cast<T*>(dw1), static_cast<T*>(dw3),
      static_cast<T*>(dw2), R, d, f);
  return cudaGetLastError();
}


// -- bf16: tensor cores --------------------------------------------------------

namespace tc {

using gemm::bf16;
using gemm::kBox;
using gemm::kBoxBytes;
constexpr int kStages = 4;

// NC consumer warpgroups: a 64 NC x 64 tile of [R, f]
template <int NC>
struct ActSmem {
  bf16 x[kStages][NC][kBox];     // [64 NC rows][64 deep], K-major
  bf16 dout[kStages][NC][kBox];
  bf16 w1[kStages][kBox];        // [64 deep][64 columns], MN-major
  bf16 w3[kStages][kBox];
  bf16 w2[kStages][kBox];        // w2's [64 columns of f][64 deep], K-major
  gemm::Pipe<kStages> pipe;
};

// a 64 NC x 64 NC tile of dx [R, d]
template <int NC>
struct DxSmem {
  bf16 hi[kStages][NC][kBox];    // du's (then dv's) planes, K-major
  bf16 lo[kStages][NC][kBox];
  bf16 w[kStages][NC][kBox];     // w1's (then w3's) [64 NC rows][64 deep]
  gemm::Pipe<kStages> pipe;
};

// a 128 x 128 tile of dw1, dw3 or dw2; every tile [64 deep][128], MN-major
struct DwSmem {
  bf16 t[3][kStages][2][kBox];
  gemm::Pipe<kStages> pipe;
};

template <int NC>
__host__ __device__ constexpr int dx_blocks_per_sm() { return NC == 1 ? 2 : 1; }

// 1. du, dv, g [R, f] as bf16 planes from u = x w1, v = x w3, dg = do w2^T
template <int NC>
__global__ void __launch_bounds__(gemm::threads<NC>(), 1)
ffn_bwd_act_tc(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mw1,
               const __grid_constant__ CUtensorMap mw3,
               const __grid_constant__ CUtensorMap mw2,
               bf16* __restrict__ du, bf16* __restrict__ dv,
               bf16* __restrict__ g, int R, int d, int f) {
  constexpr int BM = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  ActSmem<NC>& sm = flash::sm90::smem_as<ActSmem<NC>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, BM),
                              gemm::tiles(f, 64));
  const int m0 = t.x * BM, n0 = t.y * 64;
  const int nk = gemm::tiles(d, 64);
  gemm::pipe_init<kStages, NC>(sm.pipe);

  if (threadIdx.x >= 128 * NC) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128 * NC)
      gemm::produce(sm.pipe, nk, (2 * NC + 3) * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
                      const int k0 = kt * 64;
                      gemm::load_k<BM>(sm.x[s][0], &mx, bar, k0, m0);
                      gemm::load_k<BM>(sm.dout[s][0], &mdo, bar, k0, m0);
                      gemm::load_mn<64>(sm.w1[s], &mw1, bar, k0, n0);
                      gemm::load_mn<64>(sm.w3[s], &mw3, bar, k0, n0);
                      gemm::load_k<64>(sm.w2[s], &mw2, bar, k0, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::consumer_regs<NC, 1>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float u[32], v[32], dg[32];
  gemm::zero(u);
  gemm::zero(v);
  gemm::zero(dg);
  gemm::consume(sm.pipe, nk, [&](int s) {
    gemm::mma_stage<64, 0, 1>(u, sm.x[s][wg], sm.w1[s]);
    gemm::mma_stage<64, 0, 1>(v, sm.x[s][wg], sm.w3[s]);
    gemm::mma_stage<64, 0, 0>(dg, sm.dout[s][wg], sm.w2[s]);
  });
  flash::sm90::fence_regs(u);
  flash::sm90::fence_regs(v);
  flash::sm90::fence_regs(dg);
  const int row0 = m0 + gemm::acc_row0();
  const size_t plane = (size_t)R * f;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = row0 + flash::sm90::acc_row(e);
    const int c = n0 + flash::sm90::acc_col(e, lane);
    if (r >= R || c >= f) continue;
    float gu[2], gv[2], gg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float uu = u[e + i], vv = v[e + i], gd = dg[e + i];
      const float sg = 1.f / (1.f + expf(-uu));
      gu[i] = gd * vv * (sg * (1.f + uu * (1.f - sg)));
      gv[i] = gd * (uu * sg);
      gg[i] = (uu * sg) * vv;
    }
    const size_t o = (size_t)r * f + c;
    gemm::store_hi_lo(du + o, du + plane + o, gu[0], gu[1]);
    gemm::store_hi_lo(dv + o, dv + plane + o, gv[0], gv[1]);
    gemm::store_hi_lo(g + o, g + plane + o, gg[0], gg[1]);
  }
}

// 2. dx [R, d] = (du_hi + du_lo) w1^T + (dv_hi + dv_lo) w3^T
template <int NC>
__global__ void __launch_bounds__(gemm::threads<NC>(), dx_blocks_per_sm<NC>())
ffn_bwd_dx_tc(const __grid_constant__ CUtensorMap mdu_hi,
              const __grid_constant__ CUtensorMap mdu_lo,
              const __grid_constant__ CUtensorMap mdv_hi,
              const __grid_constant__ CUtensorMap mdv_lo,
              const __grid_constant__ CUtensorMap mw1,
              const __grid_constant__ CUtensorMap mw3, bf16* __restrict__ dx,
              int R, int d, int f) {
  constexpr int BT = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  DxSmem<NC>& sm = flash::sm90::smem_as<DxSmem<NC>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, BT),
                              gemm::tiles(d, BT));
  const int m0 = t.x * BT, n0 = t.y * BT;
  const int nkf = gemm::tiles(f, 64);
  gemm::pipe_init<kStages, NC>(sm.pipe);

  if (threadIdx.x >= 128 * NC) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128 * NC)
      gemm::produce(sm.pipe, 2 * nkf, 3 * NC * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
                      const bool second = kt >= nkf;   // the dv w3^T segment
                      const int k0 = (second ? kt - nkf : kt) * 64;
                      gemm::load_k<BT>(sm.hi[s][0], second ? &mdv_hi : &mdu_hi,
                                       bar, k0, m0);
                      gemm::load_k<BT>(sm.lo[s][0], second ? &mdv_lo : &mdu_lo,
                                       bar, k0, m0);
                      gemm::load_k<BT>(sm.w[s][0], second ? &mw3 : &mw1, bar,
                                       k0, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<
      gemm::consumer_regs<NC, dx_blocks_per_sm<NC>()>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[BT / 2];
  gemm::zero(acc);
  gemm::consume(sm.pipe, 2 * nkf, [&](int s) {
    gemm::mma_stage<BT, 0, 0>(acc, sm.hi[s][wg], sm.w[s][0]);
    gemm::mma_stage<BT, 0, 0>(acc, sm.lo[s][wg], sm.w[s][0]);
  });
  flash::sm90::fence_regs(acc);
  const int row0 = m0 + gemm::acc_row0();
#pragma unroll
  for (int e = 0; e < BT / 2; e += 2) {
    const int r = row0 + flash::sm90::acc_row(e);
    const int c = n0 + flash::sm90::acc_col(e, lane);
    if (r < R && c < d)
      gemm::store_bf16x2(dx + (size_t)r * d + c, acc[e], acc[e + 1]);
  }
}

// 3. z = 0: dw1 [d, f] = x^T du; z = 1: dw3 = x^T dv; z = 2: dw2 [f, d] =
// g^T do, each plane pair walked against one tile of the other operand.
// blockIdx.x enumerates the output's 128 x 128 tiles, d's fastest.
__global__ void __launch_bounds__(gemm::threads<2>(), 1)
ffn_bwd_dw_tc(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mdo,
              const __grid_constant__ CUtensorMap mdu_hi,
              const __grid_constant__ CUtensorMap mdu_lo,
              const __grid_constant__ CUtensorMap mdv_hi,
              const __grid_constant__ CUtensorMap mdv_lo,
              const __grid_constant__ CUtensorMap mg_hi,
              const __grid_constant__ CUtensorMap mg_lo,
              bf16* __restrict__ dw1, bf16* __restrict__ dw3,
              bf16* __restrict__ dw2, int R, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  DwSmem& sm = flash::sm90::smem_as<DwSmem>(smem_raw);
  const int z = blockIdx.z;
  const int td = gemm::tiles(d, 128);
  const int d0 = (blockIdx.x % td) * 128, f0 = (blockIdx.x / td) * 128;
  // the output [M, N]: dw1, dw3 [d, f]; dw2 [f, d]
  const int m0 = z < 2 ? d0 : f0, n0 = z < 2 ? f0 : d0;
  const int M = z < 2 ? d : f, N = z < 2 ? f : d;
  const int nk = gemm::tiles(R, 64);
  gemm::pipe_init<kStages, 2>(sm.pipe);

  if (threadIdx.x >= 256) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 256) {
      // tiles 0, 1, 2: x, du's (dv's) hi, lo; for dw2 do, g's hi, lo
      const CUtensorMap* map[3] = {
          z < 2 ? &mx : &mdo, z == 0 ? &mdu_hi : z == 1 ? &mdv_hi : &mg_hi,
          z == 0 ? &mdu_lo : z == 1 ? &mdv_lo : &mg_lo};
      const int c0[3] = {d0, f0, f0};
      gemm::produce(sm.pipe, nk, 3 * 2 * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
#pragma unroll
                      for (int i = 0; i < 3; ++i)
                        gemm::load_mn<128>(sm.t[i][s][0], map[i], bar,
                                           kt * 64, c0[i]);
                    });
    }
    return;
  }
  flash::sm90::regs_inc<gemm::consumer_regs<2, 1>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  // A's plane(s) and B's: dw1/dw3 x against du's (dv's) two planes; dw2
  // g's two planes against do
  const int a0 = z < 2 ? 0 : 1, a1 = z < 2 ? 0 : 2;
  const int b0 = z < 2 ? 1 : 0, b1 = z < 2 ? 2 : 0;
  float acc[64];
  gemm::zero(acc);
  gemm::consume(sm.pipe, nk, [&](int s) {
    gemm::mma_stage<128, 1, 1>(acc, sm.t[a0][s][wg], sm.t[b0][s][0]);
    gemm::mma_stage<128, 1, 1>(acc, sm.t[a1][s][wg], sm.t[b1][s][0]);
  });
  flash::sm90::fence_regs(acc);
  bf16* out = z == 0 ? dw1 : z == 1 ? dw3 : dw2;
  const int row0 = m0 + gemm::acc_row0();
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int r = row0 + flash::sm90::acc_row(e);
    const int c = n0 + flash::sm90::acc_col(e, lane);
    if (r < M && c < N)
      gemm::store_bf16x2(out + (size_t)r * N + c, acc[e], acc[e + 1]);
  }
}

template <int NC>
constexpr int act_smem() {
  return flash::sm90::smem_bytes<ActSmem<NC>>();
}
template <int NC>
constexpr int dx_smem() {
  return flash::sm90::smem_bytes<DxSmem<NC>>();
}
constexpr int dw_smem() { return flash::sm90::smem_bytes<DwSmem>(); }

template <int NC>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           const void* dout, void* du, void* dv, void* g, void* dx,
           void* dw1, void* dw3, void* dw2, int R, int d, int f,
           cudaStream_t stream) {
  constexpr int BT = 64 * NC;
  const size_t plane = (size_t)R * f;
  bf16* dup = static_cast<bf16*>(du);
  bf16* dvp = static_cast<bf16*>(dv);
  bf16* gp = static_cast<bf16*>(g);
  CUtensorMap mx, mdo, mw1, mw2, mw3, mdu_hi, mdu_lo, mdv_hi, mdv_lo, mg_hi,
      mg_lo;
  const struct {
    CUtensorMap* map;
    const void* base;
    int rows, cols;
  } maps[] = {{&mx, x, R, d},          {&mdo, dout, R, d},
              {&mw1, w1, d, f},        {&mw3, w3, d, f},
              {&mw2, w2, f, d},        {&mdu_hi, dup, R, f},
              {&mdu_lo, dup + plane, R, f}, {&mdv_hi, dvp, R, f},
              {&mdv_lo, dvp + plane, R, f}, {&mg_hi, gp, R, f},
              {&mg_lo, gp + plane, R, f}};
  cudaError_t err = cudaSuccess;
  for (const auto& m : maps)
    if (err == cudaSuccess)
      err = gemm::cached_map(m.map, m.base, m.rows, m.cols);
  if (err == cudaSuccess)
    err = gemm::allow_smem(ffn_bwd_act_tc<NC>, act_smem<NC>());
  if (err == cudaSuccess)
    err = gemm::allow_smem(ffn_bwd_dx_tc<NC>, dx_smem<NC>());
  if (err == cudaSuccess) err = gemm::allow_smem(ffn_bwd_dw_tc, dw_smem());
  if (err != cudaSuccess) return err;

  dim3 g1(gemm::tiles(R, BT) * gemm::tiles(f, 64));
  ffn_bwd_act_tc<NC><<<g1, gemm::threads<NC>(), act_smem<NC>(), stream>>>(
      mx, mdo, mw1, mw3, mw2, dup, dvp, gp, R, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2(gemm::tiles(R, BT) * gemm::tiles(d, BT));
  ffn_bwd_dx_tc<NC><<<g2, gemm::threads<NC>(), dx_smem<NC>(), stream>>>(
      mdu_hi, mdu_lo, mdv_hi, mdv_lo, mw1, mw3, static_cast<bf16*>(dx), R, d,
      f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g3(gemm::tiles(d, 128) * gemm::tiles(f, 128), 1, 3);
  ffn_bwd_dw_tc<<<g3, gemm::threads<2>(), dw_smem(), stream>>>(
      mx, mdo, mdu_hi, mdu_lo, mdv_hi, mdv_lo, mg_hi, mg_lo,
      static_cast<bf16*>(dw1), static_cast<bf16*>(dw3),
      static_cast<bf16*>(dw2), R, d, f);
  return cudaGetLastError();
}

// 64 x 64 x 64 product units a call issues, hi/lo counted: act three per
// (64 rows, 64 columns of f, 64 deep of d); dx two planes times two
// segments; dw two (a plane pair) for each of its three products
template <int NC>
long long units(int R, int d, int f) {
  constexpr int BT = 64 * NC;
  const long long mt = (long long)gemm::tiles(R, BT) * NC;
  const long long dt = gemm::tiles(d, 128) * 2LL, ft = gemm::tiles(f, 128) * 2LL;
  return 3 * mt * gemm::tiles(f, 64) * gemm::tiles(d, 64) +
         4 * mt * gemm::tiles(d, BT) * NC * gemm::tiles(f, 64) +
         3 * 2 * dt * ft * gemm::tiles(R, 64);
}

}  // namespace tc

}  // namespace

// x, do [R, d]; w1, w3 [d, f]; w2 [f, d]; du, dv, g: scratch of R * f * 4
// bytes each the caller allocates (f32, or bf16 hi and lo planes [2, R,
// f]); dx [R, d]; dw1, dw3 [d, f]; dw2 [f, d]; all of one type apart from
// the scratch, all contiguous, every pointer 16-byte aligned.
extern "C" int fused_ffn_bwd(const void* x, const void* w1, const void* w3,
                             const void* w2, const void* dout, void* du,
                             void* dv, void* g, void* dx, void* dw1,
                             void* dw3, void* dw2, int R, int d, int f,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d < 8 || f < 8 || d % 8 || f % 8) return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return gemm::consumers(R) == 1
               ? tc::launch<1>(x, w1, w3, w2, dout, du, dv, g, dx, dw1, dw3,
                               dw2, R, d, f, s)
               : tc::launch<2>(x, w1, w3, w2, dout, du, dv, g, dx, dw1, dw3,
                               dw2, R, d, f, s);
  if (dtype == DTYPE_F32) {
    if (R > 65535 * 64) return cudaErrorInvalidValue;   // grid y of f32 act
    return launch<float>(x, w1, w3, w2, dout, du, dv, g, dx, dw1, dw3, dw2,
                         R, d, f, s);
  }
  return cudaErrorInvalidValue;
}

// the product units (64 x 64 x 64 multiply-adds, 2 * 64^3 flops each) a
// bf16 call at (R, d, f) issues on the tensor cores, hi/lo counted: what
// the rates divide by
extern "C" long long fused_ffn_bwd_units(int R, int d, int f) {
  return gemm::consumers(R) == 1 ? tc::units<1>(R, d, f)
                               : tc::units<2>(R, d, f);
}

// dynamic shared memory a bf16 block takes (ptxas reports only static
// shared memory): kernel 0 act, 1 dx, 2 dw; nc consumer warpgroups (dw
// always two)
extern "C" int fused_ffn_bwd_smem(int kernel, int nc) {
  if (kernel == 2) return tc::dw_smem();
  if (nc == 1) return kernel ? tc::dx_smem<1>() : tc::act_smem<1>();
  return kernel ? tc::dx_smem<2>() : tc::act_smem<2>();
}
