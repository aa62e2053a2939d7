// Fused SwiGLU FFN backward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `_bwd` (`_dx_kernel` :258,
// `_dw_kernel` :284, the shared `_act_grads` :239; pallas_calls at :333 and
// :368) — kernel A4, the gradient of A3 in the training step.
//
// What it computes, for x [R, d], w1/w3 [d, f], w2 [f, d] and the output
// gradient do [R, d] (bf16 or f32, math in f32):
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
// for u, so the launch is three kernels that pass f32 scratch:
//   1. act: per 64 x 64 tile of [R, f], the three d-deep products u, v and
//      dg, then the elementwise epilogue writes du, dv and g (f32);
//   2. dx: per 128 x 128 tile of [R, d], du w1^T + dv w3^T, one f-deep sum;
//   3. dw: per 128 x 128 tile of dw1, dw3 or dw2 (grid z picks the
//      product), an R-deep sum.
// Every output tile is owned by one block and its sum runs in a fixed
// order: no atomics and no split over rows, so the gradients are the same
// on every run. The products share one tiled routine: 16-deep slices of
// both operands staged in shared memory as f32, the next slice's 16-byte
// global loads issued before the current slice's FMAs on the CUDA cores,
// each thread owning an 8 x 8 (or 4 x 4) patch. The scratch round trip is
// 3 * R * f * 4 bytes (541 MB at R = 4096). Tensor cores are later work.
#include "common.cuh"

namespace {

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

}  // namespace

// x, do [R, d]; w1, w3 [d, f]; w2 [f, d]; du, dv, g [R, f] f32 scratch the
// caller allocates; dx [R, d]; dw1, dw3 [d, f]; dw2 [f, d]; all of one type
// apart from the scratch, all contiguous.
extern "C" int fused_ffn_bwd(const void* x, const void* w1, const void* w3,
                             const void* w2, const void* dout, void* du,
                             void* dv, void* g, void* dx, void* dw1,
                             void* dw3, void* dw2, int R, int d, int f,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d < 8 || f < 8 || d % 8 || f % 8 || R > 65535 * 64)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w1, w3, w2, dout, du, dv, g, dx, dw1, dw3,
                                 dw2, R, d, f, s);
  if (dtype == DTYPE_F32)
    return launch<float>(x, w1, w3, w2, dout, du, dv, g, dx, dw1, dw3, dw2, R,
                         d, f, s);
  return cudaErrorInvalidValue;
}
