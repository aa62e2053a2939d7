// Weight-only int8 fused SwiGLU FFN forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `fused_ffn_w8`
// (`_fwd_w8_kernel`, pallas_call at :470) — kernel A6, the serving tick's
// FFN when the engine serves w8 weights (reached through `apply_ffn`).
//
// What it computes: for x [R, d] (bf16 or f32), int8 w1/w3 [d, f] and
// w2 [f, d] in the reference's [in, out] layout, and f32 dequant
// multipliers s1/s3 [f], s2 [d] (absmax / 127, divided once by the
// wrapper):
//   u = (x @ w1) * s1,  v = (x @ w3) * s3,  g = silu(u) * v,
//   out = (g @ w2) * s2,
// all math in f32, output in x's type. The gate/up scales land on the
// sums before silu (they cannot pass the nonlinearity); the down scale is
// the same for every slice of f, so it multiplies the final sum once.
//
// Bound on the H100: bytes at decode. At R = 8, d = 4096, f = 11008 the
// three int8 matrices are 135.3 MB per layer (0.040 ms at 3.35 TB/s),
// half of A3's bf16 weights, against 2.2 GFLOP.
//
// Design: A3's deterministic plan (`fused_ffn.cu`) with int8 weight tiles.
//   1. gate/up: each block owns 32 columns of f for up to 32 rows; per
//      64-deep step, threads 0..127 load the w1 tile and 128..255 the w3
//      tile, one 16-byte word of 16 int8 weights each, widened to f32 in
//      registers on the way to shared memory; g goes to an f32 scratch;
//   2. down: 32 output columns, up to 32 rows and one fixed slice of f per
//      block (so a decode launch still has about four blocks per SM),
//      writing unscaled f32 partial sums;
//   3. reduce: the partials are added in split order, times s2, and cast.
// No atomics, so a recomputed prefill reproduces pages and tokens. No
// dequantized copy of a weight exists outside registers and the staged
// f32 tile. Tensor cores (int8 or bf16 mma after the widening) and TMA
// are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;  // output columns per block
constexpr int kBK = 64;  // reduction depth per staged tile

// One [kBK, kBN] int8 tile of a row-major weight matrix: 128 threads, two
// 16-byte words per row. Columns are whole words (widths are multiples of
// 16), rows past `kend` and columns past `ncols` load zeros.
struct WeightTile {
  int row, col;
  Int8x16 v;

  __device__ explicit WeightTile(int t) : row(t >> 1), col((t & 1) * 16) {}

  __device__ void fetch(const int8_t* W, int ld, int col0, int ncols, int k0,
                        int kend) {
    if (k0 + row < kend && col0 + col < ncols)
      v.load(W + (size_t)(k0 + row) * ld + col0 + col);
    else
      v.zero();
  }
  __device__ void stash(float (*ws)[kBN]) const { v.store_floats(&ws[row][col]); }
};

// One [BR, kBK] tile of the row-major activations (x or g), 8 elements a
// thread: the first 8 * BR threads.
template <typename T, int BR>
struct RowTile {
  int row, col;
  bool active;
  Vec8<T> v;

  __device__ explicit RowTile(int tid)
      : row(tid >> 3), col((tid & 7) * 8), active(tid < BR * 8) {}

  __device__ void fetch(const T* A, int lda, int row0, int R, int k0,
                        int kend) {
    if (!active) return;
    if (row0 + row < R && k0 + col < kend)
      v.load(A + (size_t)(row0 + row) * lda + k0 + col);
    else
      v.zero();
  }
  __device__ void stash(float (*as)[kBK]) const {
    if (!active) return;
    float f[8];
    v.to_floats(f);
    float4* d = reinterpret_cast<float4*>(&as[row][col]);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// g[R, f] = silu((x @ w1) * s1) * ((x @ w3) * s3), f32. Thread (rg, c)
// owns rows rg*TR .. rg*TR+TR-1 of the block and column c.
template <typename T, int TR>
__global__ void __launch_bounds__(kThreads)
w8_gate_up_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1,
                  const float* __restrict__ s1, const int8_t* __restrict__ w3,
                  const float* __restrict__ s3, float* __restrict__ g, int R,
                  int d, int f) {
  constexpr int BR = 8 * TR;
  __shared__ __align__(16) float xs[BR][kBK];
  __shared__ __align__(16) float ws[2][kBK][kBN];  // w1, w3
  const int tid = threadIdx.x, c = tid & 31, rg = tid >> 5;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * BR;
  const int side = tid >> 7;  // 0: this thread loads w1, 1: w3
  const int8_t* W = side ? w3 : w1;

  WeightTile wt(tid & 127);
  RowTile<T, BR> xt(tid);
  float acc_u[TR], acc_v[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc_u[i] = acc_v[i] = 0.f;

  wt.fetch(W, f, col0, f, 0, d);
  xt.fetch(x, d, row0, R, 0, d);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    wt.stash(ws[side]);
    xt.stash(xs);
    __syncthreads();
    if (k0 + kBK < d) {  // next tile in flight during this tile's FMAs
      wt.fetch(W, f, col0, f, k0 + kBK, d);
      xt.fetch(x, d, row0, R, k0 + kBK, d);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a = ws[0][kk][c], b = ws[1][kk][c];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float xv = xs[rg * TR + i][kk];
        acc_u[i] = fmaf(xv, a, acc_u[i]);
        acc_v[i] = fmaf(xv, b, acc_v[i]);
      }
    }
    __syncthreads();
  }
  const int col = col0 + c;
  if (col >= f) return;
  const float su = s1[col], sv = s3[col];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + rg * TR + i;
    if (r < R) {
      const float u = acc_u[i] * su;
      g[(size_t)r * f + col] = u / (1.f + expf(-u)) * (acc_v[i] * sv);
    }
  }
}

// part[split, R, d] = g[:, ks] @ w2[ks, :] over this split's slice ks of f,
// unscaled.
template <int TR>
__global__ void __launch_bounds__(kThreads)
w8_down_kernel(const float* __restrict__ g, const int8_t* __restrict__ w2,
               float* __restrict__ part, int R, int d, int f,
               int k_per_split) {
  constexpr int BR = 8 * TR;
  __shared__ __align__(16) float gs[BR][kBK];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x, c = tid & 31, rg = tid >> 5;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * BR;
  const int split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int kend = min(f, kbeg + k_per_split);
  const bool loads_w = tid < 128;

  WeightTile wt(tid & 127);
  RowTile<float, BR> gt(tid);
  float acc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc[i] = 0.f;

  if (kbeg < kend) {
    if (loads_w) wt.fetch(w2, d, col0, d, kbeg, kend);
    gt.fetch(g, f, row0, R, kbeg, kend);
  }
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    if (loads_w) wt.stash(ws);
    gt.stash(gs);
    __syncthreads();
    if (k0 + kBK < kend) {
      if (loads_w) wt.fetch(w2, d, col0, d, k0 + kBK, kend);
      gt.fetch(g, f, row0, R, k0 + kBK, kend);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float b = ws[kk][c];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i] = fmaf(gs[rg * TR + i][kk], b, acc[i]);
    }
    __syncthreads();
  }
  const int col = col0 + c;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + rg * TR + i;
    if (r < R && col < d) part[((size_t)split * R + r) * d + col] = acc[i];
  }
}

// out[r, j] = (sum over splits of part, in split order) * s2[j]
template <typename T>
__global__ void w8_reduce_kernel(const float* __restrict__ part,
                                 const float* __restrict__ s2,
                                 T* __restrict__ out, int n, int d,
                                 int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = from_float<T>(s * s2[i % d]);
}

template <typename T, int TR>
int launch(const void* x, const void* w1, const void* s1, const void* w3,
           const void* s3, const void* w2, const void* s2, void* g,
           void* part, void* out, int R, int d, int f, int splits,
           cudaStream_t stream) {
  constexpr int BR = 8 * TR;
  const int k_tiles = (f + kBK - 1) / kBK;
  const int k_per_split = ((k_tiles + splits - 1) / splits) * kBK;
  dim3 g1((f + kBN - 1) / kBN, (R + BR - 1) / BR);
  w8_gate_up_kernel<T, TR><<<g1, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const int8_t*>(w3),
      static_cast<const float*>(s3), static_cast<float*>(g), R, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((d + kBN - 1) / kBN, (R + BR - 1) / BR, splits);
  w8_down_kernel<TR><<<g2, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const int8_t*>(w2),
      static_cast<float*>(part), R, d, f, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = R * d;
  w8_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(s2),
      static_cast<T*>(out), n, d, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const void* w1, const void* s1, const void* w3,
                const void* s3, const void* w2, const void* s2, void* g,
                void* part, void* out, int R, int d, int f, int splits,
                cudaStream_t stream) {
  // 8 rows a block for decode-sized R, 32 for prefill chunks
  if (R <= 8)
    return launch<T, 1>(x, w1, s1, w3, s3, w2, s2, g, part, out, R, d, f,
                        splits, stream);
  return launch<T, 4>(x, w1, s1, w3, s3, w2, s2, g, part, out, R, d, f,
                      splits, stream);
}

}  // namespace

// x [R, d]; w1, w3 int8 [d, f]; w2 int8 [f, d]; s1, s3 [f] and s2 [d] f32
// dequant multipliers; g [R, f] f32 and part [splits, R, d] f32 are
// scratch the caller allocates; out [R, d] in x's type.
extern "C" int fused_ffn_w8_fwd(const void* x, const void* w1, const void* s1,
                                const void* w3, const void* s3, const void* w2,
                                const void* s2, void* g, void* part, void* out,
                                int R, int d, int f, int splits, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d % 16 || f % 16 || splits < 1) return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch_rows<__nv_bfloat16>(x, w1, s1, w3, s3, w2, s2, g, part, out,
                                      R, d, f, splits, s);
  if (dtype == DTYPE_F32)
    return launch_rows<float>(x, w1, s1, w3, s3, w2, s2, g, part, out, R, d,
                              f, splits, s);
  return cudaErrorInvalidValue;
}
