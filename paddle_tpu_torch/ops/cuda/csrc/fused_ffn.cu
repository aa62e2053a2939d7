// Fused SwiGLU FFN forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `_fwd` (`_fwd_kernel`,
// pallas_call at :223) — kernel A3, reached through `fused_ffn` /
// `apply_ffn` on the serving tick and through `llama.ffn`
// in the training step, whose backward is A4 (`fused_ffn_bwd.cu`).
//
// What it computes: out = (silu(x @ w1) * (x @ w3)) @ w2 for x [R, d],
// w1/w3 [d, f], w2 [f, d]; inputs read as bf16 or f32, all math in f32,
// output in x's type.
//
// Bound on the H100: bytes at decode. At R = 8, d = 4096, f = 11008 in
// bf16 the three weight matrices are 270.5 MB per layer (about 81 us at
// 3.35 TB/s) against 2.2 GFLOP; the FLOP/B ratio only reaches the card's
// ridge at R of a few hundred rows.
//
// Design. The TPU kernel carries the down-projection sum across its
// sequential d_ff grid axis in VMEM scratch; GPU blocks run in parallel
// and carry nothing, so the work is split in three deterministic steps:
//   1. gate/up: each block owns 32 columns of d_ff for up to 32 rows and
//      writes g = silu(x @ w1) * (x @ w3) as f32 to a scratch [R, f];
//   2. down: each block owns 32 output columns for up to 32 rows and one
//      slice of d_ff (a fixed split-K, so that a decode launch still has
//      about four blocks per SM), and writes its f32 partial sum;
//   3. reduce: the partial sums are added in split order and cast.
// No atomics: the result is the same from run to run, which preemption
// recompute relies on. Tiles of 64 along the reduction are staged in
// shared memory as f32; the next tile's global loads (16 bytes a thread)
// are issued before the current tile's FMAs on the CUDA cores. The g round
// trip is R * f * 4 bytes (0.35 MB at R = 8), nothing beside the weights.
// Folding the three steps into one launch, and tensor cores (wgmma) for
// prefill-sized R, are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;  // output columns per block
constexpr int kBK = 64;  // reduction depth per staged tile

// One [rows, kBK] tile of a row-major A (x or g) and one [kBK, kBN] tile of
// a row-major B (weights), moved as 8-element vectors: 256 threads cover
// the B tile exactly (64 rows x 4 vectors); the first 8 * rows threads
// also cover the A tile.
template <typename TA, typename TB, int BR>
struct TileLoader {
  int b_row, b_col, a_row, a_col;
  bool a_thread;
  Vec8<TB> b;
  Vec8<TA> a;

  __device__ TileLoader(int tid) {
    b_row = tid >> 2;
    b_col = (tid & 3) * 8;
    a_row = tid >> 3;
    a_col = (tid & 7) * 8;
    a_thread = tid < BR * 8;
  }

  // k in [k0, kend) is live; rows/cols outside the matrix load zeros
  __device__ void fetch(const TA* A, int lda, int row0, int R, const TB* B,
                        int ldb, int col0, int ncols, int k0, int kend) {
    if (k0 + b_row < kend && col0 + b_col < ncols)
      b.load(B + (size_t)(k0 + b_row) * ldb + col0 + b_col);
    else
      b.zero();
    if (a_thread) {
      if (row0 + a_row < R && k0 + a_col < kend)
        a.load(A + (size_t)(row0 + a_row) * lda + k0 + a_col);
      else
        a.zero();
    }
  }

  __device__ void stash(float (*as)[kBK], float (*bs)[kBN]) const {
    float v[8];
    b.to_floats(v);
    float4* bd = reinterpret_cast<float4*>(&bs[b_row][b_col]);
    bd[0] = make_float4(v[0], v[1], v[2], v[3]);
    bd[1] = make_float4(v[4], v[5], v[6], v[7]);
    if (a_thread) {
      a.to_floats(v);
      float4* ad = reinterpret_cast<float4*>(&as[a_row][a_col]);
      ad[0] = make_float4(v[0], v[1], v[2], v[3]);
      ad[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

// g[R, f] = silu(x @ w1) * (x @ w3), f32. Thread (rg, c) owns rows
// rg*TR .. rg*TR+TR-1 of the block and column c.
template <typename T, int TR>
__global__ void __launch_bounds__(kThreads)
ffn_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w3, float* __restrict__ g, int R,
                   int d, int f) {
  constexpr int BR = 8 * TR;
  __shared__ __align__(16) float xs[BR][kBK];
  __shared__ __align__(16) float w1s[kBK][kBN];
  __shared__ __align__(16) float w3s[kBK][kBN];
  const int tid = threadIdx.x, c = tid & 31, rg = tid >> 5;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * BR;

  TileLoader<T, T, BR> l1(tid), l3(tid);
  l3.a_thread = false;  // x is staged once, by l1
  float acc_u[TR], acc_v[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc_u[i] = acc_v[i] = 0.f;

  l1.fetch(x, d, row0, R, w1, f, col0, f, 0, d);
  l3.fetch(x, d, row0, R, w3, f, col0, f, 0, d);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    l1.stash(xs, w1s);
    l3.stash(xs, w3s);
    __syncthreads();
    if (k0 + kBK < d) {  // next tile in flight during this tile's FMAs
      l1.fetch(x, d, row0, R, w1, f, col0, f, k0 + kBK, d);
      l3.fetch(x, d, row0, R, w3, f, col0, f, k0 + kBK, d);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float a = w1s[kk][c], b = w3s[kk][c];
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
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + rg * TR + i;
    if (r < R && col < f) {
      const float u = acc_u[i];
      g[(size_t)r * f + col] = u / (1.f + expf(-u)) * acc_v[i];
    }
  }
}

// part[split, R, d] = g[:, ks] @ w2[ks, :] over this split's slice ks of f.
template <typename T, int TR>
__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const float* __restrict__ g, const T* __restrict__ w2,
                float* __restrict__ part, int R, int d, int f,
                int k_per_split) {
  constexpr int BR = 8 * TR;
  __shared__ __align__(16) float gs[BR][kBK];
  __shared__ __align__(16) float w2s[kBK][kBN];
  const int tid = threadIdx.x, c = tid & 31, rg = tid >> 5;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * BR;
  const int split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int kend = min(f, kbeg + k_per_split);

  TileLoader<float, T, BR> ld(tid);
  float acc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc[i] = 0.f;

  if (kbeg < kend) ld.fetch(g, f, row0, R, w2, d, col0, d, kbeg, kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    ld.stash(gs, w2s);
    __syncthreads();
    if (k0 + kBK < kend) ld.fetch(g, f, row0, R, w2, d, col0, d, k0 + kBK, kend);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float b = w2s[kk][c];
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

// out = sum over splits of part, in split order
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = from_float<T>(s);
}

template <typename T, int TR>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           void* g, void* part, void* out, int R, int d, int f, int splits,
           cudaStream_t stream) {
  constexpr int BR = 8 * TR;
  const int k_tiles = (f + kBK - 1) / kBK;
  const int k_per_split = ((k_tiles + splits - 1) / splits) * kBK;
  dim3 g1((f + kBN - 1) / kBN, (R + BR - 1) / BR);
  ffn_gate_up_kernel<T, TR><<<g1, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<float*>(g), R, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 g2((d + kBN - 1) / kBN, (R + BR - 1) / BR, splits);
  ffn_down_kernel<T, TR><<<g2, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(w2),
      static_cast<float*>(part), R, d, f, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = R * d;
  ffn_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const void* w1, const void* w3, const void* w2,
                void* g, void* part, void* out, int R, int d, int f,
                int splits, cudaStream_t stream) {
  // 8 rows a block for decode-sized R, 32 for prefill chunks
  if (R <= 8)
    return launch<T, 1>(x, w1, w3, w2, g, part, out, R, d, f, splits, stream);
  return launch<T, 4>(x, w1, w3, w2, g, part, out, R, d, f, splits, stream);
}

}  // namespace

// x [R, d]; w1, w3 [d, f]; w2 [f, d]; g [R, f] f32 and part [splits, R, d]
// f32 are scratch the caller allocates; out [R, d] in x's type.
extern "C" int fused_ffn_fwd(const void* x, const void* w1, const void* w3,
                             const void* w2, void* g, void* part, void* out,
                             int R, int d, int f, int splits, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d % 8 || f % 8 || splits < 1) return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch_rows<__nv_bfloat16>(x, w1, w3, w2, g, part, out, R, d, f,
                                      splits, s);
  if (dtype == DTYPE_F32)
    return launch_rows<float>(x, w1, w3, w2, g, part, out, R, d, f, splits,
                              s);
  return cudaErrorInvalidValue;
}
