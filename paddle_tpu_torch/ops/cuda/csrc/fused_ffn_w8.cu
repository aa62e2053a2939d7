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
// all sums in f32, output in x's type. The gate/up scales land on the
// sums before silu (they cannot pass the nonlinearity); the down scale is
// the same for every slice of f, so it multiplies the final sum once.
//
// Bound on the H100: bytes at decode. At R = 8, d = 4096, f = 11008 the
// three int8 matrices are 135.3 MB per layer (0.040 ms at 3.35 TB/s),
// half of A3's bf16 weights, against 2.2 GFLOP.
//
// Design: A3's deterministic plan (`fused_ffn.cu`) with int8 weights.
//   1. gate/up: each block owns a tile of [R, f] and writes g;
//   2. down: each block owns a tile of [R, d] and one fixed slice of f
//      (the wrapper's `w8_splits`), writing unscaled f32 partial sums;
//   3. reduce: the partials are added in split order, times s2, and cast.
// No atomics, one owner per output tile, so a recomputed prefill
// reproduces pages and tokens bit for bit.
//
// bf16 x: every product on the tensor cores, through the wgmma core of
// `gemm_sm90.cuh` (a producer warpgroup keeps a TMA ring full and gives
// its registers to the consumer warpgroup). The weights reach the tensor
// cores as bf16: wgmma takes 8-bit operands only K-major and only against
// another 8-bit operand, and the reference keeps x unquantized. The
// widening is exact: |q| <= 127 fits bf16's 8-bit significand, so each
// product x_bf16 * bf16(q) is exact in the f32 accumulator, as the
// reference's f32 products are.
//   The product is swapped, u^T = W1^T x^T (and out^T = W2^T g^T): the
// int8 weight tile [64 deep][64 columns] comes in by TMA as it lies in
// device memory (a `mat_map_i8` map, 64-byte swizzle), and the consumers
// widen W^T straight into the register A operand of the wgmma
// (`gemm::i8_frag`: four 16-bit shared-memory loads, two byte interleaves
// and a conversion with no int-to-float instruction, a byte into the
// mantissa of 2^23 and one f32 subtraction). The token rows are the
// wgmma's N, read K-major from their TMA tile: N = 8 for a decode tick,
// tiles of 64 rows above. Each block owns 64 columns of f (gate/up) or
// of d (down) and N rows; blocks are small (6 stages of 9 KB at N = 8,
// four an SM), so the weight bytes of several blocks are in flight on
// each SM. No dequantized copy of a weight reaches device memory or
// shared memory: the bf16 weights exist only in registers.
//   Why swapped. The first design widened each int8 stage into bf16 boxes
// in shared memory and ran the core's shared-memory products on them
// with the token rows as the 64-row M: at decode that moved ~72 KB of
// shared memory per 8 KB of weights (x's 64 rows, 56 of them zeros, read
// by every product; the widened boxes written, then read), and its
// gate/up kernel read the weights at 1.5 TB/s on an H100 SXM (700 W,
// `chip_smoke.py`'s decode profile). The swapped product reads a tile's
// weights once from shared memory and N rows of x (~19 KB per 8 KB of
// weights at N = 8).
//   g goes to bf16 planes hi = bf16(g), lo = bf16(g - hi) in the bytes an
// f32 g would take, and the down product runs both planes against each
// widened w2 fragment, so g keeps the f32 reference's precision (A3's
// reasoning).
//
// f32 x (the agreement checks): the CUDA-core kernels. Gate/up owns 32
// columns of f for up to 32 rows; per 64-deep step threads 0..127 load the
// w1 tile and 128..255 the w3 tile, one 16-byte word of 16 int8 weights
// each, widened to f32 on the way to shared memory; g is an f32 scratch;
// down owns 32 output columns and one slice of f (`splits`, about four
// blocks an SM at decode).
#include "common.cuh"
#include "gemm_sm90.cuh"

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

// -- bf16: tensor cores, the swapped product --------------------------------

namespace tc {

using gemm::bf16;

// N token rows a tile: 8 for a decode tick's rows, 64 above (row tiles of
// 64). Small tiles, so several blocks share an SM and deeper rings keep
// more weight bytes in flight.
template <int N>
__host__ __device__ constexpr int blocks_per_sm() { return N == 8 ? 4 : 2; }
template <int N>
__host__ __device__ constexpr int stages() { return N == 8 ? 6 : 4; }

template <int N>
struct GateUpSmem {
  bf16 x[stages<N>()][N * 64];        // [N rows][64 deep], K-major (B)
  int8_t w1[stages<N>()][64 * 64];    // [64 deep][64 columns of f]
  int8_t w3[stages<N>()][64 * 64];
  gemm::Pipe<stages<N>()> pipe;
};

template <int N>
struct DownSmem {
  bf16 hi[stages<N>()][N * 64];       // g's planes, [N rows][64 deep]
  bf16 lo[stages<N>()][N * 64];
  int8_t w2[stages<N>()][64 * 64];    // [64 deep][64 columns of d]
  gemm::Pipe<stages<N>()> pipe;
};

// acc (64 x N) += A B: A a widened W^T fragment, B N rows K-major
template <int N>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 8)
    flash::sm90::wgmma_rs_kb_n8(acc, a, db);
  else
    flash::sm90::wgmma_rs_kb_n64(acc, a, db);
}

__device__ __forceinline__ float silu(float u) {
  return u / (1.f + expf(-u));
}

// g = silu((x w1) s1) * ((x w3) s3) as the planes g_hi, g_lo [R, f]: the
// block owns 64 columns of f (W^T's rows) and N rows of x (the N)
template <int N>
__global__ void __launch_bounds__(gemm::threads<1>(), blocks_per_sm<N>())
w8_gate_up_tc(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mw1,
              const __grid_constant__ CUtensorMap mw3,
              const float* __restrict__ s1, const float* __restrict__ s3,
              bf16* __restrict__ g_hi, bf16* __restrict__ g_lo, int R,
              int d, int f) {
  constexpr int S = stages<N>();
  extern __shared__ unsigned char smem_raw[];
  GateUpSmem<N>& sm = flash::sm90::smem_as<GateUpSmem<N>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, N),
                              gemm::tiles(f, 64));
  const int r0 = t.x * N, n0 = t.y * 64;
  const int nk = gemm::tiles(d, 64);
  gemm::pipe_init<S, 1>(sm.pipe);

  if (threadIdx.x >= 128) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128)
      gemm::produce(sm.pipe, nk, N * 128 + 2 * 64 * 64,
                    [&](int s, int kt, uint64_t* bar) {
                      gemm::load_rows(sm.x[s], &mx, bar, kt * 64, r0);
                      gemm::load_i8(sm.w1[s], &mw1, bar, kt * 64, n0);
                      gemm::load_i8(sm.w3[s], &mw3, bar, kt * 64, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::held_regs<1, blocks_per_sm<N>()>()>();
  float u[N / 2], v[N / 2];
  gemm::zero(u);
  gemm::zero(v);
  // the zeros are written before the first product: an accumulator
  // written between a wgmma and its wait serializes every wgmma (C7515)
  flash::sm90::fence_regs(u);
  flash::sm90::fence_regs(v);
  uint32_t a1[4][4], a3[4][4];
  gemm::consume_rs(
      sm.pipe, nk,
      [&](int s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          gemm::i8_frag(a1[kk], sm.w1[s], kk);
          gemm::i8_frag(a3[kk], sm.w3[s], kk);
          flash::sm90::wg_fence();
          const uint64_t db = flash::sm90::desc_k(sm.x[s], kk);
          mma_rs<N>(u, a1[kk], db);
          mma_rs<N>(v, a3[kk], db);
        }
      },
      [&] {
        gemm::fence_frags(a1);
        gemm::fence_frags(a3);
      });
  flash::sm90::fence_regs(u);
  flash::sm90::fence_regs(v);
  // entries e and e + 2 are columns c, c + 1 of f in one row of x
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e0 = 0; e0 < N / 2; e0 += 4)
#pragma unroll
    for (int e = e0; e < e0 + 2; ++e) {
      const int r = r0 + flash::sm90::acc_col(e, lane);
      const int c = n0 + gemm::i8_col(e);
      if (r < R && c < f) {
        const size_t o = (size_t)r * f + c;
        const float u0 = u[e] * s1[c], u1 = u[e + 2] * s1[c + 1];
        gemm::store_hi_lo(g_hi + o, g_lo + o, silu(u0) * (v[e] * s3[c]),
                          silu(u1) * (v[e + 2] * s3[c + 1]));
      }
    }
}

// part[split, R, d] = (g_hi + g_lo)[:, ks] @ w2[ks, :], unscaled, over
// this split's slice ks of f (k_per_split, a multiple of 64): the block
// owns 64 columns of d and N rows
template <int N>
__global__ void __launch_bounds__(gemm::threads<1>(), blocks_per_sm<N>())
w8_down_tc(const __grid_constant__ CUtensorMap mhi,
           const __grid_constant__ CUtensorMap mlo,
           const __grid_constant__ CUtensorMap mw2, float* __restrict__ part,
           int R, int d, int f, int k_per_split) {
  constexpr int S = stages<N>();
  extern __shared__ unsigned char smem_raw[];
  DownSmem<N>& sm = flash::sm90::smem_as<DownSmem<N>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, N),
                              gemm::tiles(d, 64));
  const int r0 = t.x * N, n0 = t.y * 64, split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int nk = gemm::tiles(max(0, min(f, kbeg + k_per_split) - kbeg), 64);
  gemm::pipe_init<S, 1>(sm.pipe);

  if (threadIdx.x >= 128) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128)
      gemm::produce(sm.pipe, nk, 2 * N * 128 + 64 * 64,
                    [&](int s, int kt, uint64_t* bar) {
                      const int k0 = kbeg + kt * 64;
                      gemm::load_rows(sm.hi[s], &mhi, bar, k0, r0);
                      gemm::load_rows(sm.lo[s], &mlo, bar, k0, r0);
                      gemm::load_i8(sm.w2[s], &mw2, bar, k0, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::held_regs<1, blocks_per_sm<N>()>()>();
  float acc[N / 2];
  gemm::zero(acc);
  flash::sm90::fence_regs(acc);   // as in gate/up
  uint32_t a2[4][4];
  gemm::consume_rs(
      sm.pipe, nk,
      [&](int s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          gemm::i8_frag(a2[kk], sm.w2[s], kk);
          flash::sm90::wg_fence();
          mma_rs<N>(acc, a2[kk], flash::sm90::desc_k(sm.hi[s], kk));
          mma_rs<N>(acc, a2[kk], flash::sm90::desc_k(sm.lo[s], kk));
        }
      },
      [&] { gemm::fence_frags(a2); });
  flash::sm90::fence_regs(acc);
  const int lane = threadIdx.x & 31;
  float* dst = part + (size_t)split * R * d;
#pragma unroll
  for (int e0 = 0; e0 < N / 2; e0 += 4)
#pragma unroll
    for (int e = e0; e < e0 + 2; ++e) {
      const int r = r0 + flash::sm90::acc_col(e, lane);
      const int c = n0 + gemm::i8_col(e);
      if (r < R && c < d)
        *reinterpret_cast<float2*>(dst + (size_t)r * d + c) =
            make_float2(acc[e], acc[e + 2]);
    }
}

template <int N>
constexpr int gate_up_smem() {
  return flash::sm90::smem_bytes<GateUpSmem<N>>();
}
template <int N>
constexpr int down_smem() {
  return flash::sm90::smem_bytes<DownSmem<N>>();
}

template <int N>
int launch(const void* x, const void* w1, const void* s1, const void* w3,
           const void* s3, const void* w2, const void* s2, void* g,
           void* part, void* out, int R, int d, int f, int splits,
           cudaStream_t stream) {
  bf16* g_hi = static_cast<bf16*>(g);
  bf16* g_lo = g_hi + (size_t)R * f;
  CUtensorMap mx, mw1, mw3, mw2, mhi, mlo;
  cudaError_t err = gemm::cached_map(&mx, x, R, d, N);
  if (err == cudaSuccess)
    err = gemm::cached_map(&mw1, w1, d, f, gemm::kI8Map);
  if (err == cudaSuccess)
    err = gemm::cached_map(&mw3, w3, d, f, gemm::kI8Map);
  if (err == cudaSuccess)
    err = gemm::cached_map(&mw2, w2, f, d, gemm::kI8Map);
  if (err == cudaSuccess) err = gemm::cached_map(&mhi, g_hi, R, f, N);
  if (err == cudaSuccess) err = gemm::cached_map(&mlo, g_lo, R, f, N);
  if (err == cudaSuccess)
    err = gemm::allow_smem(w8_gate_up_tc<N>, gate_up_smem<N>());
  if (err == cudaSuccess)
    err = gemm::allow_smem(w8_down_tc<N>, down_smem<N>());
  if (err != cudaSuccess) return err;

  dim3 g1(gemm::tiles(R, N) * gemm::tiles(f, 64));
  w8_gate_up_tc<N><<<g1, gemm::threads<1>(), gate_up_smem<N>(), stream>>>(
      mx, mw1, mw3, static_cast<const float*>(s1),
      static_cast<const float*>(s3), g_hi, g_lo, R, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_per_split = gemm::tiles(gemm::tiles(f, 64), splits) * 64;
  dim3 g2(gemm::tiles(R, N) * gemm::tiles(d, 64), 1, splits);
  w8_down_tc<N><<<g2, gemm::threads<1>(), down_smem<N>(), stream>>>(
      mhi, mlo, mw2, static_cast<float*>(part), R, d, f, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = R * d;
  w8_reduce_kernel<bf16><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(s2),
      static_cast<bf16*>(out), n, d, splits);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x [R, d]; w1, w3 int8 [d, f]; w2 int8 [f, d]; s1, s3 [f] and s2 [d] f32
// dequant multipliers; g (R * f * 4 bytes: f32 g, or bf16 g's hi and lo
// planes [2, R, f]) and part [splits, R, d] f32 are scratch the caller
// allocates; out [R, d] in x's type. Every pointer 16-byte aligned,
// everything contiguous.
extern "C" int fused_ffn_w8_fwd(const void* x, const void* w1, const void* s1,
                                const void* w3, const void* s3, const void* w2,
                                const void* s2, void* g, void* part, void* out,
                                int R, int d, int f, int splits, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d < 16 || f < 16 || d % 16 || f % 16 || splits < 1)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return R <= 8 ? tc::launch<8>(x, w1, s1, w3, s3, w2, s2, g, part, out, R,
                                  d, f, splits, s)
                  : tc::launch<64>(x, w1, s1, w3, s3, w2, s2, g, part, out,
                                   R, d, f, splits, s);
  if (dtype == DTYPE_F32)   // 8 rows a block for decode-sized R, 32 above
    return R <= 8 ? launch<float, 1>(x, w1, s1, w3, s3, w2, s2, g, part, out,
                                     R, d, f, splits, s)
                  : launch<float, 4>(x, w1, s1, w3, s3, w2, s2, g, part, out,
                                     R, d, f, splits, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory a bf16 block takes (ptxas reports only static
// shared memory): kernel 0 gate/up, 1 down; n token rows a tile (8, 64)
extern "C" int fused_ffn_w8_smem(int kernel, int n) {
  if (n == 8) return kernel ? tc::down_smem<8>() : tc::gate_up_smem<8>();
  return kernel ? tc::down_smem<64>() : tc::gate_up_smem<64>();
}

// the token rows of a bf16 tile for R rows, and the blocks an SM it is
// sized for (`w8_tile` in the wrapper)
extern "C" int fused_ffn_w8_tile_rows(int R) { return R <= 8 ? 8 : 64; }
extern "C" int fused_ffn_w8_blocks_per_sm(int R) {
  return R <= 8 ? tc::blocks_per_sm<8>() : tc::blocks_per_sm<64>();
}
