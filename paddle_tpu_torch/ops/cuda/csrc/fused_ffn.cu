// Fused SwiGLU FFN forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `_fwd` (`_fwd_kernel`,
// pallas_call at :223) — kernel A3, reached through `fused_ffn` /
// `apply_ffn` on the serving tick and through `llama.ffn`
// in the training step, whose backward is A4 (`fused_ffn_bwd.cu`).
//
// What it computes: out = (silu(x @ w1) * (x @ w3)) @ w2 for x [R, d],
// w1/w3 [d, f], w2 [f, d]; inputs read as bf16 or f32, all sums in f32,
// output in x's type.
//
// Bound on the H100: bytes at decode, operations at training rows. At
// R = 8, d = 4096, f = 11008 in bf16 the three weight matrices are 270.5
// MB per layer (about 81 us at 3.35 TB/s) against 2.2 GFLOP; at R = 4096
// the three products are 1.11 TFLOP (1.12 ms at 989 TFLOP/s).
//
// Design. The TPU kernel carries the down-projection sum across its
// sequential d_ff grid axis in VMEM scratch; GPU blocks run in parallel
// and carry nothing, so the work is split in three deterministic steps:
//   1. gate/up: each block owns a tile of [R, f] and writes
//      g = silu(x @ w1) * (x @ w3) to a scratch of R * f * 4 bytes;
//   2. down: each block owns a tile of [R, d] and one slice of d_ff (a
//      fixed split-K, the wrapper's `ffn_splits`, so that a decode launch
//      still fills the card), and writes its f32 partial sum;
//   3. reduce: the partial sums are added in split order and cast.
// No atomics: the result is the same from run to run, which preemption
// recompute relies on.
//
// bf16: every product on the tensor cores, through the wgmma core of
// `gemm_sm90.cuh` (a producer warpgroup streams 64-deep stages of
// 128-byte-swizzled tiles in by TMA through a ring of four; one or two
// consumer warpgroups issue wgmma from shared memory into f32
// accumulators). Rows past R and the depth past d or f load as zeros.
//   - gate/up keeps u = x w1 and v = x w3 in two accumulators of one tile
//     (x K-major, w1 and w3 read MN-major through the transpose bit) and
//     writes g as two bf16 planes, hi = bf16(g) and lo = bf16(g - hi), in
//     the bytes an f32 g would take;
//   - down walks both planes against each w2 tile (two wgmmas into one
//     sum), so g enters at ~2^-16 relative as the f32 reference has it: a
//     single bf16 g would add 2^-9 of every term, about 2e-3 of the rms of
//     a sum of random signs, and break the one-ulp rule near zero.
// Tiles: 128 rows x 128 columns with two consumer warpgroups (R > 64, one
// block an SM, 192 KB of stages); 64 x 64 with one for decode rows (96
// KB, two blocks an SM), where one zero-filled 64-row tile carries the
// rows and the weights' bytes are the bound: gate/up spreads d_ff over
// 172 blocks, down puts 64 column blocks times the split on the card.
//
// f32 (the agreement checks): the CUDA-core kernels, tiles of 64 along the
// reduction staged in shared memory as f32, FMAs, g an f32 scratch.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

// -- f32: CUDA cores ----------------------------------------------------------

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

// -- bf16: tensor cores --------------------------------------------------------

namespace tc {

using gemm::bf16;
using gemm::kBox;
using gemm::kBoxBytes;
constexpr int kStages = 4;

template <int NC>   // NC consumer warpgroups: a 64 NC x 64 NC tile
struct GateUpSmem {
  bf16 x[kStages][NC][kBox];    // [64 NC rows][64 deep], K-major
  bf16 w1[kStages][NC][kBox];   // [64 deep][64 NC columns], MN-major
  bf16 w3[kStages][NC][kBox];
  gemm::Pipe<kStages> pipe;
};

template <int NC>
struct DownSmem {
  bf16 hi[kStages][NC][kBox];   // g's planes, [64 NC rows][64 deep]
  bf16 lo[kStages][NC][kBox];
  bf16 w2[kStages][NC][kBox];   // [64 deep][64 NC columns], MN-major
  gemm::Pipe<kStages> pipe;
};

// two blocks an SM for the 64-row tiles, one for the 128-row ones
template <int NC>
__host__ __device__ constexpr int blocks_per_sm() { return NC == 1 ? 2 : 1; }

__device__ __forceinline__ float silu(float u) {
  return u / (1.f + expf(-u));
}

// g = silu(x w1) * (x w3) as the planes g_hi, g_lo [R, f]
template <int NC>
__global__ void __launch_bounds__(gemm::threads<NC>(), blocks_per_sm<NC>())
ffn_gate_up_tc(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw1,
               const __grid_constant__ CUtensorMap mw3,
               bf16* __restrict__ g_hi, bf16* __restrict__ g_lo, int R,
               int d, int f) {
  constexpr int BT = 64 * NC;   // rows and columns of the tile
  extern __shared__ unsigned char smem_raw[];
  GateUpSmem<NC>& sm = flash::sm90::smem_as<GateUpSmem<NC>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, BT),
                              gemm::tiles(f, BT));
  const int m0 = t.x * BT, n0 = t.y * BT;
  const int nk = gemm::tiles(d, 64);
  gemm::pipe_init<kStages, NC>(sm.pipe);

  if (threadIdx.x >= 128 * NC) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128 * NC)
      gemm::produce(sm.pipe, nk, 3 * NC * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
                      gemm::load_k<BT>(sm.x[s][0], &mx, bar, kt * 64, m0);
                      gemm::load_mn<BT>(sm.w1[s][0], &mw1, bar, kt * 64, n0);
                      gemm::load_mn<BT>(sm.w3[s][0], &mw3, bar, kt * 64, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::consumer_regs<NC, blocks_per_sm<NC>()>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float u[BT / 2], v[BT / 2];
  gemm::zero(u);
  gemm::zero(v);
  gemm::consume(sm.pipe, nk, [&](int s) {
    gemm::mma_stage<BT, 0, 1>(u, sm.x[s][wg], sm.w1[s][0]);
    gemm::mma_stage<BT, 0, 1>(v, sm.x[s][wg], sm.w3[s][0]);
  });
  flash::sm90::fence_regs(u);
  flash::sm90::fence_regs(v);
  const int row0 = m0 + gemm::acc_row0();
#pragma unroll
  for (int e = 0; e < BT / 2; e += 2) {
    const int r = row0 + flash::sm90::acc_row(e);
    const int c = n0 + flash::sm90::acc_col(e, lane);
    if (r < R && c < f) {
      const size_t o = (size_t)r * f + c;
      gemm::store_hi_lo(g_hi + o, g_lo + o, silu(u[e]) * v[e],
                        silu(u[e + 1]) * v[e + 1]);
    }
  }
}

// part[split, R, d] = (g_hi + g_lo)[:, ks] @ w2[ks, :] over this split's
// slice ks of f (k_per_split, a multiple of 64)
template <int NC>
__global__ void __launch_bounds__(gemm::threads<NC>(), blocks_per_sm<NC>())
ffn_down_tc(const __grid_constant__ CUtensorMap mhi,
            const __grid_constant__ CUtensorMap mlo,
            const __grid_constant__ CUtensorMap mw2, float* __restrict__ part,
            int R, int d, int f, int k_per_split) {
  constexpr int BT = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  DownSmem<NC>& sm = flash::sm90::smem_as<DownSmem<NC>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(R, BT),
                              gemm::tiles(d, BT));
  const int m0 = t.x * BT, n0 = t.y * BT, split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int nk = gemm::tiles(max(0, min(f, kbeg + k_per_split) - kbeg), 64);
  gemm::pipe_init<kStages, NC>(sm.pipe);

  if (threadIdx.x >= 128 * NC) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128 * NC)
      gemm::produce(sm.pipe, nk, 3 * NC * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
                      const int k0 = kbeg + kt * 64;
                      gemm::load_k<BT>(sm.hi[s][0], &mhi, bar, k0, m0);
                      gemm::load_k<BT>(sm.lo[s][0], &mlo, bar, k0, m0);
                      gemm::load_mn<BT>(sm.w2[s][0], &mw2, bar, k0, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::consumer_regs<NC, blocks_per_sm<NC>()>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[BT / 2];
  gemm::zero(acc);
  gemm::consume(sm.pipe, nk, [&](int s) {
    gemm::mma_stage<BT, 0, 1>(acc, sm.hi[s][wg], sm.w2[s][0]);
    gemm::mma_stage<BT, 0, 1>(acc, sm.lo[s][wg], sm.w2[s][0]);
  });
  flash::sm90::fence_regs(acc);
  const int row0 = m0 + gemm::acc_row0();
  float* dst = part + (size_t)split * R * d;
#pragma unroll
  for (int e = 0; e < BT / 2; e += 2) {
    const int r = row0 + flash::sm90::acc_row(e);
    const int c = n0 + flash::sm90::acc_col(e, lane);
    if (r < R && c < d)
      *reinterpret_cast<float2*>(dst + (size_t)r * d + c) =
          make_float2(acc[e], acc[e + 1]);
  }
}

template <int NC>
constexpr int gate_up_smem() {
  return flash::sm90::smem_bytes<GateUpSmem<NC>>();
}
template <int NC>
constexpr int down_smem() {
  return flash::sm90::smem_bytes<DownSmem<NC>>();
}

template <int NC>
int launch(const void* x, const void* w1, const void* w3, const void* w2,
           void* g, void* part, void* out, int R, int d, int f, int splits,
           cudaStream_t stream) {
  constexpr int BT = 64 * NC;
  bf16* g_hi = static_cast<bf16*>(g);
  bf16* g_lo = g_hi + (size_t)R * f;
  CUtensorMap mx, mw1, mw3, mw2, mhi, mlo;
  cudaError_t err = gemm::cached_map(&mx, x, R, d);
  if (err == cudaSuccess) err = gemm::cached_map(&mw1, w1, d, f);
  if (err == cudaSuccess) err = gemm::cached_map(&mw3, w3, d, f);
  if (err == cudaSuccess) err = gemm::cached_map(&mw2, w2, f, d);
  if (err == cudaSuccess) err = gemm::cached_map(&mhi, g_hi, R, f);
  if (err == cudaSuccess) err = gemm::cached_map(&mlo, g_lo, R, f);
  if (err == cudaSuccess)
    err = gemm::allow_smem(ffn_gate_up_tc<NC>, gate_up_smem<NC>());
  if (err == cudaSuccess)
    err = gemm::allow_smem(ffn_down_tc<NC>, down_smem<NC>());
  if (err != cudaSuccess) return err;

  dim3 g1(gemm::tiles(R, BT) * gemm::tiles(f, BT));
  ffn_gate_up_tc<NC><<<g1, gemm::threads<NC>(), gate_up_smem<NC>(), stream>>>(
      mx, mw1, mw3, g_hi, g_lo, R, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_per_split = gemm::tiles(gemm::tiles(f, 64), splits) * 64;
  dim3 g2(gemm::tiles(R, BT) * gemm::tiles(d, BT), 1, splits);
  ffn_down_tc<NC><<<g2, gemm::threads<NC>(), down_smem<NC>(), stream>>>(
      mhi, mlo, mw2, static_cast<float*>(part), R, d, f, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = R * d;
  ffn_reduce_kernel<bf16><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out), n, splits);
  return cudaGetLastError();
}

// 64 x 64 x 64 product units a call issues: both products of gate/up on
// every (row tile, column tile, k-tile), the down product twice (hi, lo)
template <int NC>
long long units(int R, int d, int f) {
  constexpr int BT = 64 * NC;
  const long long mt = (long long)gemm::tiles(R, BT) * NC;
  return 2 * mt * gemm::tiles(f, BT) * NC * gemm::tiles(d, 64) +
         2 * mt * gemm::tiles(d, BT) * NC * gemm::tiles(f, 64);
}

}  // namespace tc

}  // namespace

// x [R, d]; w1, w3 [d, f]; w2 [f, d]; g (R * f * 4 bytes: f32 g, or bf16
// g's hi and lo planes [2, R, f]) and part [splits, R, d] f32 are scratch
// the caller allocates; out [R, d] in x's type. Every pointer 16-byte
// aligned, everything contiguous.
extern "C" int fused_ffn_fwd(const void* x, const void* w1, const void* w3,
                             const void* w2, void* g, void* part, void* out,
                             int R, int d, int f, int splits, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || d < 8 || f < 8 || d % 8 || f % 8 || splits < 1)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return gemm::consumers(R) == 1
               ? tc::launch<1>(x, w1, w3, w2, g, part, out, R, d, f, splits,
                               s)
               : tc::launch<2>(x, w1, w3, w2, g, part, out, R, d, f, splits,
                               s);
  if (dtype == DTYPE_F32)
    return R <= 8 ? launch<float, 1>(x, w1, w3, w2, g, part, out, R, d, f,
                                     splits, s)
                  : launch<float, 4>(x, w1, w3, w2, g, part, out, R, d, f,
                                     splits, s);
  return cudaErrorInvalidValue;
}

// the product units (64 x 64 x 64 multiply-adds, 2 * 64^3 flops each) a
// bf16 call at (R, d, f) issues on the tensor cores, hi/lo counted: what
// the rates divide by
extern "C" long long fused_ffn_fwd_units(int R, int d, int f) {
  return gemm::consumers(R) == 1 ? tc::units<1>(R, d, f)
                               : tc::units<2>(R, d, f);
}

// dynamic shared memory a bf16 block takes (ptxas reports only static
// shared memory): kernel 0 gate/up, 1 down; nc consumer warpgroups
extern "C" int fused_ffn_fwd_smem(int kernel, int nc) {
  if (nc == 1) return kernel ? tc::down_smem<1>() : tc::gate_up_smem<1>();
  return kernel ? tc::down_smem<2>() : tc::gate_up_smem<2>();
}

// tensor maps the library has encoded so far (misses of its map cache):
// the decode tick reads how many of a launch's six it encodes
extern "C" long long fused_ffn_maps_encoded() {
  return gemm::maps_encoded();
}
