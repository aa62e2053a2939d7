// GEMM with a fused bias + activation epilogue for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `fused_gemm_epilogue`
// (`_epilogue_kernel` :529, pallas_call at :574) — kernel A8, reached
// through the fused op `gemm_epilogue` (ops/kernels/fused_ops.py).
//
// What it computes: out = act(x @ y + bias) for x [m, k], y [k, n] (both
// bf16 or both f32, row-major), bias [n] f32 or none; the product is
// accumulated in f32, bias and activation are applied to the f32
// accumulator, and the result is rounded once to x's type.
//
// Bound on the H100: operations at the varlen stack's rows (4096 x 4096 @
// 4096 x 12288 is 412 GFLOP, 0.417 ms at 989 TFLOP/s in bf16), bytes at
// decode rows (8 x 4096 @ 4096 x 22016 reads 180 MB of y, 0.054 ms at
// 3.35 TB/s).
//
// Design. The TPU kernel keeps a whole [bm, k] x [k, bn] pair in VMEM and
// does one dot per output block; here a block walks k in 64-deep stages
// and the epilogue runs on the accumulator in registers before the only
// store, so x @ y + bias never reaches device memory. Every output tile
// has one owner and sums its k-tiles in order: no atomics, and a rerun
// is bit-identical. Three kernels; the wrapper's `epilogue_path` picks
// one from dtype, shape, strides and addresses before the launch:
//   - "wgmma" (bf16 operands TMA can address: bases 16-byte aligned, rows
//     a multiple of 16 bytes): the wgmma core of `gemm_sm90.cuh`, as A3's
//     gate/up reads x w1. x is a K-major operand, y [k, n] an MN-major one
//     (the transpose bit); one producer warpgroup keeps a four-stage TMA
//     ring of 128-byte-swizzled 64 x 64 boxes full and gives its
//     registers to the consumers (`setmaxnreg`); output tiles follow the
//     grouped walk `gemm::raster`. TMA fills what lies past m, k or n
//     with zeros, so only the stores mask.
//       * rows > 64, bound by operations: 128 x kWideN tiles, two
//         consumer warpgroups of 64 rows (`gemm::consumers`), one block an
//         SM. A 128 x 256 tile loads 48 KB a stage for 2 M multiply-adds,
//         as A3's gate/up (x against w1 and w3) does at 681 TFLOP/s;
//         128 x 128 loads 32 KB for 1 M (the A/B is in PERF.md).
//       * decode rows (m <= 64), bound by y's bytes: one zero-filled
//         64-row tile carries the rows. A 64 x 128 tile gives 172 blocks
//         at n = 22016: 40 SMs would stream two blocks' bytes and 92 one,
//         the busiest 1.53 x the mean. The tile is cut to 64 columns
//         instead, 66 KB of stages a block, three blocks an SM: 344
//         blocks all resident at once, three or two an SM (1.15 x), up to
//         96 KB of y in flight an SM. n is cut rather than k so that the
//         epilogue stays fused and no second pass reduces split sums.
//   - "mma" (bf16 operands TMA cannot address: a row of x or y whose
//     length is not a multiple of 16 bytes, or a base that is not 16-byte
//     aligned): a 128 x 128 output tile per block of 256 threads (8 warps,
//     each 64 x 32), staged in shared memory in 32-deep steps and
//     multiplied with mma.sync m16n8k16; rows read element by element
//     where they cannot be read in 16-byte words (the `vec` flags).
//   - "fma" (f32): a 64 x 64 tile per block, each thread a 4 x 4 patch,
//     FMAs on the CUDA cores (full f32, no TF32).
// Bias and activation are applied to the f32 accumulator in every kernel
// (`apply_act`, `activation.cuh`).
#include "activation.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16, "mma": operands TMA cannot address; tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kAPitch = kBK + 8;     // bf16 elements a row of the x tile
constexpr int kBPitch = kBN + 8;     // bf16 elements a row of the y tile

// eight bf16 of row `r`, columns c .. c+7, of a row-major [rows, cols]
// matrix with leading dimension ld; zeros past the edges. vec: the row
// stride and base are 16-byte aligned, so a whole chunk is one load.
// Otherwise element by element into registers (the loop is unrolled, so
// no word of the chunk is addressed through local memory).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p,
                                       int rows, int cols, int ld, int r,
                                       int c, int vec) {
  if (r < rows && vec && c + 8 <= cols)
    return __ldg(reinterpret_cast<const uint4*>(p + (size_t)r * ld + c));
  uint32_t w[4] = {0, 0, 0, 0};
  if (r < rows) {
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(p + (size_t)r * ld);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < cols) w[i / 2] |= uint32_t(src[c + i]) << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_epilogue_bf16(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int m, int k, int n,
                   int act, int vec_x, int vec_y) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM * kAPitch];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ys[kBK * kBPitch];   // [k][n]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  // each thread moves two 8-element chunks of each tile per k-step
  uint4 xr[2], yr[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      xr[i] = load8(x, m, k, k, m0 + id / 4, k0 + (id % 4) * 8, vec_x);
      yr[i] = load8(y, k, n, n, k0 + id / 16, n0 + (id % 16) * 8, vec_y);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads;
      *reinterpret_cast<uint4*>(xs + (id / 4) * kAPitch + (id % 4) * 8) =
          xr[i];
      *reinterpret_cast<uint4*>(ys + (id / 16) * kBPitch + (id % 16) * 8) =
          yr[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < k; k0 += kBK) {
    const bool more = k0 + kBK < k;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments (row-major 16 x 16): a0 (g, c2), a1 (g+8, c2),
      // a2 (g, c2+8), a3 (g+8, c2+8); two bf16 a register, low = lower k
      unsigned a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = xs + (wm + i * 16 + g) * kAPitch + kk + c2;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kAPitch);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 8);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kAPitch + 8);
      }
      // B fragments (16 x 8, k-major pairs): b0 (k = c2, c2+1; n = g),
      // b1 (k = c2+8, c2+9; n = g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(
            ys + (kk + c2) * kBPitch + wn + j * 8 + g);
        const unsigned b0 = q[0] | (unsigned(q[kBPitch]) << 16);
        const unsigned b1 =
            q[8 * kBPitch] | (unsigned(q[9 * kBPitch]) << 16);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0, b1);
      }
    }
    __syncthreads();   // every warp is done with this step's tiles
    if (more) {
      stash();
      __syncthreads();
    }
  }

  // epilogue on the accumulator: d0, d1 at (g, c2 .. c2+1), d2, d3 at
  // (g+8, c2 .. c2+1) of each 16 x 8 tile
  const bool pair = (n % 2) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + c2;
    if (col >= n) continue;
    const bool two = col + 1 < n;
    const float b0 = bias ? bias[col] : 0.f;
    const float b1 = (bias && two) ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= m) continue;
        const float v0 = apply_act(acc[i][j][2 * h] + b0, act);
        const float v1 = apply_act(acc[i][j][2 * h + 1] + b1, act);
        __nv_bfloat16* o = out + (size_t)row * n + col;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32, "fma": CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kFT = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gemm_epilogue_f32(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int m, int k, int n, int act, int vec_x, int vec_y) {
  __shared__ __align__(16) float xt[kFK * kFT];   // [k][m]  x^T
  __shared__ __align__(16) float ys[kFK * kFT];   // [k][n]
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();
    {  // x: row tid / 4, k columns (tid % 4) * 4 .. + 3, stored transposed
      const int r = m0 + tid / 4, c = k0 + (tid % 4) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < m) {
        const float* src = x + (size_t)r * k + c;
        if (vec_x && c + 4 <= k) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
        } else {
          for (int e = 0; e < 4 && c + e < k; ++e) v[e] = src[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) xt[((tid % 4) * 4 + e) * kFT + tid / 4] = v[e];
    }
    {  // y: k row tid / 16, columns (tid % 16) * 4 .. + 3
      const int r = k0 + tid / 16, c = n0 + (tid % 16) * 4;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < k) {
        const float* src = y + (size_t)r * n + c;
        if (vec_y && c + 4 <= n) {
          w = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          float* e = reinterpret_cast<float*>(&w);
          for (int i = 0; i < 4 && c + i < n; ++i) e[i] = src[i];
        }
      }
      *reinterpret_cast<float4*>(ys + (tid / 16) * kFT + (tid % 16) * 4) = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(xt + kk * kFT + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(ys + kk * kFT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n)
        out[(size_t)row * n + col] =
            apply_act(acc[i][j] + (bias ? bias[col] : 0.f), act);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16, "wgmma": the wgmma core of gemm_sm90.cuh
// ---------------------------------------------------------------------------

namespace tc {

using gemm::bf16;
using gemm::kBox;
using gemm::kBoxBytes;
constexpr int kStages = 4;
constexpr int kWideN = 256;   // tile columns for rows > 64

// NC consumer warpgroups (64 NC rows), BN columns
template <int NC, int BN>
struct Smem {
  bf16 x[kStages][NC][kBox];        // [64 NC rows][64 deep], K-major
  bf16 y[kStages][BN / 64][kBox];   // [64 deep][BN columns], MN-major
  gemm::Pipe<kStages> pipe;
};

// decode rows: 64 x 64 tiles three to an SM; 128 x kWideN tiles one
template <int NC>
__host__ __device__ constexpr int blocks_per_sm() { return NC == 1 ? 3 : 1; }
template <int NC>
__host__ __device__ constexpr int tile_n() { return NC == 1 ? 64 : kWideN; }

template <int NC, int BN>
__global__ void __launch_bounds__(gemm::threads<NC>(), blocks_per_sm<NC>())
epilogue_tc(const __grid_constant__ CUtensorMap mx,
            const __grid_constant__ CUtensorMap my,
            const float* __restrict__ bias, bf16* __restrict__ out, int m,
            int k, int n, int act) {
  constexpr int BM = 64 * NC;
  constexpr int AN = BN > 128 ? 128 : BN;   // columns of one wgmma
  constexpr int NA = BN / AN;               // accumulators a thread keeps
  extern __shared__ unsigned char smem_raw[];
  Smem<NC, BN>& sm = flash::sm90::smem_as<Smem<NC, BN>>(smem_raw);
  const int2 t = gemm::raster(blockIdx.x, gemm::tiles(m, BM),
                              gemm::tiles(n, BN));
  const int m0 = t.x * BM, n0 = t.y * BN;
  const int nk = gemm::tiles(k, 64);
  gemm::pipe_init<kStages, NC>(sm.pipe);

  if (threadIdx.x >= 128 * NC) {
    flash::sm90::regs_dec<gemm::kProducerRegs>();
    if (threadIdx.x == 128 * NC)
      gemm::produce(sm.pipe, nk, (NC + BN / 64) * kBoxBytes,
                    [&](int s, int kt, uint64_t* bar) {
                      gemm::load_k<BM>(sm.x[s][0], &mx, bar, kt * 64, m0);
                      gemm::load_mn<BN>(sm.y[s][0], &my, bar, kt * 64, n0);
                    });
    return;
  }
  flash::sm90::regs_inc<gemm::held_regs<NC, blocks_per_sm<NC>()>()>();
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[NA][AN / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    gemm::zero(acc[a]);
    flash::sm90::fence_regs(acc[a]);   // the zeros before the first wgmma
  }
  gemm::consume(sm.pipe, nk, [&](int s) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      gemm::mma_stage<AN, 0, 1>(acc[a], sm.x[s][wg], sm.y[s][a * (AN / 64)]);
  });
#pragma unroll
  for (int a = 0; a < NA; ++a) flash::sm90::fence_regs(acc[a]);

  // the epilogue on the f32 accumulator, then the only store (n is a
  // multiple of 8, so a column pair never straddles it)
  const int row0 = m0 + gemm::acc_row0();
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < AN / 2; e += 2) {
      const int r = row0 + flash::sm90::acc_row(e);
      const int c = n0 + a * AN + flash::sm90::acc_col(e, lane);
      if (r < m && c < n) {
        float z0 = acc[a][e], z1 = acc[a][e + 1];
        if (bias) {
          z0 += bias[c];
          z1 += bias[c + 1];
        }
        gemm::store_bf16x2(out + (size_t)r * n + c, apply_act(z0, act),
                           apply_act(z1, act));
      }
    }
}

template <int NC>
constexpr int smem() {
  return flash::sm90::smem_bytes<Smem<NC, tile_n<NC>()>>();
}

template <int NC>
int launch(const void* x, const void* y, const float* bias, void* out, int m,
           int k, int n, int act, cudaStream_t stream) {
  constexpr int BM = 64 * NC, BN = tile_n<NC>();
  const long long blocks =
      (long long)gemm::tiles(m, BM) * gemm::tiles(n, BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mx, my;
  cudaError_t err = gemm::cached_map(&mx, x, m, k);
  if (err == cudaSuccess) err = gemm::cached_map(&my, y, k, n);
  if (err == cudaSuccess)
    err = gemm::allow_smem(epilogue_tc<NC, BN>, smem<NC>());
  if (err != cudaSuccess) return err;
  epilogue_tc<NC, BN><<<(unsigned)blocks, gemm::threads<NC>(), smem<NC>(),
                        stream>>>(mx, my, bias, static_cast<bf16*>(out), m,
                                  k, n, act);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// x [m, k], y [k, n] row-major, both of `dtype`; bias [n] f32 or null;
// out [m, n] of `dtype`, contiguous. tma: bf16 operands TMA can address
// (both bases 16-byte aligned, k and n multiples of 8: the wrapper's
// `epilogue_path` is "wgmma"), run on the wgmma core; otherwise vec_x /
// vec_y: rows of x / y start on 16-byte boundaries (the wrapper checks
// the strides and pointers).
extern "C" int fused_gemm_epilogue(const void* x, const void* y,
                                   const void* bias, void* out, int m, int k,
                                   int n, int act, int vec_x, int vec_y,
                                   int tma, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 1 || n < 1 || act < ACT_NONE || act > ACT_SIGMOID)
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  if (dtype == DTYPE_BF16 && tma) {
    if (k % 8 || n % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(y) % 16)
      return cudaErrorInvalidValue;
    return gemm::consumers(m) == 1
               ? tc::launch<1>(x, y, b, out, m, k, n, act, s)
               : tc::launch<2>(x, y, b, out, m, k, n, act, s);
  }
  if (dtype == DTYPE_BF16) {
    dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_epilogue_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y), b,
        static_cast<__nv_bfloat16*>(out), m, k, n, act, vec_x, vec_y);
    return cudaGetLastError();
  }
  if (dtype == DTYPE_F32) {
    dim3 grid((n + kFT - 1) / kFT, (m + kFT - 1) / kFT);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_epilogue_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), b,
        static_cast<float*>(out), m, k, n, act, vec_x, vec_y);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory a "wgmma" block takes with nc consumer warpgroups
// (1: the 64 x 64 decode tile, 2: 128 x kWideN); ptxas reports only static
// shared memory
extern "C" int fused_gemm_epilogue_smem(int nc) {
  return nc == 1 ? tc::smem<1>() : tc::smem<2>();
}

// the columns of a "wgmma" tile with nc consumer warpgroups
extern "C" int fused_gemm_epilogue_tile_n(int nc) {
  return nc == 1 ? tc::tile_n<1>() : tc::tile_n<2>();
}
