// Tile staging shared by the flash attention forward (A1) and backward (A2)
// kernels: 64-row tiles of a row-major [n, hd] head matrix, moved into
// shared memory as f32 with 16-byte loads, either transposed (d-major, so a
// thread reads four consecutive rows of one column as a float4) or
// row-major (so it reads four consecutive columns of one row).
#pragma once

#include "common.cuh"

namespace flash {

constexpr int kThreads = 256;    // 16 x 16 threads, each owns a 4-row strip
constexpr int kTile = 64;        // rows of a q tile and of a k/v tile
constexpr int kMaxHD = 128;      // head_dim the shared tiles are sized for
constexpr float kNegInf = -1e30f;

// rows [row0, row0 + kTile) of src [n, hd] into dst[d * kTile + r]; rows
// past n are zeros. Consecutive threads take consecutive rows, so the
// shared stores of a warp hit 32 different banks.
template <typename T>
__device__ __forceinline__ void load_tile_t(const T* __restrict__ src, int n,
                                            int hd, int row0,
                                            float* __restrict__ dst) {
  const int vecs = hd / 8;
  for (int i = threadIdx.x; i < kTile * vecs; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 8;
    Vec8<T> v;
    if (row0 + r < n)
      v.load(src + (size_t)(row0 + r) * hd + c);
    else
      v.zero();
    float f[8];
    v.to_floats(f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(c + e) * kTile + r] = f[e];
  }
}

// the same rows into dst[r * kMaxHD + d]; consecutive threads take
// consecutive 8-column chunks of a row, so global reads coalesce.
template <typename T>
__device__ __forceinline__ void load_tile_rm(const T* __restrict__ src, int n,
                                             int hd, int row0,
                                             float* __restrict__ dst) {
  const int vecs = hd / 8;
  for (int i = threadIdx.x; i < kTile * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    Vec8<T> v;
    if (row0 + r < n)
      v.load(src + (size_t)(row0 + r) * hd + c);
    else
      v.zero();
    float f[8];
    v.to_floats(f);
    float4* d4 = reinterpret_cast<float4*>(dst + r * kMaxHD + c);
    d4[0] = make_float4(f[0], f[1], f[2], f[3]);
    d4[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][e] += a[i] * b[e] for the four rows of a and eight columns b0|b1
__device__ __forceinline__ void fma_4x8(float (&acc)[4][8], float4 a,
                                        float4 b0, float4 b1) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void fma_4x4(float (&acc)[4][4], float4 a,
                                        float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// a thread's eight output columns of head_dim: tx*4 .. tx*4+3 and
// 64 + tx*4 .. 64 + tx*4+3, so a quarter-warp's float4 reads of one
// shared row are contiguous
__device__ __forceinline__ int out_col(int tx, int e) {
  return (e < 4 ? 0 : 64) + tx * 4 + (e & 3);
}

// store a thread's 4 x 8 strip (rows row0 .. row0+3 of a [n, hd] matrix)
// in T, skipping rows past n and columns past hd; scale multiplies, or
// each row is divided by div[i] when div is non-null
template <typename T>
__device__ __forceinline__ void store_strip(T* __restrict__ dst, int n,
                                            int hd, int row0, int tx,
                                            const float (&acc)[4][8],
                                            const float* div) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + i;
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = out_col(tx, e);
      if (c < hd)
        dst[(size_t)r * hd + c] =
            from_float<T>(div ? acc[i][e] / div[i] : acc[i][e]);
    }
  }
}

// max and sum over the 16 threads that share a row strip (one half-warp)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace flash
