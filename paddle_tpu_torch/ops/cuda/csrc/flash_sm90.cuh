// Hopper (sm_90a) machinery shared by the bf16 flash attention forward
// (A1) and backward (A2) kernels and by the wgmma GEMM core of the fused
// FFN (A3, A4, A6) and the GEMM epilogue (A8; `gemm_sm90.cuh`): TMA
// tensor maps (per head, `head_map`, or of a row-major matrix: `mat_map`
// and `mat_map_rows` in bf16, `mat_map_i8` in int8) and loads, mbarriers,
// wgmma
// descriptors and instructions (A from registers or from shared memory,
// either operand K-major or MN-major), `setmaxnreg`, and the register
// fragments that carry a score tile from one product's accumulator into
// the next product's A operand.
//
// Tiles. Every operand tile is 64 rows of a row-major [rows, hd] head
// matrix in bf16, cut into 64-column halves: one half is 64 rows of 128
// bytes with the 128-byte swizzle (16-byte chunk c of row r stored at
// chunk c ^ (r % 8)), 8 KB, 1024-byte aligned, written by one TMA box
// load. Columns past hd and rows past the sequence come in as zeros
// (TMA fills what lies outside the tensor), so a head_dim that is a
// multiple of 8 but not of 64 is zero-padded up to the product's depth.
// One tile serves two ways: as a K-major operand (the reduction runs
// along hd: q k^T, do v^T) and, through the transpose bit, as an
// MN-major B operand (the reduction runs along the rows: p v, ds k).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; entry points come through
                    // cudaGetDriverEntryPoint, so nothing links libcuda
#include "flash_tiles.cuh"

namespace flash {
namespace sm90 {

constexpr int kRows = 64;               // rows of every tile (wgmma M)
constexpr int kHalfBytes = 64 * 128;    // one swizzled [64][64] bf16 half
constexpr int kStages = 2;              // depth of the K/V (or Q/dO) ring
constexpr int kConsumers = 128;         // one consumer warpgroup
constexpr int kBlockThreads = kConsumers + 32;   // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them; follow with __syncthreads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The producer's side of a ring of kStages stages, each with a `full`
// barrier (32 producer arrivals plus the TMA bytes) and an `empty` one
// (kConsumers arrivals): next() waits until the consumers have released
// the stage it hands out. A stage's first use does not wait.
struct Ring {
  uint64_t* empty;
  int it = 0;
  __device__ __forceinline__ int next(int stages) {
    const int s = it % stages;
    mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
    ++it;
    return s;
  }
};

// The producer's skip test for kBatch consecutive tiles t0 .. t0+7 of an
// id row of n positions (64 to a tile; tiles from `count` on are not
// walked): bit t of the result is set when tile t0 + t's [min, max]
// overlaps `range`, and ids[t] holds the lane's two ids of that tile
// (positions + lane and + lane + 32; -1 past n). Bit t of `mixed` is set
// unless the tile and `range` hold one and the same id, so that the
// consumer can drop the segment compare from the tiles inside one
// sequence. A lane's 16 loads are independent, so a batch costs about
// one load latency where a tile at a time would cost eight.
constexpr int kBatch = 8;

__device__ __forceinline__ unsigned walk_batch(const int* __restrict__ ids,
                                               int n, int t0, int count,
                                               int2 range,
                                               int2 (&mine)[kBatch],
                                               unsigned& mixed) {
  const int lane = threadIdx.x & 31;
  int lo[kBatch], hi[kBatch];
#pragma unroll
  for (int t = 0; t < kBatch; ++t) {
    const int p = (t0 + t) * kRows + lane;
    const bool in = t0 + t < count;
    const bool ina = in && p < n, inb = in && p + 32 < n;
    mine[t] = make_int2(ina ? __ldg(ids + p) : -1,
                        inb ? __ldg(ids + p + 32) : -1);
    lo[t] = ina ? mine[t].x : INT_MAX;
    hi[t] = ina ? mine[t].x : INT_MIN;
    if (inb) lo[t] = min(lo[t], mine[t].y), hi[t] = max(hi[t], mine[t].y);
  }
  unsigned walk = 0;
  mixed = 0;
#pragma unroll
  for (int t = 0; t < kBatch; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[t] = min(lo[t], __shfl_xor_sync(0xffffffffu, lo[t], off));
      hi[t] = max(hi[t], __shfl_xor_sync(0xffffffffu, hi[t], off));
    }
    if (t0 + t < count && overlaps(range, make_int2(lo[t], hi[t])))
      walk |= 1u << t;
    if (!(lo[t] == hi[t] && range.x == range.y && lo[t] == range.x))
      mixed |= 1u << t;
  }
  return walk;
}

// the batch's tiles below `count`, all walked (no segment ids)
__device__ __forceinline__ unsigned walk_all(int t0, int count) {
  return count - t0 >= kBatch ? (1u << kBatch) - 1
                              : (1u << (count - t0)) - 1;
}

// -- TMA ---------------------------------------------------------------------
// one [64 rows][64 columns] box of a [heads, rows, hd] tensor: columns
// c0 .. c0+63, rows r0 .. r0+63 of head `head`, into a swizzled half;
// completion is counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0), "r"(head)
      : "memory");
}

// a tile of HDP / 64 halves (HDP = head_dim padded to 64 or 128)
template <int HDP>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int r0, int head) {
#pragma unroll
  for (int h = 0; h < HDP / 64; ++h)
    tma_load(dst + h * (kHalfBytes / 2), map, bar, h * 64, r0, head);
}

// one [64 rows][64 columns] box of a row-major [rows, cols] matrix (a
// `mat_map`): columns c0 .. c0+63 of rows r0 .. r0+63, into a swizzled
// half; completion is counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------
// shared-memory matrix descriptors for the 128-byte swizzle: start address,
// leading byte offset (bits 16-29), stride byte offset (bits 32-45), all
// in 16-byte units, layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand, depth step kk (16 columns of hd): the half kk / 4, 32
// bytes into its rows per step; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile,
                                           int kk) {
  return desc(reinterpret_cast<const char*>(tile) + (kk >> 2) * kHalfBytes +
                  (kk & 3) * 32,
              16, 1024);
}

// MN-major (transposed) B operand, depth step kk (rows 16 kk .. 16 kk +
// 15): 2048 bytes per step; the 64-column halves 8 KB apart (LBO), 8-row
// groups of the depth 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile,
                                            int kk) {
  return desc(reinterpret_cast<const char*>(tile) + kk * 2048, kHalfBytes,
              1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Warp specialisation: the producer warpgroup gives registers back, the
// consumers take them (all four warps of a warpgroup execute it; the
// branches must not rejoin)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// keep the compiler from moving register accesses across an asynchronous
// product that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 64 f32 tile: A [64, 16] and B [64, 16] both
// K-major in shared memory (descriptors), scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B for a 64 x 64 f32 tile: A [64, 16] bf16 from registers (the
// m64k16 fragment), B [16, 64] MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for a 64 x 128 f32 tile: A [64, 16] bf16 from registers (the
// m64k16 fragment), B [16, 128] MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over 64 rows of depth: A from fragments a[4][4] (four depth
// steps of 16), B MN-major in `tile`, N = HDP
template <int HDP>
__device__ __forceinline__ void wgmma_rs(float (&d)[HDP / 2],
                                         const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (HDP == 128)
      wgmma_rs_n128(d, a[kk], desc_mn(tile, kk));
    else
      wgmma_rs_n64(d, a[kk], desc_mn(tile, kk));
  }
}

// d = A B^T over depth HDP, A and B K-major tiles, 64 x 64 f32
template <int HDP>
__device__ __forceinline__ void wgmma_ss(float (&d)[32],
                                         const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss_n64(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// d += A B for a 64 x 64 f32 tile, A [64, 16] and B [16, 64] both in
// shared memory; TA / TB = 1 reads that operand MN-major (the transpose
// bit: `desc_mn`), 0 K-major (`desc_k`)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t_n64(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the same for a 64 x 128 f32 tile, B [16, 128]
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A B for a 64 x 8 f32 tile: A [64, 16] bf16 from registers (the
// m64k16 fragment), B [8, 16] K-major in shared memory (`desc_k`)
__device__ __forceinline__ void wgmma_rs_kb_n8(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same for a 64 x 64 f32 tile, B [64, 16] K-major
__device__ __forceinline__ void wgmma_rs_kb_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- accumulator and fragment layouts -----------------------------------------
// Thread t of the warpgroup (warp w = t / 32, lane) holds accumulator
// entry e of a 64 x N tile at row w * 16 + lane / 4 + 8 * ((e >> 1) & 1)
// and column 8 * (e >> 2) + 2 * (lane % 4) + (e & 1). Its A fragment for
// depth step kk holds the same rows at columns 16 kk + ..., so register i
// of the fragment is entries 8 kk + 2 i and 8 kk + 2 i + 1 of a 64 x 64
// accumulator, packed as two bf16: no shuffle moves a score tile into the
// next product.
__device__ __forceinline__ int acc_row(int e) { return ((e >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(int e, int lane) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (a 64 x 64 accumulator) as fragments hi = bf16(x) and lo = bf16(x - hi):
// P, P^T, dS and dS^T enter their products as such a pair, two wgmmas
// into one f32 sum, so they carry x to ~2^-16 relative, as the f32
// reference multiplies p in f32
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * kk + 2 * i], b = x[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][i] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// the accumulator's entries of one row and column pair, stored in bf16 for
// rows < n and columns < hd (hd is a multiple of 8, so a pair never
// straddles it)
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          int n, int hd, int row0,
                                          const float (&acc)[N / 2],
                                          float inv0, float inv1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const int r = row0 + acc_row(e), c = acc_col(e, lane);
    const float inv = acc_row(e) ? inv1 : inv0;
    if (r < n && c < hd)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * hd + c) =
          __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
  }
}

// -- host: tensor maps --------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous bf16 [heads, rows, hd] tensor as 64 x 64 boxes with the
// 128-byte swizzle; what lies outside it loads as zeros
inline cudaError_t head_map(CUtensorMap* map, const void* base, int heads,
                            int rows, int hd) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(base), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major bf16 [rows, cols] matrix as 64 x 64 boxes with the 128-byte
// swizzle (the base 16-byte aligned, cols a multiple of 8); what lies
// outside it loads as zeros
inline cudaError_t mat_map(CUtensorMap* map, const void* base, int rows,
                           int cols) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, kRows};
  const cuuint32_t step[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(base), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major [rows, cols] matrix of `bytes`-byte elements (the base
// 16-byte aligned, a row a multiple of 16 bytes) as boxes of box_rows x
// box_cols with `swizzle`; what lies outside it loads as zeros
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                             int bytes, const void* base, int rows, int cols,
                             int box_rows, int box_cols,
                             CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                  step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major bf16 [rows, cols] matrix as boxes of `box_rows` rows (8 to
// 64) by 64 columns with the 128-byte swizzle: the operand tiles of a
// product whose N is box_rows (A6's token rows)
inline cudaError_t mat_map_rows(CUtensorMap* map, const void* base, int rows,
                                int cols, int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows,
                   cols, box_rows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a row-major int8 [rows, cols] matrix (cols a multiple of 16) as boxes
// of 64 rows by 64 bytes with the 64-byte swizzle: 16-byte chunk j of a
// box's row r lands at chunk j ^ ((r / 2) % 4), 4 KB a box (512-byte
// aligned)
inline cudaError_t mat_map_i8(CUtensorMap* map, const void* base, int rows,
                              int cols) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols,
                   kRows, 64, CU_TENSOR_MAP_SWIZZLE_64B);
}

// dynamic shared memory rounded up to the 1024-byte alignment the swizzle
// needs
template <typename Smem>
__device__ __forceinline__ Smem& smem_as(unsigned char* raw) {
  return *reinterpret_cast<Smem*>(raw + ((1024 - (smem_u32(raw) & 1023)) &
                                         1023));
}

template <typename Smem>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem)) + 1024;
}

}  // namespace sm90
}  // namespace flash
