// A wgmma GEMM core for Hopper (sm_90a) on the machinery of
// `flash_sm90.cuh`: the fused SwiGLU FFN forward (A3, `fused_ffn.cu`) and
// backward (A4, `fused_ffn_bwd.cu`), the int8-weight FFN (A6,
// `fused_ffn_w8.cu`) and the GEMM epilogue (A8, `fused_gemm_epilogue.cu`)
// run every bf16 product through it.
//
// Block. NC consumer warpgroups (1 or 2), each owning 64 rows of the
// block's output tile, and one producer warpgroup whose first thread keeps
// a ring of `S` stages full by TMA; `setmaxnreg` moves the producer's
// registers to the consumers. A stage is one 64-deep step of the
// reduction: every operand tile the step's products read, each cut into
// [64][64] bf16 boxes of the 128-byte swizzle (8 KB, 1024-byte aligned),
// which is what every tensor map (`mat_map`) loads. A K-major tile (the
// reduction runs along the matrix's rows: x in x w1, du in du w1^T) stacks
// its boxes down the rows, an MN-major tile (the reduction runs down the
// matrix: w1 in x w1, x in x^T du) lays them side by side 8 KB apart, as
// `desc_k` and `desc_mn` read them. TMA fills what lies past the matrix
// with zeros, so rows past R and a reduction depth that is not a multiple
// of 64 need no masks until the stores.
//
// Walk. The producer walks k-tiles 0 .. nk-1 and the caller's `load`
// says which tiles (and which matrices: a walk may run over a list of
// segments, as dx = du w1^T + dv w3^T does) fill a stage. The consumers
// wait for a stage, issue its products, keep one committed group in
// flight and release the stage before it: the next stage's copy and
// products overlap this one's. Every output tile has one owner and sums
// its k-tiles in order, so a result repeats bit for bit.
//
// int8 operands (A6's weights W) come in by TMA as [64 deep][64] byte
// tiles (`load_i8`), and each product is swapped, out^T = W^T x^T: the
// consumers widen W^T into the register A operand (`i8_frag`, exact) and
// x's rows are the N of a wgmma whose B is read K-major (`consume_rs`).
#pragma once

#include <atomic>

#include "flash_sm90.cuh"

namespace gemm {

using bf16 = __nv_bfloat16;
using flash::sm90::smem_u32;

constexpr int kBox = 64 * 64;          // elements of one swizzled box
constexpr int kBoxBytes = kBox * 2;    // 8 KB
constexpr int kProducerRegs = 40;

// threads of a block with NC consumer warpgroups, and the registers each
// consumer thread can take when `blocks` blocks share an SM
template <int NC>
__host__ __device__ constexpr int threads() { return 128 * (NC + 1); }
template <int NC, int BLOCKS>
__host__ __device__ constexpr int consumer_regs() {
  return ((65536 / BLOCKS - 128 * kProducerRegs) / (128 * NC)) / 8 * 8 > 240
             ? 240
             : ((65536 / BLOCKS - 128 * kProducerRegs) / (128 * NC)) / 8 * 8;
}

// The registers a thread of such a block launches with (ptxas takes the
// launch bounds' share, in steps of 8), and what a consumer thread can
// hold once the producer warpgroup has given back all but kProducerRegs:
// the block keeps the registers it launched with, so asking for more
// would make setmaxnreg.inc wait forever. consumer_regs<NC, BLOCKS>() is
// the same number where the share divides evenly (one or two blocks).
template <int NC, int BLOCKS>
__host__ __device__ constexpr int launch_regs() {
  const int share = 65536 / (BLOCKS * threads<NC>()) / 8 * 8;
  return share > 248 ? 248 : share;
}
template <int NC, int BLOCKS>
__host__ __device__ constexpr int held_regs() {
  const int launch = launch_regs<NC, BLOCKS>();
  const int held = launch + (launch - kProducerRegs) / NC / 8 * 8;
  return held > 240 ? 240 : held;
}

// the ring's barriers: `full` (one arrival plus the stage's TMA bytes)
// and `empty` (every consumer thread)
template <int S>
struct Pipe {
  uint64_t full[S], empty[S];
};

template <int S, int NC>
__device__ __forceinline__ void pipe_init(Pipe<S>& p) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      flash::sm90::mbar_init(&p.full[s], 1);
      flash::sm90::mbar_init(&p.empty[s], 128 * NC);
    }
    flash::sm90::mbar_init_fence();
  }
  __syncthreads();
}

// A K-major tile: ROWS rows from r0, 64 columns (the depth) from k0
template <int ROWS>
__device__ __forceinline__ void load_k(bf16* dst, const CUtensorMap* map,
                                       uint64_t* bar, int k0, int r0) {
#pragma unroll
  for (int h = 0; h < ROWS / 64; ++h)
    flash::sm90::tma_load_2d(dst + h * kBox, map, bar, k0, r0 + 64 * h);
}

// An MN-major tile: 64 rows (the depth) from k0, COLS columns from c0
template <int COLS>
__device__ __forceinline__ void load_mn(bf16* dst, const CUtensorMap* map,
                                        uint64_t* bar, int k0, int c0) {
#pragma unroll
  for (int h = 0; h < COLS / 64; ++h)
    flash::sm90::tma_load_2d(dst + h * kBox, map, bar, c0 + 64 * h, k0);
}

// A K-major tile of N rows (a `mat_map_rows` map): N rows from r0, 64
// columns (the depth) from k0
__device__ __forceinline__ void load_rows(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int k0, int r0) {
  flash::sm90::tma_load_2d(dst, map, bar, k0, r0);
}

// An int8 tile (a `mat_map_i8` map): 64 rows (the depth) from k0, 64 bytes
// (columns) from c0
__device__ __forceinline__ void load_i8(int8_t* dst, const CUtensorMap* map,
                                        uint64_t* bar, int k0, int c0) {
  flash::sm90::tma_load_2d(dst, map, bar, c0, k0);
}

// The producer thread: k-tiles 0 .. nk-1, each into the next free stage;
// `load(s, kt, bar)` issues the TMA loads of k-tile kt into stage s, which
// bring `bytes` in all
template <int S, class Load>
__device__ __forceinline__ void produce(Pipe<S>& p, int nk, uint32_t bytes,
                                        Load&& load) {
  flash::sm90::Ring ring{p.empty};
  for (int kt = 0; kt < nk; ++kt) {
    const int s = ring.next(S);
    flash::sm90::mbar_arrive_tx(&p.full[s], bytes);
    load(s, kt, &p.full[s]);
  }
}

// The consumer warpgroups: `mma(s)` issues stage s's products; one group
// stays in flight while the next stage is awaited. Returns with every
// product complete.
template <int S, class Mma>
__device__ __forceinline__ void consume(Pipe<S>& p, int nk, Mma&& mma) {
  using namespace flash::sm90;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(&p.full[s], (kt / S) & 1);
    wg_fence();
    mma(s);
    wg_commit();
    wg_wait<1>();                   // k-tile kt - 1's products are done
    if (kt > 0) mbar_arrive(&p.empty[(kt - 1) % S]);
  }
  wg_wait<0>();
}

// consume() for products whose A operand the consumers build in
// registers (A6's widened weights): `mma(s)` builds stage s's fragments
// and issues its products, a wgmma.fence before each product that reads
// fragments just written; `done()` runs once they are complete (a fence
// on the fragments, so that no register of a fragment is rewritten under
// a product in flight). A stage's products complete before the next
// stage is awaited; within a stage, building the next fragment overlaps
// the products already issued, and the other blocks on the SM fill the
// gaps.
template <int S, class Mma, class Done>
__device__ __forceinline__ void consume_rs(Pipe<S>& p, int nk, Mma&& mma,
                                           Done&& done) {
  using namespace flash::sm90;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(&p.full[s], (kt / S) & 1);
    mma(s);
    wg_commit();
    wg_wait<0>();
    done();
    mbar_arrive(&p.empty[s]);
  }
}

// four int8 (one word) as four bf16 (two words), exactly: |q| <= 128 has
// at most 8 significant bits, which bf16 keeps. Each byte, sign-flipped
// to q + 128, goes into the mantissa of 2^23; taking 2^23 + 128 off in
// f32 leaves q, whose high half is its bf16. No int-to-float conversion
// (a quarter-rate instruction) is issued.
__device__ __forceinline__ float i8_lane_f32(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}
__device__ __forceinline__ uint2 i8x4_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = i8_lane_f32(u, 0x7540), f1 = i8_lane_f32(u, 0x7541);
  const float f2 = i8_lane_f32(u, 0x7542), f3 = i8_lane_f32(u, 0x7543);
  return make_uint2(
      __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
      __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// The m64k16 A fragment of W^T for depth step kk, widened exactly, from a
// [64 deep][64 columns] int8 tile W as `load_i8` lands it (the 64-byte
// swizzle: 16-byte chunk j of row k at chunk j ^ ((k / 2) % 4)). Row m of
// W^T, m = 16 w + g + 8 h for warp w, lane group g = lane / 4, is column
// 16 w + 2 g + h of W (`i8_col`), so a thread's two rows (h = 0, 1)
// are one 2-byte pair of a row of W: four 16-bit loads (depths 2c, 2c + 1,
// 2c + 8, 2c + 9 of the step, c = lane % 4, four different chunks, so no
// bank conflict) and two byte interleaves make its four registers.
__device__ __forceinline__ void i8_frag(uint32_t (&a)[4], const int8_t* tile,
                                        int kk) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int col = 16 * w + 2 * (lane >> 2), c = lane & 3;
  uint32_t l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 16 * kk + 2 * c + (i & 1) + 8 * (i >> 1);
    const int off = 64 * k + ((((col >> 4) ^ (k >> 1)) & 3) << 4) +
                    (col & 15);
    l[i] = *reinterpret_cast<const uint16_t*>(tile + off);
  }
  const uint2 p = i8x4_bf16x4(__byte_perm(l[0], l[1], 0x5140));
  const uint2 q = i8x4_bf16x4(__byte_perm(l[2], l[3], 0x5140));
  a[0] = p.x;
  a[1] = p.y;
  a[2] = q.x;
  a[3] = q.y;
}

// the column of W (the f or d index within a 64-wide tile) of a swapped
// accumulator's entry e: W^T's row of the entry (`i8_frag`'s mapping)
__device__ __forceinline__ int i8_col(int e) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  return 16 * w + 2 * (lane >> 2) + ((e >> 1) & 1);
}

// keep fragments in their registers up to this point
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc (64 x N, f32) += A B over one 64-deep stage: `a` the warpgroup's
// 64-row box of A (TA = 0: K-major, 1: MN-major), `b` the stage's N-column
// tile of B (TB likewise)
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_stage(float (&acc)[N / 2], const bf16* a,
                                          const bf16* b) {
  using namespace flash::sm90;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = TA ? desc_mn(a, kk) : desc_k(a, kk);
    const uint64_t db = TB ? desc_mn(b, kk) : desc_k(b, kk);
    if constexpr (N == 128)
      wgmma_ss_t_n128<TA, TB>(acc, da, db);
    else
      wgmma_ss_t_n64<TA, TB>(acc, da, db);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// The first row (within the block tile) of the thread's accumulator
// entries; entry e of a 64 x N accumulator lies at row + acc_row(e),
// column acc_col(e, lane) (`flash_sm90.cuh`), e and e + 1 side by side
__device__ __forceinline__ int acc_row0() {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t & 127) >> 5) * 16 + ((t & 31) >> 2);
}

// The output tile (row tile, column tile) of block b in a tm x tn grid,
// walked in groups of kGroup row tiles with the row tiles fastest inside
// a group: the blocks in flight at once (132, one an SM) share about 8 row
// strips and 16 column strips of the operands in L2, where a plain
// row-fastest walk shares the column strips only and a column-fastest one
// the row strips only
constexpr int kGroup = 8;
__device__ __forceinline__ int2 raster(int b, int tm, int tn) {
  const int per = kGroup * tn, first = (b / per) * kGroup;
  const int gm = min(kGroup, tm - first), r = b % per;
  return make_int2(first + r % gm, r / gm);
}

// two adjacent values, as bf16
__device__ __forceinline__ void store_bf16x2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// two adjacent f32 values t as the planes hi = bf16(t), lo = bf16(t - hi):
// hi + lo carries t to ~2^-16 relative, and the same bytes as t
__device__ __forceinline__ void store_hi_lo(bf16* hi, bf16* lo, float a,
                                            float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
}

// -- host ---------------------------------------------------------------------

// tensor maps encoded so far by this library's `cached_map` (its misses)
inline std::atomic<long long>& maps_encoded() {
  static std::atomic<long long> n{0};
  return n;
}

// what `cached_map` encodes: kind 0 a bf16 `mat_map` (64 x 64 boxes),
// kind r > 0 a bf16 `mat_map_rows` of r-row boxes, kI8Map an int8
// `mat_map_i8`
constexpr int kI8Map = -1;

// a map of `kind` through a per-thread direct-mapped cache keyed by
// (address, rows, cols, kind): a map is a function of those alone, so a
// cached one is always the right one. The weights' maps recur on every
// call (32 layers of three on a decode tick) and the caching allocator
// hands the activations the same addresses tick after tick.
inline cudaError_t cached_map(CUtensorMap* out, const void* base, int rows,
                              int cols, int kind = 0) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    int rows, cols, kind;
  };
  constexpr int kSlots = 256;
  thread_local Entry cache[kSlots] = {};
  const uintptr_t key = reinterpret_cast<uintptr_t>(base);
  Entry& e = cache[((key >> 9) ^ (key >> 21) ^ (uintptr_t)rows * 7919u ^
                    (uintptr_t)cols * 104729u ^ (uintptr_t)(kind + 1)) %
                   kSlots];
  if (e.base != base || e.rows != rows || e.cols != cols || e.kind != kind) {
    e.base = nullptr;
    const cudaError_t err =
        kind == kI8Map ? flash::sm90::mat_map_i8(&e.map, base, rows, cols)
        : kind > 0 ? flash::sm90::mat_map_rows(&e.map, base, rows, cols, kind)
                   : flash::sm90::mat_map(&e.map, base, rows, cols);
    if (err != cudaSuccess) return err;
    ++maps_encoded();
    e.base = base;
    e.rows = rows;
    e.cols = cols;
    e.kind = kind;
  }
  *out = e.map;
  return cudaSuccess;
}

// raise a kernel's dynamic shared memory limit to what its tile takes
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// consumer warpgroups for R rows: one 64-row tile for decode rows, where
// one zero-filled tile carries them all, two (128 rows) above
inline int consumers(int R) { return R > 64 ? 2 : 1; }

__host__ __device__ __forceinline__ int tiles(int n, int tile) {
  return (n + tile - 1) / tile;
}

}  // namespace gemm
