// Paged-KV attention for Hopper (sm_90a), CUDA C++: kernel A5's two
// modes, templated on the page element type.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_attention`
// (`_kernel` :88, pallas_call at :249) — kernel A5. `paged_attention.cu`
// instantiates it for fp pages (the cache in q's type),
// `paged_attention_int8.cu` for int8 pages with per-page dequant scales
// (the reference's `has_quant` mode).
//
// What it computes: for every sequence b and kv head, the packed query
// rows r = t*G + g of q [B, KV, rows, hd] attend over that sequence's
// pages of the pool [num_blocks, KV, bs, hd], found through its row of
// the block table [B, max_blocks]. Row r sees positions kv_pos <= past[b]
// + t; rows with t >= this[b] are dead and come back 0. Online softmax
// with f32 math, output in q's type. With int8 pages, each page's k and v
// dequant scalars kdq, vdq [num_blocks, KV] are constant over hd, so they
// factor out of the products as in the reference: sm_scale * kdq[page]
// multiplies the scores, and vdq[page] the probabilities after the
// running sum l is updated. No fp copy of an int8 page exists.
//
// Bound on the H100: bytes. A decode launch (max_q = 1) reads each live
// cached token's K and V once — 2 * KV * hd * 2 B = 16 KiB per token per
// layer at LLaMA-7B in bf16, 8 KiB with int8 pages — and does 4 * hd
// FLOPs per (row, token), far below the ~295 FLOP/B the card needs to be
// compute bound. A mixed launch (64 rows a sequence) does ~64 FLOP/B.
//
// bf16 q (`paged::` below), the serving path's kernel. Its rule: a row's
// bits depend only on its own position and its sequence's pages — not on
// the chunk it sits in, the rows beside it, max_q or the other sequences
// of the launch — so a token gets the same logits in a decode row, a
// speculative verify chunk, any prefill chunking and a recompute.
// - Every unit of work is one group of at most kRows = 8 live rows of one
//   sequence and kv head, walked by the four warps splitting each stage's
//   keys (16 each), each warp with its own softmax state, folded in warp
//   order at the end. The rows are the N of the products, so a decode row
//   pads to an 8-row group.
// - Positions are cut at fixed spans, `span` = a whole number of pages of
//   at least 256 positions (the wrapper's `paged_splits`, G <= 8; G > 8
//   has one span, the whole table). A row's value is its spans' folded
//   states (m, l, acc) merged in ascending order: the first span's state,
//   then each later one by x a + y f with a = 2^(M - max), f = 2^(m -
//   max), then acc / l. A row group either walks its spans in one block
//   and merges them in shared memory, or — a chunk of at most part_rows
//   live rows (decode rows, verify chunks) whose last row reaches a
//   second span — gives each span its own block, writes f32 partials
//   (written once, read once; `paged_splits` keeps them within a tenth of
//   the K/V bytes they split), and a second kernel of the library,
//   `paged_attention_merge`, merges them with the same steps. Either way
//   one owner per output, no atomics, the same arithmetic. The kernel
//   only asks past + rows >= span; the policy lives in `paged_splits`.
// - Units, ordered level by level (every sequence's first span or row
//   group before any second one, kv heads fastest), are taken by a grid
//   of at most four waves of resident blocks, each looping over every
//   grid-th unit up to the launch's largest level (reduced on the card
//   from the lengths); units past a sequence's own count are skipped. So
//   the grid does not grow with max_len, and no device value reaches the
//   host: the launch needs no synchronize and can be captured in a CUDA
//   graph. Pages past the live length and -1 table entries are never
//   read.
// - Pages stay in their own type in shared memory: each stage of 64 keys
//   comes in by 16-byte `cp.async` (8-byte for int8 rows of an odd
//   number of 8-byte words; zero-filled past the walk's end) into a ring
//   of stages. A launch of at most 8 rows a sequence takes the decode
//   instantiation, three blocks an SM: a two-stage ring in bf16 (stage
//   i + 1 in flight while stage i is computed; three stages at two
//   blocks an SM measured 10-30 % slower), three in int8. Other launches
//   take three stages (bf16) or four (int8), two blocks an SM. The
//   block stages a span's table entries in shared memory once.
// - Products on the tensor cores, mma.sync m16n8k16 bf16 with f32
//   accumulators, rows as the N of 8: S^T = K Q^T and O^T = V^T P^T.
//   bf16 K and V come in through ldmatrix (V transposed); int8 K and V
//   are widened exactly at use into the A fragments (the 2^23-magic
//   recipe of `gemm::i8x4_bf16x4`), their depth and output columns
//   permuted so that a thread's bytes are one 32-bit word. P enters as a
//   bf16 hi + lo pair (two products into one f32 sum, movmatrix carrying
//   the score accumulator into the B fragment). The softmax and merge
//   arithmetic is written with `__f*_rn` intrinsics, so no multiply-add
//   contraction differs between the kernels or their instantiations.
// f32 q keeps the CUDA-core kernel below (the anonymous namespace): one
// block per (b, kv head), keys staged 64 at a time as f32.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowChunk = 32;
constexpr int kKeysPerIter = 64;
constexpr int kLanesPerPair = 8;
constexpr int kLoadBatch = 8;  // page-vector loads in flight per thread and side

__host__ __device__ inline int key_stride(int hd) { return hd + 8; }

// f32 q: the CUDA-core page walk. T: q and output type; C: page element
// type (T, or int8_t when kQuant).
template <typename T, typename C, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                       const C* __restrict__ vc,
                       const float* __restrict__ kdq,
                       const float* __restrict__ vdq,
                       const int* __restrict__ tables,
                       const int* __restrict__ past_lens,
                       const int* __restrict__ this_lens, T* __restrict__ out,
                       int KV, int rows, int hd, int bs, int max_blocks,
                       int group, float sm_scale, int keys_per_iter,
                       int row_chunk) {
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int past = past_lens[b];
  const int this_len = this_lens[b];
  const int live_rows = min(rows, max(this_len, 0) * group);
  const size_t head_base = ((size_t)b * KV + kv) * rows * hd;
  const T* qb = q + head_base;
  T* ob = out + head_base;

  // dead rows (pad rows of a mixed launch, idle batch slots): zero, no work
  for (int i = live_rows * hd + tid; i < rows * hd; i += kThreads)
    ob[i] = from_float<T>(0.f);
  if (live_rows == 0) return;

  const int kstr = key_stride(hd);
  const int pages_per_iter = keys_per_iter / bs;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                                  // [kt][kstr]
  float* v_s = k_s + keys_per_iter * kstr;            // [kt][kstr]
  float* q_s = v_s + keys_per_iter * kstr;            // [rc][hd]
  float* acc_s = q_s + row_chunk * hd;                // [rc][hd]
  float* s_s = acc_s + row_chunk * hd;                // [rc][kt]
  float* m_s = s_s + row_chunk * keys_per_iter;       // [rc]
  float* l_s = m_s + row_chunk;                       // [rc]
  float* a_s = l_s + row_chunk;                       // [rc]
  float* ksc_s = a_s + row_chunk;                     // [pages_per_iter]
  float* vsc_s = ksc_s + pages_per_iter;              // [pages_per_iter]

  const int vecs_per_page = bs * hd / 8;
  const size_t page_elems = (size_t)bs * hd;
  const int* table = tables + (size_t)b * max_blocks;

  for (int r0 = 0; r0 < live_rows; r0 += row_chunk) {
    const int nr = min(row_chunk, live_rows - r0);
    const int t_last = (r0 + nr - 1) / group;
    // pages holding positions 0 .. past + t_last: all this chunk can see
    const int n_pages = (past + t_last + 1 + bs - 1) / bs;

    for (int i = tid; i < nr * hd; i += kThreads) {
      q_s[i] = to_float(qb[(size_t)r0 * hd + i]);
      acc_s[i] = 0.f;
    }
    for (int r = tid; r < nr; r += kThreads) {
      m_s[r] = -CUDART_INF_F;
      l_s[r] = 0.f;
    }

    for (int p0 = 0; p0 < n_pages; p0 += pages_per_iter) {
      const int np = min(pages_per_iter, n_pages - p0);
      const int kt = np * bs;
      __syncthreads();  // previous tile fully consumed (and q_s/acc_s set)

      if (kQuant) {
        // each page's score and probability multipliers
        for (int pi = tid; pi < np; pi += kThreads) {
          const size_t blk = (size_t)table[p0 + pi];
          ksc_s[pi] = sm_scale * kdq[blk * KV + kv];
          vsc_s[pi] = vdq[blk * KV + kv];
        }
      }

      // stage K and V of pages p0 .. p0+np-1 as f32; each thread issues
      // kLoadBatch loads per side before it converts and stores any, so a
      // whole tile is in flight at once
      const int nvec = np * vecs_per_page;
      for (int v0 = 0; v0 < nvec; v0 += kThreads * kLoadBatch) {
        Vec8<C> kb[kLoadBatch], vb[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            const int pi = v / vecs_per_page;
            const size_t blk = (size_t)table[p0 + pi];
            const size_t g = (blk * KV + kv) * page_elems +
                             (size_t)(v - pi * vecs_per_page) * 8;
            kb[u].load(kc + g);
            vb[u].load(vc + g);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int v = v0 + u * kThreads + tid;
          if (v < nvec) {
            const int pi = v / vecs_per_page;
            const int o = (v - pi * vecs_per_page) * 8;
            const int key = pi * bs + o / hd;
            const int e = o % hd;
            float kf[8], vf[8];
            kb[u].to_floats(kf);
            vb[u].to_floats(vf);
            float4* kd = reinterpret_cast<float4*>(k_s + key * kstr + e);
            float4* vd = reinterpret_cast<float4*>(v_s + key * kstr + e);
            kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
            kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
            vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
            vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
          }
        }
      }
      __syncthreads();

      // scores: 8 lanes per (row, key) pair; every thread runs the same
      // number of rounds so the shuffles stay converged
      const int pairs = nr * kt;
      const int lane8 = tid & (kLanesPerPair - 1);
      for (int base = 0; base < pairs; base += kThreads / kLanesPerPair) {
        const int pair = base + tid / kLanesPerPair;
        const bool valid = pair < pairs;
        const int r = valid ? pair / kt : 0;
        const int j = valid ? pair - r * kt : 0;
        float part = 0.f;
        if (valid) {
          const float* qr = q_s + r * hd;
          const float* kr = k_s + j * kstr;
          for (int e = lane8; e < hd; e += kLanesPerPair) part += qr[e] * kr[e];
        }
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (valid && lane8 == 0) {
          const int t = (r0 + r) / group;
          const int kv_pos = p0 * bs + j;
          const float scale = kQuant ? ksc_s[j / bs] : sm_scale;
          s_s[r * kt + j] = kv_pos <= past + t ? part * scale : -CUDART_INF_F;
        }
      }
      __syncthreads();

      // online-softmax update, one warp per row; int8 pages scale the
      // probabilities by their page's v multiplier after l is summed
      for (int r = warp; r < nr; r += kThreads / 32) {
        float* sr = s_s + r * kt;
        float mx = m_s[r];
        for (int j = lane; j < kt; j += 32) mx = fmaxf(mx, sr[j]);
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int j = lane; j < kt; j += 32) {
          const float s = sr[j];
          const float pj = s == -CUDART_INF_F ? 0.f : expf(s - mx);
          sr[j] = kQuant ? pj * vsc_s[j / bs] : pj;
          sum += pj;
        }
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          // m is finite from the first tile on: position 0 is visible to
          // every live row, so exp(-inf - mx) = 0 only ever zeroes acc = 0
          const float alpha = expf(m_s[r] - mx);
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = mx;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P @ V
      for (int i = tid; i < nr * hd; i += kThreads) {
        const int r = i / hd;
        const int e = i - r * hd;
        const float* pr = s_s + r * kt;
        float a = acc_s[i] * a_s[r];
        for (int j = 0; j < kt; ++j) a += pr[j] * v_s[j * kstr + e];
        acc_s[i] = a;
      }
    }
    __syncthreads();

    for (int i = tid; i < nr * hd; i += kThreads) {
      const float l = l_s[i / hd];
      ob[(size_t)r0 * hd + i] = from_float<T>(acc_s[i] / (l == 0.f ? 1.f : l));
    }
    __syncthreads();  // q_s/acc_s/m_s are reused by the next row chunk
  }
}

// kdq/vdq are read only when kQuant.
template <typename T, typename C, bool kQuant>
int launch(const void* q, const void* kc, const void* vc, const void* kdq,
           const void* vdq, const void* tables, const void* past,
           const void* this_lens, void* out, int B, int KV, int rows, int hd,
           int bs, int max_blocks, int group, float sm_scale,
           cudaStream_t stream) {
  const int keys_per_iter = bs >= kKeysPerIter ? bs : (kKeysPerIter / bs) * bs;
  const int row_chunk = rows < kRowChunk ? rows : kRowChunk;
  const int pages_per_iter = keys_per_iter / bs;
  const size_t smem =
      sizeof(float) * (2 * (size_t)keys_per_iter * key_stride(hd) +
                       2 * (size_t)row_chunk * hd +
                       (size_t)row_chunk * keys_per_iter + 3 * row_chunk +
                       2 * pages_per_iter);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, C, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, KV);
  paged_attention_kernel<T, C, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kc),
      static_cast<const C*>(vc), static_cast<const float*>(kdq),
      static_cast<const float*>(vdq), static_cast<const int*>(tables),
      static_cast<const int*>(past), static_cast<const int*>(this_lens),
      static_cast<T*>(out), KV, rows, hd, bs, max_blocks, group, sm_scale,
      keys_per_iter, row_chunk);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace paged {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // four warps
constexpr int kKT = 64;            // keys a stage: four 16-key tiles
constexpr int kTable = 256;        // table entries staged in shared memory
constexpr int kWaves = 4;          // grid: at most this many waves of blocks
constexpr int kRows = 8;           // rows a unit walks: the products' N
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block: a ring of stages, each a K and a V tile of
// kKT key rows (row pitch HDP elements + 16 bytes, so the eight rows an
// ldmatrix or a fragment load touches fall in different banks), and for
// int8 pages the keys' score and probability multipliers; then the
// staged table entries; then the running merge of a row group's spans
// (O [kRows][HDP], M [kRows], L [kRows], f32). HDP is hd rounded up to
// 32, 64, 128 or 256. kDec: the decode kernel (at most 8 rows a
// sequence), whose ring is cut so that three blocks share an SM.
template <typename C, int HDP, bool kDec>
struct Geo {
  static constexpr int kElem = sizeof(C);
  static constexpr int kPitch = HDP * kElem + 16;
  static constexpr int kStages = kElem == 1 ? (kDec ? 3 : 4) : (kDec ? 2 : 3);
  static constexpr int kBlocksPerSM = kDec ? 3 : 2;
  static constexpr int kSide = kKT * kPitch;
  static constexpr int kScales = kElem == 1 ? 2 * kKT * 4 : 0;
  static constexpr int kStage = 2 * kSide + kScales;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kMerge = kRing + kTable * 4;
  static constexpr int kSmem = kMerge + (kRows * HDP + 2 * kRows) * 4;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (16, 8 or 4) from global to shared memory, asynchronously;
// src_bytes 0 writes zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     saddr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     saddr(dst)),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}
// an 8 x 8 bf16 matrix in the fragment layout (thread g*4+c holds row g,
// columns 2c, 2c+1), transposed across the warp
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// d += A B, A 16 x 16 (row), B 16 x 8 (col), bf16, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of K (rows kt*16 .. +15 of the stage) for depth step kk.
// bf16: ldmatrix, depth in order. int8: K[key][16 kk + 4c .. + 3] is one
// word a row (keys g and g + 8), widened exactly; depth k16 index 2c, 2c+1,
// 2c+8, 2c+9 maps to hd 4c .. 4c+3, and q's B fragment takes the same
// permutation, so the sum over hd is unchanged.
template <typename C, int HDP>
__device__ __forceinline__ void k_frag(uint32_t (&a)[4],
                                       const unsigned char* ks, int kt,
                                       int kk) {
  constexpr int P = Geo<C, HDP, false>::kPitch;
  const int lane = threadIdx.x & 31;
  if (sizeof(C) == 2) {
    const int mi = lane >> 3;
    const int key = kt * 16 + (mi & 1) * 8 + (lane & 7);
    ldsm(a, ks + key * P + (16 * kk + (mi >> 1) * 8) * 2);
  } else {
    const int g = lane >> 2, c = lane & 3;
    const unsigned char* p = ks + (kt * 16 + g) * P + 16 * kk + 4 * c;
    const uint2 r0 = gemm::i8x4_bf16x4(ld32(p));
    const uint2 r1 = gemm::i8x4_bf16x4(ld32(p + 8 * P));
    a[0] = r0.x, a[1] = r1.x, a[2] = r0.y, a[3] = r1.y;
  }
}

// The A fragments of V^T for keys kt*16 .. +15 and the 32 output columns
// of group j (two 16-column tiles, a[0] and a[1]). bf16: ldmatrix
// transposed, columns in order. int8: V[key][32 j + 4g .. + 3] is one word
// for each of the thread's keys 2c, 2c+1, 2c+8, 2c+9; byte pairs of two
// keys are interleaved and widened, so tile 0's rows are hd 32 j + 4g
// (+1 for the upper eight) and tile 1's hd 32 j + 4g + 2 (+1): `out_col`.
template <typename C, int HDP>
__device__ __forceinline__ void v_frags(uint32_t (&a)[2][4],
                                        const unsigned char* vs, int kt,
                                        int j) {
  constexpr int P = Geo<C, HDP, false>::kPitch;
  const int lane = threadIdx.x & 31;
  if (sizeof(C) == 2) {
    const int mi = lane >> 3;
    const int key = kt * 16 + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_t(a[h], vs + key * P + (32 * j + 16 * h + (mi & 1) * 8) * 2);
  } else {
    const int g = lane >> 2, c = lane & 3;
    const unsigned char* p = vs + (kt * 16 + 2 * c) * P + 32 * j + 4 * g;
    const uint32_t w0 = ld32(p), w1 = ld32(p + P);
    const uint32_t w8 = ld32(p + 8 * P), w9 = ld32(p + 9 * P);
    const uint2 lo01 = gemm::i8x4_bf16x4(__byte_perm(w0, w1, 0x5140));
    const uint2 hi01 = gemm::i8x4_bf16x4(__byte_perm(w0, w1, 0x7362));
    const uint2 lo89 = gemm::i8x4_bf16x4(__byte_perm(w8, w9, 0x5140));
    const uint2 hi89 = gemm::i8x4_bf16x4(__byte_perm(w8, w9, 0x7362));
    a[0][0] = lo01.x, a[0][1] = lo01.y, a[0][2] = lo89.x, a[0][3] = lo89.y;
    a[1][0] = hi01.x, a[1][1] = hi01.y, a[1][2] = hi89.x, a[1][3] = hi89.y;
  }
}

// hd column of accumulator entry e of 16-column tile mt (see v_frags)
template <typename C>
__device__ __forceinline__ int out_col(int mt, int e) {
  const int g = (threadIdx.x & 31) >> 2;
  return sizeof(C) == 2 ? 16 * mt + g + 8 * (e >> 1)
                        : 32 * (mt >> 1) + 4 * g + 2 * (mt & 1) + (e >> 1);
}

struct Args {
  const bf16* q;
  const void* kc;
  const void* vc;
  const float* kdq;
  const float* vdq;
  const int* tables;
  const int* past;
  const int* this_lens;
  bf16* out;
  // [B, KV, splits, part_rows, hd] acc, then [.., 2] (m, l)
  float* part;
  int B, KV, rows, hd, bs, max_blocks, group, span, splits, part_rows;
  float scale;     // sm_scale * log2(e): scores in the log2 domain
  int max_units;   // units a sequence may have (set by the launch)
};

// Where a walk's folded state goes: the rows' values (kOut), the span's
// partials for the merge kernel (kPart), or the block's running merge of
// the row group's spans (kMergeInto).
enum Fold { kOut, kPart, kMergeInto };

// x a + y f, rounded at each step: one step of the ascending merge of
// spans, the same in the merge kernel and inside a block
__device__ __forceinline__ float mix(float x, float a, float y, float f) {
  return __fadd_rn(__fmul_rn(x, a), __fmul_rn(y, f));
}

// The four warps' states of row r (buf rows w * 8 + r: acc[HDP], m, l),
// folded in warp order: the row's max mm and sum L over the walk's keys
// (its acc column is folded by the caller with the same weights).
template <int HDP>
__device__ __forceinline__ void fold_ml(const float* buf, int r, float& mm,
                                        float& L) {
  constexpr int W = HDP + 2;
  mm = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < 4; ++w) mm = fmaxf(mm, buf[(w * 8 + r) * W + HDP]);
  L = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float* row = buf + (w * 8 + r) * W;
    // 0 for a warp that saw none of the row's keys
    L = __fadd_rn(L, __fmul_rn(row[HDP + 1], exp2f(__fsub_rn(row[HDP], mm))));
  }
}

// The page walk of one block over positions [lo, hi) of span s for the
// live rows r0 .. r0 + nlive - 1 of sequence b (at most kRows, the N of
// the products): the four warps split each stage's keys, 16 each, each
// warp with its own softmax state, folded in warp order at the end; the
// folded state then goes where `fold` says. Every row of every launch
// takes this walk, so a row's bits follow from its position and its
// sequence's pages alone.
template <typename C, int HDP, bool kDec>
__device__ __forceinline__ void walk(const Args& A, unsigned char* smem,
                                     int b, int kv, int s, int r0, int nlive,
                                     Fold fold, int lo, int hi) {
  using Gm = Geo<C, HDP, kDec>;
  constexpr bool kI8 = sizeof(C) == 1;
  constexpr int MT = HDP / 16;                  // 16-wide hd steps
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int past = A.past[b];
  const size_t head = (size_t)b * A.KV + kv;
  const int* trow = A.tables + (size_t)b * A.max_blocks;
  const int* tbl = reinterpret_cast<const int*>(smem + Gm::kRing);
  const int p_lo = lo / A.bs;

  // q as the B operand of S^T = K Q^T: row r0 + g, one depth step each
  uint32_t qf[MT][2];
  int lim[2];   // last visible position of the thread's rows 2c, 2c+1
  {
    const bool live = g < nlive;
    const bf16* qr = A.q + (head * A.rows + (live ? r0 + g : 0)) * A.hd;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      if (kI8) {
        const int col = 16 * kk + 4 * c;
        const uint2 v = live && col < A.hd
                            ? *reinterpret_cast<const uint2*>(qr + col)
                            : make_uint2(0, 0);
        qf[kk][0] = v.x, qf[kk][1] = v.y;
      } else {
        const int col = 16 * kk + 2 * c;
        qf[kk][0] = live && col < A.hd ? ld32(qr + col) : 0u;
        qf[kk][1] = live && col + 8 < A.hd ? ld32(qr + col + 8) : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * c + j;
      // rows past the live ones see everything (their q is 0): no mask
      lim[j] = r < nlive ? past + (r0 + r) / A.group : INT_MAX;
    }
  }
  const int lim_min = past + r0 / A.group;   // the group's first row

  // stage i: positions lo + 64 i .. + 63, in slot i % kStages
  const float inv_bs = 1.f / A.bs;
  const int row_bytes = A.hd * (int)sizeof(C);
  auto load = [&](int i) {
    unsigned char* st = smem + (i % Gm::kStages) * Gm::kStage;
    const int p0 = lo + i * kKT;
    auto pool_row = [&](int pos, size_t& row) {   // pool row of a position
      int page = __float2int_rz(pos * inv_bs);
      page -= page * A.bs > pos;
      page += (page + 1) * A.bs <= pos;
      const int j = page - p_lo;
      const int blk = j < kTable ? tbl[j] : __ldg(trow + page);
      row = ((size_t)blk * A.KV + kv) * A.bs + (pos - page * A.bs);
      return blk;
    };
    auto rows_of = [&](auto chunk) {
      constexpr int CH = decltype(chunk)::value;
      constexpr int CPR = HDP * (int)sizeof(C) / CH;
      const int nch = row_bytes / CH;
      for (int idx = tid; idx < kKT * CPR; idx += kThreads) {
        const int key = idx / CPR, ch = idx % CPR;
        if (ch >= nch) continue;
        const int pos = p0 + key;
        unsigned char* dk = st + key * Gm::kPitch + ch * CH;
        if (pos < hi) {
          size_t row;
          pool_row(pos, row);
          const size_t off = row * row_bytes + ch * CH;
          cp_async<CH>(dk, static_cast<const char*>(A.kc) + off, CH);
          cp_async<CH>(dk + Gm::kSide, static_cast<const char*>(A.vc) + off,
                       CH);
        } else {
          cp_async<CH>(dk, A.kc, 0);
          cp_async<CH>(dk + Gm::kSide, A.vc, 0);
        }
      }
    };
    if (row_bytes % 16 == 0)
      rows_of(std::integral_constant<int, 16>());
    else
      rows_of(std::integral_constant<int, 8>());
    if (kI8) {
      float* sc = reinterpret_cast<float*>(st + 2 * Gm::kSide);
      for (int key = tid; key < kKT; key += kThreads) {
        const int pos = p0 + key;
        if (pos < hi) {
          size_t row;
          const size_t at = (size_t)pool_row(pos, row) * A.KV + kv;
          cp_async<4>(sc + key, A.kdq + at, 4);
          cp_async<4>(sc + kKT + key, A.vdq + at, 4);
        } else {
          cp_async<4>(sc + key, A.kdq, 0);
          cp_async<4>(sc + kKT + key, A.vdq, 0);
        }
      }
    }
  };

  float m[2], l[2], acc[MT][4];
  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  const int ntiles = (hi - lo + kKT - 1) / kKT;
#pragma unroll
  for (int i = 0; i < Gm::kStages - 1; ++i) {
    if (i < ntiles) load(i);
    cp_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_wait<Gm::kStages - 2>();
    __syncthreads();   // stage i landed for all; stage i - 1 consumed
    if (i + Gm::kStages - 1 < ntiles) load(i + Gm::kStages - 1);
    cp_commit();
    const unsigned char* st = smem + (i % Gm::kStages) * Gm::kStage;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * Gm::kSide);
    const int p0 = lo + i * kKT;
    const bool edge = p0 + kKT - 1 > lim_min || p0 + kKT > hi;

    // S^T = K Q^T over the warp's 16 keys, keys as M and rows as N; the
    // depth steps in two chains of products (odd steps into sx), so they
    // overlap
    float sc[4], sx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = sx[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      uint32_t a[4];
      k_frag<C, HDP>(a, st, warp, kk);
      mma((kk & 1) ? sx : sc, a, qf[kk][0], qf[kk][1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = __fadd_rn(sc[e], sx[e]);
    // scale into the log2 domain, mask, row max over the warp's keys
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = warp * 16 + g + 8 * (e >> 1);
      const float f = kI8 ? ksc[key] * A.scale : A.scale;
      const int pos = p0 + key;
      float x = __fmul_rn(sc[e], f);
      if (edge && (pos >= hi || pos > lim[e & 1])) x = -CUDART_INF_F;
      sc[e] = x;
      mx[e & 1] = fmaxf(mx[e & 1], x);
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = mx[j];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const float mn = fmaxf(m[j], v);
      // a row with nothing visible yet keeps m = -inf: exponents of 0
      mu[j] = mn == -CUDART_INF_F ? 0.f : mn;
      alpha[j] = exp2f(__fsub_rn(m[j], mu[j]));
      m[j] = mn;
      l[j] = __fmul_rn(l[j], alpha[j]);
    }
    // p = 2^(x - m); l sums p; int8 pages scale p by the key's page's v
    // multiplier after l is summed
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = kI8 ? ksc[kKT + warp * 16 + g + 8 * (e >> 1)] : 1.f;
      const float p = exp2f(__fsub_rn(sc[e], mu[e & 1]));
      l[e & 1] = __fadd_rn(l[e & 1], p);
      sc[e] = kI8 ? __fmul_rn(p, f) : p;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][e] = __fmul_rn(acc[mt][e], alpha[e & 1]);

    // O^T += V^T P^T, P as bf16 hi + lo: the B fragments are the score
    // accumulator's pairs, transposed by movmatrix
    const unsigned char* vs = st + Gm::kSide;
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x0 = sc[2 * h], x1 = sc[2 * h + 1];
      const uint32_t hw = pack2(x0, x1);
      bh[h] = movt(hw);
      bl[h] = movt(pack2(__fsub_rn(x0, lo_f(hw)), __fsub_rn(x1, hi_f(hw))));
    }
#pragma unroll
    for (int j = 0; j < MT / 2; ++j) {
      uint32_t a[2][4];
      v_frags<C, HDP>(a, vs, warp, j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma(acc[2 * j + h], a[h], bh[0], bh[1]);
        mma(acc[2 * j + h], a[h], bl[0], bl[1]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free

  // l: the thread's keys summed, then across the row's eight lanes
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v = l[j];
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
    l[j] = v;
  }
  // the warps' states of the same 8 rows, folded in warp order
  constexpr int W = HDP + 2;   // a row: acc[HDP], m, l
  float* buf = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      buf[(warp * 8 + 2 * c + (e & 1)) * W + out_col<C>(mt, e)] = acc[mt][e];
  if (g == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      buf[(warp * 8 + 2 * c + j) * W + HDP] = m[j];
      buf[(warp * 8 + 2 * c + j) * W + HDP + 1] = l[j];
    }
  __syncthreads();
  bf16* ob = A.out + head * A.rows * A.hd;
  float* pacc = A.part + (head * A.splits + s) * A.part_rows * A.hd;
  float* pml = A.part +
               (size_t)A.B * A.KV * A.splits * A.part_rows * A.hd +
               (head * A.splits + s) * A.part_rows * 2;
  float* o_run = reinterpret_cast<float*>(smem + Gm::kMerge);
  float* m_run = o_run + kRows * HDP;
  float* l_run = m_run + kRows;
  for (int it = tid; it < nlive * A.hd; it += kThreads) {
    const int r = it / A.hd, col = it - r * A.hd;
    float mm, L;
    fold_ml<HDP>(buf, r, mm, L);
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* row = buf + (w * 8 + r) * W;
      O = __fadd_rn(O, __fmul_rn(row[col], exp2f(__fsub_rn(row[HDP], mm))));
    }
    if (fold == kOut) {
      ob[(size_t)(r0 + r) * A.hd + col] =
          __float2bfloat16(__fdiv_rn(O, L == 0.f ? 1.f : L));
    } else if (fold == kPart) {
      pacc[r * A.hd + col] = O;
      if (col == 0) pml[2 * r] = mm, pml[2 * r + 1] = L;
    } else if (s == 0) {
      o_run[r * HDP + col] = O;
    } else if (past + (r0 + r) / A.group >= lo) {   // the row reaches span s
      const float M = m_run[r], Mn = fmaxf(M, mm);
      o_run[r * HDP + col] =
          mix(o_run[r * HDP + col], exp2f(__fsub_rn(M, Mn)), O,
              exp2f(__fsub_rn(mm, Mn)));
    }
  }
  if (fold != kMergeInto) return;
  __syncthreads();   // every column of a row has read the row's old (m, l)
  if (tid < nlive) {
    const int r = tid;
    float mm, L;
    fold_ml<HDP>(buf, r, mm, L);
    if (s == 0) {
      m_run[r] = mm, l_run[r] = L;
    } else if (past + (r0 + r) / A.group >= lo) {
      const float M = m_run[r], Mn = fmaxf(M, mm);
      l_run[r] = mix(l_run[r], exp2f(__fsub_rn(M, Mn)), L,
                     exp2f(__fsub_rn(mm, Mn)));
      m_run[r] = Mn;
    }
  }
  __syncthreads();
}

// Live rows of sequence b: its this-length's tokens, G rows each.
__device__ __forceinline__ int live_rows(const Args& A, int b) {
  return min(max(A.this_lens[b], 0), A.rows / A.group) * A.group;
}

// Does sequence b split its spans across blocks? Chunks of at most
// part_rows live rows (decode rows, speculative verify chunks) whose last
// row reaches a second span, under a plan with spans (`paged_splits`:
// G <= 8, spans long enough that such partials stay within a tenth of the
// K/V bytes they split). Each span then has its own block and the merge
// kernel folds them; any other row group walks its spans in one block and
// merges them there, with the same arithmetic.
__device__ __forceinline__ bool split_seq(const Args& A, int b) {
  const int live = live_rows(A, b);
  if (A.splits < 2 || live == 0 || live > A.part_rows) return false;
  const int last = A.past[b] + (live - 1) / A.group;
  return last >= A.span && last / A.span < A.splits;
}

// The units of work of sequence b: each span of a split sequence, each
// kRows-row group that holds live rows of any other, and one unit (which
// only zeroes) for an idle slot.
__device__ __forceinline__ int units_of(const Args& A, int b) {
  const int live = live_rows(A, b);
  if (split_seq(A, b)) return (A.past[b] + (live - 1) / A.group) / A.span + 1;
  return max(1, (live + kRows - 1) / kRows);
}

// Stage the table entries of pages lo / bs .. (hi - 1) / bs and, for a
// head_dim below HDP, zero the ring (its columns past hd stay zero in
// every stage).
template <typename C, int HDP, bool kDec>
__device__ __forceinline__ void stage_span(const Args& A, unsigned char* smem,
                                           int b, int lo, int hi) {
  using Gm = Geo<C, HDP, kDec>;
  int* tbl = reinterpret_cast<int*>(smem + Gm::kRing);
  const int p_lo = lo / A.bs;
  const int n_pages = min((hi - 1) / A.bs - p_lo + 1, kTable);
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    tbl[i] = A.tables[(size_t)b * A.max_blocks + p_lo + i];
  if (A.hd < HDP)
    for (int i = threadIdx.x; i < Gm::kRing / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// Unit j of sequence b and kv head kv: its dead rows zeroed (j = 0), then
// span j of a split sequence, or row group j of any other, whose spans
// (those its last row reaches) are walked in order and merged in the
// block.
template <typename C, int HDP, bool kDec>
__device__ __forceinline__ void run_unit(const Args& A, unsigned char* smem,
                                         int b, int kv, int j) {
  using Gm = Geo<C, HDP, kDec>;
  const int tid = threadIdx.x;
  const int live = live_rows(A, b);
  // dead rows — pad rows of a mixed launch, idle slots — zeroed once
  if (j == 0) {
    bf16* ob = A.out + ((size_t)b * A.KV + kv) * A.rows * A.hd;
    for (int i = live * A.hd + tid; i < A.rows * A.hd; i += kThreads)
      ob[i] = __float2bfloat16(0.f);
  }
  const bool split = split_seq(A, b);
  const int r0 = split ? 0 : j * kRows;
  const int nlive = split ? live : min(live - r0, kRows);
  if (nlive <= 0) return;
  const int end = min(A.past[b] + (r0 + nlive - 1) / A.group + 1,
                      A.max_blocks * A.bs);
  if (split) {
    const int lo = j * A.span, hi = min(lo + A.span, end);
    if (hi <= lo) return;
    stage_span<C, HDP, kDec>(A, smem, b, lo, hi);
    walk<C, HDP, kDec>(A, smem, b, kv, j, 0, nlive, kPart, lo, hi);
    return;
  }
  if (end <= 0) return;
  const int n = A.splits > 1 ? (end - 1) / A.span + 1 : 1;
  for (int s = 0; s < n; ++s) {
    const int lo = n > 1 ? s * A.span : 0;
    const int hi = n > 1 ? min(lo + A.span, end) : end;
    if (s > 0) __syncthreads();   // the last walk is done with the ring
    stage_span<C, HDP, kDec>(A, smem, b, lo, hi);
    walk<C, HDP, kDec>(A, smem, b, kv, s, r0, nlive,
                       n > 1 ? kMergeInto : kOut, lo, hi);
  }
  if (n == 1) return;
  const float* o_run = reinterpret_cast<const float*>(smem + Gm::kMerge);
  const float* l_run = o_run + kRows * HDP + kRows;
  bf16* ob = A.out + ((size_t)b * A.KV + kv) * A.rows * A.hd;
  for (int it = tid; it < nlive * A.hd; it += kThreads) {
    const int r = it / A.hd, col = it - r * A.hd;
    ob[(size_t)(r0 + r) * A.hd + col] =
        __float2bfloat16(__fdiv_rn(o_run[r * HDP + col], l_run[r]));
  }
}

// Units are numbered level by level (u = (j * B + b) * KV + kv: every
// sequence's first span or row group before any second one), and block x
// takes units x, x + grid, ... up to the launch's largest level, which
// every block reduces from the lengths; a unit past its sequence's own
// count is skipped. The grid (`launch_kernel`) is at most kWaves waves of
// resident blocks, so its size does not follow max_len. kDec: the decode
// kernel, launched when every sequence has at most 8 rows.
template <typename C, int HDP, bool kDec>
__global__ void __launch_bounds__(kThreads, (Geo<C, HDP, kDec>::kBlocksPerSM))
paged_attention_mma(Args A) {
  extern __shared__ __align__(128) unsigned char paged_smem[];
  __shared__ int warp_top[kThreads / 32];
  const int tid = threadIdx.x;
  int top = 0;
  for (int b = tid; b < A.B; b += kThreads) top = max(top, units_of(A, b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = max(top, __shfl_xor_sync(0xffffffffu, top, off));
  if ((tid & 31) == 0) warp_top[tid >> 5] = top;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) top = max(top, warp_top[w]);
  const int units = A.KV * A.B * min(top, A.max_units);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kv = u % A.KV, b = (u / A.KV) % A.B, j = u / (A.KV * A.B);
    if (j >= units_of(A, b)) continue;
    __syncthreads();   // the previous unit is done with shared memory
    run_unit<C, HDP, kDec>(A, paged_smem, b, kv, j);
  }
}

// The split sequences' rows: row r's spans s = 0 .. (its position) / span
// merged in ascending order, (M, L, O) starting from span 0's partials
// and taking each later span by `mix` — the steps a block takes when it
// walks a row group's spans itself — then out = O / L. (Every span up to
// the row's own position holds position s * span, so its m is finite.)
__device__ __forceinline__ void merge_rows(const Args& A, int b, int kv) {
  const int live = live_rows(A, b), pr = A.part_rows;
  const size_t head = (size_t)b * A.KV + kv;
  const float* pacc = A.part + head * A.splits * pr * A.hd;
  const float* pml = A.part + (size_t)A.B * A.KV * A.splits * pr * A.hd +
                     head * A.splits * pr * 2;
  bf16* ob = A.out + head * A.rows * A.hd;
  for (int it = threadIdx.x; it < live * A.hd; it += kThreads) {
    const int r = it / A.hd, col = it - r * A.hd;
    const int n = (A.past[b] + r / A.group) / A.span + 1;
    float M = __ldcg(pml + 2 * r), L = __ldcg(pml + 2 * r + 1);
    float O = __ldcg(pacc + (size_t)r * A.hd + col);
    for (int s = 1; s < n; ++s) {
      const float m = __ldcg(pml + (s * pr + r) * 2);
      const float Mn = fmaxf(M, m);
      const float a = exp2f(__fsub_rn(M, Mn)), f = exp2f(__fsub_rn(m, Mn));
      L = mix(L, a, __ldcg(pml + (s * pr + r) * 2 + 1), f);
      O = mix(O, a, __ldcg(pacc + ((size_t)s * pr + r) * A.hd + col), f);
      M = Mn;
    }
    ob[(size_t)r * A.hd + col] = __float2bfloat16(__fdiv_rn(O, L));
  }
}

__global__ void __launch_bounds__(kThreads) paged_attention_merge(Args A) {
  const int kv = blockIdx.x, b = blockIdx.y;
  if (split_seq(A, b)) merge_rows(A, b, kv);
}

template <typename C, int HDP, bool kDec>
int launch_kernel(const Args& A, cudaStream_t stream) {
  using Gm = Geo<C, HDP, kDec>;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_mma<C, HDP, kDec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
  if (err != cudaSuccess) return err;
  const long long units = (long long)A.KV * A.B * A.max_units;
  if (units > 0x7fffffff) return cudaErrorInvalidConfiguration;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)kWaves * Gm::kBlocksPerSM * sms;
  const long long blocks = units < cap ? units : cap;
  paged_attention_mma<C, HDP, kDec>
      <<<(unsigned)blocks, kThreads, Gm::kSmem, stream>>>(A);
  return cudaGetLastError();
}

// hd rounded up to the kernel's depth (a multiple of 32: int8 V's output
// columns come in groups of 32)
inline int hd_pad(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

template <typename C, int HDP>
int launch_hdp(Args A, cudaStream_t stream) {
  // at most max(splits, row groups) units a sequence
  A.max_units = max(A.splits, (A.rows + kRows - 1) / kRows);
  if (A.splits > 1 && (A.part_rows < 1 || A.part_rows > kRows))
    return cudaErrorInvalidValue;
  const int err = A.rows <= 8 ? launch_kernel<C, HDP, true>(A, stream)
                              : launch_kernel<C, HDP, false>(A, stream);
  if (err != cudaSuccess || A.splits < 2) return err;
  paged_attention_merge<<<dim3(A.KV, A.B), kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

template <typename C>
int launch(const Args& A, cudaStream_t stream) {
  switch (hd_pad(A.hd)) {
    case 32: return launch_hdp<C, 32>(A, stream);
    case 64: return launch_hdp<C, 64>(A, stream);
    case 128: return launch_hdp<C, 128>(A, stream);
    default: return launch_hdp<C, 256>(A, stream);
  }
}

// dynamic shared memory of a block for head_dim hd (dec: the decode kernel)
template <typename C>
int smem_bytes(int hd, bool dec) {
  switch (hd_pad(hd)) {
    case 32: return dec ? Geo<C, 32, true>::kSmem : Geo<C, 32, false>::kSmem;
    case 64: return dec ? Geo<C, 64, true>::kSmem : Geo<C, 64, false>::kSmem;
    case 128:
      return dec ? Geo<C, 128, true>::kSmem : Geo<C, 128, false>::kSmem;
    default:
      return dec ? Geo<C, 256, true>::kSmem : Geo<C, 256, false>::kSmem;
  }
}

}  // namespace paged
