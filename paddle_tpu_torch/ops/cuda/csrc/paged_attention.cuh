// Paged-KV attention for Hopper (sm_90a), CUDA C++: the page walk shared
// by kernel A5's two modes, templated on the page element type.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `paged_attention`
// (`_kernel`, pallas_call at :249) — kernel A5. `paged_attention.cu`
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
// multiplies the score tile, and vdq[page] the probabilities after the
// running sum l is updated. No fp copy of an int8 page exists outside the
// staged tile.
//
// Bound on the H100: bytes. A decode launch (max_q = 1) reads each live
// cached token's K and V once — 2 * KV * hd * 2 B = 16 KiB per token per
// layer at LLaMA-7B in bf16, 8 KiB with int8 pages — and does 4 * hd FLOPs
// per (row, token), far below the ~295 FLOP/B the card needs to be
// compute bound.
//
// Design (simple and right first):
// - one thread block of 128 threads per (b, kv head); the block reads
//   block_tables[b, p] itself and stops at the last page the chunk's last
//   live row can see, so pages past past+this — and the -1 entries that
//   mark unused table slots — are never read;
// - up to 64 keys (several pages) per iteration are staged in shared
//   memory as f32 (bf16 pages as 16-byte loads of 8, int8 pages as 8-byte
//   loads of 8), then scores (8 lanes per (row, key) pair, shuffle
//   reduce), a warp-per-row online-softmax update (m, l in shared), and
//   the P·V accumulate into a shared [rows, hd] f32 accumulator;
// - live rows are processed in chunks of 32. Dead rows (t >= this[b]) do
//   no work: they are zeroed once and never enter the page walk, so a
//   mixed launch that pads every sequence to token_num rows pays only the
//   stores of its pad rows.
// Later work: TMA page loads, wgmma for prefill chunks, split-K over long
// contexts so short batches fill all 132 SMs, 16-byte int8 loads.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowChunk = 32;
constexpr int kKeysPerIter = 64;
constexpr int kLanesPerPair = 8;
constexpr int kLoadBatch = 8;  // page-vector loads in flight per thread and side

__host__ __device__ inline int key_stride(int hd) { return hd + 8; }

// T: q and output type; C: page element type (T, or int8_t when kQuant).
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
