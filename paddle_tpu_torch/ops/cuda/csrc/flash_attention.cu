// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd` (`_fwd_kernel`
// :153, pallas_call at :264) — kernel A1, reached through
// `llama.attention` in the training step and `flash_attn_unpadded` on the
// varlen path.
//
// What it computes: for q [B, H, T, hd] and k, v [B, KV, S, hd] (bf16 or
// f32; q head h reads kv head h / (H / KV)), o = softmax(q k^T * scale) v
// with an optional causal mask, in f32, written in q's type, and the f32
// log-sum-exp of every row, lse [B, H, T], which the backward (A2) reads.
// Segment mode (varlen: packed sequences, `flash_attn_unpadded`): with
// int32 ids seg_q [B, T] and seg_k [B, S], row t sees key s only where
// seg_q[t] == seg_k[s], as the reference's `_seg_mask` (:144).
// The reference's lse is [B, H, T, 8]: the lane broadcast is a Mosaic
// tiling artifact and is not carried over.
//
// Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
// causal, the two products take 68.7 GFLOP (0.070 ms at 989 TFLOP/s in
// bf16) against 135 MB of q, k, v, o and lse. The TPU kernel walks the kv
// blocks as a sequential grid axis with (m, l, acc) in VMEM scratch; here
// each block walks its own kv tiles, so nothing crosses blocks: no
// atomics, and the same result on every run (activation recompute relies
// on that). Blocks are issued longest walk first.
//
// bf16 design: the tensor cores, fed by TMA.
//   - One block per (batch, head, 64-row q tile): one consumer warpgroup
//     and one producer warp (160 threads). The producer loads the q tile
//     once and keeps a ring of two K/V stages in flight: one TMA box load
//     per 64-column half (one tensor map per operand), completion counted
//     on the stage's mbarrier; the consumer frees a stage through a second
//     mbarrier. So the next tile's copy overlaps this tile's products.
//   - S = Q K^T is a wgmma m64n64k16 with both operands in shared memory;
//     O += P V a wgmma m64n{64,128}k16 with P from registers (the score
//     accumulator is already the A fragment's layout) and V's row-major
//     [keys, hd] tile read MN-major through the transpose bit. f32
//     accumulators throughout; the online softmax runs on the score
//     accumulator in registers, with exp2 of log2e-scaled scores.
//   - Tiles are bf16 in the 128-byte swizzle (`flash_sm90.cuh`): 80 KB at
//     hd = 128, so two blocks share an SM. A head_dim that is a multiple of
//     8 but not of 64 is zero-padded to 64 or 128 by TMA's fill.
//   - P enters the product as a bf16 pair hi + lo (two wgmmas into one f32
//     sum, 1.5x the forward's products): a single bf16 P would add 2^-9
//     relative error per entry, the size of the one-ulp rule the outputs
//     are held to; the reference multiplies p in f32.
// Segment mode skips tiles: before a kv tile is loaded, the producer warp
// reduces its 64 key ids to [min, max] and drops the tile when that does
// not overlap the q tile's own [min, max] (right for any ids, sorted or
// not). Packed sequences then walk only the tiles their segments touch:
// 620 of the causal triangle's 2,080 pairs at lengths [700, 1100, 1300,
// 996]. Within a walked tile, keys of other segments are masked; where a
// row's first walked tiles hold none of its keys, m stays at kNegInf =
// -1e30, masked scores become exactly 0 and exp(m - m_new) stays finite,
// so the first visible tile starts the row's sums from zero. On request
// every block records how many tiles it walked (`record_walk`), so the
// skipping can be read off the card.
//
// f32 path (DTYPE_F32, the agreement checks at rtol 1e-5): the CUDA-core
// kernel, f32 tiles and FMAs, so no product rounds to TF32 or bf16; 256
// threads own one 64-row q tile, each a 4 x 4 patch of the scores and a 4
// x 8 patch of the output. It skips tiles by the same test.
#include "flash_sm90.cuh"

using namespace flash;

namespace {

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int kSmemFloats = 3 * kMaxHD * kTile + kTile * kTile;

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ seg_q,
              const int* __restrict__ seg_k, float* __restrict__ o,
              float* __restrict__ lse, int H, int KV, int T_, int S, int hd,
              int causal, float scale, int* __restrict__ walked) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // [kMaxHD][kTile]  q^T
  float* kt = qt + kMaxHD * kTile;     // [kMaxHD][kTile]  k^T
  float* vs = kt + kMaxHD * kTile;     // [kTile][kMaxHD]  v
  float* pt = vs + kTile * kMaxHD;     // [kTile kv][kTile q]  p^T

  const int nq = (T_ + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.x) * kTile;   // longest walk first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (size_t)(b * H + h) * T_ * hd;
  const float* kb = k + (size_t)(b * KV + kvh) * S * hd;
  const float* vb = v + (size_t)(b * KV + kvh) * S * hd;
  int2 qr = make_int2(0, 0);     // every warp reduces the same ids
  if (seg_q) qr = warp_seg_range(seg_q + (size_t)b * T_, T_, q0);

  load_tile_t(qb, T_, hd, q0, qt);
  int sq[4];
  load_segs(seg_q, b, T_, q0 + ty * 4, sq);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  int nk = (S + kTile - 1) / kTile;
  if (causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);

  int tiles = 0;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    if (seg_q && !overlaps(qr, warp_seg_range(seg_k + (size_t)b * S, S, k0)))
      continue;       // no key of this tile shares a row's segment
    ++tiles;
    __syncthreads();  // the previous tile's readers are done
    load_tile_t(kb, S, hd, k0, kt);
    load_tile_rm(vb, S, hd, k0, vs);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < hd; ++d)
      fma_4x4(s, ld4(qt + d * kTile + ty * 4), ld4(kt + d * kTile + tx * 4));
    int sk[4];
    load_segs(seg_k, b, S, k0 + tx * 4, sk);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        const bool ok = col < S && (!causal || col <= row) && sq[i] == sk[c];
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = s[i][c] == kNegInf ? 0.f : expf(s[i][c] - m_new);
        rs += s[i][c];
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st4(pt + (tx * 4 + c) * kTile + ty * 4, s[0][c], s[1][c], s[2][c],
          s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c)
      fma_4x8(acc, ld4(pt + c * kTile + ty * 4), ld4(vs + c * kMaxHD + tx * 4),
              ld4(vs + c * kMaxHD + 64 + tx * 4));
  }

  store_strip(o + (size_t)(b * H + h) * T_ * hd, T_, hd, q0 + ty * 4, tx, acc,
              l);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < T_) lse[(size_t)(b * H + h) * T_ + row] = m[i] + logf(l[i]);
    }
  }
  record_walk(walked, tiles);
}

int launch_f32(const void* q, const void* k, const void* v, const int* seg_q,
               const int* seg_k, void* o, void* lse, int B, int H, int KV,
               int T_, int S, int hd, int causal, float scale,
               cudaStream_t stream, int* walked) {
  const int smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kTile - 1) / kTile, H, B);
  flash_fwd_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_k, static_cast<float*>(o),
      static_cast<float*>(lse), H, KV, T_, S, hd, causal, scale, walked);
  return cudaGetLastError();
}

// -- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;
using sm90::kRows;
using sm90::kStages;

template <int HDP>   // head_dim padded to the product depth: 64 or 128
struct FwdSmem {
  bf16 q[HDP / 64][kRows * 64];               // each half 1024-aligned
  bf16 k[kStages][HDP / 64][kRows * 64];
  bf16 v[kStages][HDP / 64][kRows * 64];
  int seg[kStages][kRows];   // the stage's key ids (segment mode)
  int tile[kStages];         // the stage's kv tile; -1 ends the walk
  int mixed[kStages];        // 1: the stage's ids and the rows' differ
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int HDP>
__global__ void __launch_bounds__(sm90::kBlockThreads, 2)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const int* __restrict__ seg_q, const int* __restrict__ seg_k,
               bf16* __restrict__ o, float* __restrict__ lse, int H, int KV,
               int T_, int S, int hd, int causal, float scale_log2,
               int* __restrict__ walked) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<HDP>& sm = smem_as<FwdSmem<HDP>>(smem_raw);
  const int nq = (T_ + kRows - 1) / kRows;
  const int qt = nq - 1 - blockIdx.x, q0 = qt * kRows;  // longest walk first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int lane = threadIdx.x & 31;
  int nk = (S + kRows - 1) / kRows;
  if (causal) nk = min(nk, qt + 1);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: q once, then the walked kv tiles through the ring,
    // then an end marker
    if (lane == 0) {
      mbar_arrive_tx(&sm.q_full, HDP / 64 * kHalfBytes);
      tma_tile<HDP>(sm.q[0], &tq, &sm.q_full, q0, b * H + h);
    }
    int2 qr = make_int2(0, 0);
    if (seg_q) qr = warp_seg_range(seg_q + (size_t)b * T_, T_, q0);
    Ring ring{sm.empty};
    for (int j0 = 0; j0 < nk; j0 += kBatch) {
      // in segment mode, the tiles whose ids miss the q tile's are skipped
      int2 kid[kBatch];
      unsigned mixed = 0;
      const unsigned walk =
          seg_q ? walk_batch(seg_k + (size_t)b * S, S, j0, nk, qr, kid, mixed)
                : walk_all(j0, nk);
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (!((walk >> t) & 1)) continue;
        const int j = j0 + t, s = ring.next(kStages);
        if (seg_q) {
          sm.seg[s][lane] = kid[t].x;
          sm.seg[s][lane + 32] = kid[t].y;
        }
        if (lane == 0) {
          sm.tile[s] = j;
          sm.mixed[s] = (mixed >> t) & 1;
          mbar_arrive_tx(&sm.full[s], 2 * (HDP / 64) * kHalfBytes);
          tma_tile<HDP>(sm.k[s][0], &tk, &sm.full[s], j * kRows,
                        b * KV + kvh);
          tma_tile<HDP>(sm.v[s][0], &tv, &sm.full[s], j * kRows,
                        b * KV + kvh);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
    const int s = ring.next(kStages);
    if (lane == 0) sm.tile[s] = -1;
    mbar_arrive(&sm.full[s]);
    return;
  }

  // consumer warpgroup: rows r0 and r0 + 8 of the tile in every thread
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  int sq[2] = {0, 0};
  if (seg_q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sq[i] = row[i] < T_ ? __ldg(seg_q + (size_t)b * T_ + row[i]) : -1;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HDP / 2];
#pragma unroll
  for (int e = 0; e < HDP / 2; ++e) acc[e] = 0.f;
  mbar_wait(&sm.q_full, 0);

  int it = 0;   // the tiles walked
  for (;; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const int j = sm.tile[s];
    if (j < 0) break;
    const int k0 = j * kRows;

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wg_fence();
    wgmma_ss<HDP>(sc, sm.q[0], sm.k[s][0]);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale, then mask where a tile needs it (on the diagonal, at the
    // ragged end, or holding more than one segment id): one uniform
    // branch around the whole mask, so the tiles inside run none of it;
    // then the online softmax, in the log2 domain
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    const bool seg = seg_q && sm.mixed[s];
    if (seg || k0 + kRows > S || (causal && k0 + kRows - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = acc_row(e) ? 1 : 0, c = acc_col(e, lane);
        if (k0 + c >= S || (causal && k0 + c > row[i]) ||
            (seg && sm.seg[s][c] != sq[i]))
          sc[e] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = acc_row(e) ? 1 : 0;
      mx[i] = fmaxf(mx[i], sc[e]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // a row's 64 columns lie in one quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = acc_row(e) ? 1 : 0;
      sc[e] = sc[e] == kNegInf ? 0.f : exp2f(sc[e] - m[i]);
      rs[i] += sc[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int e = 0; e < HDP / 2; ++e) acc[e] *= alpha[acc_row(e) ? 1 : 0];

    uint32_t ph[4][4], pl[4][4];
    split_frags(sc, ph, pl);
    fence_regs(acc);
    wg_fence();
    wgmma_rs<HDP>(acc, ph, sm.v[s][0]);
    wgmma_rs<HDP>(acc, pl, sm.v[s][0]);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&sm.empty[s]);
  }

  const size_t base = (size_t)(b * H + h) * T_;
  store_acc<HDP>(o + base * hd, T_, hd, q0 + r0, acc, 1.f / l[0],
                 1.f / l[1]);
  if ((lane & 3) == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < T_) lse[base + row[i]] = (m[i] + log2f(l[i])) * kLn2;
  record_walk(walked, it);
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, const int* seg_q,
                const int* seg_k, void* o, void* lse, int B, int H, int KV,
                int T_, int S, int hd, int causal, float scale,
                cudaStream_t stream, int* walked) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = sm90::head_map(&mq, q, B * H, T_, hd);
  if (err == cudaSuccess) err = sm90::head_map(&mk, k, B * KV, S, hd);
  if (err == cudaSuccess) err = sm90::head_map(&mv, v, B * KV, S, hd);
  if (err != cudaSuccess) return err;
  const int smem = sm90::smem_bytes<FwdSmem<HDP>>();
  err = cudaFuncSetAttribute(flash_fwd_bf16<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kRows - 1) / kRows, H, B);
  flash_fwd_bf16<HDP><<<grid, sm90::kBlockThreads, smem, stream>>>(
      mq, mk, mv, seg_q, seg_k, static_cast<bf16*>(o),
      static_cast<float*>(lse), H, KV, T_, S, hd, causal,
      scale * sm90::kLog2e, walked);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, T, hd]; k, v [B, KV, S, hd]; seg_q [B, T] and seg_k [B, S]
// int32, both null outside segment mode; o [B, H, T, hd] in q's type;
// lse [B, H, T] f32. All contiguous. walked: null, or int32 [B * H *
// ceil(T / 64)], where every block records the kv tiles it walked.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* seg_q,
                                   const void* seg_k, void* o, void* lse,
                                   int B, int H, int KV, int T_, int S,
                                   int hd, int causal, float scale,
                                   int dtype, void* stream, void* walked) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(walked);
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H % KV || hd % 8 || hd < 8 ||
      hd > kMaxHD || B > 65535 || H > 65535 || (!seg_q != !seg_k))
    return cudaErrorInvalidValue;
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  if (dtype == DTYPE_BF16)
    return hd <= 64 ? launch_bf16<64>(q, k, v, sq, sk, o, lse, B, H, KV, T_,
                                      S, hd, causal, scale, s, w)
                    : launch_bf16<128>(q, k, v, sq, sk, o, lse, B, H, KV, T_,
                                       S, hd, causal, scale, s, w);
  if (dtype == DTYPE_F32)
    return launch_f32(q, k, v, sq, sk, o, lse, B, H, KV, T_, S, hd, causal,
                      scale, s, w);
  return cudaErrorInvalidValue;
}

// dynamic shared memory a bf16 block takes at this head_dim (ptxas reports
// only static shared memory), for the build log
extern "C" int flash_attention_fwd_smem(int hd) {
  return hd <= 64 ? sm90::smem_bytes<FwdSmem<64>>()
                  : sm90::smem_bytes<FwdSmem<128>>();
}

// 64 x 64 x head_dim products a bf16 block issues per walked tile pair:
// S = Q K^T, then P V twice (P as hi and lo)
extern "C" int flash_attention_fwd_products() { return 3; }
