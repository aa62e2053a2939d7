// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd` (`_dq_kernel`
// :280 and `_dkv_kernel` :326, pallas_calls at :414 and :459) — kernel A2,
// the gradient of A1 in the training step and on the varlen path.
//
// What it computes, the flash-attention-2 recompute form: from q, k, v, the
// output gradient do, the forward's lse and delta = rowsum(do * o) (a plain
// torch op before the launch, as the reference leaves it to XLA),
//   p  = exp(q k^T * scale - lse)     (0 where masked)
//   ds = p * (do v^T - delta) * scale
//   dq = ds k,   dk = ds^T q,   dv = p^T do
// with dk, dv summed over the H / KV q heads that share a kv head. Inputs
// bf16 or f32, math in f32, gradients in the inputs' type. In segment mode
// (int32 ids seg_q [B, T], seg_k [B, S]) p is also 0 where the row's and
// the key's segments differ, as in the forward.
//
// Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
// causal, the backward needs five products per visible (row, key) pair
// (q k^T, do v^T, dq, dk, dv): 171.9 GFLOP, 0.174 ms at 989 TFLOP/s,
// against 269 MB moved. Two kernels, one launch each, as the reference
// has two pallas_calls; nothing crosses blocks, so there are no atomics
// and the gradients are the same on every run. That costs two recomputed
// products (q k^T and do v^T in both kernels): seven products per pair.
//
// bf16 design: every product on the tensor cores (wgmma), operand tiles in
// shared memory in the 128-byte swizzle, filled by TMA through a ring of
// two stages that a producer warp keeps in flight (`flash_sm90.cuh`); one
// consumer warpgroup owns a 64-row tile and accumulates in f32:
//   - dq: one block per (batch, head, 64-row q tile) keeps q and do
//     resident and walks the kv tiles up to the diagonal: S = Q K^T and
//     dP = dO V^T (both operands in shared memory), ds in registers, then
//     dQ += dS K with dS as the register A operand and K's row-major tile
//     read MN-major (the transpose bit);
//   - dk/dv: one block per (batch, kv head, 64-key kv tile) keeps k and v
//     resident and walks the G q heads of its group and, for each, the q
//     tiles from the diagonal on. It computes the transposed scores S^T =
//     K Q^T and dP^T = V dO^T, so P^T and dS^T land in registers as the A
//     operand of dV += P^T dO and dK += dS^T Q; lse and delta are indexed
//     along the accumulator's columns (the producer stages the q tile's 64
//     values of each beside its tiles).
// P, P^T, dS and dS^T enter their products as bf16 pairs hi + lo (two
// wgmmas into one f32 sum): ds is a difference, dp - delta, and one bf16
// rounding of it would use the whole one-ulp rule the gradients are held
// to. Ten product units in all: q k^T and do v^T twice, dq, dk and dv two
// each.
// Segment mode skips tiles by the forward's test: a kv tile (dq kernel) or
// q tile (dk/dv kernel) is walked only when its ids' [min, max] overlaps
// the resident tile's; on request each block records the tiles it walked.
//
// f32 path (DTYPE_F32): the CUDA-core kernels, f32 tiles and FMAs (each
// thread a 4 x 8 patch of its output), with the same tile skipping.
#include "flash_sm90.cuh"

using namespace flash;

namespace {

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int kDqSmemFloats = 5 * kMaxHD * kTile + kTile * kTile;
constexpr int kDkvSmemFloats = 6 * kMaxHD * kTile + 2 * kTile * kTile;

__global__ void __launch_bounds__(kThreads)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ seg_q, const int* __restrict__ seg_k,
             float* __restrict__ dq, int H, int KV, int T_, int S, int hd,
             int causal, float scale, int* __restrict__ walked) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // [kMaxHD][kTile]  q^T
  float* dot = qt + kMaxHD * kTile;    // [kMaxHD][kTile]  do^T
  float* kt = dot + kMaxHD * kTile;    // [kMaxHD][kTile]  k^T
  float* vt = kt + kMaxHD * kTile;     // [kMaxHD][kTile]  v^T
  float* ks = vt + kMaxHD * kTile;     // [kTile][kMaxHD]  k
  float* dst = ks + kTile * kMaxHD;    // [kTile kv][kTile q]  ds^T

  const int nq = (T_ + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.x) * kTile;   // longest walk first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qoff = (size_t)(b * H + h) * T_;
  const float* kb = k + (size_t)(b * KV + kvh) * S * hd;
  const float* vb = v + (size_t)(b * KV + kvh) * S * hd;
  int2 qr = make_int2(0, 0);     // every warp reduces the same ids
  if (seg_q) qr = warp_seg_range(seg_q + (size_t)b * T_, T_, q0);

  load_tile_t(q + qoff * hd, T_, hd, q0, qt);
  load_tile_t(dout + qoff * hd, T_, hd, q0, dot);
  int sq[4];
  load_segs(seg_q, b, T_, q0 + ty * 4, sq);
  float lse_r[4], dl_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < T_ ? lse[qoff + row] : 0.f;
    dl_r[i] = row < T_ ? delta[qoff + row] : 0.f;
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
    __syncthreads();
    load_tile_t(kb, S, hd, k0, kt);
    load_tile_t(vb, S, hd, k0, vt);
    load_tile_rm(kb, S, hd, k0, ks);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      fma_4x4(s, ld4(qt + d * kTile + ty * 4), ld4(kt + d * kTile + tx * 4));
      fma_4x4(dp, ld4(dot + d * kTile + ty * 4), ld4(vt + d * kTile + tx * 4));
    }
    int sk[4];
    load_segs(seg_k, b, S, k0 + tx * 4, sk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        const bool ok = row < T_ && col < S && (!causal || col <= row) &&
                        sq[i] == sk[c];
        const float p = ok ? expf(s[i][c] * scale - lse_r[i]) : 0.f;
        s[i][c] = p * (dp[i][c] - dl_r[i]) * scale;     // ds
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st4(dst + (tx * 4 + c) * kTile + ty * 4, s[0][c], s[1][c], s[2][c],
          s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c)
      fma_4x8(acc, ld4(dst + c * kTile + ty * 4), ld4(ks + c * kMaxHD + tx * 4),
              ld4(ks + c * kMaxHD + 64 + tx * 4));
  }
  store_strip(dq + qoff * hd, T_, hd, q0 + ty * 4, tx, acc, nullptr);
  record_walk(walked, tiles);
}

__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ seg_q, const int* __restrict__ seg_k,
              float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
              int T_, int S, int hd, int causal, float scale,
              int* __restrict__ walked) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                    // [kMaxHD][kTile]  k^T (resident)
  float* vt = kt + kMaxHD * kTile;     // [kMaxHD][kTile]  v^T (resident)
  float* qt = vt + kMaxHD * kTile;     // [kMaxHD][kTile]  q^T
  float* dot = qt + kMaxHD * kTile;    // [kMaxHD][kTile]  do^T
  float* qs = dot + kMaxHD * kTile;    // [kTile][kMaxHD]  q
  float* dos = qs + kTile * kMaxHD;    // [kTile][kMaxHD]  do
  float* ps = dos + kTile * kMaxHD;    // [kTile q][kTile kv]  p
  float* dss = ps + kTile * kTile;     // [kTile q][kTile kv]  ds

  const int k0 = blockIdx.x * kTile;   // kv tile 0 (longest walk) first
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t kvoff = (size_t)(b * KV + kvh) * S;
  int2 kr = make_int2(0, 0);     // every warp reduces the same ids
  if (seg_k) kr = warp_seg_range(seg_k + (size_t)b * S, S, k0);

  load_tile_t(k + kvoff * hd, S, hd, k0, kt);
  load_tile_t(v + kvoff * hd, S, hd, k0, vt);
  int sk[4];          // this block's kv rows ty*4 .. ty*4+3
  load_segs(seg_k, b, S, k0 + ty * 4, sk);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const int nq = (T_ + kTile - 1) / kTile;
  // under the causal mask q rows before k0 see none of this tile's keys
  const int i0 = causal ? k0 / kTile : 0;

  int tiles = 0;
  for (int g = 0; g < G; ++g) {
    const size_t qoff = (size_t)(b * H + kvh * G + g) * T_;
    for (int qi = i0; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      if (seg_q &&
          !overlaps(kr, warp_seg_range(seg_q + (size_t)b * T_, T_, q0)))
        continue;     // no row of this tile shares a key's segment
      ++tiles;
      __syncthreads();
      load_tile_t(q + qoff * hd, T_, hd, q0, qt);
      load_tile_t(dout + qoff * hd, T_, hd, q0, dot);
      load_tile_rm(q + qoff * hd, T_, hd, q0, qs);
      load_tile_rm(dout + qoff * hd, T_, hd, q0, dos);
      __syncthreads();

      // this thread's patch of the transposed scores: kv rows ty*4 + i,
      // q columns tx*4 + c
      float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        fma_4x4(st, ld4(kt + d * kTile + ty * 4), ld4(qt + d * kTile + tx * 4));
        fma_4x4(dpt, ld4(vt + d * kTile + ty * 4),
                ld4(dot + d * kTile + tx * 4));
      }
      int sq[4];
      load_segs(seg_q, b, T_, q0 + tx * 4, sq);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + tx * 4 + c;
        const float lse_c = row < T_ ? lse[qoff + row] : 0.f;
        const float dl_c = row < T_ ? delta[qoff + row] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + ty * 4 + i;
          const bool ok = row < T_ && col < S && (!causal || col <= row) &&
                          sq[c] == sk[i];
          const float p = ok ? expf(st[i][c] * scale - lse_c) : 0.f;
          st[i][c] = p;
          dpt[i][c] = p * (dpt[i][c] - dl_c) * scale;   // ds
        }
        st4(ps + (tx * 4 + c) * kTile + ty * 4, st[0][c], st[1][c], st[2][c],
            st[3][c]);
        st4(dss + (tx * 4 + c) * kTile + ty * 4, dpt[0][c], dpt[1][c],
            dpt[2][c], dpt[3][c]);
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        fma_4x8(dv_acc, ld4(ps + r * kTile + ty * 4),
                ld4(dos + r * kMaxHD + tx * 4),
                ld4(dos + r * kMaxHD + 64 + tx * 4));
        fma_4x8(dk_acc, ld4(dss + r * kTile + ty * 4),
                ld4(qs + r * kMaxHD + tx * 4),
                ld4(qs + r * kMaxHD + 64 + tx * 4));
      }
    }
  }
  store_strip(dk + kvoff * hd, S, hd, k0 + ty * 4, tx, dk_acc, nullptr);
  store_strip(dv + kvoff * hd, S, hd, k0 + ty * 4, tx, dv_acc, nullptr);
  record_walk(walked, tiles);
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const int* seg_q,
               const int* seg_k, void* dq, void* dk, void* dv, int B, int H,
               int KV, int T_, int S, int hd, int causal, float scale,
               cudaStream_t stream, int* walked) {
  const int dq_smem = kDqSmemFloats * sizeof(float);
  const int dkv_smem = kDkvSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem);
  if (err != cudaSuccess) return err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  dim3 gq((T_ + kTile - 1) / kTile, H, B);
  flash_dq_f32<<<gq, kThreads, dq_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, seg_q, seg_k, static_cast<float*>(dq), H, KV,
      T_, S, hd, causal, scale, walked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv((S + kTile - 1) / kTile, KV, B);
  flash_dkv_f32<<<gkv, kThreads, dkv_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, seg_q, seg_k, static_cast<float*>(dk),
      static_cast<float*>(dv), H, KV, T_, S, hd, causal, scale,
      walked ? walked + (size_t)gq.x * gq.y * gq.z : nullptr);
  return cudaGetLastError();
}

// -- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;
using sm90::kRows;
using sm90::kStages;

template <int HDP>   // head_dim padded to the product depth: 64 or 128
struct DqSmem {
  bf16 q[HDP / 64][kRows * 64];               // each half 1024-aligned
  bf16 dout[HDP / 64][kRows * 64];
  bf16 k[kStages][HDP / 64][kRows * 64];
  bf16 v[kStages][HDP / 64][kRows * 64];
  int seg[kStages][kRows];   // the stage's key ids (segment mode)
  int tile[kStages];         // the stage's kv tile; -1 ends the walk
  int mixed[kStages];        // 1: the stage's ids and the rows' differ
  uint64_t q_full, full[kStages], empty[kStages];
};

template <int HDP>
__global__ void __launch_bounds__(sm90::kBlockThreads, 1)
flash_dq_bf16(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ seg_q, const int* __restrict__ seg_k,
              bf16* __restrict__ dq, int H, int KV, int T_, int S, int hd,
              int causal, float scale, float scale_log2,
              int* __restrict__ walked) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<HDP>& sm = smem_as<DqSmem<HDP>>(smem_raw);
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
    // producer warp: q and do once, then the walked K/V tiles through the
    // ring, then an end marker
    if (lane == 0) {
      mbar_arrive_tx(&sm.q_full, 2 * (HDP / 64) * kHalfBytes);
      tma_tile<HDP>(sm.q[0], &tq, &sm.q_full, q0, b * H + h);
      tma_tile<HDP>(sm.dout[0], &tdo, &sm.q_full, q0, b * H + h);
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

  // consumer warpgroup: rows r0 and r0 + 8 of the q tile
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  const size_t qoff = (size_t)(b * H + h) * T_;
  int sq[2] = {0, 0};
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < T_;
    lse2[i] = in ? lse[qoff + row[i]] * kLog2e : 0.f;
    dl[i] = in ? delta[qoff + row[i]] : 0.f;
    if (seg_q) sq[i] = in ? __ldg(seg_q + (size_t)b * T_ + row[i]) : -1;
  }
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

    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
    wgmma_ss<HDP>(sc, sm.q[0], sm.k[s][0]);       // S = Q K^T
    wgmma_ss<HDP>(dp, sm.dout[0], sm.v[s][0]);    // dP = dO V^T
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // p, masked where a tile needs it (one uniform branch, as in the
    // forward), then ds
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = exp2f(sc[e] * scale_log2 - lse2[acc_row(e) ? 1 : 0]);
    const bool seg = seg_q && sm.mixed[s];
    if (seg || k0 + kRows > S || (causal && k0 + kRows - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = acc_row(e) ? 1 : 0, c = acc_col(e, lane);
        if (k0 + c >= S || (causal && k0 + c > row[i]) ||
            (seg && sm.seg[s][c] != sq[i]))
          sc[e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = acc_row(e) ? 1 : 0;
      dp[e] = sc[e] * (dp[e] - dl[i]) * scale;    // ds
    }

    uint32_t dh[4][4], dlo[4][4];
    split_frags(dp, dh, dlo);
    fence_regs(acc);
    wg_fence();
    wgmma_rs<HDP>(acc, dh, sm.k[s][0]);           // dQ += dS K
    wgmma_rs<HDP>(acc, dlo, sm.k[s][0]);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&sm.empty[s]);
  }
  store_acc<HDP>(dq + qoff * hd, T_, hd, q0 + r0, acc, 1.f, 1.f);
  record_walk(walked, it);
}

template <int HDP>
struct DkvSmem {
  bf16 k[HDP / 64][kRows * 64];               // resident
  bf16 v[HDP / 64][kRows * 64];
  bf16 q[kStages][HDP / 64][kRows * 64];      // the ring
  bf16 dout[kStages][HDP / 64][kRows * 64];
  float lse2[kStages][kRows];   // the stage's rows: lse * log2(e)
  float delta[kStages][kRows];
  int seg[kStages][kRows];      // their ids (segment mode)
  int tile[kStages];            // the stage's q tile; -1 ends the walk
  int mixed[kStages];           // 1: its ids and the keys' differ
  uint64_t kv_full, full[kStages], empty[kStages];
};

template <int HDP>
__global__ void __launch_bounds__(sm90::kBlockThreads, 1)
flash_dkv_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ seg_q, const int* __restrict__ seg_k,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
               int T_, int S, int hd, int causal, float scale,
               float scale_log2, int* __restrict__ walked) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<HDP>& sm = smem_as<DkvSmem<HDP>>(smem_raw);
  const int jt = blockIdx.x, k0 = jt * kRows;   // kv tile 0 (longest) first
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int lane = threadIdx.x & 31;
  const int nq = (T_ + kRows - 1) / kRows;
  // under the causal mask q rows before k0 see none of this tile's keys
  const int i0 = causal ? jt : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warp: k and v once, then for each q head of the group the
    // walked q tiles (q, do, and their rows' lse, delta and ids) through
    // the ring, then an end marker
    if (lane == 0) {
      mbar_arrive_tx(&sm.kv_full, 2 * (HDP / 64) * kHalfBytes);
      tma_tile<HDP>(sm.k[0], &tk, &sm.kv_full, k0, b * KV + kvh);
      tma_tile<HDP>(sm.v[0], &tv, &sm.kv_full, k0, b * KV + kvh);
    }
    int2 kr = make_int2(0, 0);
    if (seg_k) kr = warp_seg_range(seg_k + (size_t)b * S, S, k0);
    Ring ring{sm.empty};
    for (int g = 0; g < G; ++g) {
      const int head = b * H + kvh * G + g;
      for (int i0b = i0; i0b < nq; i0b += kBatch) {
        // in segment mode, the q tiles whose ids miss the kv tile's are
        // skipped
        int2 qid[kBatch];
        unsigned mixed = 0;
        const unsigned walk =
            seg_q ? walk_batch(seg_q + (size_t)b * T_, T_, i0b, nq, kr, qid,
                               mixed)
                  : walk_all(i0b, nq);
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          if (!((walk >> t) & 1)) continue;
          const int qi = i0b + t, q0 = qi * kRows, s = ring.next(kStages);
#pragma unroll
          for (int r = lane; r < kRows; r += 32) {
            const bool in = q0 + r < T_;
            const size_t at = (size_t)head * T_ + q0 + r;
            sm.lse2[s][r] = in ? lse[at] * kLog2e : 0.f;
            sm.delta[s][r] = in ? delta[at] : 0.f;
          }
          if (seg_q) {
            sm.seg[s][lane] = qid[t].x;
            sm.seg[s][lane + 32] = qid[t].y;
          }
          if (lane == 0) {
            sm.tile[s] = qi;
            sm.mixed[s] = (mixed >> t) & 1;
            mbar_arrive_tx(&sm.full[s], 2 * (HDP / 64) * kHalfBytes);
            tma_tile<HDP>(sm.q[s][0], &tq, &sm.full[s], q0, head);
            tma_tile<HDP>(sm.dout[s][0], &tdo, &sm.full[s], q0, head);
          } else {
            mbar_arrive(&sm.full[s]);
          }
        }
      }
    }
    const int s = ring.next(kStages);
    if (lane == 0) sm.tile[s] = -1;
    mbar_arrive(&sm.full[s]);
    return;
  }

  // consumer warpgroup: keys r0 and r0 + 8 of the kv tile are its rows,
  // the q tile's rows its columns
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int key[2] = {k0 + r0, k0 + r0 + 8};
  int sk[2] = {0, 0};
  if (seg_k)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sk[i] = key[i] < S ? __ldg(seg_k + (size_t)b * S + key[i]) : -1;
  float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
  for (int e = 0; e < HDP / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  mbar_wait(&sm.kv_full, 0);

  int it = 0;   // the tiles walked
  for (;; ++it) {
    const int s = it % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const int qi = sm.tile[s];
    if (qi < 0) break;
    const int q0 = qi * kRows;

    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
    wgmma_ss<HDP>(sc, sm.k[0], sm.q[s][0]);       // S^T = K Q^T
    wgmma_ss<HDP>(dp, sm.v[0], sm.dout[s][0]);    // dP^T = V dO^T
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // p (rows are keys, columns q rows: lse and delta by column), masked
    // where a tile needs it (one uniform branch, as in the forward), then
    // ds
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = exp2f(sc[e] * scale_log2 - sm.lse2[s][acc_col(e, lane)]);
    const bool seg = seg_q && sm.mixed[s];
    if (seg || q0 + kRows > T_ || (causal && k0 + kRows - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = acc_row(e) ? 1 : 0, c = acc_col(e, lane);
        if (q0 + c >= T_ || (causal && key[i] > q0 + c) ||
            (seg && sm.seg[s][c] != sk[i]))
          sc[e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = sc[e] * (dp[e] - sm.delta[s][acc_col(e, lane)]) * scale;  // ds

    uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
    split_frags(sc, ph, pl);
    split_frags(dp, dh, dlo);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
    wgmma_rs<HDP>(dv_acc, ph, sm.dout[s][0]);     // dV += P^T dO
    wgmma_rs<HDP>(dv_acc, pl, sm.dout[s][0]);
    wgmma_rs<HDP>(dk_acc, dh, sm.q[s][0]);        // dK += dS^T Q
    wgmma_rs<HDP>(dk_acc, dlo, sm.q[s][0]);
    wg_commit();
    wg_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&sm.empty[s]);
  }
  const size_t kvoff = (size_t)(b * KV + kvh) * S;
  store_acc<HDP>(dk + kvoff * hd, S, hd, k0 + r0, dk_acc, 1.f, 1.f);
  store_acc<HDP>(dv + kvoff * hd, S, hd, k0 + r0, dv_acc, 1.f, 1.f);
  record_walk(walked, it);
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, const int* seg_q,
                const int* seg_k, void* dq, void* dk, void* dv, int B, int H,
                int KV, int T_, int S, int hd, int causal, float scale,
                cudaStream_t stream, int* walked) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = sm90::head_map(&mq, q, B * H, T_, hd);
  if (err == cudaSuccess) err = sm90::head_map(&mdo, dout, B * H, T_, hd);
  if (err == cudaSuccess) err = sm90::head_map(&mk, k, B * KV, S, hd);
  if (err == cudaSuccess) err = sm90::head_map(&mv, v, B * KV, S, hd);
  if (err != cudaSuccess) return err;
  const int dq_smem = sm90::smem_bytes<DqSmem<HDP>>();
  const int dkv_smem = sm90::smem_bytes<DkvSmem<HDP>>();
  err = cudaFuncSetAttribute(flash_dq_bf16<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dkv_bf16<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem);
  if (err != cudaSuccess) return err;
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  const float scale_log2 = scale * sm90::kLog2e;
  dim3 gq((T_ + kRows - 1) / kRows, H, B);
  flash_dq_bf16<HDP><<<gq, sm90::kBlockThreads, dq_smem, stream>>>(
      mq, mk, mv, mdo, lp, dlp, seg_q, seg_k, static_cast<bf16*>(dq), H, KV,
      T_, S, hd, causal, scale, scale_log2, walked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv((S + kRows - 1) / kRows, KV, B);
  flash_dkv_bf16<HDP><<<gkv, sm90::kBlockThreads, dkv_smem, stream>>>(
      mq, mk, mv, mdo, lp, dlp, seg_q, seg_k, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, T_, S, hd, causal, scale, scale_log2,
      walked ? walked + (size_t)gq.x * gq.y * gq.z : nullptr);
  return cudaGetLastError();
}

}  // namespace

// q, do [B, H, T, hd]; k, v [B, KV, S, hd]; lse, delta [B, H, T] f32;
// seg_q [B, T] and seg_k [B, S] int32, both null outside segment mode;
// dq like q, dk and dv like k. All contiguous. walked: null, or int32
// [B * H * ceil(T / 64) + B * KV * ceil(S / 64)], where every dq block
// records the kv tiles it walked and then every dk/dv block the q tiles.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* seg_q, const void* seg_k,
                                   void* dq, void* dk, void* dv, int B, int H,
                                   int KV, int T_, int S, int hd, int causal,
                                   float scale, int dtype, void* stream,
                                   void* walked) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(walked);
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H % KV || hd % 8 || hd < 8 ||
      hd > kMaxHD || B > 65535 || H > 65535 || (!seg_q != !seg_k))
    return cudaErrorInvalidValue;
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  if (dtype == DTYPE_BF16)
    return hd <= 64
               ? launch_bf16<64>(q, k, v, dout, lse, delta, sq, sk, dq, dk,
                                 dv, B, H, KV, T_, S, hd, causal, scale, s, w)
               : launch_bf16<128>(q, k, v, dout, lse, delta, sq, sk, dq, dk,
                                  dv, B, H, KV, T_, S, hd, causal, scale, s,
                                  w);
  if (dtype == DTYPE_F32)
    return launch_f32(q, k, v, dout, lse, delta, sq, sk, dq, dk, dv, B, H, KV,
                      T_, S, hd, causal, scale, s, w);
  return cudaErrorInvalidValue;
}

// dynamic shared memory a bf16 block of the dq (which = 0) or the dk/dv
// kernel (which = 1) takes at this head_dim, for the build log
extern "C" int flash_attention_bwd_smem(int hd, int which) {
  if (hd <= 64)
    return which ? sm90::smem_bytes<DkvSmem<64>>()
                 : sm90::smem_bytes<DqSmem<64>>();
  return which ? sm90::smem_bytes<DkvSmem<128>>()
               : sm90::smem_bytes<DqSmem<128>>();
}

// 64 x 64 x head_dim products a bf16 block of the dq (which = 0) or the
// dk/dv kernel (which = 1) issues per walked tile pair: dq S = Q K^T, dP =
// dO V^T and dS K twice (dS as hi and lo); dk/dv S^T, dP^T, and P^T dO and
// dS^T Q twice each
extern "C" int flash_attention_bwd_products(int which) {
  return which ? 6 : 4;
}
