// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd` (`_dq_kernel`
// :280 and `_dkv_kernel` :326, pallas_calls at :414 and :459) — kernel A2,
// the gradient of A1 in the training step.
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
// the key's segments differ, as in the forward; the tiles walked are the
// same as without segments.
//
// Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
// causal, the backward needs five products per visible (row, key) pair
// (q k^T, do v^T, dq, dk, dv): 171.9 GFLOP, 0.174 ms at 989 TFLOP/s,
// against 269 MB moved. These kernels do seven, 240.6 GFLOP: the dq and
// the dk/dv kernel each recompute q k^T and do v^T, 1.4x the bound's work.
//
// Design. Two kernels, one launch each, as the reference has two
// pallas_calls; nothing crosses blocks, so there are no atomics and the
// gradients are the same on every run:
//   - dq: one block per (batch, head, 64-row q tile) walks the kv tiles up
//     to the diagonal; per tile it recomputes the scores and do v^T in one
//     pass over head_dim, forms ds in registers, stages it in shared memory
//     and accumulates ds k into its 4 x 8 output patch (180 KB of tiles);
//   - dk/dv: one block per (batch, kv head, 64-key kv tile) walks the G q
//     heads of its group and, for each, the q tiles from the diagonal down;
//     it keeps k^T and v^T resident and accumulates p^T do and ds^T q
//     (224 KB of tiles, one block per SM).
// f32 tiles, FMAs on the CUDA cores; tensor cores are later work.
#include "flash_tiles.cuh"

using namespace flash;

namespace {

constexpr int kDqSmemFloats = 5 * kMaxHD * kTile + kTile * kTile;
constexpr int kDkvSmemFloats = 6 * kMaxHD * kTile + 2 * kTile * kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                T* __restrict__ dq, int H, int KV, int T_, int S, int hd,
                int causal, float scale) {
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
  const T* kb = k + (size_t)(b * KV + kvh) * S * hd;
  const T* vb = v + (size_t)(b * KV + kvh) * S * hd;

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

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
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
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
                 int T_, int S, int hd, int causal, float scale) {
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

  for (int g = 0; g < G; ++g) {
    const size_t qoff = (size_t)(b * H + kvh * G + g) * T_;
    for (int qi = i0; qi < nq; ++qi) {
      const int q0 = qi * kTile;
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
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const int* seg_q,
           const int* seg_k, void* dq, void* dk, void* dv, int B, int H,
           int KV, int T_, int S, int hd, int causal, float scale,
           cudaStream_t stream) {
  const int dq_smem = kDqSmemFloats * sizeof(float);
  const int dkv_smem = kDkvSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  dim3 gq((T_ + kTile - 1) / kTile, H, B);
  flash_dq_kernel<T><<<gq, kThreads, dq_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, seg_q, seg_k, static_cast<T*>(dq), H, KV, T_,
      S, hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gkv((S + kTile - 1) / kTile, KV, B);
  flash_dkv_kernel<T><<<gkv, kThreads, dkv_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, seg_q, seg_k, static_cast<T*>(dk),
      static_cast<T*>(dv), H, KV, T_, S, hd, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, do [B, H, T, hd]; k, v [B, KV, S, hd]; lse, delta [B, H, T] f32;
// seg_q [B, T] and seg_k [B, S] int32, both null outside segment mode;
// dq like q, dk and dv like k. All contiguous.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* seg_q, const void* seg_k,
                                   void* dq, void* dk, void* dv, int B, int H,
                                   int KV, int T_, int S, int hd, int causal,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H % KV || hd % 8 || hd < 8 ||
      hd > kMaxHD || B > 65535 || H > 65535 || (!seg_q != !seg_k))
    return cudaErrorInvalidValue;
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, sq, sk, dq, dk, dv,
                                 B, H, KV, T_, S, hd, causal, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, dout, lse, delta, sq, sk, dq, dk, dv, B, H,
                         KV, T_, S, hd, causal, scale, s);
  return cudaErrorInvalidValue;
}
