// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd` (`_fwd_kernel`
// :153, pallas_call at :264) — kernel A1, reached through
// `llama.attention` in the training step.
//
// What it computes: for q [B, H, T, hd] and k, v [B, KV, S, hd] (bf16 or
// f32; q head h reads kv head h / (H / KV)), o = softmax(q k^T * scale) v
// with an optional causal mask, in f32, written in q's type, and the f32
// log-sum-exp of every row, lse [B, H, T], which the backward (A2) reads.
// The reference's lse is [B, H, T, 8]: the lane broadcast is a Mosaic
// tiling artifact and is not carried over.
//
// Bound on the H100: operations. At B = 2, T = 2048, H = 32, hd = 128,
// causal, the two products take 68.7 GFLOP (0.070 ms at 989 TFLOP/s in
// bf16) against 135 MB of q, k, v, o and lse.
//
// Design. The TPU kernel walks the kv blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch. Here one block of 256 threads owns one
// (batch, head, 64-row q tile) and walks the 64-key kv tiles itself, up to
// the diagonal under the causal mask, so blocks above it are never touched
// and nothing crosses blocks: no atomics, the same result on every run
// (activation recompute relies on that). Tiles are staged in shared memory
// as f32 (q and k transposed, v row-major; 112 KB); each thread owns a
// 4 x 4 patch of the scores and a 4 x 8 patch of the output, the online
// softmax reduces over the 16 threads of a half-warp with shuffles, and the
// products are FMAs on the CUDA cores. Blocks are issued longest walk
// first. Tensor cores (mma.sync / wgmma), a K/V double buffer and bf16
// tiles are later work.
#include "flash_tiles.cuh"

using namespace flash;

namespace {

constexpr int kSmemFloats = 3 * kMaxHD * kTile + kTile * kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int T_, int S,
                 int hd, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // [kMaxHD][kTile]  q^T
  float* kt = qt + kMaxHD * kTile;     // [kMaxHD][kTile]  k^T
  float* vs = kt + kMaxHD * kTile;     // [kTile][kMaxHD]  v
  float* pt = vs + kTile * kMaxHD;     // [kTile kv][kTile q]  p^T

  const int nq = (T_ + kTile - 1) / kTile;
  const int q0 = (nq - 1 - blockIdx.x) * kTile;   // longest walk first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + (size_t)(b * H + h) * T_ * hd;
  const T* kb = k + (size_t)(b * KV + kvh) * S * hd;
  const T* vb = v + (size_t)(b * KV + kvh) * S * hd;

  load_tile_t(qb, T_, hd, q0, qt);
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

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile_t(kb, S, hd, k0, kt);
    load_tile_rm(vb, S, hd, k0, vs);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < hd; ++d)
      fma_4x4(s, ld4(qt + d * kTile + ty * 4), ld4(kt + d * kTile + tx * 4));

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        const bool ok = col < S && (!causal || col <= row);
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
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int KV, int T_, int S, int hd, int causal,
           float scale, cudaStream_t stream) {
  const int smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, KV, T_, S, hd, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, T, hd]; k, v [B, KV, S, hd]; o [B, H, T, hd] in q's type;
// lse [B, H, T] f32. All contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int KV, int T_, int S, int hd,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H % KV || hd % 8 || hd < 8 ||
      hd > kMaxHD || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, KV, T_, S, hd, causal,
                                 scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, o, lse, B, H, KV, T_, S, hd, causal, scale,
                         s);
  return cudaErrorInvalidValue;
}
