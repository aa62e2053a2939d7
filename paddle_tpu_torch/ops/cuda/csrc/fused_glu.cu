// Gated-activation epilogue for Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_ffn.py `fused_glu` (`_glu_kernel`
// :586, pallas_call at :611) — kernel A9, the swiglu / geglu half of the
// fused op `fused_bias_act` (ops/kernels/fused_ops.py).
//
// What it computes: out = act(u) * v in f32, rounded once to u's type,
// for u, v [rows, f] (bf16 or f32). u and v are the two halves of one
// [rows, 2f] tensor, so they come in as strided rows: `ld` elements from
// one row's start to the next, no contiguous copy made.
//
// Bound on the H100: bytes. At 4,096 x 11,008 in bf16 it reads u and v and
// writes out once, 271 MB, 0.081 ms at 3.35 TB/s; it does ~20 operations
// an element.
//
// Design. One pass over 8-element chunks: each thread reads 16 bytes of u
// and of v (two 16-byte words each for f32), computes in registers and
// writes 16 bytes, neighbouring threads on neighbouring chunks of a row.
// A row whose length or stride is not a multiple of 16 bytes (`vec` = 0)
// is read element by element.
#include "activation.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
glu_kernel(const T* __restrict__ u, const T* __restrict__ v,
           T* __restrict__ out, int rows, int f, int ld, int act,
           int vec) {
  const int chunks = (f + 7) / 8;
  const long long total = (long long)rows * chunks;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const T* ur = u + (size_t)r * ld;
    const T* vr = v + (size_t)r * ld;
    T* o = out + (size_t)r * f;
    if (vec && c + 8 <= f) {
      Vec8<T> a, b;
      a.load(ur + c);
      b.load(vr + c);
      float fa[8], fb[8];
      a.to_floats(fa);
      b.to_floats(fb);
      Vec8<T> res;
      T* e = reinterpret_cast<T*>(res.w);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = from_float<T>(apply_act(fa[i], act) * fb[i]);
      uint4* dst = reinterpret_cast<uint4*>(o + c);
#pragma unroll
      for (int i = 0; i < Vec8<T>::kWords; ++i) dst[i] = res.w[i];
    } else {
      for (int i = c; i < c + 8 && i < f; ++i)
        o[i] = from_float<T>(apply_act(to_float(ur[i]), act) *
                             to_float(vr[i]));
    }
  }
}

template <typename T>
int launch(const void* u, const void* v, void* out, int rows, int f,
           int ld, int act, int vec, cudaStream_t s) {
  const long long total = (long long)rows * ((f + 7) / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  glu_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(u),
                                           static_cast<const T*>(v),
                                           static_cast<T*>(out), rows, f, ld,
                                           act, vec);
  return cudaGetLastError();
}

}  // namespace

// u, v: rows of f elements, `ld` elements apart; out [rows, f] contiguous,
// all of `dtype`. vec: f, ld and both pointers allow 16-byte chunks.
extern "C" int fused_glu(const void* u, const void* v, void* out, int rows,
                         int f, int ld, int act, int vec, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || f < 1 || ld < f || act < ACT_NONE || act > ACT_SIGMOID)
    return cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(u, v, out, rows, f, ld, act, vec, s);
  if (dtype == DTYPE_F32)
    return launch<float>(u, v, out, rows, f, ld, act, vec, s);
  return cudaErrorInvalidValue;
}
