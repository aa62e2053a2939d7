// The activations of the GEMM epilogue (A8) and the GLU (A9), in f32, as
// the reference's `_EPI_ACTS` (paddle_tpu/ops/pallas/fused_ffn.py):
// jax.nn.gelu defaults to its tanh form, jax.nn.silu is x * sigmoid(x).
// The codes are the wrapper's ACT_CODE.
#pragma once

#define ACT_NONE 0
#define ACT_RELU 1
#define ACT_GELU 2
#define ACT_SILU 3
#define ACT_SIGMOID 4

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(z, 0.f);
    case ACT_GELU:
      return 0.5f * z *
             (1.f + tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z)));
    case ACT_SILU:
      return z / (1.f + expf(-z));
    case ACT_SIGMOID:
      return 1.f / (1.f + expf(-z));
    default:
      return z;
  }
}
