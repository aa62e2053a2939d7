// Shared helpers for the port's CUDA kernels (plain C interface, no
// PyTorch headers). Element types are selected at run time by a dtype
// code the Python wrapper passes: 0 = float32, 1 = bfloat16. int8
// weights and pages are read through the int8 vectors below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define DTYPE_F32 0
#define DTYPE_BF16 1

// Every library exports the CUDA error text for the codes its entries
// return, so the wrapper can raise a readable error.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// byte i (0..3) of a 32-bit word as a signed int8, widened to float; the
// shifts keep the word in a register (a byte pointer into it would not)
__device__ __forceinline__ float int8_lane(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Eight consecutive elements of T, moved as 16-byte words: one uint4 for
// bf16, two for float32. The address must be 16-byte aligned.
template <typename T>
struct Vec8 {
  static constexpr int kWords = sizeof(T) * 8 / 16;
  uint4 w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(src + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void to_floats(float* out) const {
    const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_float(e[i]);
  }
};

// Eight int8 elements, moved as one 8-byte word (int8 KV pages). The
// address must be 8-byte aligned.
template <>
struct Vec8<int8_t> {
  uint2 w;

  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint2(0, 0); }
  __device__ __forceinline__ void to_floats(float* out) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = int8_lane(w.x, i);
      out[4 + i] = int8_lane(w.y, i);
    }
  }
};

// Sixteen int8 elements, moved as one 16-byte word (int8 weights). The
// address must be 16-byte aligned.
struct Int8x16 {
  uint4 w;

  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0, 0, 0, 0); }
  // widen to f32 and store 16 floats at a 16-byte aligned address
  __device__ __forceinline__ void store_floats(float* dst) const {
    float4* d = reinterpret_cast<float4*>(dst);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i] = make_float4(int8_lane(words[i], 0), int8_lane(words[i], 1),
                         int8_lane(words[i], 2), int8_lane(words[i], 3));
  }
};
