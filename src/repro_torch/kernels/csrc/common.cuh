// Shared helpers of the port's CUDA kernels: element loads and stores in
// the input dtype with float32 arithmetic, and 16-byte words of elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
  }
};

// The 16 / sizeof(T) elements of one 16-byte word, as floats and back
// (bf16 widens exactly and narrows by Elem's rounding).
template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(uint4 w, float* x) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(uint4 w, float* x) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);            // exact widening
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = (uint32_t)__bfloat16_as_ushort(
                 Elem<__nv_bfloat16>::store(x[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(
                  Elem<__nv_bfloat16>::store(x[2 * i + 1])) << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};
