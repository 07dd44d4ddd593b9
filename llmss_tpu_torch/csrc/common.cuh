// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace llmss {

// Masked lanes hold the finite fp32 minimum, never -inf: exp() of a masked
// score against a real row max underflows to exactly 0, and a row that is
// masked everywhere in a live tile degrades to a uniform average instead
// of NaN (same convention as llmss_tpu/ops/attention.py and the Pallas
// kernels).
constexpr float kNegInf = -FLT_MAX;

// dtype codes shared with the Python wrappers (ops/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

// An int8 KV cache stores value = int8 * scale, one fp32 scale per (slot,
// KV head); the decode kernels read the raw int8 and fold the scales in.
template <typename KV> constexpr bool kQuant = sizeof(KV) == 1;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// Round an fp32 value through T (the Pallas kernels cast P to the value
// dtype before the P.V product).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Eight consecutive elements read with 16-byte loads (two for fp32).
// The pointer must be 16-byte aligned.
template <typename T> struct Vec8 {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_float(float out[8]) const {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_f<T>(e[i]);
  }
};

template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void to_float(float out[8]) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// Eight int8 values (a lane's 8 bytes of an int8 KV row, read back from
// the lane template's ring), widened to fp32 without a conversion
// instruction (I2F runs at a quarter of the FMA rate or less): byte x ^
// 0x80 (x + 128) as the low byte of the fp32 2^23 + x + 128, minus 2^23 +
// 128, is x, exactly (attn_tile_i8.cuh widen16's fp32 step).
template <> struct Vec8<int8_t> {
  uint2 raw;
  __device__ __forceinline__ void to_float(float out[8]) const {
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650 + b)) - 8388736.f;
    }
  }
};

}  // namespace llmss
