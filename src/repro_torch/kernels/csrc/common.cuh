// Device helpers shared by the port's attention kernels (flash_attention.cu,
// paged_attention.cu): fp32 conversion of the storage types (float, bf16,
// and the int8 codes of quantized pages), warp reductions and vector loads.  Each .cu file builds into its own library,
// so everything here has internal linkage.  kernels/build.py hashes this
// header together with every source, so a change here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// N consecutive elements starting at p (aligned to N elements) -> fp32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x; out[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// N consecutive int8 codes starting at p (aligned to N bytes) -> fp32.
template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float* out) {
  if constexpr (N == 16 || N == 8 || N == 4 || N == 2) {
    using V = std::conditional_t<N == 16, uint4,
              std::conditional_t<N == 8, uint2,
              std::conditional_t<N == 4, uint32_t, uint16_t>>>;
    const V t = *reinterpret_cast<const V*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(c[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(p[i]);
  }
}

}  // namespace
