// Shared helpers of the port's CUDA kernels (sm_90a, plain C entry points).
//
// Every kernel library built from this directory exports its launcher with
// C linkage and returns the cudaError_t of the launch as an int, so the
// Python wrapper (vattention_tpu_torch/ops/cuda_build.py) can raise on a
// refused launch.  Types: float32 and bfloat16 compute and storage, and
// 1-byte K/V storage (e4m3 or int8) that the attention kernels widen
// exactly; float32 arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vattn {

// dtype codes shared with the Python wrappers (ops/cuda_build.py): compute
// dtypes, and the arena's storage dtypes (the compute codes and two more)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat8E4M3 = 2;
constexpr int kInt8 = 3;

using fp8 = __nv_fp8_e4m3;

// The JAX reference's finite mask value (ops/utils.py: -0.7 * f32 max).
// Finite, so a fully masked row never produces inf - inf = NaN.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(fp8 x) {  // exact
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(int8_t x) {  // exact
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---- exact widening of 1-byte K/V (4 values in a 32-bit word, the lowest
// byte first) to 4 bfloat16 (the first two in .x) or to 4 floats ------- //
// e4m3 -> bf16 with integer ops and one multiply per pair: each byte's
// exponent and mantissa land in its bf16 half's fields (bias 127 against
// e4m3's 7) and the sign at bit 15, then a bf16 multiply by 2^120 rebiases
// (exact: a power of two, and every e4m3 value, denormals included, is a
// bf16 normal after it).  NaN patterns do not stay NaN; kernel A never
// stores one.
__device__ __forceinline__ uint2 widen4_bf16(uint32_t w, fp8) {
  const uint32_t p = __byte_perm(w, 0u, 0x3120);  // bytes b0 b2 b1 b3
  const uint32_t lo = ((p & 0x007F007Fu) << 4) | ((p & 0x00800080u) << 8);
  const uint32_t hi = ((p & 0x7F007F00u) >> 4) | (p & 0x80008000u);
  const __nv_bfloat162 rebias = __halves2bfloat162(
      __ushort_as_bfloat16(0x7B80), __ushort_as_bfloat16(0x7B80));  // 2^120
  const __nv_bfloat162 a = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&lo), rebias);
  const __nv_bfloat162 b = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&hi), rebias);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}
// int8 -> float through the magic number 2^23: 0x4B000000 | (b + 128) is
// 2^23 + b + 128 exactly
__device__ __forceinline__ float4 widen4_f32(uint32_t w, int8_t) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  // byte k of u under the bytes 00 00 4B of the magic (selector 0x754k)
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kMagic,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kMagic,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kMagic,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kMagic);
}
__device__ __forceinline__ uint2 widen4_bf16(uint32_t w, int8_t tag) {
  const float4 f = widen4_f32(w, tag);  // |b| <= 128: exact in bf16
  const __nv_bfloat162 a = __floats2bfloat162_rn(f.x, f.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.z, f.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ float4 widen4_f32(uint32_t w, fp8 tag) {
  const uint2 b = widen4_bf16(w, tag);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// 16 values (one 16-byte chunk) to 16 bf16: values 0-7 in lo, 8-15 in hi
template <typename KV>
__device__ __forceinline__ void widen16_bf16(const uint4& x, uint4& lo,
                                             uint4& hi) {
  const uint2 a = widen4_bf16(x.x, KV{}), b = widen4_bf16(x.y, KV{});
  const uint2 c = widen4_bf16(x.z, KV{}), d = widen4_bf16(x.w, KV{});
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace vattn

extern "C" const char* vattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
