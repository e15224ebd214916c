// Shared helpers of the port's CUDA kernels (sm_90a, plain C entry points).
//
// Every kernel library built from this directory exports its launcher with
// C linkage and returns the cudaError_t of the launch as an int, so the
// Python wrapper (vattention_tpu_torch/ops/cuda_build.py) can raise on a
// refused launch.  Types: float32 and bfloat16 storage, float32 arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vattn {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// The JAX reference's finite mask value (ops/utils.py: -0.7 * f32 max).
// Finite, so a fully masked row never produces inf - inf = NaN.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace vattn

extern "C" const char* vattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
