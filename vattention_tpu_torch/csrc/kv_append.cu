// Kernel A: scatter one step's K/V rows into the arena, converting them to
// the arena's storage type.
//
// Replaces the TPU kernels cache_append_tokens (_rmw_batch_kernel) and
// cache_append_run (_rmw_run_kernel) of vattention_tpu/ops/cache_append.py,
// with the quantization the JAX backend runs in XLA just before them
// (vattn_backend.py: _flush_fp8_subnormals, _quantize_int8).  Token t's K
// and V rows (Hkv x D each, float32 or bfloat16, the model's type) go to
// arena row rows[t] of layer `layer`; rows[t] == -1 skips the token
// (prefill padding, idle slots).  Rows are distinct within a step, so every
// write is a plain store: the TPU's 32-row read-modify-write windows have
// no counterpart here.  Storage:
//   the model's own type: the rows are copied;
//   e4m3: |x| < 15 * 2^-10 is flushed to zero (no denormal pattern is
//     stored), the rest rounds to nearest even with saturation at +-448
//     (the JAX package's astype gives NaN past 464), in integer
//     arithmetic on the float's bits;
//   int8: clip(rint(x / kv_scale), -127, 127), an IEEE division.
//
// Bound: bytes.  Each valid token reads 2*Hkv*D elements of its type and
// writes them once in the arena's.
// Design: one block per (token, K/V); each thread writes 16-byte vectors,
// consecutive threads on consecutive addresses of one destination row
// (a 1-byte vector quantizes 16 source values).
#include "common.cuh"

using namespace vattn;

namespace {

constexpr float kFp8Cutoff = 15.f / 1024.f;   // 15 * 2^-10
constexpr float kFp8MinNormal = 1.f / 64.f;   // 2^-6
constexpr float kInt8Clip = 127.f;

// the arena's 1-byte storage codes
// e4m3: |x| below the cutoff flushes to zero; from the cutoff (the
// midpoint between e4m3's largest denormal and least normal) up to the
// least normal rounds to the least normal; above it, round to nearest even
// on the float's bits (carry into the exponent included) and saturate at
// 448 (0x7E).  The same function as the plain version's cast after its
// flush, bit for bit: no e4m3 denormal is ever stored.
struct ToFp8 {
  static __device__ __forceinline__ uint32_t one(float x) {
    const uint32_t u = __float_as_uint(x);
    const uint32_t a = u & 0x7FFFFFFFu;
    const float ax = __uint_as_float(a);
    if (ax < kFp8Cutoff) return 0u;
    uint32_t b = 0x08u;  // 2^-6
    if (ax >= kFp8MinNormal) {
      const uint32_t r = a + 0x7FFFFu + ((a >> 20) & 1u);  // RNE at bit 20
      b = min((r >> 20) - (120u << 3), 0x7Eu);  // rebias 127 -> 7
    }
    return b | ((u >> 24) & 0x80u);
  }
  __device__ __forceinline__ uint32_t pack2(float a, float b) const {
    return one(a) | (one(b) << 8);
  }
};
struct ToInt8 {
  float scale;
  __device__ __forceinline__ uint32_t one(float x) const {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kInt8Clip), kInt8Clip);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
  }
  __device__ __forceinline__ uint32_t pack2(float a, float b) const {
    return one(a) | (one(b) << 8);
  }
};

// 16 source values (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 x = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[8 * i + 2 * j] = v.x;
      f[8 * i + 2 * j + 1] = v.y;
    }
  }
}

// the model's own type: 16-byte copies
__global__ void kv_copy_kernel(uint4* cache, const uint4* __restrict__ k,
                               const uint4* __restrict__ v,
                               const int* __restrict__ rows, int hkv,
                               int row_vecs, long long rows_total,
                               int layer) {
  const int t = blockIdx.x;
  const int kv = blockIdx.y;
  const int row = rows[t];
  if (row < 0) return;
  const uint4* src = (kv == 0 ? k : v) + static_cast<long long>(t) * hkv * row_vecs;
  const long long head_stride = rows_total * row_vecs;
  uint4* dst = cache + static_cast<long long>(layer * 2 + kv) * hkv * head_stride +
               static_cast<long long>(row) * row_vecs;
  for (int i = threadIdx.x; i < hkv * row_vecs; i += blockDim.x) {
    const int h = i / row_vecs;
    const int c = i - h * row_vecs;
    dst[h * head_stride + c] = src[i];
  }
}

// 1-byte storage: each 16-byte store quantizes 16 source values
template <typename Src, typename Quant>
__global__ void kv_quantize_kernel(uint4* cache, const Src* __restrict__ k,
                                   const Src* __restrict__ v,
                                   const int* __restrict__ rows, int hkv,
                                   int head_dim, long long rows_total,
                                   int layer, Quant quant) {
  const int t = blockIdx.x;
  const int kv = blockIdx.y;
  const int row = rows[t];
  if (row < 0) return;
  const int row_vecs = head_dim / 16;
  const Src* src = (kv == 0 ? k : v) + static_cast<long long>(t) * hkv * head_dim;
  const long long head_stride = rows_total * row_vecs;
  uint4* dst = cache + static_cast<long long>(layer * 2 + kv) * hkv * head_stride +
               static_cast<long long>(row) * row_vecs;
  for (int i = threadIdx.x; i < hkv * row_vecs; i += blockDim.x) {
    const int h = i / row_vecs;
    const int c = i - h * row_vecs;
    float f[16];
    load16(src + 16 * i, f);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = quant.pack2(f[4 * j], f[4 * j + 1]) |
             (quant.pack2(f[4 * j + 2], f[4 * j + 3]) << 16);
    dst[h * head_stride + c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename Quant>
int launch_quantize(int src_dtype, const dim3& grid, cudaStream_t s,
                    void* cache, const void* k, const void* v,
                    const int* rows, int hkv, int head_dim,
                    long long rows_total, int layer, Quant quant) {
  if (src_dtype == kFloat32)
    kv_quantize_kernel<float, Quant><<<grid, 128, 0, s>>>(
        static_cast<uint4*>(cache), static_cast<const float*>(k),
        static_cast<const float*>(v), rows, hkv, head_dim, rows_total, layer,
        quant);
  else if (src_dtype == kBFloat16)
    kv_quantize_kernel<__nv_bfloat16, Quant><<<grid, 128, 0, s>>>(
        static_cast<uint4*>(cache), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), rows, hkv, head_dim,
        rows_total, layer, quant);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cache: [L, 2, Hkv, rows_total, head_dim] of kv_dtype; k, v: [num_tokens,
// Hkv, head_dim] of src_dtype (float32 or bfloat16); rows: [num_tokens]
// int32.  kv_dtype is src_dtype (a copy), e4m3 or int8 (kv_scale: the
// int8 step); head_dim a multiple of 16.
extern "C" int vattn_kv_append(void* cache, const void* k, const void* v,
                               const int* rows, int num_tokens, int hkv,
                               int head_dim, long long rows_total, int layer,
                               int src_dtype, int kv_dtype, float kv_scale,
                               void* stream) {
  if (num_tokens <= 0) return 0;
  if (head_dim % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_tokens, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kFloat8E4M3)
    return launch_quantize(src_dtype, grid, s, cache, k, v, rows, hkv,
                           head_dim, rows_total, layer, ToFp8{});
  if (kv_dtype == kInt8)
    return launch_quantize(src_dtype, grid, s, cache, k, v, rows, hkv,
                           head_dim, rows_total, layer, ToInt8{kv_scale});
  if (kv_dtype != src_dtype || (src_dtype != kFloat32 && src_dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_vecs = head_dim * (src_dtype == kFloat32 ? 4 : 2) / 16;
  kv_copy_kernel<<<grid, 128, 0, s>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(k),
      static_cast<const uint4*>(v), rows, hkv, row_vecs, rows_total, layer);
  return static_cast<int>(cudaGetLastError());
}
