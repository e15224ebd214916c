// Kernel C: batched GQA decode attention over the contiguous KV arena, one
// launch per call.
//
// Replaces the TPU kernel flash_decode (_decode_kernel) of
// vattention_tpu/ops/flash_decode.py.  Slot b's single query token (Hq
// heads) attends arena rows of positions [0, seqlens[b]), or under a
// sliding window [max(0, seqlens[b] - window), seqlens[b]); position p lives
// at arena row tile_rows[b, p / sub] + p % sub (the host-resolved extent
// table, ops/utils.tile_rows_from_segments).  Slots with seqlens[b] == 0
// write zeros.  Queries and outputs float32 or bfloat16; the arena that
// type, or 1-byte e4m3 or int8 widened exactly in the kernel (the TPU
// kernel's upcast_kv); arithmetic float32.
//
// Bound: bytes.  The kernel reads each live K and V row once (2*Hkv*D
// elements per position) and the queries once; its arithmetic is ~2G
// FLOPs per byte, far below the card's ridge point.
// Design: decode_attention.cuh's body (shared with kernel F) on a fixed
// grid of `nblocks` blocks of 128 threads (the wrapper gives twice the SM
// count: two blocks fit an SM): each block plans the splits over the
// slots' live depths from seqlens on the device, streams its ranges'
// 64-position K/V tiles through per-warp cp.async rings into tensor-core
// products (bf16), and the last split of each (slot, head) merges the
// splits inside the launch.
#include "decode_attention.cuh"

using namespace vattn;

namespace {

template <typename T, typename KV, int G>
__global__ void __launch_bounds__(decode::kThreads) decode_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ cache, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets,
    const int* __restrict__ tile_rows, const int* __restrict__ seqlens,
    int batch, int hkv, int group, int n_sub, int sub, long long rows_total,
    int layer, float sm_scale, int window) {
  extern __shared__ __align__(128) unsigned char dec_smem[];
  decode::decode_blocks<T, KV, G>(q, cache, out, part, tickets, tile_rows,
                                  seqlens, batch, hkv, group, n_sub, sub,
                                  rows_total, layer, sm_scale, window,
                                  blockIdx.x, gridDim.x, dec_smem);
}

template <typename T, typename KV, int G>
int launch(const void* q, const void* cache, void* out, float* part,
           int* tickets, const int* tile_rows, const int* seqlens, int batch,
           int hkv, int group, int n_sub, int sub, long long rows_total,
           int layer, float sm_scale, int window, int nblocks,
           cudaStream_t stream) {
  constexpr int smem = decode::kSmemBytes<T, KV>;
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, KV, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attention_kernel<T, KV, G><<<nblocks, decode::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      static_cast<T*>(out), part, tickets, tile_rows, seqlens, batch, hkv,
      group, n_sub, sub, rows_total, layer, sm_scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int dispatch_group(int group, const void* q, const void* cache, void* out,
                   float* part, int* tickets, const int* tile_rows,
                   const int* seqlens, int batch, int hkv, int n_sub, int sub,
                   long long rows_total, int layer, float sm_scale,
                   int window, int nblocks, cudaStream_t s) {
  switch (decode::chunk_width(group)) {
#define VATTN_DECODE_CHUNK(C)                                                 \
  case C:                                                                     \
    return launch<T, KV, C>(q, cache, out, part, tickets, tile_rows, seqlens, \
                            batch, hkv, group, n_sub, sub, rows_total, layer, \
                            sm_scale, window, nblocks, s);
    VATTN_DECODE_CHUNK(1)
    VATTN_DECODE_CHUNK(2)
    VATTN_DECODE_CHUNK(4)
    VATTN_DECODE_CHUNK(8)
#undef VATTN_DECODE_CHUNK
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [batch, Hkv*group, 128] of dtype; cache: [L, 2, Hkv, rows_total,
// 128] of kv_dtype (dtype, e4m3 or int8);
// tile_rows: [batch, n_sub] int32 (each slot's table as deep as its
// seqlen); seqlens: [batch] int32; group (Hq/Hkv) >= 1, in chunks of C =
// decode::chunk_width(group) heads, NC = cdiv(group, C) per kv head; part:
// float32 scratch, 16-byte aligned, of (nblocks + batch * Hkv * NC) *
// decode::kPartFloats<C> (C * 130, rounded up to a multiple of 4)
// elements; tickets: batch * Hkv * NC int32 counters, 0 before the launch
// and 0 after it; window: the sliding window (0: none).  batch at most 1024
// and nblocks at most 1024.
extern "C" int vattn_decode_attention(const void* q, const void* cache,
                                      void* out, void* part, int* tickets,
                                      const int* tile_rows,
                                      const int* seqlens, int batch, int hkv,
                                      int group, int n_sub, int sub,
                                      long long rows_total, int layer,
                                      float sm_scale, int window, int nblocks,
                                      int dtype, int kv_dtype, void* stream) {
  if (batch <= 0) return 0;
  if (batch > decode::kMaxSlots || nblocks <= 0 || group <= 0 ||
      nblocks > decode::kMaxGrid || sub <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
#define VATTN_DECODE(T, KV)                                                   \
  dispatch_group<T, KV>(group, q, cache, out, p, tickets, tile_rows, seqlens, \
                        batch, hkv, n_sub, sub, rows_total, layer, sm_scale,  \
                        window, nblocks, s)
  if (dtype != kFloat32 && dtype != kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kFloat32;
  if (kv_dtype == dtype)
    return f32 ? VATTN_DECODE(float, float) : VATTN_DECODE(__nv_bfloat16, __nv_bfloat16);
  if (kv_dtype == kFloat8E4M3)
    return f32 ? VATTN_DECODE(float, fp8) : VATTN_DECODE(__nv_bfloat16, fp8);
  if (kv_dtype == kInt8)
    return f32 ? VATTN_DECODE(float, int8_t) : VATTN_DECODE(__nv_bfloat16, int8_t);
#undef VATTN_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory per block of the body for `dtype` over `kv_dtype`
// (chip_smoke's ptxas report)
extern "C" int vattn_decode_smem_bytes(int dtype, int kv_dtype) {
  const bool narrow = kv_dtype == kFloat8E4M3 || kv_dtype == kInt8;
  if (dtype == kBFloat16)
    return narrow ? decode::kSmemBytes<__nv_bfloat16, fp8>
                  : decode::kSmemBytes<__nv_bfloat16, __nv_bfloat16>;
  return narrow ? decode::kSmemBytes<float, fp8> : decode::kSmemBytes<float, float>;
}
