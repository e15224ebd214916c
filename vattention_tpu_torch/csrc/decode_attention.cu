// Kernel C: batched GQA decode attention over the contiguous KV arena, one
// launch per call.
//
// Replaces the TPU kernel flash_decode (_decode_kernel) of
// vattention_tpu/ops/flash_decode.py.  Slot b's single query token (Hq
// heads) attends arena rows of positions [0, seqlens[b]); position p lives
// at arena row tile_rows[b, p / sub] + p % sub (the host-resolved extent
// table, ops/utils.tile_rows_from_segments).  Slots with seqlens[b] == 0
// write zeros.  Storage float32 or bfloat16, arithmetic float32.
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

template <typename T, int G>
__global__ void __launch_bounds__(decode::kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets,
    const int* __restrict__ tile_rows, const int* __restrict__ seqlens,
    int batch, int hkv, int n_sub, int sub, long long rows_total, int layer,
    float sm_scale) {
  extern __shared__ __align__(128) unsigned char dec_smem[];
  decode::decode_blocks<T, G>(q, cache, out, part, tickets, tile_rows,
                              seqlens, batch, hkv, n_sub, sub, rows_total,
                              layer, sm_scale, blockIdx.x, gridDim.x,
                              dec_smem);
}

template <typename T, int G>
int launch(const void* q, const void* cache, void* out, float* part,
           int* tickets, const int* tile_rows, const int* seqlens, int batch,
           int hkv, int n_sub, int sub, long long rows_total, int layer,
           float sm_scale, int nblocks, cudaStream_t stream) {
  constexpr int smem = decode::kSmemBytes<T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attention_kernel<T, G><<<nblocks, decode::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<T*>(out), part, tickets, tile_rows, seqlens, batch, hkv,
      n_sub, sub, rows_total, layer, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int group, const void* q, const void* cache, void* out,
                   float* part, int* tickets, const int* tile_rows,
                   const int* seqlens, int batch, int hkv, int n_sub, int sub,
                   long long rows_total, int layer, float sm_scale,
                   int nblocks, cudaStream_t s) {
  switch (group) {
    case 1:
      return launch<T, 1>(q, cache, out, part, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
    case 2:
      return launch<T, 2>(q, cache, out, part, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
    case 4:
      return launch<T, 4>(q, cache, out, part, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
    case 8:
      return launch<T, 8>(q, cache, out, part, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [batch, Hkv*group, 128]; cache: [L, 2, Hkv, rows_total, 128];
// tile_rows: [batch, n_sub] int32 (each slot's table as deep as its
// seqlen); seqlens: [batch] int32; part: float32 scratch, 16-byte
// aligned, of (nblocks + batch * Hkv) * decode::kPartFloats<group>
// (group * 130, rounded up to a multiple of 4) elements; tickets: batch *
// Hkv int32 counters, 0 before the launch and 0 after it.  group (Hq/Hkv)
// must be 1, 2, 4 or 8, batch at most 1024 and nblocks at most 1024.
extern "C" int vattn_decode_attention(const void* q, const void* cache,
                                      void* out, void* part, int* tickets,
                                      const int* tile_rows,
                                      const int* seqlens, int batch, int hkv,
                                      int group, int n_sub, int sub,
                                      long long rows_total, int layer,
                                      float sm_scale, int nblocks, int dtype,
                                      void* stream) {
  if (batch <= 0) return 0;
  if (batch > decode::kMaxSlots || nblocks <= 0 ||
      nblocks > decode::kMaxGrid || sub <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_group<float>(group, q, cache, out, p, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
  if (dtype == kBFloat16)
    return dispatch_group<__nv_bfloat16>(group, q, cache, out, p, tickets, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, nblocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory per block of the body for `dtype` (chip_smoke's
// ptxas report)
extern "C" int vattn_decode_smem_bytes(int dtype) {
  return dtype == kBFloat16 ? decode::kSmemBytes<__nv_bfloat16>
                            : decode::kSmemBytes<float>;
}
