// Kernel C: batched GQA decode attention over the contiguous KV arena.
//
// Replaces the TPU kernel flash_decode (_decode_kernel) of
// vattention_tpu/ops/flash_decode.py.  Slot b's single query token (Hq
// heads) attends arena rows of positions [0, seqlens[b]); position p lives
// at arena row tile_rows[b, p / sub] + p % sub (the host-resolved extent
// table, ops/utils.tile_rows_from_segments).  Slots with seqlens[b] == 0
// write zeros.  Storage float32 or bfloat16, arithmetic float32.
//
// Bound: bytes.  The kernel reads each live K and V row once (2*Hkv*D
// elements per position) and the queries once; its arithmetic is ~1 FMA
// per byte, far below the card's ridge point.
// Design: split over positions (flash-decoding), so a batch of 8 slots
// still fills the card.  Pass 1 and the merge are decode_attention.cuh's
// bodies (shared with kernel F): pass 1 runs one block of 8 warps per
// (slot, kv head, split of `chunk` positions); the merge runs one block per
// (slot, kv head) over the splits that hold positions and normalises.
#include "decode_attention.cuh"

using namespace vattn;
using vattn::decode::kPartFloats;
using vattn::decode::kSmemFloats;
using vattn::decode::kThreads;

namespace {

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ cache,
    float* __restrict__ part, const int* __restrict__ tile_rows,
    const int* __restrict__ seqlens, int hkv, int n_sub, int sub,
    long long rows_total, int layer, float sm_scale, int chunk) {
  __shared__ float smem[kSmemFloats<G>];
  decode::decode_split<T, G>(q, cache, part, tile_rows, seqlens, hkv, n_sub,
                             sub, rows_total, layer, sm_scale, chunk,
                             blockIdx.x, blockIdx.y, gridDim.y, smem);
}

template <typename T, int G>
__global__ void decode_merge_kernel(const float* __restrict__ part,
                                    T* __restrict__ out,
                                    const int* __restrict__ seqlens, int hkv,
                                    int nsplit, int chunk) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int hq = hkv * G;
  decode::decode_merge<T, G>(
      part + static_cast<long long>(bh) * nsplit * kPartFloats<G>,
      out + (static_cast<long long>(b) * hq + h * G) * decode::kD, seqlens[b],
      chunk, threadIdx.x, blockDim.x);
}

template <typename T, int G>
int launch(const void* q, const void* cache, void* out, float* part,
           const int* tile_rows, const int* seqlens, int batch, int hkv,
           int n_sub, int sub, long long rows_total, int layer,
           float sm_scale, int chunk, int nsplit, cudaStream_t stream) {
  decode_partial_kernel<T, G><<<dim3(batch * hkv, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), part,
      tile_rows, seqlens, hkv, n_sub, sub, rows_total, layer, sm_scale,
      chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, G><<<batch * hkv, 128, 0, stream>>>(
      part, static_cast<T*>(out), seqlens, hkv, nsplit, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int group, const void* q, const void* cache, void* out,
                   float* part, const int* tile_rows, const int* seqlens,
                   int batch, int hkv, int n_sub, int sub,
                   long long rows_total, int layer, float sm_scale, int chunk,
                   int nsplit, cudaStream_t stream) {
  switch (group) {
    case 1:
      return launch<T, 1>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 2:
      return launch<T, 2>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 4:
      return launch<T, 4>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 8:
      return launch<T, 8>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [batch, Hkv*group, 128]; cache: [L, 2, Hkv, rows_total, 128];
// tile_rows: [batch, n_sub] int32; seqlens: [batch] int32 (each at most
// chunk * nsplit); part: float32 scratch of batch * Hkv * nsplit *
// group * 130 elements.  group (Hq/Hkv) must be 1, 2, 4 or 8.
extern "C" int vattn_decode_attention(const void* q, const void* cache,
                                      void* out, void* part,
                                      const int* tile_rows,
                                      const int* seqlens, int batch, int hkv,
                                      int group, int n_sub, int sub,
                                      long long rows_total, int layer,
                                      float sm_scale, int chunk, int nsplit,
                                      int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (chunk <= 0 || nsplit <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_group<float>(group, q, cache, out, p, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, s);
  if (dtype == kBFloat16)
    return dispatch_group<__nv_bfloat16>(group, q, cache, out, p, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
