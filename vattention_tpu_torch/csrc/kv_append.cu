// Kernel A: scatter one step's K/V rows into the arena.
//
// Replaces the TPU kernels cache_append_tokens (_rmw_batch_kernel) and
// cache_append_run (_rmw_run_kernel) of vattention_tpu/ops/cache_append.py.
// Token t's K and V rows (Hkv x D each) go to arena row rows[t] of layer
// `layer`; rows[t] == -1 skips the token (prefill padding, idle slots).
// Rows are distinct within a step, so every write is a plain store: the
// TPU's 32-row read-modify-write windows have no counterpart here.
//
// Bound: bytes.  Each valid token reads and writes 2*Hkv*D elements once.
// Design: one block per (token, K/V); 16-byte vector copies, consecutive
// threads on consecutive addresses of one destination row.
#include "common.cuh"

namespace {

__global__ void kv_append_kernel(uint4* cache, const uint4* __restrict__ k,
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

}  // namespace

// cache: [L, 2, Hkv, rows_total, D]; k, v: [num_tokens, Hkv, D]; rows:
// [num_tokens] int32.  row_bytes = D * element size, a multiple of 16.
extern "C" int vattn_kv_append(void* cache, const void* k, const void* v,
                               const int* rows, int num_tokens, int hkv,
                               int row_bytes, long long rows_total, int layer,
                               void* stream) {
  if (num_tokens <= 0) return 0;
  const dim3 grid(num_tokens, 2);
  kv_append_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(k),
      static_cast<const uint4*>(v), rows, hkv, row_bytes / 16, rows_total,
      layer);
  return static_cast<int>(cudaGetLastError());
}
