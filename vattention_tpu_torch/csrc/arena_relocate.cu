// Kernel D: apply the allocator's relocation plan inside the arena.
//
// Replaces the TPU kernel apply_relocations (_copy_kernel) of
// vattention_tpu/ops/arena_copy.py.  Move i copies KV block src[i] (rows
// [src*block_tokens, (src+1)*block_tokens)) to block dst[i], in every
// layer and for both K and V.  The plan's order matters: a move's
// destination is free only at that point in the plan (later moves may
// read what earlier ones wrote), and CUDA blocks run in no order.
//
// Design: one block per (layer, K/V, kv head) slice of the arena.  Slices
// are disjoint, so each block walks ALL moves in plan order over its own
// slice, with __syncthreads() between moves; that makes every move's
// writes visible to the block before the next move reads.  Exact.
// Bound: bytes.  Each move reads and writes block_tokens rows of every
// slice once.
#include "common.cuh"

namespace {

__global__ void arena_relocate_kernel(uint4* cache, const int* __restrict__ src,
                                      const int* __restrict__ dst, int n_moves,
                                      long long slice_vecs,
                                      long long block_vecs) {
  // no __restrict__ on the arena: source and destination alias
  uint4* slice = cache + static_cast<long long>(blockIdx.x) * slice_vecs;
  for (int m = 0; m < n_moves; ++m) {
    const uint4* s = slice + static_cast<long long>(src[m]) * block_vecs;
    uint4* d = slice + static_cast<long long>(dst[m]) * block_vecs;
    for (long long i = threadIdx.x; i < block_vecs; i += blockDim.x) d[i] = s[i];
    __syncthreads();
  }
}

}  // namespace

// cache: [L, 2, Hkv, rows_total, D] viewed as num_slices = L*2*Hkv slices
// of rows_total rows; row_bytes = D * element size, a multiple of 16.
extern "C" int vattn_arena_relocate(void* cache, const int* src, const int* dst,
                                    int n_moves, int num_slices,
                                    long long rows_total, int row_bytes,
                                    int block_tokens, void* stream) {
  if (n_moves <= 0) return 0;
  const long long row_vecs = row_bytes / 16;
  arena_relocate_kernel<<<num_slices, 512, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), src, dst, n_moves, rows_total * row_vecs,
      static_cast<long long>(block_tokens) * row_vecs);
  return static_cast<int>(cudaGetLastError());
}
