// Kernel D: apply the allocator's relocation plan inside the arena.
//
// Replaces the TPU kernel apply_relocations (_copy_kernel) of
// vattention_tpu/ops/arena_copy.py.  Move i copies KV block src[i] (rows
// [src*block_tokens, (src+1)*block_tokens)) to block dst[i], in every
// layer and for both K and V.  The plan's order matters: a move's
// destination is free only at that point in the plan (later moves may
// read what earlier ones wrote), and CUDA blocks run in no order.
//
// Bound: bytes.  Each move reads and writes block_tokens rows of every
// (layer, K/V, kv head) slice once.
//
// Design.  Slices are disjoint, and move m copies vector r of block src[m]
// to vector r of block dst[m] in each: a later move depends on an earlier
// one only at the same slice and the same offset r.  So the grid is
// (chunk of offsets, slice): thread t of block (x, y) owns the offsets
// x * threads * VPT + i * threads + t (i < VPT) of every block of slice y
// and walks the whole plan over them alone.  No other thread touches its
// addresses, so nothing is shared and no barrier is needed: every
// dependency between moves is a dependency between one thread's own
// accesses, ordered by program order.  The grid holds several blocks per
// SM whatever the slice count (64 slices at one kv head, 128 at Yi's 16
// layers, 256 at 32), where one block per slice left half the card idle.
//
// A thread takes the plan in batches of consecutive moves, at most
// max_batch (VPT * max_batch <= kBatchVecs): it issues every load of a
// batch, then its stores in plan order.  A batch ends before the first
// move whose src block an earlier move of the batch writes (that load must
// see the store).  Then every hazard is ordered: read after write by the
// cut, write after read by loads-before-stores, write after write by the
// stores' plan order; and from batch to batch by program order (no
// __restrict__ on the arena, so the compiler moves no load of one batch
// above a store of the one before).  The rule is ops/arena_copy.py's
// relocation_batches; each thread computes it from the plan itself (the
// same cut in every thread), so D stays one launch per plan and takes the
// move table as the cache engine uploads it.  At 64-token blocks a move
// is 16 KB of a slice, and a batch puts up to kBatchVecs of a thread's
// 16-byte loads in flight instead of one.
#include "common.cuh"

namespace {

constexpr int kRelocThreads = 256;   // a block's threads at most
constexpr int kMaxRelocVecs = 4;     // offsets a thread owns at most (VPT: 1, 2 or 4)
constexpr int kBatchVecs = 16;       // a batch's loads in flight a thread at most
constexpr int kMaxSlices = 65535;    // gridDim.y

template <int VPT>
__global__ void __launch_bounds__(kRelocThreads)
arena_relocate_kernel(uint4* cache, const int* __restrict__ src, const int* __restrict__ dst,
                      int n_moves, long long slice_vecs, int block_vecs, int max_batch) {
  constexpr int B = kBatchVecs / VPT;  // moves a batch at most
  // no __restrict__ on the arena: a move's source and destination alias
  uint4* slice = cache + static_cast<long long>(blockIdx.y) * slice_vecs;
  const int c0 = blockIdx.x * blockDim.x * VPT + threadIdx.x;
  for (int m = 0; m < n_moves;) {
    // the batch: moves m, m + 1, ... until max_batch, the plan's end, or a
    // move whose src block an earlier move of the batch writes
    int sb[B], db[B];
    sb[0] = __ldg(src + m);
    db[0] = __ldg(dst + m);
    int nb = 1;
#pragma unroll
    for (int k = 1; k < B; ++k) {
      if (nb == k && k < max_batch && m + k < n_moves) {
        const int s = __ldg(src + m + k);
        bool written = false;
#pragma unroll
        for (int j = 0; j < k; ++j) written |= db[j] == s;
        if (!written) {
          sb[k] = s;
          db[k] = __ldg(dst + m + k);
          nb = k + 1;
        }
      }
    }
    uint4 v[B][VPT];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (k >= nb) continue;
      const uint4* from = slice + static_cast<long long>(sb[k]) * block_vecs;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = c0 + i * blockDim.x;
        if (c < block_vecs) v[k][i] = from[c];
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (k >= nb) continue;
      uint4* to = slice + static_cast<long long>(db[k]) * block_vecs;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = c0 + i * blockDim.x;
        if (c < block_vecs) to[c] = v[k][i];
      }
    }
    m += nb;
  }
}

}  // namespace

// cache: [L, 2, Hkv, rows_total, D] viewed as num_slices = L*2*Hkv slices
// of rows_total rows; row_bytes = D * element size, a multiple of 16.
// The plan (ops/arena_copy.py relocate_plan): blocks of `threads` (whole
// warps, at most kRelocThreads), vpt offsets a thread (1, 2 or 4), chunks
// blocks a slice, together at least a block's vectors and no chunk
// without one; batches of at most max_batch moves (vpt * max_batch at most
// kBatchVecs).  num_slices at most kMaxSlices.
extern "C" int vattn_arena_relocate(void* cache, const int* src, const int* dst, int n_moves,
                                    int num_slices, long long rows_total, int row_bytes,
                                    int block_tokens, int vpt, int threads, int chunks,
                                    int max_batch, void* stream) {
  const long long block_vecs = static_cast<long long>(block_tokens) * (row_bytes / 16);
  const long long tile = static_cast<long long>(threads) * vpt;
  if (n_moves < 0 || num_slices <= 0 || num_slices > kMaxSlices || row_bytes <= 0 ||
      row_bytes % 16 || block_tokens <= 0 || block_vecs > 0x7fffffffLL ||
      block_tokens > rows_total || (vpt != 1 && vpt != 2 && vpt != kMaxRelocVecs) ||
      threads <= 0 || threads % 32 || threads > kRelocThreads || chunks <= 0 ||
      tile * chunks < block_vecs || tile * (chunks - 1) >= block_vecs || max_batch <= 0 ||
      vpt * max_batch > kBatchVecs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_moves == 0) return 0;
  const dim3 grid(chunks, num_slices), block(threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* c = static_cast<uint4*>(cache);
  const long long slice_vecs = rows_total * (row_bytes / 16);
  const int bv = static_cast<int>(block_vecs);
  switch (vpt) {
    case 1: arena_relocate_kernel<1><<<grid, block, 0, s>>>(c, src, dst, n_moves, slice_vecs, bv, max_batch); break;
    case 2: arena_relocate_kernel<2><<<grid, block, 0, s>>>(c, src, dst, n_moves, slice_vecs, bv, max_batch); break;
    default: arena_relocate_kernel<kMaxRelocVecs><<<grid, block, 0, s>>>(c, src, dst, n_moves, slice_vecs, bv, max_batch); break;
  }
  return static_cast<int>(cudaGetLastError());
}
