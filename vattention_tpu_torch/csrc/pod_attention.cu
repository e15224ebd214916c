// Kernel F: POD attention -- every prefill run of a mixed step and the
// batched decode, in one launch that returns both outputs.
//
// Replaces the TPU kernel pod_fused_attention (_pod_kernel) of
// vattention_tpu/ops/pod_fused.py.  The prefill part is kernel B's
// (prefill_attention.cuh: K runs, qt_run/qinfo, rows through the arena's
// row table, the empty run giving zeros); the decode part is kernel C's
// (decode_attention.cuh: slot b attends positions [0, seqlens[b]), idle
// slots give zeros).  The bodies are shared unchanged, so F's prefill
// output equals B's and its decode output C's, bit for bit, on the same
// inputs.
//
// Bound: operations at serving depths.  Both phases together move the
// prefill queries and outputs, every live K/V row of the prefill runs and
// of the decode slots, and the decode queries and outputs; they do 4*Hq*D
// FLOPs per attended (query, key) pair.  The prefill part is tensor-core
// bound, the decode part bandwidth bound; the larger of the two times
// bounds the launch (bytes / 3.35 TB/s against FLOPs / 989 TF/s).
// Design: one grid of n_pre + n_dec blocks of 256 threads.  n_pre blocks
// cover B's grid (q tiles x kv heads; in bf16 each block runs two q tiles,
// one per 128-thread half, each half synchronising on its own named
// barrier), n_dec blocks cover C's pass-1 grid (slot-heads x splits of 256
// positions).  Block t finds its role from its index through the even
// weave of build_pod_schedule (pod_fused.py:134-138): it is the
// decodes_before(t)-th decode block when decodes_before(t + 1) exceeds
// it, and prefill otherwise.  Blocks are dispatched roughly in index
// order, so compute-bound prefill blocks and bandwidth-bound decode blocks
// reach the SMs interleaved, the counterpart of the TPU weave that
// overlaps the decode stream's DMAs with the prefill stream's MXU work
// (a per-SM runtime balancer is later work).  Decode splits
// merge inside the launch: each writes its partial to C's scratch, fences,
// and takes a ticket on its (slot, head) counter; the last of the
// cdiv(seqlens[b], 256) splits that hold positions runs C's merge over
// them in split order and resets the counter to 0 for the next launch.
// Both roles carve one dynamic shared buffer (two bf16 q tiles: 220 KB),
// so one block fits an SM and the two roles take turns on an SM rather
// than share it; the bf16 prefill body's registers set the occupancy of
// both roles.
#include <type_traits>

#include "decode_attention.cuh"
#include "prefill_attention.cuh"

using namespace vattn;

namespace {

constexpr int kThreads = 256;
static_assert(prefill::kThreads == kThreads && decode::kThreads == kThreads &&
                  2 * prefill::kTcThreads == kThreads,
              "one block size for both roles");

// Decode blocks among blocks [0, t) of n when n_dec of them decode: the
// greedy weave of build_pod_schedule ("take a decode tile while
// di * n_pre <= pi * n_dec") in closed form.
__device__ __forceinline__ long long decodes_before(long long t,
                                                    long long n_dec,
                                                    long long n) {
  return (t == 0 || n_dec == 0) ? 0 : (t - 1) * n_dec / n + 1;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
constexpr int kTilesPerBlock = kTensorCores<T> ? 2 : 1;

template <typename T, int G>
constexpr int smem_bytes() {
  constexpr int pre = kTensorCores<T> ? 2 * prefill::kTcSmemBytes : prefill::kSmemBytes;
  constexpr int dec = decode::kSmemFloats<G> * static_cast<int>(sizeof(float));
  return pre > dec ? pre : dec;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) pod_attention_kernel(
    const T* __restrict__ qp, const T* __restrict__ qd,
    const T* __restrict__ cache, T* __restrict__ op, T* __restrict__ od,
    float* __restrict__ part, int* __restrict__ tickets,
    const int* __restrict__ qt_run, const int* __restrict__ qinfo,
    const int* __restrict__ pre_rows, int pre_n_sub,
    const int* __restrict__ dec_rows, int dec_n_sub,
    const int* __restrict__ seqlens, int hkv, int sub, int pad_tile,
    long long rows_total, int layer, float sm_scale, int n_tiles, int batch,
    int nsplit, int chunk) {
  extern __shared__ __align__(128) unsigned char pod_smem[];
  __shared__ int merge_here;
  const int hq = hkv * G;
  const int pre_cols = (n_tiles + kTilesPerBlock<T> - 1) / kTilesPerBlock<T>;
  const long long n_dec = static_cast<long long>(batch) * hkv * nsplit;
  const long long n = static_cast<long long>(pre_cols) * hkv + n_dec;
  const long long t = blockIdx.x;
  const long long di = decodes_before(t, n_dec, n);

  if (decodes_before(t + 1, n_dec, n) == di) {
    // prefill: block t - di of B's grid, in B's order (q tiles fastest)
    const int pi = static_cast<int>(t - di);
    const int h = pi / pre_cols;
    const int col = pi - h * pre_cols;
    const prefill::TileRows rows{pre_rows, pre_n_sub, sub};
    if constexpr (kTensorCores<T>) {
      const int half = threadIdx.x / prefill::kTcThreads;
      const int tile = 2 * col + half;
      if (tile < n_tiles)
        prefill::prefill_tile_tc(
            qp, cache, op, prefill::RunTiles{qt_run}, qinfo, rows, hq, hkv,
            pad_tile, rows_total, layer, sm_scale, tile, h,
            threadIdx.x - half * prefill::kTcThreads,
            pod_smem + half * prefill::kTcSmemBytes,
            prefill::HalfSync{1 + half});
    } else {
      prefill::prefill_tile<T>(qp, cache, op, prefill::RunTiles{qt_run},
                               qinfo, rows, hq, hkv, pad_tile, rows_total,
                               layer, sm_scale, col, h, threadIdx.x,
                               reinterpret_cast<float*>(pod_smem),
                               prefill::BlockSync{});
    }
    return;
  }

  // decode: block di of C's pass-1 grid, in C's order (slot-heads fastest)
  const int bh = static_cast<int>(di % (static_cast<long long>(batch) * hkv));
  const int split = static_cast<int>(di / (static_cast<long long>(batch) * hkv));
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int depth = seqlens[b];
  T* o = od + (static_cast<long long>(b) * hq + h * G) * decode::kD;
  const float* src = part + static_cast<long long>(bh) * nsplit * decode::kPartFloats<G>;
  if (depth <= 0) {  // idle slot: split 0 writes the zeros
    if (split == 0) decode::decode_merge<T, G>(src, o, depth, chunk, threadIdx.x, kThreads);
    return;
  }
  if (!decode::decode_split<T, G>(qd, cache, part, dec_rows, seqlens, hkv,
                                  dec_n_sub, sub, rows_total, layer, sm_scale,
                                  chunk, bh, split, nsplit,
                                  reinterpret_cast<float*>(pod_smem)))
    return;  // past the slot's depth: no partial, no ticket
  // this split's partial is written: publish it, then take a ticket; the
  // split that takes the last one merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int used = (depth + chunk - 1) / chunk;
    merge_here = atomicAdd(tickets + bh, 1) == used - 1;
    // every split of (slot, head) has taken its ticket: reset for the next launch
    if (merge_here) atomicExch(tickets + bh, 0);
  }
  __syncthreads();
  if (!merge_here) return;
  __threadfence();
  decode::decode_merge<T, G>(src, o, depth, chunk, threadIdx.x, kThreads);
}

template <typename T, int G>
int launch(const void* qp, const void* qd, const void* cache, void* op,
           void* od, float* part, int* tickets, const int* qt_run,
           const int* qinfo, const int* pre_rows, int pre_n_sub,
           const int* dec_rows, int dec_n_sub, const int* seqlens, int n_tiles,
           int batch, int hkv, int sub, int pad_tile, long long rows_total,
           int layer, float sm_scale, int chunk, int nsplit,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, G>();
  const cudaError_t attr = cudaFuncSetAttribute(
      pod_attention_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long pre_cols = (n_tiles + kTilesPerBlock<T> - 1) / kTilesPerBlock<T>;
  const long long blocks = pre_cols * hkv + static_cast<long long>(batch) * hkv * nsplit;
  if (blocks == 0) return 0;
  pod_attention_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(qp), static_cast<const T*>(qd),
      static_cast<const T*>(cache), static_cast<T*>(op), static_cast<T*>(od),
      part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub,
      seqlens, hkv, sub, pad_tile, rows_total, layer, sm_scale, n_tiles, batch,
      nsplit, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int group, const void* qp, const void* qd,
                   const void* cache, void* op, void* od, float* part,
                   int* tickets, const int* qt_run, const int* qinfo,
                   const int* pre_rows, int pre_n_sub, const int* dec_rows,
                   int dec_n_sub, const int* seqlens, int n_tiles, int batch,
                   int hkv, int sub, int pad_tile, long long rows_total,
                   int layer, float sm_scale, int chunk, int nsplit,
                   cudaStream_t s) {
  switch (group) {
    case 1:
      return launch<T, 1>(qp, qd, cache, op, od, part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
    case 2:
      return launch<T, 2>(qp, qd, cache, op, od, part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
    case 4:
      return launch<T, 4>(qp, qd, cache, op, od, part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
    case 8:
      return launch<T, 8>(qp, qd, cache, op, od, part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_prefill, out_prefill: [num_tokens, hkv*group, 128]; q_decode,
// out_decode: [batch, hkv*group, 128]; cache: [L, 2, hkv, rows_total, 128];
// qt_run: [num_tokens / pad_tile, 2]; qinfo: [K, 2]; pre_tile_rows:
// [K, pre_n_sub]; dec_tile_rows: [batch, dec_n_sub]; seqlens: [batch]
// (all int32, seqlens each at most chunk * nsplit).  part: float32 scratch
// of batch * hkv * nsplit * group * 130 elements; tickets: batch * hkv
// int32 counters, 0 before the launch and 0 after it.  group must be 1, 2,
// 4 or 8; 64/group must divide pad_tile, which must divide num_tokens.
extern "C" int vattn_pod_attention(
    const void* q_prefill, const void* q_decode, const void* cache,
    void* out_prefill, void* out_decode, void* part, int* tickets,
    const int* qt_run, const int* qinfo, const int* pre_tile_rows,
    int pre_n_sub, const int* dec_tile_rows, int dec_n_sub,
    const int* seqlens, int num_tokens, int batch, int hkv, int group,
    int sub, int pad_tile, long long rows_total, int layer, float sm_scale,
    int chunk, int nsplit, int dtype, void* stream) {
  if (group <= 0 || prefill::kRows % group != 0 || pad_tile <= 0 ||
      pad_tile % (prefill::kRows / group) != 0 || num_tokens < 0 ||
      num_tokens % pad_tile != 0 || batch < 0 || chunk <= 0 || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = num_tokens / (prefill::kRows / group);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_group<float>(group, q_prefill, q_decode, cache, out_prefill, out_decode, p, tickets, qt_run, qinfo, pre_tile_rows, pre_n_sub, dec_tile_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
  if (dtype == kBFloat16)
    return dispatch_group<__nv_bfloat16>(group, q_prefill, q_decode, cache, out_prefill, out_decode, p, tickets, qt_run, qinfo, pre_tile_rows, pre_n_sub, dec_tile_rows, dec_n_sub, seqlens, n_tiles, batch, hkv, sub, pad_tile, rows_total, layer, sm_scale, chunk, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
