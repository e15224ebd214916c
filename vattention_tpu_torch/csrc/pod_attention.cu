// Kernel F: POD attention -- every prefill run of a mixed step and the
// batched decode, in one launch that returns both outputs.
//
// Replaces the TPU kernel pod_fused_attention (_pod_kernel) of
// vattention_tpu/ops/pod_fused.py.  The prefill part is kernel B's
// (prefill_attention.cuh: K runs, qt_run/qinfo, rows through the arena's
// row table, the empty run giving zeros); the decode part is kernel C's
// (decode_attention.cuh: slot b attends positions [0, seqlens[b]), idle
// slots give zeros).  One sliding window, if any, goes to both parts (the
// TPU kernel takes none).  The bodies are shared unchanged, so F's
// prefill output equals B's and its decode output C's, bit for bit, on
// the same inputs.
//
// Bound: operations at serving depths.  Both phases together move the
// prefill queries and outputs, every live K/V row of the prefill runs and
// of the decode slots, and the decode queries and outputs; they do 4*Hq*D
// FLOPs per attended (query, key) pair.  The prefill part is tensor-core
// bound, the decode part bandwidth bound; the larger of the two times
// bounds the launch (bytes / 3.35 TB/s against FLOPs / 989 TF/s).
// Design: one grid of n_pre + n_dec blocks.  Blocks [0, n_pre) cover B's
// grid (row blocks x kv heads: in bf16 128 flattened (token, head) rows on
// two consumer warpgroups fed by a producer warpgroup, so bf16 blocks are
// 384 threads), blocks [n_pre, n_pre + n_dec) are C's fixed grid of n_dec
// blocks (decode_attention.cuh on the first 128 threads: the same split
// plan over the slots' live depths, the same per-warp K/V rings and
// tensor-core tiles, the same ticket merge inside the launch, so F's
// decode output is C's bit for bit when n_dec is C's grid).  The TPU kernel
// weaves the two streams evenly on its one core (build_pod_schedule,
// pod_fused.py:134-138) so that decode DMAs overlap prefill MXU work.  Here
// a bf16 block holds a whole SM (the prefill body's 230,448 B of shared
// memory, 230,464 B over a 1-byte arena, 168 registers x 384 threads at
// launch), so the roles never share one, and a decode block woven ahead of
// a prefill block only delays it.  Over a bf16 arena a prefill-role block
// moves registers from its producer warpgroup to its consumers
// (setmaxnreg, inside the body); a decode-role block never does and keeps
// 168 a thread.  Blocks are dispatched roughly in index order, so the
// prefill blocks (about one wave at serving chunks) start at once and the
// decode blocks fill the SMs the prefill leaves, then the whole card; a
// per-SM balancer is later work.
// Both roles carve one dynamic shared buffer.  The arena is the compute
// type's or 1-byte (e4m3 or int8): both bodies widen 1-byte tiles exactly,
// so F equals B then C bit for bit on each arena type.
#include <type_traits>

#include "decode_attention.cuh"
#include "prefill_attention.cuh"

using namespace vattn;

namespace {

// f32 blocks are the prefill body's 256 threads, bf16 blocks its 384; the
// decode role runs on the first decode::kThreads of them
static_assert(decode::kThreads <= prefill::kThreads &&
                  decode::kThreads <= prefill::kTcThreads,
              "the decode body fits in either block");

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <typename T, typename KV>
constexpr int smem_bytes() {
  constexpr int pre = kTensorCores<T> ? prefill::kTcSmemBytesFor<KV> : prefill::kSmemBytes;
  constexpr int dec = decode::kSmemBytes<T, KV>;
  return pre > dec ? pre : dec;
}

// chip_smoke's ptxas report gives F's bf16 shared memory as the prefill body's
static_assert(smem_bytes<__nv_bfloat16, __nv_bfloat16>() ==
                      prefill::kTcSmemBytesFor<__nv_bfloat16> &&
                  smem_bytes<__nv_bfloat16, fp8>() == prefill::kTcSmemBytesFor<fp8>,
              "bf16 blocks carve the prefill body's buffer");

template <typename T>
constexpr int kBlockThreads = kTensorCores<T> ? prefill::kTcThreads : prefill::kThreads;

template <typename T, typename KV, int G>
__global__ void __launch_bounds__(kBlockThreads<T>, 1) pod_attention_kernel(
    const T* __restrict__ qp, const T* __restrict__ qd,
    const KV* __restrict__ cache, T* __restrict__ op, T* __restrict__ od,
    float* __restrict__ part, int* __restrict__ tickets,
    const int* __restrict__ qt_run, const int* __restrict__ qinfo,
    const int* __restrict__ pre_rows, int pre_n_sub,
    const int* __restrict__ dec_rows, int dec_n_sub,
    const int* __restrict__ seqlens, int hkv, int group, int sub,
    int pad_tile, long long rows_total, int layer, float sm_scale, int window,
    int n_tiles, int batch, int n_dec) {
  extern __shared__ __align__(128) unsigned char pod_smem[];
  const int hq = hkv * group;
  const long long n_pre = static_cast<long long>(n_tiles) * hkv;
  const long long t = blockIdx.x;

  if (t < n_pre) {
    // prefill: block t of B's grid, in B's order (row blocks fastest)
    const int pi = static_cast<int>(t);
    const int h = pi / n_tiles;
    const int tile = pi - h * n_tiles;
    const prefill::TileRows rows{pre_rows, pre_n_sub, sub};
    if constexpr (kTensorCores<T>)
      prefill::prefill_tile_tc(qp, cache, op, prefill::RunTiles{qt_run},
                               qinfo, rows, hq, hkv, pad_tile, rows_total,
                               layer, sm_scale, window, tile, h, pod_smem);
    else
      prefill::prefill_tile<T>(qp, cache, op, prefill::RunTiles{qt_run},
                               qinfo, rows, hq, hkv, pad_tile, rows_total,
                               layer, sm_scale, window, tile, h, threadIdx.x,
                               reinterpret_cast<float*>(pod_smem));
    return;
  }

  // decode: block t - n_pre of C's grid
  if (threadIdx.x >= decode::kThreads) return;
  decode::decode_blocks<T, KV, G>(qd, cache, od, part, tickets, dec_rows,
                                  seqlens, batch, hkv, group, dec_n_sub, sub,
                                  rows_total, layer, sm_scale, window,
                                  static_cast<int>(t - n_pre), n_dec, pod_smem);
}

template <typename T, typename KV, int G>
int launch(const void* qp, const void* qd, const void* cache, void* op,
           void* od, float* part, int* tickets, const int* qt_run,
           const int* qinfo, const int* pre_rows, int pre_n_sub,
           const int* dec_rows, int dec_n_sub, const int* seqlens, int n_tiles,
           int batch, int hkv, int group, int sub, int pad_tile,
           long long rows_total, int layer, float sm_scale, int window,
           int n_dec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, KV>();
  const cudaError_t attr = cudaFuncSetAttribute(
      pod_attention_kernel<T, KV, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(n_tiles) * hkv + n_dec;
  if (blocks == 0) return 0;
  pod_attention_kernel<T, KV, G><<<static_cast<unsigned>(blocks), kBlockThreads<T>, smem, stream>>>(
      static_cast<const T*>(qp), static_cast<const T*>(qd),
      static_cast<const KV*>(cache), static_cast<T*>(op), static_cast<T*>(od),
      part, tickets, qt_run, qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub,
      seqlens, hkv, group, sub, pad_tile, rows_total, layer, sm_scale, window,
      n_tiles, batch, n_dec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int dispatch_group(int group, const void* qp, const void* qd,
                   const void* cache, void* op, void* od, float* part,
                   int* tickets, const int* qt_run, const int* qinfo,
                   const int* pre_rows, int pre_n_sub, const int* dec_rows,
                   int dec_n_sub, const int* seqlens, int n_tiles, int batch,
                   int hkv, int sub, int pad_tile, long long rows_total,
                   int layer, float sm_scale, int window, int n_dec,
                   cudaStream_t s) {
  switch (decode::chunk_width(group)) {
#define VATTN_POD_CHUNK(C)                                                    \
  case C:                                                                     \
    return launch<T, KV, C>(qp, qd, cache, op, od, part, tickets, qt_run,     \
                            qinfo, pre_rows, pre_n_sub, dec_rows, dec_n_sub,  \
                            seqlens, n_tiles, batch, hkv, group, sub,         \
                            pad_tile, rows_total, layer, sm_scale, window,    \
                            n_dec, s);
    VATTN_POD_CHUNK(1)
    VATTN_POD_CHUNK(2)
    VATTN_POD_CHUNK(4)
    VATTN_POD_CHUNK(8)
#undef VATTN_POD_CHUNK
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_prefill, out_prefill: [num_tokens, hkv*group, 128]; q_decode,
// out_decode: [batch, hkv*group, 128], all of dtype; cache: [L, 2, hkv,
// rows_total, 128] of kv_dtype (dtype, e4m3 or int8);
// qt_run: [num_tokens / pad_tile, 2]; qinfo: [K, 2]; pre_tile_rows:
// [K, pre_n_sub]; dec_tile_rows: [batch, dec_n_sub]; seqlens: [batch]
// (all int32).  n_dec: the decode blocks (kernel C's grid; 0 when batch
// is 0; at most 1024).  part: float32 scratch as kernel C's, of (n_dec +
// batch * hkv * NC) partials (NC = cdiv(group, decode::chunk_width(group)));
// tickets: batch * hkv * NC int32 counters, 0 before the launch and 0 after
// it; window: the sliding window of both roles (0: none).  group >= 1 and
// batch at most 1024; prefill::min_q_tile(dtype, group) must divide
// pad_tile, and pad_tile num_tokens.
extern "C" int vattn_pod_attention(
    const void* q_prefill, const void* q_decode, const void* cache,
    void* out_prefill, void* out_decode, void* part, int* tickets,
    const int* qt_run, const int* qinfo, const int* pre_tile_rows,
    int pre_n_sub, const int* dec_tile_rows, int dec_n_sub,
    const int* seqlens, int num_tokens, int batch, int hkv, int group,
    int sub, int pad_tile, long long rows_total, int layer, float sm_scale,
    int window, int n_dec, int dtype, int kv_dtype, void* stream) {
  const int q_tile = prefill::min_q_tile(dtype, group);
  if (q_tile == 0 || pad_tile <= 0 || pad_tile % q_tile != 0 || num_tokens < 0 ||
      num_tokens % pad_tile != 0 || batch < 0 || batch > decode::kMaxSlots ||
      n_dec < 0 || n_dec > decode::kMaxGrid || (batch > 0 && n_dec == 0) ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // row blocks of the prefill role (prefill::launch's grid)
  const int n_tiles = static_cast<int>(static_cast<long long>(num_tokens) * group /
                                       prefill::block_rows(dtype));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
#define VATTN_POD(T, KV)                                                     \
  dispatch_group<T, KV>(group, q_prefill, q_decode, cache, out_prefill,      \
                        out_decode, p, tickets, qt_run, qinfo, pre_tile_rows, \
                        pre_n_sub, dec_tile_rows, dec_n_sub, seqlens, n_tiles, \
                        batch, hkv, sub, pad_tile, rows_total, layer,        \
                        sm_scale, window, n_dec, s)
  const bool f32 = dtype == kFloat32;
  if (kv_dtype == dtype)
    return f32 ? VATTN_POD(float, float) : VATTN_POD(__nv_bfloat16, __nv_bfloat16);
  if (kv_dtype == kFloat8E4M3)
    return f32 ? VATTN_POD(float, fp8) : VATTN_POD(__nv_bfloat16, fp8);
  if (kv_dtype == kInt8)
    return f32 ? VATTN_POD(float, int8_t) : VATTN_POD(__nv_bfloat16, int8_t);
#undef VATTN_POD
  return static_cast<int>(cudaErrorInvalidValue);
}
