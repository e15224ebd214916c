// Kernel B: chunked causal GQA prefill over K runs in one launch, reading
// K/V from the contiguous arena through the host-resolved row table.
// Kernel G: the same for one run, resolving rows in the kernel from the
// request's extent table.
//
// B replaces the TPU kernel flash_prefill_multi (_prefill_kernel) of
// vattention_tpu/ops/flash_prefill.py: position p of run r lives at arena
// row tile_rows[r, p / sub] + p % sub.  G replaces flash_prefill of the
// same file, whose BlockSpec index map walks the extent table
// (seg_row_lookup) once per sub-row tile, so the TPU kernel is only
// defined for sub-aligned extents; G walks it for each key position
// (prefill_attention.cuh: Segments), so any extents work and G equals B
// bit for bit on the same rows.  The body, its bound and its design are in
// prefill_attention.cuh, shared with kernels E, F and H.
#include "prefill_attention.cuh"

// q, out: [num_tokens, hq, 128]; cache: [L, 2, hkv, rows_total, 128] of
// kv_dtype (dtype, e4m3 or int8);
// qt_run: [num_tokens / pad_tile, 2]; qinfo: [K, 2]; tile_rows: [K, n_sub]
// (all int32); window: the sliding window (0: none).  min_q_tile(dtype,
// hq/hkv) (128 / gcd(128, hq/hkv) in bf16, 64 / gcd(64, hq/hkv) in f32)
// must divide pad_tile, and pad_tile num_tokens.
extern "C" int vattn_prefill_attention(const void* q, const void* cache,
                                       void* out, const int* qt_run,
                                       const int* qinfo, const int* tile_rows,
                                       int num_tokens, int hq, int hkv,
                                       int pad_tile, int n_sub, int sub,
                                       long long rows_total, int layer,
                                       float sm_scale, int window, int dtype,
                                       int kv_dtype, void* stream) {
  return vattn::prefill::launch(
      q, cache, out, vattn::prefill::RunTiles{qt_run}, qinfo,
      vattn::prefill::TileRows{tile_rows, n_sub, sub}, num_tokens, hq, hkv,
      pad_tile, rows_total, layer, sm_scale, window, dtype, kv_dtype, stream);
}

// q, out: [num_tokens, hq, 128] at positions qinfo[0] + [0, num_tokens);
// cache: [L, 2, hkv, rows_total, 128] of kv_dtype (dtype, e4m3 or int8);
// seg_row: [S]; seg_cum: [S + 1]; qinfo: [2] = (q_start, kv_len) (all
// int32); 1 <= S <= 8; window: the sliding window (0: none).
// min_q_tile(dtype, hq/hkv) must divide num_tokens.
extern "C" int vattn_segment_prefill_attention(
    const void* q, const void* cache, void* out, const int* seg_row,
    const int* seg_cum, int num_segments, const int* qinfo, int num_tokens,
    int hq, int hkv, long long rows_total, int layer, float sm_scale,
    int window, int dtype, int kv_dtype, void* stream) {
  using namespace vattn::prefill;
  if (num_segments < 1 || num_segments > kMaxSegments || hkv <= 0 ||
      hq % hkv != 0 || hq < hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, cache, out, OneRun{}, qinfo,
                Segments{seg_row, seg_cum, num_segments}, num_tokens, hq, hkv,
                min_q_tile(dtype, hq / hkv), rows_total, layer, sm_scale,
                window, dtype, kv_dtype, stream);
}

// Dynamic shared memory per block of the prefill body for `dtype` over
// `kv_dtype`, in bytes (what the launchers above ask for).
extern "C" int vattn_prefill_smem_bytes(int dtype, int kv_dtype) {
  using namespace vattn::prefill;
  if (dtype != vattn::kBFloat16) return kSmemBytes;
  return kv_dtype == vattn::kFloat8E4M3 || kv_dtype == vattn::kInt8
             ? kTcSmemBytesFor<int8_t>
             : kTcSmemBytesFor<__nv_bfloat16>;
}

namespace {
template <typename KV, typename Rows>
int role_regs(int consumer) {
  using namespace vattn::prefill;
  return consumer ? kTcConsumerRegs<KV, Rows> : kTcProducerRegs<KV, Rows>;
}
}  // namespace

// Registers a thread of the bf16 body over `kv_dtype` keeps after
// setmaxnreg: the producer warpgroup's (`consumer` 0) or the consumer
// warpgroups' (`consumer` 1), for kernel G's extent table (`segments` 1)
// or any other row map (0).
extern "C" int vattn_prefill_role_regs(int kv_dtype, int segments,
                                       int consumer) {
  using vattn::prefill::Segments;
  using vattn::prefill::TileRows;
  if (kv_dtype == vattn::kFloat8E4M3 || kv_dtype == vattn::kInt8)
    return segments ? role_regs<int8_t, Segments>(consumer)
                    : role_regs<int8_t, TileRows>(consumer);
  return segments ? role_regs<__nv_bfloat16, Segments>(consumer)
                  : role_regs<__nv_bfloat16, TileRows>(consumer);
}
