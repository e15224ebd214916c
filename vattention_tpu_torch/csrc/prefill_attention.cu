// Kernel B: chunked causal GQA prefill over K runs in one launch, reading
// K/V from the contiguous arena through the host-resolved row table.
//
// Replaces the TPU kernel flash_prefill_multi (_prefill_kernel) of
// vattention_tpu/ops/flash_prefill.py.  Position p of run r lives at arena
// row tile_rows[r, p / sub] + p % sub.  The body, its bound and its design
// are in prefill_attention.cuh, shared with kernel E (block tables).
#include "prefill_attention.cuh"

// q, out: [num_tokens, hq, 128]; cache: [L, 2, hkv, rows_total, 128];
// qt_run: [num_tokens / pad_tile, 2]; qinfo: [K, 2]; tile_rows: [K, n_sub]
// (all int32).  hq/hkv must divide 64, and 64/(hq/hkv) must divide
// pad_tile, which must divide num_tokens.
extern "C" int vattn_prefill_attention(const void* q, const void* cache,
                                       void* out, const int* qt_run,
                                       const int* qinfo, const int* tile_rows,
                                       int num_tokens, int hq, int hkv,
                                       int pad_tile, int n_sub, int sub,
                                       long long rows_total, int layer,
                                       float sm_scale, int dtype,
                                       void* stream) {
  return vattn::prefill::launch(
      q, cache, out, qt_run, qinfo,
      vattn::prefill::TileRows{tile_rows, n_sub, sub}, num_tokens, hq, hkv,
      pad_tile, rows_total, layer, sm_scale, dtype, stream);
}
