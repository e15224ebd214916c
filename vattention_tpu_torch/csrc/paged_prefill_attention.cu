// Kernel E: chunked causal GQA prefill over K runs in one launch, reading
// K/V from the paged pool through per-run block tables.  Kernel H: the
// same for one run through one block table.
//
// E replaces the TPU kernel paged_flash_prefill_multi of
// vattention_tpu/ops/paged_attention.py, H its single-run
// paged_flash_prefill.  Position p of run r lives at pool row
// block_tables[r, min(p / bs, cdiv(kv_len, bs) - 1)] * bs + p % bs (the
// TPU kernels clamp to the diagonal and the last valid block,
// paged_attention.py:55-63); only positions p < kv_len are loaded, so no
// table entry past a run's last valid block is read.  The body is kernel
// B's (prefill_attention.cuh), as the JAX kernels reuse _prefill_kernel:
// the key tile (64 keys in bf16, 32 in f32) does not depend on the block
// size and may span several blocks.  H is E's row map with a one-run q map
// (tile i is run 0's local tile i), so H equals E bit for bit on one run.
//
// Bound: operations at serving depths, as kernel B.
#include "prefill_attention.cuh"

// q, out: [num_tokens, hq, 128]; cache: [L, 2, hkv, rows_total, 128];
// qt_run: [num_tokens / pad_tile, 2]; qinfo: [K, 2]; block_tables: [K, nb]
// block ids (all int32).  hq/hkv must divide R (128 in bf16, 64 in f32),
// and R/(hq/hkv) must divide pad_tile, which must divide num_tokens.
extern "C" int vattn_paged_prefill_attention(
    const void* q, const void* cache, void* out, const int* qt_run,
    const int* qinfo, const int* block_tables, int num_tokens, int hq,
    int hkv, int pad_tile, int nb, int block_size, long long rows_total,
    int layer, float sm_scale, int dtype, void* stream) {
  if (nb <= 0 || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return vattn::prefill::launch(
      q, cache, out, vattn::prefill::RunTiles{qt_run}, qinfo,
      vattn::prefill::BlockTables{block_tables, nb, block_size}, num_tokens,
      hq, hkv, pad_tile, rows_total, layer, sm_scale, dtype, stream);
}

// q, out: [num_tokens, hq, 128] at positions qinfo[0] + [0, num_tokens);
// cache: [L, 2, hkv, rows_total, 128]; block_table: [nb] block ids; qinfo:
// [2] = (q_start, kv_len) (all int32).  hq/hkv must divide R (128 in
// bf16, 64 in f32), and R/(hq/hkv) must divide num_tokens.
extern "C" int vattn_paged_prefill_single(
    const void* q, const void* cache, void* out, const int* block_table,
    int nb, int block_size, const int* qinfo, int num_tokens, int hq,
    int hkv, long long rows_total, int layer, float sm_scale, int dtype,
    void* stream) {
  using namespace vattn::prefill;
  const int rows = block_rows(dtype);
  if (nb <= 0 || block_size <= 0 || hkv <= 0 || hq % hkv != 0 || hq < hkv ||
      rows == 0 || rows % (hq / hkv) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, cache, out, OneRun{}, qinfo,
                BlockTables{block_table, nb, block_size}, num_tokens, hq, hkv,
                rows / (hq / hkv), rows_total, layer, sm_scale, dtype,
                stream);
}
