// The chunked causal GQA prefill body shared by kernel B (rows through the
// arena's row table), kernel E (rows through per-run block tables), kernel
// F (POD: B's rows, beside the decode body in one launch), kernel G (one
// run, rows through the request's extent table) and kernel H (one run,
// rows through one block table).
//
// B, E, G and H replace the TPU's _prefill_kernel of
// vattention_tpu/ops/flash_prefill.py, which vattention_tpu/ops/paged_attention.py
// also reuses for its block tables.  The q region [Tq, Hq, D] is a
// concatenation of prefill runs, each padded to pad_tile (the scheduler's
// charge unit, config.PREFILL_TOKEN_PAD).  A q map gives (run, local tile)
// for each pad_tile-row tile i: qt_run[i] for B, E and F, (0, i) for the
// single-run G and H; qinfo[run] = (q_start, kv_len).  Token j of local
// tile lt sits at absolute position q_start + lt*pad_tile + j -- not at
// positions[], which is 0 on padding rows.  It attends positions p <= its
// own position with p < kv_len; position p lives at the arena row that the
// row map gives (`Rows::run(run, kv_len)(p)`).  The chunk's own K/V is
// already in the arena (kernel A runs first).  Tiles of runs with
// kv_len == 0 (the empty run that fixed-width padding maps tail tiles to)
// write zeros.  Every K/V load is bounded by n_keys = min(kv_len, the
// tile's causal diagonal), so a row map is only asked for p < kv_len.
//
// Bound: operations at serving depths (4*Hq*D FLOPs per attended (q, k)
// pair against 2*Hkv*D K/V elements per key row read): a 512-token chunk
// at depth 4096 (Yi-6B: Hq 32, Hkv 4) is 0.033 ms of bf16 tensor-core
// work on an H100 and 0.0016 ms of HBM traffic.
// Design: one block per (q tile, kv head): its query rows are the G heads
// of one GQA group for each token of the tile, so every K/V row staged in
// shared memory serves G heads.  The block walks 64-key tiles only up to
// its causal diagonal and keeps an online softmax per row in float32.
// Each key position resolves its own row, so a key tile may span several
// table entries (blocks of 16 tokens under a 64-key tile).
//   bfloat16 (prefill_tile_tc, 384 threads, 128 query rows = 128/G
//     tokens): two consumer warpgroups own 64 rows each, wgmma's M, and
//     a producer warpgroup fills a ring of kTcStages K/V tiles by cp.async
//     (16-byte copies into the 128B-swizzled layout, zero-filled past the
//     keys a tile needs; each key's row resolved once per tile, one tile
//     ahead).  Copies report to a per-stage "full" mbarrier, consumers
//     give a stage back through its "empty" mbarrier: no block barrier
//     per tile.  Per key tile each consumer warpgroup computes S = Q K^T
//     with 8 wgmma m64n64k16 (Q and K through smem descriptors, S in
//     registers), updates the softmax in registers (each thread holds two
//     rows; max across the row's 4 lanes by shuffles), rounds P to bf16
//     in registers as the JAX kernel feeds p.astype(v.dtype) to its PV
//     matmul, and adds P V to O with 4 wgmma m64n128k16 whose A is P's
//     registers and whose B is V, MN-major (D contiguous: the transpose
//     bit).  Step j issues S_j with P_{j-1} V_{j-1} and runs tile j's
//     softmax under the latter (FA3's overlap inside a warpgroup).  O
//     stays in registers and is written once, as O / l; no S, P or PV
//     goes through shared memory.  Only tiles that cross a warpgroup's
//     causal diagonal or kv_len test each key.  One block per SM
//     (kTcSmemBytes of shared memory, 168 registers x 384 threads).
//   float32: the same algorithm on the CUDA cores (32-key tiles, 4
//     threads per row), exact float32 products for the f32 test path.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace vattn {
namespace prefill {

// Kernel B's row map: position p of run r at tile_rows[r, p / sub] + p % sub.
struct TileRows {
  const int* tile_rows;  // [K, n_sub]
  int n_sub;
  int sub;

  struct Run {
    const int* trow;
    int sub;
    __device__ __forceinline__ long long operator()(int p) const {
      return trow[p / sub] + (p % sub);
    }
  };
  __device__ __forceinline__ Run run(int r, int /*kv_len*/) const {
    return {tile_rows + static_cast<long long>(r) * n_sub, sub};
  }
};

// Kernel E's row map: position p of run r at
// block_tables[r, min(p / bs, last)] * bs + p % bs, where last is the run's
// last valid block, cdiv(kv_len, bs) - 1 (the JAX kernel's clamp,
// paged_attention.py:153-158).  Loads stop at p < kv_len, so the clamp
// never binds there; it keeps a table tail past the run's blocks unread
// whatever the caller left in it.
struct BlockTables {
  const int* tables;  // [K, nb] block ids
  int nb;
  int bs;

  struct Run {
    const int* table;
    int bs;
    int last;
    __device__ __forceinline__ long long operator()(int p) const {
      return static_cast<long long>(table[min(p / bs, last)]) * bs + (p % bs);
    }
  };
  __device__ __forceinline__ Run run(int r, int kv_len) const {
    return {tables + static_cast<long long>(r) * nb, bs,
            max((kv_len + bs - 1) / bs, 1) - 1};
  }
};

// Kernel G's row map: one run's extent table, walked for each key position
// as seg_row_lookup (vattention_tpu/ops/utils.py:281-297) does: position p
// lives at seg_row[j] + p - seg_cum[j] for the j with seg_cum[j] <= p <
// seg_cum[j+1] (the last such j), and at row 0 where no extent maps it.
// Each key resolves its own row, so extents need not align to any tile.
// The S <= kMaxSegments entries are read once per block into registers;
// entries past S get the empty range [seg_cum[S], seg_cum[S]).
constexpr int kMaxSegments = 8;

struct Segments {
  const int* seg_row;  // [S]
  const int* seg_cum;  // [S + 1]
  int num_segments;    // S

  struct Run {
    int cum[kMaxSegments + 1];
    int row[kMaxSegments];
    __device__ __forceinline__ long long operator()(int p) const {
      long long r = 0;
#pragma unroll
      for (int j = 0; j < kMaxSegments; ++j)
        if (p >= cum[j] && p < cum[j + 1])
          r = static_cast<long long>(row[j]) + (p - cum[j]);
      return r;
    }
  };
  __device__ __forceinline__ Run run(int /*run*/, int /*kv_len*/) const {
    Run out;
#pragma unroll
    for (int j = 0; j <= kMaxSegments; ++j)
      out.cum[j] = seg_cum[min(j, num_segments)];
#pragma unroll
    for (int j = 0; j < kMaxSegments; ++j)
      out.row[j] = j < num_segments ? seg_row[j] : 0;
    return out;
  }
};

// q maps: (run, local tile) of the q region's pad_tile-row tile pt.
// Kernels B, E and F read the host-built qt_run[pt].
struct RunTiles {
  const int* qt_run;  // [num_tokens / pad_tile, 2]
  __device__ __forceinline__ int2 operator()(int pt) const {
    return make_int2(qt_run[2 * pt], qt_run[2 * pt + 1]);
  }
};

// Kernels G and H: one run, so tile pt is (run 0, local tile pt).
struct OneRun {
  __device__ __forceinline__ int2 operator()(int pt) const {
    return make_int2(0, pt);
  }
};

constexpr int kD = 128;               // head dim
constexpr int kRows = 64;             // float32: query rows (token, head) per block
constexpr int kKeys = 32;             // keys per tile
constexpr int kThreads = kRows * 4;   // 4 threads per query row
constexpr int kQStride = kD + 1;      // padded: conflict-free row reads
constexpr int kKStride = kD + 1;
constexpr int kSmemBytes =
    (kRows * kQStride + kKeys * kKStride + kKeys * kD) * static_cast<int>(sizeof(float));

// The float32 body: q tile `tile` (kRows/G tokens) of kv head `h`, run by
// kThreads threads (local index `tid`) over `smem` (kSmemBytes).
template <typename T, typename QMap, typename Rows>
__device__ __forceinline__ void prefill_tile(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out,
    QMap qmap, const int* __restrict__ qinfo, Rows rows,
    int hq, int hkv, int pad_tile, long long rows_total, int layer,
    float sm_scale, int tile, int h, int tid, float* smem) {
  float* qs = smem;                       // [kRows][kQStride]
  float* ks = qs + kRows * kQStride;      // [kKeys][kKStride]
  float* vs = ks + kKeys * kKStride;      // [kKeys][kD]

  const int group = hq / hkv;
  const int qtok = kRows / group;         // tokens per block
  const int tok0 = tile * qtok;
  const int pt = tok0 / pad_tile;
  const int2 qt = qmap(pt);
  const int run = qt.x;
  const int lqt = qt.y;
  const int q_start = qinfo[2 * run];
  const int kv_len = qinfo[2 * run + 1];
  const int pos0 = q_start + lqt * pad_tile + (tok0 - pt * pad_tile);

  const int lane = tid & 31;
  const int r = tid >> 2;                 // this thread's query row
  const int part = tid & 3;               // its quarter of the 32 keys / D lanes
  const int t = r / group;
  const int g = r - t * group;
  const long long tok_stride = static_cast<long long>(hq) * kD;
  T* orow = out + static_cast<long long>(tok0 + t) * tok_stride +
            static_cast<long long>(h * group + g) * kD;

  if (kv_len <= 0) {
    for (int i = 0; i < kD / 4; ++i) orow[part + 4 * i] = from_float<T>(0.f);
    return;
  }

  // stage the block's queries: row rr = (token rr/group, head h*group + rr%group)
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int rr = i / kD;
    const int d = i - rr * kD;
    const int tt = rr / group;
    const int gg = rr - tt * group;
    qs[rr * kQStride + d] = to_float(
        q[static_cast<long long>(tok0 + tt) * tok_stride +
          static_cast<long long>(h * group + gg) * kD + d]);
  }

  const int q_pos = pos0 + t;
  const int n_keys = min(kv_len, pos0 + qtok);  // causal diagonal of the tile
  const long long head_stride = rows_total * kD;
  const T* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride;
  const T* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride;
  const auto row_of = rows.run(run, kv_len);

  float acc[kD / 4];
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int i = tid; i < kKeys * kD; i += kThreads) {
      const int c = i / kD;
      const int d = i - c * kD;
      const int p = k0 + c;
      float kval = 0.f, vval = 0.f;
      if (p < n_keys) {
        const long long row = row_of(p);
        kval = to_float(kbase[row * kD + d]);
        vval = to_float(vbase[row * kD + d]);
      }
      ks[c * kKStride + d] = kval;
      vs[c * kD + d] = vval;
    }
    __syncthreads();

    // scores of row r against keys part*8 .. part*8+7 of the tile
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    const float* qrow = qs + r * kQStride;
    const float* krow = ks + part * 8 * kKStride;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += qv * krow[j * kKStride + d];
    }

    bool valid[8];
    float mt = kMaskValue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = k0 + part * 8 + j;
      valid[j] = p < n_keys && p <= q_pos;
      s[j] = valid[j] ? s[j] * sm_scale : kMaskValue;
      mt = fmaxf(mt, s[j]);
    }
    // the 4 threads of a row are adjacent lanes
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = valid[j] ? expf(s[j] - m_new) : 0.f;  // explicit zero: masked keys add nothing
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;

#pragma unroll
    for (int i = 0; i < kD / 4; ++i) acc[i] *= alpha;
    // acc[i] holds output lane part + 4*i: consecutive threads hit
    // consecutive shared-memory words of a V row
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const float pc = __shfl_sync(0xffffffffu, s[c & 7], (lane & ~3) | (c >> 3));
      const float* vrow = vs + c * kD + part;
#pragma unroll
      for (int i = 0; i < kD / 4; ++i) acc[i] += pc * vrow[4 * i];
    }
  }

#pragma unroll
  for (int i = 0; i < kD / 4; ++i) orow[part + 4 * i] = from_float<T>(acc[i] / l);
}

template <typename T, typename QMap, typename Rows>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out,
    QMap qmap, const int* __restrict__ qinfo, Rows rows,
    int hq, int hkv, int pad_tile, long long rows_total, int layer,
    float sm_scale) {
  extern __shared__ float smem[];
  prefill_tile<T>(q, cache, out, qmap, qinfo, rows, hq, hkv, pad_tile,
                  rows_total, layer, sm_scale, blockIdx.x, blockIdx.y,
                  threadIdx.x, smem);
}

// ---- bfloat16 on the tensor cores (wgmma) ---------------------------- //
constexpr int kTcRows = 128;              // query rows per block: 2 warpgroups x 64
constexpr int kTcKeys = 64;               // keys per tile
constexpr int kTcConsumers = 256;         // 2 warpgroups
constexpr int kTcProducers = 128;         // 1 warpgroup of copies
constexpr int kTcThreads = kTcConsumers + kTcProducers;
constexpr int kTcStages = 4;              // K/V ring depth
constexpr int kTcHalf = 128;              // bytes of one 64-element half row
constexpr int kTcQBytes = kTcRows * kD * 2;          // Q: [2 halves][128 rows][128 B]
constexpr int kTcKBytes = kTcKeys * kD * 2;          // K or V: [2 halves][64 keys][128 B]
constexpr int kTcStageBytes = 2 * kTcKBytes;         // K then V
constexpr int kTcSmemBytes =  // + slack to align to 1024, + the mbarriers
    1024 + kTcQBytes + kTcStages * kTcStageBytes + 2 * 8 * kTcStages;

// 2^x on the special-function unit, subnormal results flushed to zero (a
// weight below 2^-126 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile for one thread's two rows (a, b):
// mask keys at or past lim_a / lim_b (kMask only), update the row maxima
// (in base 2, shared by the row's 4 lanes), turn S into P in place, and
// fold P's row sums into this thread's partial l.  Returns in alpha_a,
// alpha_b the factors that carry O from the old maxima to the new ones.
// `key0` is the first key this thread's S columns hold.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& alpha_a,
                                             float& alpha_b, float scale,
                                             int key0, int lim_a, int lim_b) {
  auto masked = [&](int i) {
    return kMask && key0 + 8 * (i >> 2) + (i & 1) >= ((i & 2) ? lim_b : lim_a);
  };
  float mx_a = -INFINITY, mx_b = -INFINITY;  // raw scores
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float v = masked(i) ? -INFINITY : s[i];
    if (i & 2)
      mx_b = fmaxf(mx_b, v);
    else
      mx_a = fmaxf(mx_a, v);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  // every row sees key 0 in tile 0, so m is finite from then on and a
  // tile that masks a whole row leaves it (alpha 1, P 0)
  const float mn_a = fmaxf(m_a, mx_a * scale);
  const float mn_b = fmaxf(m_b, mx_b * scale);
  alpha_a = ex2(m_a - mn_a);
  alpha_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p =
        masked(i) ? 0.f : ex2(fmaf(s[i], scale, -((i & 2) ? mn_b : mn_a)));
    s[i] = p;
    if (i & 2)
      sum_b += p;
    else
      sum_a += p;
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bfloat16 body: q tile `tile` (kTcRows/G tokens) of kv head `h`, run
// by all kTcThreads threads of the block over `smem` (kTcSmemBytes).
// Threads 0..255 are the two consumer warpgroups, the last warpgroup the
// producer; the roles meet only at the ring's mbarriers.
template <typename QMap, typename Rows>
__device__ __forceinline__ void prefill_tile_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale, int tile, int h,
    unsigned char* smem) {
  using namespace sm90;
  const int tid = threadIdx.x;
  const uint32_t qs = (smem_addr(smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t ring = qs + kTcQBytes;
  const uint32_t full = ring + kTcStages * kTcStageBytes;  // [kTcStages] mbarriers
  const uint32_t empty = full + 8 * kTcStages;             // [kTcStages] mbarriers

  const int group = hq / hkv;
  const int qtok = kTcRows / group;
  const int tok0 = tile * qtok;
  const int pt = tok0 / pad_tile;
  const int2 qt = qmap(pt);
  const int run = qt.x;
  const int lqt = qt.y;
  const int q_start = qinfo[2 * run];
  const int kv_len = qinfo[2 * run + 1];
  const int pos0 = q_start + lqt * pad_tile + (tok0 - pt * pad_tile);
  const long long tok_stride = static_cast<long long>(hq) * kD;
  // block row rr = (token rr / group, head h*group + rr % group)
  const long long head0 = static_cast<long long>(tok0) * tok_stride +
                          static_cast<long long>(h * group) * kD;
  auto row_offset = [&](int rr) {
    const int t = rr / group;
    return head0 + t * tok_stride + static_cast<long long>(rr - t * group) * kD;
  };

  if (kv_len <= 0) {
    for (int i = tid; i < kTcRows * (kD / 8); i += kTcThreads)
      reinterpret_cast<uint4*>(out + row_offset(i >> 4))[i & 15] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int n_keys = min(kv_len, pos0 + qtok);  // causal diagonal of the tile
  const int n_tiles = (n_keys + kTcKeys - 1) / kTcKeys;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, kTcProducers);        // every producer thread
      mbar_init(empty + 8 * s, kTcConsumers);       // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // ---- producer: Q once, then K/V tile j into stage j % kTcStages once
    // the consumers have released tile j - kTcStages there
    const int ptid = tid - kTcConsumers;
    for (int i = ptid; i < kTcRows * (kD / 8); i += kTcProducers) {
      const int rr = i >> 4;
      const int c = i & 15;
      cp_async16(qs + (c >> 3) * (kTcRows * kTcHalf) + swizzle128(rr, c & 7),
                 q + row_offset(rr) + c * 8, true);
    }
    const long long head_stride = rows_total * kD;
    const __nv_bfloat16* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride;
    const __nv_bfloat16* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride;
    const auto row_of = rows.run(run, kv_len);
    // warp w of the producer copies keys 16w .. 16w + 15 of each tile;
    // its lanes l and l + 16 resolve key 16w + l % 16, once per tile and
    // one tile ahead (a table read is never waited for where copies are
    // issued); -1 past the keys the tile needs
    const int lane = tid & 31;
    const int key0 = 16 * (ptid >> 5);
    auto key_row = [&](int j) -> long long {
      const int p = j * kTcKeys + key0 + (lane & 15);
      return p < n_keys ? row_of(p) : -1;
    };
    long long next = key_row(0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kTcStages;
      if (j >= kTcStages) mbar_wait(empty + 8 * s, ((j / kTcStages) - 1) & 1);
      const long long mine = next;
      next = key_row(j + 1);
      const uint32_t ks = ring + s * kTcStageBytes;
      // copy i moves 16-byte chunk lane % 16 of keys key0 + 2i and
      // key0 + 2i + 1: each half-warp one contiguous 256-byte row
      const int c = lane & 15;
      const uint32_t half = (c >> 3) * (kTcKeys * kTcHalf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = 2 * i + (lane >> 4);
        const long long row = __shfl_sync(0xffffffffu, mine, k);
        const long long src = (row < 0 ? 0 : row) * kD + c * 8;
        const uint32_t off = half + swizzle128(key0 + k, c & 7);
        cp_async16(ks + off, kbase + src, row >= 0);
        cp_async16(ks + kTcKBytes + off, vbase + src, row >= 0);
      }
      cp_async_arrive(full + 8 * s);  // stage 0's first phase covers Q too
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumers: thread's rows in wgmma's accumulator layout: warpgroup
  // wg owns block rows 64*wg .. 64*wg + 63, warp w of it rows 16w .. 16w+15
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r_a = 64 * wg + 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int lim_a = min(kv_len, pos0 + r_a / group + 1);       // keys < lim
  const int lim_b = min(kv_len, pos0 + (r_a + 8) / group + 1);
  const int wg_first = pos0 + (64 * wg) / group;  // first row's position
  const float scale = sm_scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  const uint32_t qwg = qs + 64 * wg * kTcHalf;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[32];
  uint32_t pa[4][4];  // P of the previous tile as wgmma's register A
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  auto wait_tile = [&](int j) {  // tile j (and, for j = 0, Q) landed
    mbar_wait(full + 8 * (j % kTcStages), (j / kTcStages) & 1);
    fence_async_shared();
  };
  // S = Q K_j^T: 8 steps of 16 along D, the second 4 in the second half
  auto issue_s = [&](int j) {
    const uint32_t ks = ring + (j % kTcStages) * kTcStageBytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 bf16 within the 128-byte row
      wgmma_m64n64k16_ss(
          s, desc128(qwg + (kk >> 2) * (kTcRows * kTcHalf) + off, 16, 1024),
          desc128(ks + (kk >> 2) * (kTcKeys * kTcHalf) + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_j: 4 steps of 16 keys; V's halves (D 0-63, 64-127) are the
  // two 64-column atoms, 8 keys apart by 1024 bytes
  auto issue_pv = [&](int j) {
    const uint32_t vs = ring + (j % kTcStages) * kTcStageBytes + kTcKBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs(o, pa[kk],
                          desc128(vs + kk * 16 * kTcHalf, kTcKeys * kTcHalf, 1024));
    wgmma_commit();
  };
  // tile j's softmax on S (landed); only tiles crossing the warpgroup's
  // diagonal or kv_len test each key.  A tile above all of a warpgroup's
  // rows gives P = 0 and alpha = 1: it adds nothing
  auto softmax = [&](int j, float& alpha_a, float& alpha_b) {
    fence_regs(s);
    const int k0 = j * kTcKeys;
    const int key0 = k0 + 2 * (lane & 3);
    if (k0 + kTcKeys > kv_len || k0 + kTcKeys - 1 > wg_first)
      softmax_tile<true>(s, m_a, m_b, l_a, l_b, alpha_a, alpha_b, scale, key0,
                         lim_a, lim_b);
    else
      softmax_tile<false>(s, m_a, m_b, l_a, l_b, alpha_a, alpha_b, scale, key0,
                          lim_a, lim_b);
  };
  // O to the new maxima (skipped where no row's maximum moved), and P as
  // wgmma's register A: k-step kk holds keys 16kk .. 16kk + 15, S's
  // column groups 2kk and 2kk + 1
  auto rescale_and_pack = [&](float alpha_a, float alpha_b) {
    if (!__all_sync(0xffffffffu, alpha_a == 1.f && alpha_b == 1.f)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Step j issues S_j and O += P_{j-1} V_{j-1} together and runs tile j's
  // softmax while the second product is in flight; O is rescaled once it
  // has landed, and tile j-1's stage goes back to the producer.
  float alpha_a, alpha_b;
  wait_tile(0);
  issue_s(0);
  wgmma_wait<0>();
  softmax(0, alpha_a, alpha_b);
  rescale_and_pack(alpha_a, alpha_b);
  for (int j = 1; j < n_tiles; ++j) {
    wait_tile(j);
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j landed; P V may still run
    softmax(j, alpha_a, alpha_b);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} landed: pa, o and tile j-1 are free
    fence_regs(o);
    mbar_arrive(empty + 8 * ((j - 1) % kTcStages));
    rescale_and_pack(alpha_a, alpha_b);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o);

  // O / l, written once: row l sums are the row's 4 lanes' partials
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
  __nv_bfloat16* oa = out + row_offset(r_a) + 2 * (lane & 3);
  __nv_bfloat16* ob = out + row_offset(r_a + 8) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(oa + 8 * j) = pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + 8 * j) = pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <typename QMap, typename Rows>
__global__ void __launch_bounds__(kTcThreads, 1) prefill_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  prefill_tile_tc(q, cache, out, qmap, qinfo, rows, hq, hkv, pad_tile,
                  rows_total, layer, sm_scale, blockIdx.x, blockIdx.y, tc_smem);
}

// query rows per block of the body for `dtype` (0 if none)
inline int block_rows(int dtype) {
  return dtype == kBFloat16 ? kTcRows : dtype == kFloat32 ? kRows : 0;
}

template <typename Kernel, typename T, typename QMap, typename Rows>
int launch_one(Kernel kernel, int threads, int smem_bytes, int qtok,
               const void* q, const void* cache, void* out, QMap qmap,
               const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
               int pad_tile, long long rows_total, int layer, float sm_scale,
               cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(num_tokens / qtok, hkv);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<T*>(out), qmap, qinfo, rows, hq, hkv, pad_tile,
      rows_total, layer, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// q, out: [num_tokens, hq, 128]; cache: [L, 2, hkv, rows_total, 128];
// qinfo: [K, 2] (int32); `qmap` maps each pad_tile-row tile to (run, local
// tile) and `rows` each run's key positions to arena rows.  With R =
// block_rows(dtype) (128 in bf16, 64 in f32), hq/hkv must divide R, and
// R/(hq/hkv) must divide pad_tile, which must divide num_tokens.
template <typename QMap, typename Rows>
int launch(const void* q, const void* cache, void* out, QMap qmap,
           const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
           int pad_tile, long long rows_total, int layer, float sm_scale,
           int dtype, void* stream) {
  if (num_tokens <= 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  const int rows_per_block = block_rows(dtype);
  if (group <= 0 || rows_per_block == 0 || rows_per_block % group != 0 ||
      pad_tile <= 0 || pad_tile % (rows_per_block / group) != 0 ||
      num_tokens % pad_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qtok = rows_per_block / group;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_one<decltype(&prefill_attention_kernel<float, QMap, Rows>), float>(
        prefill_attention_kernel<float, QMap, Rows>, kThreads, kSmemBytes, qtok,
        q, cache, out, qmap, qinfo, rows, num_tokens, hq, hkv, pad_tile,
        rows_total, layer, sm_scale, s);
  return launch_one<decltype(&prefill_attention_tc_kernel<QMap, Rows>), __nv_bfloat16>(
      prefill_attention_tc_kernel<QMap, Rows>, kTcThreads, kTcSmemBytes, qtok,
      q, cache, out, qmap, qinfo, rows, num_tokens, hq, hkv, pad_tile,
      rows_total, layer, sm_scale, s);
}

}  // namespace prefill
}  // namespace vattn
