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
// own position q with p < kv_len and, under a sliding window (window > 0),
// p > q - window (the JAX kernel's window mask, flash_prefill.py:83-90,
// 132-133); position p lives at the arena row that the row map gives
// (`Rows::run(run, kv_len)(p)`).  The chunk's own K/V is
// already in the arena (kernel A runs first).  Tiles of runs with
// kv_len == 0 (the empty run that fixed-width padding maps tail tiles to)
// write zeros, and so does a row that sees no key (a padding row at least
// `window` past kv_len).  Every K/V load is bounded by n_keys = min(kv_len,
// the tile's causal diagonal), so a row map is only asked for p < kv_len.
//
// Bound: operations at serving depths (4*Hq*D FLOPs per attended (q, k)
// pair against 2*Hkv*D K/V elements per key row read): a 512-token chunk
// at depth 4096 (Yi-6B: Hq 32, Hkv 4) is 0.033 ms of bf16 tensor-core
// work on an H100 and 0.0016 ms of HBM traffic.
// Design: one block per (row block, kv head).  A kv head's query rows are
// flattened in (token, head) order, row t*G + g for head g of the GQA group
// at token t, and a block takes R consecutive rows (R = 128 in bf16, 64 in
// f32), so every K/V row staged in shared memory serves R query rows
// whatever G is: R/G whole tokens where G divides R, else rows of up to
// cdiv(R, G) + 1 tokens (Falcon-7B's G = 71: a 128-row block holds parts of
// 2 or 3 tokens, and no row is idle).  Each row's causal and window limits
// come from its own token.  A block never straddles a pad tile (the
// launcher asks that pad_tile * G be a multiple of R), so its tokens share
// one run.  The block walks key tiles (128 keys in bf16, 64 over a
// 1-byte arena, 32 in f32) only up to its causal diagonal, and under a
// window only from the first tile that its first row sees (floor(max(0,
// pos0 - window + 1) / tile)): tiles wholly before the window are neither
// copied nor multiplied, so at depth a block's work scales with the
// window, not with kv_len.  It keeps an online softmax per row in
// float32.
// Each key position resolves its own row, so a key tile may span several
// table entries (blocks of 16 tokens under a 128-key tile).
//   bfloat16 (prefill_tile_tc, 384 threads, 128 query rows): two
//     consumer warpgroups own 64 rows each, wgmma's M, and a producer
//     warpgroup fills a ring of K/V tiles by cp.async (16-byte copies into
//     the 128B-swizzled layout, zero-filled past the keys a tile needs;
//     each key's row resolved once per tile, one tile ahead).  Copies
//     report to a per-stage "full" mbarrier, consumers give a stage back
//     through its "empty" mbarrier: no block barrier per tile.  Per key
//     tile each consumer warpgroup computes S = Q K^T with 8 wgmma
//     m64nNk16, N the tile's keys (Q and K through smem descriptors, S in
//     registers), updates the softmax in registers (each thread holds two
//     rows; max across the row's 4 lanes by shuffles), rounds P to bf16 in
//     registers as the JAX kernel feeds p.astype(v.dtype) to its PV
//     matmul, and adds P V to O with N / 16 wgmma m64n128k16 whose A is
//     P's registers and whose B is V, MN-major (D contiguous: the
//     transpose bit).  Step j issues S_j with P_{j-1} V_{j-1} and runs
//     tile j's softmax under the latter (FA3's overlap inside a
//     warpgroup).  O stays in registers and is written once, as O / l; no
//     S, P or PV goes through shared memory.  Only tiles that cross a
//     warpgroup's causal diagonal, kv_len or the window's leading edge
//     test each key.  The ring counts tiles from the block's first tile,
//     so the producer and the consumers agree on stages and mbarrier
//     phases whatever tile the walk starts at.  One block per SM
//     (kTcSmemBytesFor<KV> of shared memory, 168 registers x 384 threads
//     at launch).
//     The tile: 128 keys in a 3-stage ring over a bf16 arena.  Per tile
//     each consumer warpgroup reads its Q rows and the tile's K and V from
//     shared memory; at 64 keys that was ~125 B a clock at the tensor
//     cores' rate against the SM's 128, and each tile's fixed costs (the
//     mbarrier wait, the fences, the two wgmma waits, the row-max
//     shuffles, the rescale vote) came every 64 keys.  128 keys read Q
//     once for twice the keys (~109 B a clock) and halve the fixed costs
//     per key.  A consumer thread then holds S's 64 floats beside O's 64
//     and P's 32 registers, more than the launch's 168: at the top of its
//     role the producer warpgroup gives registers back (setmaxnreg.dec to
//     kTcProducerRegs, 48; 64 in G) and the consumer warpgroups take them
//     (setmaxnreg.inc to kTcConsumerRegs, 224; 216 in G), as FA3 does.
//     The producer resolves rows as 32-bit numbers, so that these counts
//     hold its copies with nothing spilled.  Over a 1-byte arena the tile stays
//     64 keys in 4 stages (below), with 168 registers in every role.
//   float32: the same algorithm on the CUDA cores (32-key tiles, 4
//     threads per row), exact float32 products for the f32 test path.
// K/V storage (the arena's type `KV`): the compute type, or 1 byte (e4m3 or
// int8), widened exactly to the compute type before the products, as the
// JAX kernel's upcast_kv does (ops/utils.py).  bfloat16: cp.async cannot
// convert, so for 1-byte arenas the producer warpgroup copies each tile
// by cp.async into a second ring of 1-byte tiles, 3 tiles ahead, then
// widens each thread's own 16-byte chunks (16 values) to two 16-byte bf16
// chunks, stores them at the same swizzled offsets a bf16 arena's copies
// fill and arrives on the stage's full mbarrier itself: the
// consumers' wgmma loop, its descriptors and the bf16 ring do not change.
// (Loads into registers, even one tile ahead, keep too few bytes in flight
// to feed the consumers; and at 128 keys both rings fit only 2 stages
// each, which measured slower than 64 keys in 4 + 4.)
// float32: each element widens as it is staged (to_float).
#pragma once

#include <type_traits>

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
      int r = 0;  // an arena row: below 2^31
#pragma unroll
      for (int j = 0; j < kMaxSegments; ++j)
        if (p >= cum[j] && p < cum[j + 1]) r = row[j] + (p - cum[j]);
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

// The float32 body: row block `tile` (kRows rows) of kv head `h`, run by
// kThreads threads (local index `tid`) over `smem` (kSmemBytes).
template <typename T, typename KV, typename QMap, typename Rows>
__device__ __forceinline__ void prefill_tile(
    const T* __restrict__ q, const KV* __restrict__ cache, T* __restrict__ out,
    QMap qmap, const int* __restrict__ qinfo, Rows rows,
    int hq, int hkv, int pad_tile, long long rows_total, int layer,
    float sm_scale, int window, int tile, int h, int tid, float* smem) {
  float* qs = smem;                       // [kRows][kQStride]
  float* ks = qs + kRows * kQStride;      // [kKeys][kKStride]
  float* vs = ks + kKeys * kKStride;      // [kKeys][kD]

  const int group = hq / hkv;
  const int row0 = tile * kRows;          // the block's first flattened row
  const int tok0 = row0 / group;          // the block's first token
  const int ntok = (row0 + kRows - 1) / group - tok0 + 1;  // tokens it holds
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
  const int t = (row0 + r) / group - tok0;  // its token, from tok0
  const int g = row0 + r - (tok0 + t) * group;
  const long long tok_stride = static_cast<long long>(hq) * kD;
  T* orow = out + static_cast<long long>(tok0 + t) * tok_stride +
            static_cast<long long>(h * group + g) * kD;

  if (kv_len <= 0) {
    for (int i = 0; i < kD / 4; ++i) orow[part + 4 * i] = from_float<T>(0.f);
    return;
  }

  // stage the block's queries: row rr = flattened row row0 + rr, token
  // (row0 + rr) / group, head h*group + (row0 + rr) % group
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int rr = i / kD;
    const int d = i - rr * kD;
    const int tt = (row0 + rr) / group;
    const int gg = row0 + rr - tt * group;
    qs[rr * kQStride + d] = to_float(
        q[static_cast<long long>(tt) * tok_stride +
          static_cast<long long>(h * group + gg) * kD + d]);
  }

  const int q_pos = pos0 + t;
  const int q_low = window > 0 ? q_pos - window + 1 : 0;  // the row's first key
  const int n_keys = min(kv_len, pos0 + ntok);  // causal diagonal of the tile
  // the first key tile that the block's first row sees
  const int k_first = window > 0 ? max(0, pos0 - window + 1) / kKeys * kKeys : 0;
  const long long head_stride = rows_total * kD;
  const KV* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride;
  const KV* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride;
  const auto row_of = rows.run(run, kv_len);

  float acc[kD / 4];
#pragma unroll
  for (int i = 0; i < kD / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = k_first; k0 < n_keys; k0 += kKeys) {
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
      valid[j] = p < n_keys && p <= q_pos && p >= q_low;
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

  // l == 0: the row saw no key
#pragma unroll
  for (int i = 0; i < kD / 4; ++i)
    orow[part + 4 * i] = from_float<T>(l > 0.f ? acc[i] / l : 0.f);
}

template <typename T, typename KV, typename QMap, typename Rows>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ cache, T* __restrict__ out,
    QMap qmap, const int* __restrict__ qinfo, Rows rows,
    int hq, int hkv, int pad_tile, long long rows_total, int layer,
    float sm_scale, int window) {
  extern __shared__ float smem[];
  prefill_tile(q, cache, out, qmap, qinfo, rows, hq, hkv, pad_tile,
                  rows_total, layer, sm_scale, window, blockIdx.x, blockIdx.y,
                  threadIdx.x, smem);
}

// ---- bfloat16 on the tensor cores (wgmma) ---------------------------- //
constexpr int kTcRows = 128;              // query rows per block: 2 warpgroups x 64
constexpr int kTcConsumers = 256;         // 2 warpgroups
constexpr int kTcProducers = 128;         // 1 warpgroup of copies
constexpr int kTcThreads = kTcConsumers + kTcProducers;
constexpr int kTcHalf = 128;              // bytes of one 64-element half row
constexpr int kTcQBytes = kTcRows * kD * 2;          // Q: [2 halves][128 rows][128 B]
// Key tiles of the arena's type KV: over a bf16 arena 128 keys in a ring
// of 3 stages; over a 1-byte arena 64 keys in 4 stages, beside a second
// ring of 4 stages of 1-byte tiles (K then V, 128-byte rows), which
// cp.async fills 3 tiles ahead of the widening.  (At 128 keys only 2 + 2
// stages fit there, and they measured slower.)
template <typename KV>
constexpr int kTcKeysFor = sizeof(KV) == 1 ? 64 : 128;
template <typename KV>
constexpr int kTcStagesFor = sizeof(KV) == 1 ? 4 : 3;
template <typename KV>
constexpr int kTcSmemBytesFor =  // + slack to align to 1024, + the mbarriers
    1024 + kTcQBytes + kTcStagesFor<KV> * (4 * kTcKeysFor<KV> * kD + 2 * 8) +
    (sizeof(KV) == 1 ? kTcStagesFor<KV> * 2 * kTcKeysFor<KV> * kD : 0);
static_assert(kTcSmemBytesFor<__nv_bfloat16> <= 232448 &&
                  kTcSmemBytesFor<int8_t> <= 232448,
              "fits an H100 block");
// Registers a thread: the launch gives all 384 threads 168 each
// (__launch_bounds__(kTcThreads, 1)).  At 128 keys setmaxnreg then takes
// the producer warpgroup down to the fewest registers at which ptxas
// spills nothing for its row map (48; 64 for G's extent table, whose 17
// entries the producer holds) and gives the rest to the two consumer
// warpgroups (224; 216 beside G's); the 64-key body keeps 168 in every
// role.
constexpr int kTcLaunchRegs = 168;
template <typename KV, typename Rows>
constexpr int kTcProducerRegs =
    kTcKeysFor<KV> != 128 ? kTcLaunchRegs
                          : std::is_same<Rows, Segments>::value ? 64 : 48;
template <typename KV, typename Rows>
constexpr int kTcConsumerRegs =
    (kTcLaunchRegs * kTcThreads - kTcProducers * kTcProducerRegs<KV, Rows>) /
    kTcConsumers / 8 * 8;

// 2^x on the special-function unit, subnormal results flushed to zero (a
// weight below 2^-126 of the row's largest)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile for one thread's two rows (a, b):
// mask keys at or past lim_a / lim_b or below low_a / low_b (kMask only:
// the causal diagonal, kv_len and the window), update the row maxima
// (in base 2, shared by the row's 4 lanes), turn S into P in place, and
// fold P's row sums into this thread's partial l.  Returns in alpha_a,
// alpha_b the factors that carry O from the old maxima to the new ones.
// `key0` is the first key this thread's S columns hold.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& alpha_a,
                                             float& alpha_b, float scale,
                                             int key0, int lim_a, int lim_b,
                                             int low_a, int low_b) {
  auto masked = [&](int i) {
    const int key = key0 + 8 * (i >> 2) + (i & 1);
    return kMask && (key >= ((i & 2) ? lim_b : lim_a) ||
                     key < ((i & 2) ? low_b : low_a));
  };
  float mx_a = -INFINITY, mx_b = -INFINITY;  // raw scores
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
  // once a row has seen a key its m is finite, and a tile that masks the
  // whole row leaves it (alpha 1, P 0).  Under a window a row may see no
  // key in the block's first tiles (m stays -inf): alpha 1 there too
  const float mn_a = fmaxf(m_a, mx_a * scale);
  const float mn_b = fmaxf(m_b, mx_b * scale);
  alpha_a = kMask && mn_a == -INFINITY ? 1.f : ex2(m_a - mn_a);
  alpha_b = kMask && mn_b == -INFINITY ? 1.f : ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
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

// The bfloat16 body: row block `tile` (kTcRows rows) of kv head `h`, run
// by all kTcThreads threads of the block over `smem` (kTcSmemBytesFor<KV>).
// Threads 0..255 are the two consumer warpgroups, the last warpgroup the
// producer; the roles meet only at the ring's mbarriers.
template <typename KV, typename QMap, typename Rows>
__device__ __forceinline__ void prefill_tile_tc(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale, int window, int tile,
    int h, unsigned char* smem) {
  using namespace sm90;
  constexpr int kKeys = kTcKeysFor<KV>;
  constexpr int kStages = kTcStagesFor<KV>;
  constexpr int kKBytes = kKeys * kD * 2;       // K or V: [2 halves][kKeys][128 B]
  constexpr int kStageBytes = 2 * kKBytes;      // K then V
  constexpr int kStage1Bytes = 2 * kKeys * kD;  // a 1-byte stage: K then V
  constexpr int kProducerKeys = kKeys / 4;      // keys of a tile a producer warp copies
  const int tid = threadIdx.x;
  const uint32_t qs = (smem_addr(smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t ring = qs + kTcQBytes;
  const uint32_t full = ring + kStages * kStageBytes;  // [kStages] mbarriers
  const uint32_t empty = full + 8 * kStages;           // [kStages] mbarriers

  const int group = hq / hkv;
  const int row0 = tile * kTcRows;        // the block's first flattened row
  const int tok0 = row0 / group;          // the block's first token
  const int ntok = (row0 + kTcRows - 1) / group - tok0 + 1;  // tokens it holds
  const int pt = tok0 / pad_tile;
  const int2 qt = qmap(pt);
  const int run = qt.x;
  const int lqt = qt.y;
  const int q_start = qinfo[2 * run];
  const int kv_len = qinfo[2 * run + 1];
  const int pos0 = q_start + lqt * pad_tile + (tok0 - pt * pad_tile);
  const long long tok_stride = static_cast<long long>(hq) * kD;
  // block row rr = flattened row row0 + rr: token (row0 + rr) / group, head
  // h*group + (row0 + rr) % group; row_token gives its token from tok0
  auto row_token = [&](int rr) { return (row0 + rr) / group - tok0; };
  auto row_offset = [&](int rr) {
    const int r = row0 + rr;
    const int t = r / group;
    return t * tok_stride + static_cast<long long>(h * group + r - t * group) * kD;
  };

  const int n_keys = min(kv_len, pos0 + ntok);  // causal diagonal of the tile
  // the walk: key tiles j0 .. j0 + n_tiles - 1, j0 the first tile that the
  // block's first row sees under a window; local tile j is key tile j0 + j
  const int j0 = window > 0 ? max(0, pos0 - window + 1) / kKeys : 0;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys - j0;
  if (n_tiles <= 0) {  // the empty run, or rows at least `window` past kv_len
    for (int i = tid; i < kTcRows * (kD / 8); i += kTcThreads)
      reinterpret_cast<uint4*>(out + row_offset(i >> 4))[i & 15] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTcProducers);        // every producer thread
      mbar_init(empty + 8 * s, kTcConsumers);       // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // ---- producer: Q once, then K/V local tile j into stage j % kStages
    // once the consumers have released local tile j - kStages there
    if constexpr (kTcProducerRegs<KV, Rows> != kTcLaunchRegs)
      setmaxnreg_dec<kTcProducerRegs<KV, Rows>>();
    const int ptid = tid - kTcConsumers;
    for (int i = ptid; i < kTcRows * (kD / 8); i += kTcProducers) {
      const int rr = i >> 4;
      const int c = i & 15;
      cp_async16(qs + (c >> 3) * (kTcRows * kTcHalf) + swizzle128(rr, c & 7),
                 q + row_offset(rr) + c * 8, true);
    }
    const long long head_stride = rows_total * kD;
    const KV* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride;
    const KV* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride;
    const auto row_of = rows.run(run, kv_len);
    // warp w of the producer copies keys kw .. kw + k - 1 of each tile (k
    // = kProducerKeys); its lane l resolves key kw + l % k, once per tile
    // and one tile ahead (a table read is never waited for where copies
    // are issued), as a 32-bit row; -1 past the keys the tile needs
    const int lane = tid & 31;
    const int key0 = kProducerKeys * (ptid >> 5);
    auto key_row = [&](int j) -> int {
      const int p = (j0 + j) * kKeys + key0 + lane % kProducerKeys;
      return p < n_keys ? static_cast<int>(row_of(p)) : -1;
    };
    if constexpr (sizeof(KV) == 2) {
      int next = key_row(0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const int mine = next;
        next = key_row(j + 1);
        const uint32_t ks = ring + s * kStageBytes;
        // copy i moves 16-byte chunk lane % 16 of keys key0 + 2i and
        // key0 + 2i + 1: each half-warp one contiguous 256-byte row
        const int c = lane & 15;
        const uint32_t half = (c >> 3) * (kKeys * kTcHalf);
#pragma unroll
        for (int i = 0; i < kProducerKeys / 2; ++i) {
          const int k = 2 * i + (lane >> 4);
          const int row = __shfl_sync(0xffffffffu, mine, k);
          const long long src = static_cast<long long>(row < 0 ? 0 : row) * kD + c * 8;
          const uint32_t off = half + swizzle128(key0 + k, c & 7);
          cp_async16(ks + off, kbase + src, row >= 0);
          cp_async16(ks + kKBytes + off, vbase + src, row >= 0);
        }
        cp_async_arrive(full + 8 * s);  // stage 0's first phase covers Q too
      }
    } else {
      // 1-byte rows are 128 bytes: copy i moves 16-byte chunk lane % 8
      // (values 16c .. 16c + 15) of key key0 + 4i + lane / 8, zeros past
      // the keys the tile needs, into the 1-byte ring; a thread widens only
      // the chunks it copied, so its own cp.async groups order the ring
      // (the first group also holds Q's copies)
      constexpr int kCopies = kProducerKeys / 4;  // of K, then of V
      const int c = lane & 7;
      const uint32_t ring1 = empty + 8 * kStages;
      constexpr int kLead = kStages - 1;
      auto issue = [&](int j) {
        if (j < n_tiles) {
          const int rows_of_tile = key_row(j);
          const uint32_t st = ring1 + (j % kStages) * kStage1Bytes;
#pragma unroll
          for (int i = 0; i < kCopies; ++i) {
            const int k = 4 * i + (lane >> 3);
            const int row = __shfl_sync(0xffffffffu, rows_of_tile, k);
            const long long src = static_cast<long long>(row < 0 ? 0 : row) * kD + c * 16;
            const uint32_t off = (key0 + k) * kD + c * 16;
            cp_async16(st + off, kbase + src, row >= 0);
            cp_async16(st + kKeys * kD + off, vbase + src, row >= 0);
          }
        }
        cp_async_commit();
      };
      // bf16 chunks 2c and 2c + 1 of the key's 256-byte row, the odd one
      // first on lanes c >= 4: a quarter-warp's 8 stores then fall on 8
      // distinct 16-byte bank groups
      const bool odd = (c >> 2) & 1;
      const int first = 2 * c + odd;
      const int second = 4 * c + 1 - first;
      auto put = [&](int j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t ks = ring + s * kStageBytes;
        const uint32_t st = ring1 + s * kStage1Bytes;
#pragma unroll
        for (int i = 0; i < 2 * kCopies; ++i) {
          const int kv = i / kCopies;  // 0: K, 1: V
          const int k = key0 + 4 * (i % kCopies) + (lane >> 3);
          uint4 x, lo, hi;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                       : "r"(st + kv * (kKeys * kD) + k * kD + c * 16)
                       : "memory");
          widen16_bf16<KV>(x, lo, hi);
          const uint32_t base = ks + kv * kKBytes;
          const uint4 a = odd ? hi : lo, b = odd ? lo : hi;
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           base + (first >> 3) * (kKeys * kTcHalf) + swizzle128(k, first & 7)),
                       "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w)
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           base + (second >> 3) * (kKeys * kTcHalf) + swizzle128(k, second & 7)),
                       "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w)
                       : "memory");
        }
        fence_async_shared();  // the stores, visible to the wgmma reads
        mbar_arrive(full + 8 * s);
      };
#pragma unroll
      for (int j = 0; j < kLead; ++j) issue(j);
      for (int j = 0; j < n_tiles; ++j) {
        issue(j + kLead);  // into the slot tile j - 1 was widened from
        cp_async_wait_group<kLead>();  // this thread's copies of tile j
        put(j);
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumers: thread's rows in wgmma's accumulator layout: warpgroup
  // wg owns block rows 64*wg .. 64*wg + 63, warp w of it rows 16w .. 16w+15
  if constexpr (kTcConsumerRegs<KV, Rows> != kTcLaunchRegs)
    setmaxnreg_inc<kTcConsumerRegs<KV, Rows>>();
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int r_a = 64 * wg + 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int lim_a = min(kv_len, pos0 + row_token(r_a) + 1);     // keys < lim
  const int lim_b = min(kv_len, pos0 + row_token(r_a + 8) + 1);
  // keys >= low under a window (0 without one)
  const int low_a = window > 0 ? pos0 + row_token(r_a) - window + 1 : 0;
  const int low_b = window > 0 ? pos0 + row_token(r_a + 8) - window + 1 : 0;
  const int wg_first = pos0 + row_token(64 * wg);  // first row's position
  // the least key that every row of the warpgroup sees
  const int wg_low = window > 0 ? pos0 + row_token(64 * wg + 63) - window + 1 : 0;
  const float scale = sm_scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  const uint32_t qwg = qs + 64 * wg * kTcHalf;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[kKeys / 2];
  uint32_t pa[kKeys / 16][4];  // P of the previous tile as wgmma's register A
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  auto wait_tile = [&](int j) {  // tile j (and, for j = 0, Q) landed
    mbar_wait(full + 8 * (j % kStages), (j / kStages) & 1);
    fence_async_shared();
  };
  // S = Q K_j^T: 8 steps of 16 along D, the second 4 in the second half
  auto issue_s = [&](int j) {
    const uint32_t ks = ring + (j % kStages) * kStageBytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 bf16 within the 128-byte row
      const uint64_t a = desc128(qwg + (kk >> 2) * (kTcRows * kTcHalf) + off, 16, 1024);
      const uint64_t b = desc128(ks + (kk >> 2) * (kKeys * kTcHalf) + off, 16, 1024);
      if constexpr (kKeys == 128)
        wgmma_m64n128k16_ss(s, a, b, kk > 0);
      else
        wgmma_m64n64k16_ss(s, a, b, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_j: steps of 16 keys; V's halves (D 0-63, 64-127) are the
  // two 64-column atoms, 8 keys apart by 1024 bytes
  auto issue_pv = [&](int j) {
    const uint32_t vs = ring + (j % kStages) * kStageBytes + kKBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_m64n128k16_rs(o, pa[kk],
                          desc128(vs + kk * 16 * kTcHalf, kKeys * kTcHalf, 1024));
    wgmma_commit();
  };
  // local tile j's softmax on S (landed); only tiles crossing the
  // warpgroup's diagonal, kv_len or the window's edge test each key.  A
  // tile above (or before) all of a warpgroup's rows gives P = 0 and alpha
  // = 1: it adds nothing
  auto softmax = [&](int j, float& alpha_a, float& alpha_b) {
    fence_regs(s);
    const int k0 = (j0 + j) * kKeys;
    const int key0 = k0 + 2 * (lane & 3);
    if (k0 + kKeys > kv_len || k0 + kKeys - 1 > wg_first || k0 < wg_low)
      softmax_tile<true>(s, m_a, m_b, l_a, l_b, alpha_a, alpha_b, scale, key0,
                         lim_a, lim_b, low_a, low_b);
    else
      softmax_tile<false>(s, m_a, m_b, l_a, l_b, alpha_a, alpha_b, scale, key0,
                          lim_a, lim_b, low_a, low_b);
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
    for (int kk = 0; kk < kKeys / 16; ++kk) {
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
    mbar_arrive(empty + 8 * ((j - 1) % kStages));
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
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;  // l == 0: the row saw no key
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  __nv_bfloat16* oa = out + row_offset(r_a) + 2 * (lane & 3);
  __nv_bfloat16* ob = out + row_offset(r_a + 8) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(oa + 8 * j) = pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + 8 * j) = pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <typename KV, typename QMap, typename Rows>
__global__ void __launch_bounds__(kTcThreads, 1) prefill_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale, int window) {
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  prefill_tile_tc(q, cache, out, qmap, qinfo, rows, hq, hkv, pad_tile,
                  rows_total, layer, sm_scale, window, blockIdx.x, blockIdx.y,
                  tc_smem);
}

// query rows per block of the body for `dtype` (0 if none)
inline int block_rows(int dtype) {
  return dtype == kBFloat16 ? kTcRows : dtype == kFloat32 ? kRows : 0;
}

template <typename T, typename KV, typename Kernel, typename QMap, typename Rows>
int launch_one(Kernel kernel, int threads, int smem_bytes, int blocks,
               const void* q, const void* cache, void* out, QMap qmap,
               const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
               int pad_tile, long long rows_total, int layer, float sm_scale,
               int window, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(blocks, hkv);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(cache),
      static_cast<T*>(out), qmap, qinfo, rows, hq, hkv, pad_tile,
      rows_total, layer, sm_scale, window);
  return static_cast<int>(cudaGetLastError());
}

// The body of compute type T over storage KV: its kernel, threads and
// shared memory.
template <typename T, typename KV, typename QMap, typename Rows>
int launch_body(int blocks, const void* q, const void* cache, void* out,
                QMap qmap, const int* qinfo, Rows rows, int num_tokens,
                int hq, int hkv, int pad_tile, long long rows_total,
                int layer, float sm_scale, int window, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch_one<T, KV>(prefill_attention_kernel<T, KV, QMap, Rows>,
                             kThreads, kSmemBytes, blocks, q, cache, out, qmap,
                             qinfo, rows, num_tokens, hq, hkv, pad_tile,
                             rows_total, layer, sm_scale, window, s);
  else
    return launch_one<T, KV>(prefill_attention_tc_kernel<KV, QMap, Rows>,
                             kTcThreads, kTcSmemBytesFor<KV>, blocks, q, cache, out,
                             qmap, qinfo, rows, num_tokens, hq, hkv, pad_tile,
                             rows_total, layer, sm_scale, window, s);
}

// the least q tile, in tokens, of the body for `dtype` at `group` heads
// per kv head: R / gcd(R, group) (R = block_rows(dtype)), so that a tile's
// tile * group flattened rows fill whole blocks (0 if no body)
inline int min_q_tile(int dtype, int group) {
  const int r = block_rows(dtype);
  if (r == 0 || group <= 0) return 0;
  int a = r, b = group;
  while (b != 0) {
    const int c = a % b;
    a = b;
    b = c;
  }
  return r / a;
}

// q, out: [num_tokens, hq, 128] of `dtype`; cache: [L, 2, hkv, rows_total,
// 128] of `kv_dtype` (dtype, e4m3 or int8); qinfo: [K, 2] (int32); `qmap`
// maps each pad_tile-row tile to (run, local tile) and `rows` each run's
// key positions to arena rows; window: the sliding window (0: none).  hkv
// must divide hq, min_q_tile(dtype, hq/hkv) must divide pad_tile, and
// pad_tile num_tokens; the grid is num_tokens * (hq/hkv) / R blocks of R =
// block_rows(dtype) flattened (token, head) rows by hkv, and no block
// straddles a pad tile.
template <typename QMap, typename Rows>
int launch(const void* q, const void* cache, void* out, QMap qmap,
           const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
           int pad_tile, long long rows_total, int layer, float sm_scale,
           int window, int dtype, int kv_dtype, void* stream) {
  if (num_tokens <= 0) return 0;
  const int group = hkv > 0 && hq % hkv == 0 ? hq / hkv : 0;
  const int q_tile = min_q_tile(dtype, group);
  if (q_tile == 0 || window < 0 || pad_tile <= 0 || pad_tile % q_tile != 0 ||
      num_tokens % pad_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(static_cast<long long>(num_tokens) * group /
                                      block_rows(dtype));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VATTN_PREFILL_BODY(T, KV)                                            \
  launch_body<T, KV>(blocks, q, cache, out, qmap, qinfo, rows, num_tokens, hq, \
                     hkv, pad_tile, rows_total, layer, sm_scale, window, s)
  const bool f32 = dtype == kFloat32;
  if (kv_dtype == dtype)
    return f32 ? VATTN_PREFILL_BODY(float, float)
               : VATTN_PREFILL_BODY(__nv_bfloat16, __nv_bfloat16);
  if (kv_dtype == kFloat8E4M3)
    return f32 ? VATTN_PREFILL_BODY(float, fp8)
               : VATTN_PREFILL_BODY(__nv_bfloat16, fp8);
  if (kv_dtype == kInt8)
    return f32 ? VATTN_PREFILL_BODY(float, int8_t)
               : VATTN_PREFILL_BODY(__nv_bfloat16, int8_t);
#undef VATTN_PREFILL_BODY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace prefill
}  // namespace vattn
