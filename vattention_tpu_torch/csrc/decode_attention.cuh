// The batched GQA decode body shared by kernel C (decode_attention.cu) and
// kernel F's decode role (pod_attention.cu): one launch, splits over the
// live depth planned on the device, merged inside the launch.
//
// Both replace the TPU's _decode_kernel of vattention_tpu/ops/flash_decode.py
// (F its decode stream inside _pod_kernel of ops/pod_fused.py).  Slot b's
// single query token (Hq heads) attends arena rows of positions
// [lo_b, seqlens[b]), lo_b = max(0, seqlens[b] - window) under a sliding
// window (window > 0; the JAX kernel's kv_pos >= kv_len - window,
// flash_decode.py:120-121), else 0; position p lives at arena row
// tile_rows[b, p / sub] + p % sub.  Slots with seqlens[b] <= 0 write zeros,
// never NaN.
//
// Bound: bytes.  Every live K and V row is read once (2*Hkv*D elements per
// position) for G = Hq/Hkv heads: ~2G FLOPs per byte, far below the ridge.
//
// Heads: the G = Hq/Hkv query heads of a kv head go through the tensor
// cores in chunks of C = chunk_width(G) heads (G rounded up to 1, 2, 4 or
// 8, at most 8: the N of the tile), so a kv head is NC = cdiv(G, C) plan
// heads.  Falcon-7B's G = 71 is 9 chunks of 8 heads, the last 7 live
// (the eighth is a zero query, computed and never written); each chunk
// streams its kv head's rows itself, so an MQA slot's K/V is read 9 times,
// from L2 after the first.
//
// Split plan (`make_plan`, the same in every block; tests/test_torch_decode.py
// has a plain Python twin).  Work is counted in tiles of kTile = 64
// positions: slot b walks tiles [f_b, cdiv(seqlens[b], 64)), f_b =
// floor(lo_b / 64) (`first_tile`), so t_b = cdiv(seqlens[b], 64) - f_b
// tiles per plan head (`live_tiles`: a window sizes the plan, not the depth;
// only a slot's first tile holds positions below lo_b, masked there), W =
// H * sum t_b in all with H = Hkv * NC plan heads, and SH = H * #{b : t_b >
// 0} live (slot, head) pairs.  With P blocks (the wrapper gives a fixed
// multiple of the SM count, whatever the table's depth), a split takes at
// least c = max(min_tiles, cdiv(W, max(P - SH, P / 2, 1))) tiles (min_tiles:
// kMinTiles unless kernel C's caller gives another, as a sweep does), so
// (slot, head) (b, h) has n_b =
// cdiv(t_b, c) splits, split i covering tiles f_b + [i*t_b/n_b,
// (i+1)*t_b/n_b).
// Ranges are numbered slot-major, then head, then split; at most P + B*H
// exist (at most P when SH <= P/2), and block j runs ranges j, j + P, ...
// No range crosses a slot, idle slots get none.  Each block reads seqlens
// itself: nothing is read back to the host, and slots may be as deep as
// their tables.
//
// One range: the block's kWarps = 4 warps stream its tiles, warp w taking
// positions 16w .. 16w+15 of every tile.  Each warp fills a ring of
// kStages stages of its own 16 K rows and 16 V rows by cp.async: 16-byte
// chunks, issued kStages - 1 tiles ahead, zero-filled past the slot's
// depth, each row resolved one tile before its copy is issued.  A warp reads
// only the rows it copied, so cp.async groups and __syncwarp order the ring
// and no mbarrier or block barrier runs per tile.  Chosen over one
// cp.async.bulk per contiguous span: a bulk copy cannot swizzle, and the
// unswizzled 256-byte rows put ldmatrix's eight rows on the same banks; the
// widening step of a 1-byte ring sits between the ring and the ldmatrix
// reads (below).
//   bfloat16: a chunk's C heads are one tensor-core tile.  Per tile a
//     warp computes S^T = K Q^T (positions on M, heads on N = 8, C < 8 padded
//     with zero queries) with 8 mma.sync m16n8k16 whose A is K through
//     ldmatrix and whose B is Q, held in registers for the whole range;
//     updates an online softmax per head once per tile (column maxima over
//     the warp's 16 positions by 3 shuffles; base 2, ex2.approx); rounds P
//     to bf16 as the JAX kernel feeds p.astype(v.dtype) to its PV matmul,
//     turns S^T's accumulator fragment into the B operand of the next
//     product with movmatrix.trans; and adds O^T += V^T P^T with 8 mma.sync
//     whose A is V through ldmatrix.trans.  Rows are 256 bytes, 16-byte
//     chunk c of row r at chunk c ^ (r % 8): ldmatrix's eight rows fall on
//     distinct banks.  mma.sync, not wgmma m64n8k16: a warp owns its 16
//     positions and its ring, where wgmma's 64-row M would tie four warps
//     to one barrier per tile.
//   float32: the same plan, ring (rows padded to 132 floats) and
//     split arithmetic on the CUDA cores in exact float32 (expf), as TF32
//     would change the f32 path's greedy tokens.
// 1-byte K/V storage (e4m3 or int8, `KV`): the ring holds the arena's
// 128-byte rows (cp.async cannot convert; 8 lanes read one row, so no
// swizzle is needed), and once a stage has landed the warp widens it
// exactly into one more stage laid out as the compute type's ring (the
// swizzled 256-byte bf16 rows, or the padded f32 rows), then __syncwarp:
// ldmatrix, movmatrix and the mma.sync chain read that stage unchanged.  A
// ring of half the bytes plus one wide stage takes less shared memory than
// the bf16 ring.
// The 4 warps' states merge through shared memory into the range's
// unnormalised (max, sum, output).  A slot-head with one split writes O / l
// at once; otherwise each split writes its partial to `part` at its range
// index, fences and takes a ticket on its (slot, plan head) counter, and the
// split that takes the last ticket merges the n_b partials in a fixed
// order (so the result does not depend on which split finishes last; n_b
// is at most P, the merge's weights live in the rings) and resets the
// counter to 0 for the next launch.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace vattn {
namespace decode {

constexpr int kD = 128;                   // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                 // positions per plan tile
constexpr int kWarpPos = kTile / kWarps;  // positions per warp per tile
constexpr int kMinTiles = 4;              // a split's least tiles (default)
constexpr int kMaxSlots = 1024;           // batch limit of the plan's prefix
constexpr int kMaxGroup = 8;              // N of the tensor-core tile: a chunk's most heads
constexpr int kMaxGrid = 1024;            // blocks (bounds a merge's splits)

// the chunk width C for `group` query heads per kv head: the group rounded
// up to 1, 2, 4 or 8, at most 8 (the body's template argument G)
constexpr int chunk_width(int group) {
  return group <= 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : kMaxGroup;
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
constexpr int kStages = 3;
// bytes of one K or V row in the ring: bf16 256 (swizzled), f32 132 floats
template <typename T>
constexpr int kRowBytes = kBf16<T> ? kD * 2 : (kD + 4) * 4;
template <typename T>
constexpr int kStageBytes = 2 * kWarpPos * kRowBytes<T>;  // K rows, then V rows
// the ring of storage KV (1-byte rows of 128 bytes, else the compute
// layout's) and, for 1-byte storage, one stage widened to the compute layout
template <typename KV>
constexpr bool kNarrow = sizeof(KV) == 1;
template <typename T, typename KV>
constexpr int kRingRowBytes = kNarrow<KV> ? kD : kRowBytes<T>;
template <typename T, typename KV>
constexpr int kRingStageBytes = 2 * kWarpPos * kRingRowBytes<T, KV>;
template <typename T, typename KV>
constexpr int kWarpRing =
    kStages * kRingStageBytes<T, KV> + (kNarrow<KV> ? kStageBytes<T> : 0);

// one range's partial state: o[G][kD], then m[G], then l[G], padded to
// 16 bytes
template <int G>
constexpr int kPartFloats = (G * (kD + 2) + 3) / 4 * 4;
// a warp's state after its range, written over its own ring
constexpr int kStateFloats = kMaxGroup * (kD + 2);

// shared memory: the rings, the plan (cum[kMaxSlots + 1], red[kWarps],
// a flag), and in f32 the queries and each warp's P and alpha
constexpr int kPlanBytes = (kMaxSlots + 1 + kWarps + 3) * 4;
template <typename T, typename KV>
constexpr int kPlanOffset = kWarps * kWarpRing<T, KV>;
template <typename T, typename KV>
constexpr int kQOffset = kPlanOffset<T, KV> + kPlanBytes;
constexpr int kPWarpFloats = kWarpPos * kMaxGroup + kMaxGroup;
template <typename T, typename KV>
constexpr int kSmemBytes =
    kQOffset<T, KV> + (kBf16<T> ? 0 : (kMaxGroup * kD + kWarps * kPWarpFloats) * 4);

// ---- small helpers ------------------------------------------------------ //
__device__ __forceinline__ void sync() {  // the body's 4 warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the 8x8 b16 matrix whose row lane/4 holds columns 2*(lane%4), +1 in `x`,
// transposed: the result holds its column lane/4, rows 2*(lane%4), +1
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// c[16 x 8] += a[16 x 16] b[16 x 8]; bf16 in, f32 accumulate.  a: rows
// lane/4 (+8), columns 2*(lane%4) (+1) (+8); b: rows 2*(lane%4) (+1) (+8),
// column lane/4; c: rows lane/4 (c[0..1]) and lane/4 + 8 (c[2..3]), columns
// 2*(lane%4), +1
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// the softmax's exponential: base 2 on scores pre-scaled by log2(e) in
// bf16, natural and exact in f32
template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (kBf16<T>)
    return ex2(x);
  else
    return expf(x);
}
template <typename T>
__device__ __forceinline__ float score_scale(float sm_scale) {
  return kBf16<T> ? sm_scale * 1.4426950408889634f : sm_scale;
}
// byte offset of 16-byte chunk c of bf16 ring row r (256-byte rows)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 256 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ int tiles_of(int n) {
  return n > 0 ? (n + kTile - 1) / kTile : 0;
}
// the first tile a slot at depth n walks under `window` (0: none), and the
// number of tiles it walks
__device__ __forceinline__ int first_tile(int n, int window) {
  return window > 0 && n > window ? (n - window) / kTile : 0;
}
__device__ __forceinline__ int live_tiles(int n, int window) {
  return n > 0 ? tiles_of(n) - first_tile(n, window) : 0;
}

// exclusive prefix of v over the body's threads; `total` gets the sum
__device__ __forceinline__ int block_scan(int v, int* red, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  sync();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int r = red[w];
    if (w < warp) before += r;
    total += r;
  }
  sync();
  return before + x - v;
}

// The plan of the header: cum[b] = the first range of slot b, cum[batch] =
// the number of ranges, which it returns.  Every thread of the body calls
// it.
__device__ __forceinline__ int make_plan(const int* __restrict__ seqlens,
                                          int batch, int heads, int window,
                                          int nblocks, int min_tiles, int* cum,
                                          int* red) {
  const int per_thread = (batch + kThreads - 1) / kThreads;
  const int b0 = min(batch, static_cast<int>(threadIdx.x) * per_thread);
  const int b1 = min(batch, b0 + per_thread);
  int w = 0, live = 0;
  for (int b = b0; b < b1; ++b) {
    const int t = live_tiles(seqlens[b], window);
    w += t;
    live += t > 0;
  }
  int total_w, total_live;
  block_scan(w, red, total_w);
  block_scan(live, red, total_live);
  const long long W = static_cast<long long>(total_w) * heads;
  const int SH = total_live * heads;
  const int share = max(max(nblocks - SH, nblocks / 2), 1);
  const int per = static_cast<int>(max(static_cast<long long>(min_tiles),
                                       (W + share - 1) / share));
  int mine = 0;
  for (int b = b0; b < b1; ++b)
    mine += (live_tiles(seqlens[b], window) + per - 1) / per * heads;
  int ranges;
  int at = block_scan(mine, red, ranges);
  for (int b = b0; b < b1; ++b) {
    cum[b] = at;
    at += (live_tiles(seqlens[b], window) + per - 1) / per * heads;
  }
  if (threadIdx.x == 0) cum[batch] = ranges;
  sync();
  return ranges;
}

struct Range {
  int b, h;    // slot, the plan's head (a kv head's chunk of query heads)
  int i, n;    // split i of the slot-head's n
  int lo, hi;  // its tiles (absolute: first_tile is already added)
  int first;   // range index of split 0 of (b, h)
};

__device__ __forceinline__ Range find_range(int r, const int* cum, int batch,
                                            int heads, int window,
                                            const int* __restrict__ seqlens) {
  // the last slot whose first range is at or before r (idle slots own no
  // range, so ties resolve to the live slot after them)
  int lo = 0, hi = batch - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cum[mid] <= r)
      lo = mid;
    else
      hi = mid - 1;
  }
  Range g;
  g.b = lo;
  g.n = (cum[lo + 1] - cum[lo]) / heads;
  const int within = r - cum[lo];
  g.h = within / g.n;
  g.i = within - g.h * g.n;
  g.first = r - g.i;
  const long long t = live_tiles(seqlens[lo], window);
  const int f = first_tile(seqlens[lo], window);
  g.lo = f + static_cast<int>(g.i * t / g.n);
  g.hi = f + static_cast<int>((g.i + 1) * t / g.n);
  return g;
}

// ---- one range: each warp's online softmax over its positions ---------- //
// The range's chunk: the gn <= G query heads from `qg` (heads past gn are
// zero queries, computed and never written) on kv head `kvh`.  Writes the
// warp's state (o[kMaxGroup][kD], m[kMaxGroup], l[kMaxGroup], o
// unnormalised) over the warp's own ring at `ring_ptr`.
template <typename T, typename KV, int G>
__device__ __forceinline__ void warp_range(
    const T* __restrict__ qg, int gn, int kvh, const KV* __restrict__ cache,
    const int* __restrict__ tile_rows, int hkv, int n_sub, int sub,
    long long rows_total, int layer, float sm_scale, const Range& rg, int lo,
    int n, unsigned char* ring_ptr, float* qs, float* pw) {
  constexpr int S = kStages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t ring = sm90::smem_addr(ring_ptr);
  const long long head_stride = rows_total * kD;
  const KV* kbase = cache + (static_cast<long long>(layer * 2) * hkv + kvh) * head_stride;
  const KV* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + kvh) * head_stride;
  const int* trow = tile_rows + static_cast<long long>(rg.b) * n_sub;
  const int ntiles = rg.hi - rg.lo;
  const int pos0 = rg.lo * kTile + kWarpPos * warp;  // the warp's first position
  const float scale = score_scale<T>(sm_scale);

  // arena row of the warp's position lane % 16 of tile j (-1 outside the
  // slot's positions [lo, n))
  auto row_at = [&](int j) -> long long {
    const int p = pos0 + j * kTile + (lane & 15);
    return (j < ntiles && p < n && p >= lo)
               ? static_cast<long long>(trow[p / sub]) + p % sub
               : -1;
  };
  // tile j's 16 K and V rows into stage j % S (an empty group past the range)
  auto issue = [&](int j, long long mine) {
    if (j < ntiles) {
      const uint32_t st = ring + (j % S) * kRingStageBytes<T, KV>;
      constexpr uint32_t vofs = kWarpPos * kRingRowBytes<T, KV>;
      if constexpr (kNarrow<KV>) {
        const int c = lane & 7;  // each 8 lanes one 128-byte row
#pragma unroll
        for (int i = 0; i < kWarpPos / 4; ++i) {
          const int k = 4 * i + (lane >> 3);
          const long long row = __shfl_sync(0xffffffffu, mine, k);
          const long long src = (row < 0 ? 0 : row) * kD + c * 16;
          const uint32_t off = k * kD + c * 16;
          sm90::cp_async16(st + off, kbase + src, row >= 0);
          sm90::cp_async16(st + vofs + off, vbase + src, row >= 0);
        }
      } else if constexpr (kBf16<T>) {
        const int c = lane & 15;  // each half-warp one 256-byte row
#pragma unroll
        for (int i = 0; i < kWarpPos / 2; ++i) {
          const int k = 2 * i + (lane >> 4);
          const long long row = __shfl_sync(0xffffffffu, mine, k);
          const long long src = (row < 0 ? 0 : row) * kD + c * 8;
          sm90::cp_async16(st + swz(k, c), kbase + src, row >= 0);
          sm90::cp_async16(st + vofs + swz(k, c), vbase + src, row >= 0);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kWarpPos; ++k) {  // each warp one 512-byte row
          const long long row = __shfl_sync(0xffffffffu, mine, k);
          const long long src = (row < 0 ? 0 : row) * kD + lane * 4;
          const uint32_t off = k * kRowBytes<T> + lane * 16;
          sm90::cp_async16(st + off, kbase + src, row >= 0);
          sm90::cp_async16(st + vofs + off, vbase + src, row >= 0);
        }
      }
    }
    cp_async_commit();
  };

  // The compute-layout stage that tile j is read from, after its copies
  // have landed: the ring's stage, or for 1-byte storage the stage after
  // the ring, into which the warp widens tile j's rows (one uint4 of 16
  // values per lane and row) before a __syncwarp.
  unsigned char* wide = ring_ptr + S * kRingStageBytes<T, KV>;
  auto stage_of = [&](int j) -> unsigned char* {
    if constexpr (kNarrow<KV>) {
      const unsigned char* st = ring_ptr + (j % S) * kRingStageBytes<T, KV>;
      const int c = lane & 7;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        unsigned char* dst = wide + kv * kWarpPos * kRowBytes<T>;
#pragma unroll
        for (int i = 0; i < kWarpPos / 4; ++i) {
          const int k = 4 * i + (lane >> 3);
          const uint4 x = *reinterpret_cast<const uint4*>(st + (kv * kWarpPos + k) * kD + c * 16);
          if constexpr (kBf16<T>) {
            // bf16 chunks 2c and 2c + 1 of row k, the odd one first on
            // lanes c >= 4: a quarter-warp's stores fall on 8 distinct
            // bank groups
            uint4 lo, hi;
            widen16_bf16<KV>(x, lo, hi);
            const bool odd = (c >> 2) & 1;
            const int first = 2 * c + odd;
            *reinterpret_cast<uint4*>(dst + swz(k, first)) = odd ? hi : lo;
            *reinterpret_cast<uint4*>(dst + swz(k, 4 * c + 1 - first)) = odd ? lo : hi;
          } else {
            float4* d = reinterpret_cast<float4*>(dst + k * kRowBytes<T> + c * 64);
            d[0] = widen4_f32(x.x, KV{});
            d[1] = widen4_f32(x.y, KV{});
            d[2] = widen4_f32(x.z, KV{});
            d[3] = widen4_f32(x.w, KV{});
          }
        }
      }
      __syncwarp();
      return wide;
    } else {
      return ring_ptr + (j % S) * kStageBytes<T>;
    }
  };

  float* state = reinterpret_cast<float*>(ring_ptr);

  if constexpr (kBf16<T>) {
    // Q as mma's B, one pair of registers per 16 of D: head lane/4 (zero
    // past gn), elements 2*(lane%4) (+1) (+8)
    uint32_t qb[kD / 16][2];
    {
      const int g = lane >> 2;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(qg + min(g, gn - 1) * kD);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qb[kk][0] = g < gn ? qrow[8 * kk + (lane & 3)] : 0u;
        qb[kk][1] = g < gn ? qrow[8 * kk + 4 + (lane & 3)] : 0u;
      }
    }
    float o[kD / 16][4];  // O^T: d = 16mt + lane/4 (+8), heads 2*(lane%4) (+1)
    float m[2], l[2];     // the softmax of heads 2*(lane%4) (+1)
#pragma unroll
    for (int mt = 0; mt < kD / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    long long next = row_at(0);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      const long long mine = next;
      next = row_at(s + 1);
      issue(s, mine);
    }
    for (int j = 0; j < ntiles; ++j) {
      {
        const long long mine = next;
        next = row_at(j + S);
        issue(j + S - 1, mine);
      }
      cp_async_wait<S - 1>();
      __syncwarp();
      const uint32_t ks = sm90::smem_addr(stage_of(j));
      const uint32_t vs = ks + kWarpPos * kRowBytes<T>;
      // S^T = K Q^T over 8 steps of 16 along D
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int r = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, ks + swz(r, 2 * kk + (lane >> 4)));
          mma_16816(sacc, a, qb[kk][0], qb[kk][1]);
        }
      }
      // the online softmax, once per tile per head
      const int pa = pos0 + j * kTile + (lane >> 2);
      const bool va = pa >= lo && pa < n, vb = pa + 8 >= lo && pa + 8 < n;
      float alpha[2], p_a[2], p_b[2];
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        float mx = fmaxf(va ? sacc[gi] : -INFINITY, vb ? sacc[2 + gi] : -INFINITY);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float mn = fmaxf(m[gi], mx * scale);
        alpha[gi] = m[gi] == -INFINITY ? 0.f : ex2(m[gi] - mn);
        m[gi] = mn;
        p_a[gi] = va ? ex2(fmaf(sacc[gi], scale, -mn)) : 0.f;
        p_b[gi] = vb ? ex2(fmaf(sacc[2 + gi], scale, -mn)) : 0.f;
        l[gi] = l[gi] * alpha[gi] + p_a[gi] + p_b[gi];
      }
#pragma unroll
      for (int mt = 0; mt < kD / 16; ++mt) {
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
      }
      // P^T as mma's B: positions 2*(lane%4) (+1) (+8), head lane/4
      const uint32_t pb0 = movmatrix_trans(pack2(p_a[0], p_a[1]));
      const uint32_t pb1 = movmatrix_trans(pack2(p_b[0], p_b[1]));
      // O^T += V^T P^T, one step of 16 positions per 16 of D
      {
        const int r = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
        for (int mt = 0; mt < kD / 16; ++mt) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, vs + swz(r, 2 * mt + ((lane >> 3) & 1)));
          mma_16816(o[mt], a, pb0, pb1);
        }
      }
      __syncwarp();  // stage j (and the widened stage) is read: the next
                     // issue may refill it
    }
    // the warp's state over its ring (every copy has landed and been read)
#pragma unroll
    for (int gi = 0; gi < 2; ++gi) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], 4);
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], 8);
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], 16);
    }
    const int g0 = 2 * (lane & 3);
    if (lane < 4) {
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        state[kMaxGroup * kD + g0 + gi] = m[gi];
        state[kMaxGroup * kD + kMaxGroup + g0 + gi] = l[gi];
      }
    }
#pragma unroll
    for (int mt = 0; mt < kD / 16; ++mt) {
      const int d = 16 * mt + (lane >> 2);
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        state[(g0 + gi) * kD + d] = o[mt][gi];
        state[(g0 + gi) * kD + d + 8] = o[mt][2 + gi];
      }
    }
  } else {
    // f32: lane (p = lane % 16, heads lane/16 + 2u) scores its position;
    // lane owns output dims lane + 32i of every head
    const int p = lane & 15;
    const int gs = lane >> 4;
    constexpr int U = (G + 1) / 2;  // heads per lane
    float mu[U], lu[U], acc[G][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mu[u] = -INFINITY;
      lu[u] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    float* ps = pw;                          // P[16][kMaxGroup]
    float* alph = pw + kWarpPos * kMaxGroup;  // alpha[kMaxGroup]

    long long next = row_at(0);
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      const long long mine = next;
      next = row_at(s + 1);
      issue(s, mine);
    }
    for (int j = 0; j < ntiles; ++j) {
      {
        const long long mine = next;
        next = row_at(j + S);
        issue(j + S - 1, mine);
      }
      cp_async_wait<S - 1>();
      __syncwarp();
      const float* kst = reinterpret_cast<const float*>(stage_of(j));
      const float* vst = kst + kWarpPos * (kRowBytes<T> / 4);
      const int pj = pos0 + j * kTile + p;
      const bool valid = pj >= lo && pj < n;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int g = gs + 2 * u;
        float s = 0.f;
        if (g < G) {
          const float* krow = kst + p * (kRowBytes<T> / 4);
          const float* qrow = qs + g * kD;
#pragma unroll 8
          for (int d = 0; d < kD; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(krow + d);
            const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
            s = fmaf(kv.x, qv.x, s);
            s = fmaf(kv.y, qv.y, s);
            s = fmaf(kv.z, qv.z, s);
            s = fmaf(kv.w, qv.w, s);
          }
        }
        float x = valid ? s * scale : -INFINITY;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        const float mn = fmaxf(mu[u], mx);
        const float alpha = mu[u] == -INFINITY ? 0.f : expf(mu[u] - mn);
        mu[u] = mn;
        const float pe = valid ? expf(x - mn) : 0.f;
        lu[u] = lu[u] * alpha + pe;
        if (g < G) {
          ps[p * kMaxGroup + g] = pe;
          if (p == 0) alph[g] = alpha;
        }
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a = alph[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] *= a;
      }
#pragma unroll 4
      for (int k = 0; k < kWarpPos; ++k) {
        const float* vrow = vst + k * (kRowBytes<T> / 4) + lane;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = vrow[32 * i];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pk = ps[k * kMaxGroup + g];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(pk, v[i], acc[g][i]);
        }
      }
      __syncwarp();  // stage j and P are read
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      lu[u] += __shfl_xor_sync(0xffffffffu, lu[u], 1);
      lu[u] += __shfl_xor_sync(0xffffffffu, lu[u], 2);
      lu[u] += __shfl_xor_sync(0xffffffffu, lu[u], 4);
      lu[u] += __shfl_xor_sync(0xffffffffu, lu[u], 8);
      const int g = gs + 2 * u;
      if (p == 0 && g < G) {
        state[kMaxGroup * kD + g] = mu[u];
        state[kMaxGroup * kD + kMaxGroup + g] = lu[u];
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) state[g * kD + lane + 32 * i] = acc[g][i];
  }
}

// The merge of one (slot, chunk)'s n split partials at `src` into its
// output `o` (the chunk's first gn heads), by the body's threads, with
// `wsm` (2*n*G + G floats of shared memory) for the splits' maxima and
// sums: per head a warp finds the maximum and turns each split's maximum
// into its weight and the sum
// of weighted sums (a fixed lane order), then every thread adds the
// weighted outputs of 4 consecutive elements over the splits in split
// order.  Partials are read through L2 (__ldcg): other blocks wrote them
// during this launch.
template <typename T, int G>
__device__ __forceinline__ void merge_splits(const float* __restrict__ src,
                                             T* __restrict__ o, int n, int gn,
                                             float* wsm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* lsm = wsm + n * G;
  float* inv = lsm + n * G;
  for (int k = tid; k < n * G; k += kThreads) {
    const int s = k / G;
    const float* ps = src + s * kPartFloats<G> + G * kD + (k - s * G);
    wsm[k] = __ldcg(ps);
    lsm[k] = __ldcg(ps + G);
  }
  sync();
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, wsm[s * G + g]);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float w = softmax_exp<T>(wsm[s * G + g] - mx);
      wsm[s * G + g] = w;
      l += lsm[s * G + g] * w;
    }
    l = warp_sum(l);
    if (lane == 0) inv[g] = l;
  }
  sync();
  for (int v = tid; v < gn * kD / 4; v += kThreads) {
    const int g = 4 * v / kD;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(src + s * kPartFloats<G>) + v);
      const float w = wsm[s * G + g];
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    const float l = inv[g];
    o[4 * v] = from_float<T>(acc.x / l);
    o[4 * v + 1] = from_float<T>(acc.y / l);
    o[4 * v + 2] = from_float<T>(acc.z / l);
    o[4 * v + 3] = from_float<T>(acc.w / l);
  }
}

// ---- the body: plan, idle zeros, ranges, merges ------------------------ //
// Run by the kThreads threads 0..kThreads-1 of block `blk` of `nblocks`
// over `smem` (kSmemBytes<T, KV>, 128-byte aligned), nblocks <= kMaxGrid.
// `group` heads share each kv head; G is the chunk width (chunk_width:
// `group` rounded up to 1, 2, 4 or 8, at most 8), and the plan's heads are
// the hv = hkv * cdiv(group, G) (kv head, chunk) pairs.  `part` (16-byte
// aligned) holds kPartFloats<G> floats for each of nblocks + batch*hv
// ranges; `tickets` batch*hv counters, 0 before the launch and 0 after
// it; `window` the sliding window (0: none).
template <typename T, typename KV, int G>
__device__ __forceinline__ void decode_blocks(
    const T* __restrict__ q, const KV* __restrict__ cache, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets,
    const int* __restrict__ tile_rows, const int* __restrict__ seqlens,
    int batch, int hkv, int group, int n_sub, int sub, long long rows_total,
    int layer, float sm_scale, int window, int blk, int nblocks,
    unsigned char* smem, int min_tiles = kMinTiles) {
  static_assert(G >= 1 && G <= kMaxGroup, "chunk width");
  static_assert(kStateFloats * 4 <= kWarpRing<T, KV>,
                "a warp's state fits in its ring");
  static_assert((2 * kMaxGrid + 1) * kMaxGroup * 4 <= kWarps * kWarpRing<T, KV>,
                "a merge's weights fit in the rings");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int hq = hkv * group;
  const int chunks = (group + G - 1) / G;  // head chunks per kv head
  const int hv = hkv * chunks;             // the plan's (kv head, chunk) pairs
  int* cum = reinterpret_cast<int*>(smem + kPlanOffset<T, KV>);
  int* red = cum + kMaxSlots + 1;
  int* flag = red + kWarps;
  float* qs = reinterpret_cast<float*>(smem + kQOffset<T, KV>);  // f32 only
  float* pw = qs + kMaxGroup * kD + warp * kPWarpFloats;      // f32 only
  unsigned char* ring = smem + warp * kWarpRing<T, KV>;

  // idle slots: zeros, spread over the blocks
  for (int bh = blk; bh < batch * hkv; bh += nblocks) {
    if (seqlens[bh / hkv] > 0) continue;
    T* o = out + static_cast<long long>(bh) * group * kD;
    for (int idx = tid; idx < group * kD; idx += kThreads) o[idx] = from_float<T>(0.f);
  }
  const int ranges =
      make_plan(seqlens, batch, hv, window, nblocks, min_tiles, cum, red);

  for (int r = blk; r < ranges; r += nblocks) {
    const Range rg = find_range(r, cum, batch, hv, window, seqlens);
    const int n = seqlens[rg.b];
    const int lo = window > 0 ? max(0, n - window) : 0;
    const int kvh = rg.h / chunks;
    const int g0 = (rg.h - kvh * chunks) * G;  // the chunk's first head
    const int gn = min(G, group - g0);         // and its heads
    const long long head0 = (static_cast<long long>(rg.b) * hq + kvh * group + g0) * kD;
    T* o = out + head0;
    const T* qg = q + head0;
    if constexpr (!kBf16<T>) {
      for (int idx = tid; idx < G * kD; idx += kThreads)
        qs[idx] = idx < gn * kD ? qg[idx] : 0.f;
      sync();
    }
    warp_range<T, KV, G>(qg, gn, kvh, cache, tile_rows, hkv, n_sub, sub,
                         rows_total, layer, sm_scale, rg, lo, n, ring, qs, pw);
    sync();
    // merge the warps' states, in warp order; warps that saw no position
    // (max -inf) add nothing; some warp saw one (every range holds a
    // position in [lo, n): split 0 starts at lo's tile)
    float* dst = part + static_cast<long long>(r) * kPartFloats<G>;
    for (int idx = tid; idx < G * kD; idx += kThreads) {
      const int g = idx / kD;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* st = reinterpret_cast<const float*>(smem + w * kWarpRing<T, KV>);
        mx = fmaxf(mx, st[kMaxGroup * kD + g]);
      }
      float lsum = 0.f, osum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* st = reinterpret_cast<const float*>(smem + w * kWarpRing<T, KV>);
        const float mw = st[kMaxGroup * kD + g];
        if (mw == -INFINITY) continue;
        const float c = softmax_exp<T>(mw - mx);
        lsum += st[kMaxGroup * kD + kMaxGroup + g] * c;
        osum += st[idx] * c;
      }
      if (rg.n == 1) {
        if (idx < gn * kD) o[idx] = from_float<T>(osum / lsum);
      } else {
        dst[idx] = osum;
        if (idx % kD == 0) {
          dst[G * kD + g] = mx;
          dst[G * kD + G + g] = lsum;
        }
      }
    }
    if (rg.n > 1) {
      // publish the partial, then take a ticket: the last split merges
      __threadfence();
      sync();
      if (tid == 0) {
        int* ticket = tickets + rg.b * hv + rg.h;
        const int last = atomicAdd(ticket, 1) == rg.n - 1;
        if (last) atomicExch(ticket, 0);  // every split has taken its ticket
        *flag = last;
      }
      sync();
      if (*flag) {
        __threadfence();
        merge_splits<T, G>(part + static_cast<long long>(rg.first) * kPartFloats<G>,
                           o, rg.n, gn, reinterpret_cast<float*>(smem));
      }
    }
    sync();  // the rings, the queries and the flag are free for the next range
  }
}

}  // namespace decode
}  // namespace vattn
