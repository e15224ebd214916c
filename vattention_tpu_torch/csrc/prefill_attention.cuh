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
// pair against 2*Hkv*D K/V elements per key row read).
// Design: one block per (q tile of 64/G tokens, kv head): its 64 query
// rows are the G heads of one GQA group for each token, so every K/V row
// staged in shared memory serves G heads.  The block walks key tiles only
// up to its causal diagonal and keeps an online softmax per row in
// float32.  Each key position resolves its own row, so a key tile may
// span several table entries (blocks of 16 tokens under a 64-key tile).
//   bfloat16: the two products run on the tensor cores (WMMA 16x16x16,
//     float32 accumulate).  4 warps each own 16 query rows; per 64-key
//     tile a warp computes S = Q K^T into shared memory, two threads per
//     row update the softmax and write P as bfloat16 (the JAX kernel also
//     feeds p.astype(v.dtype) to its PV matmul), the warp computes P V
//     into shared memory, and the row's two threads rescale and add it
//     to their 64 output lanes held in registers.
//   float32: the same algorithm on the CUDA cores (32-key tiles, 4
//     threads per row), exact float32 products for the f32 test path.
#pragma once

#include <mma.h>

#include "common.cuh"

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
constexpr int kRows = 64;             // query rows (token, head) per block
constexpr int kKeys = 32;             // keys per tile
constexpr int kThreads = kRows * 4;   // 4 threads per query row
constexpr int kQStride = kD + 1;      // padded: conflict-free row reads
constexpr int kKStride = kD + 1;
constexpr int kSmemBytes =
    (kRows * kQStride + kKeys * kKStride + kKeys * kD) * static_cast<int>(sizeof(float));

// Barrier of the bodies below over the whole block (kernels B, E, G, H).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The float32 body: q tile `tile` (kRows/G tokens) of kv head `h`, run by
// kThreads threads (local index `tid`) over `smem` (kSmemBytes).
template <typename T, typename QMap, typename Rows, typename Sync>
__device__ __forceinline__ void prefill_tile(
    const T* __restrict__ q, const T* __restrict__ cache, T* __restrict__ out,
    QMap qmap, const int* __restrict__ qinfo, Rows rows,
    int hq, int hkv, int pad_tile, long long rows_total, int layer,
    float sm_scale, int tile, int h, int tid, float* smem, Sync sync) {
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
    sync();  // the previous tile's K/V are no longer read
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
    sync();

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
                  threadIdx.x, smem, BlockSync{});
}

// ---- bfloat16 on the tensor cores ----------------------------------- //
constexpr int kTcKeys = 64;               // keys per tile
constexpr int kTcThreads = 128;           // 4 warps x 16 query rows
// shared-memory row strides: multiples of 8 bf16 / 4 f32 elements (WMMA
// leading dimensions) that keep every 16-row fragment 32-byte aligned
constexpr int kLdQ = kD + 8;
constexpr int kLdKV = kD + 8;
constexpr int kLdP = kTcKeys + 8;
constexpr int kLdS = kTcKeys + 4;
constexpr int kLdO = kD + 4;
constexpr int kTcSmemBytes =
    (kRows * kLdQ + 2 * kTcKeys * kLdKV + kRows * kLdP) * 2 +
    (kRows * kLdS + kRows * kLdO) * 4;

// Barrier over one 128-thread half of a block (kernel F, whose blocks run
// two bf16 q tiles, one per half): named barrier `id` (1 or 2; 0 is
// __syncthreads').
struct HalfSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kTcThreads) : "memory");
  }
};

// The bfloat16 body: q tile `tile` of kv head `h`, run by kTcThreads
// threads (local index `tid`) over `smem` (kTcSmemBytes, 128-byte aligned).
template <typename QMap, typename Rows, typename Sync>
__device__ __forceinline__ void prefill_tile_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale, int tile, int h, int tid,
    unsigned char* smem, Sync sync) {
  namespace wmma = nvcuda::wmma;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);      // [kRows][kLdQ]
  __nv_bfloat16* ks = qs + kRows * kLdQ;                            // [kTcKeys][kLdKV]
  __nv_bfloat16* vs = ks + kTcKeys * kLdKV;                         // [kTcKeys][kLdKV]
  __nv_bfloat16* ps = vs + kTcKeys * kLdKV;                         // [kRows][kLdP]
  float* ss = reinterpret_cast<float*>(ps + kRows * kLdP);         // [kRows][kLdS]
  float* os = ss + kRows * kLdS;                                    // [kRows][kLdO]

  const int group = hq / hkv;
  const int qtok = kRows / group;
  const int tok0 = tile * qtok;
  const int pt = tok0 / pad_tile;
  const int2 qt = qmap(pt);
  const int run = qt.x;
  const int lqt = qt.y;
  const int q_start = qinfo[2 * run];
  const int kv_len = qinfo[2 * run + 1];
  const int pos0 = q_start + lqt * pad_tile + (tok0 - pt * pad_tile);

  const int warp = tid >> 5;
  // softmax/output ownership: row r = tid/2 (so warp w owns rows
  // 16w..16w+15, the rows its WMMA tiles produce), side = which 32 keys of
  // a tile and which 64 output lanes
  const int r = tid >> 1;
  const int side = tid & 1;
  const int t = r / group;
  const int g = r - t * group;
  const long long tok_stride = static_cast<long long>(hq) * kD;
  __nv_bfloat16* orow = out + static_cast<long long>(tok0 + t) * tok_stride +
                        static_cast<long long>(h * group + g) * kD + side * 64;

  if (kv_len <= 0) {
    for (int i = 0; i < 64; ++i) orow[i] = __float2bfloat16(0.f);
    return;
  }

  // stage the queries, 16-byte chunks: row rr = (token rr/group, head h*group + rr%group)
  for (int i = tid; i < kRows * (kD / 8); i += kTcThreads) {
    const int rr = i / (kD / 8);
    const int c = i - rr * (kD / 8);
    const int tt = rr / group;
    const int gg = rr - tt * group;
    const uint4* src = reinterpret_cast<const uint4*>(
        q + static_cast<long long>(tok0 + tt) * tok_stride +
        static_cast<long long>(h * group + gg) * kD);
    *reinterpret_cast<uint4*>(qs + rr * kLdQ + c * 8) = src[c];
  }

  const int q_pos = pos0 + t;
  const int n_keys = min(kv_len, pos0 + qtok);  // causal diagonal of the tile
  const long long head_stride = rows_total * kD;
  const __nv_bfloat16* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride;
  const __nv_bfloat16* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride;
  const auto row_of = rows.run(run, kv_len);

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kTcKeys) {
    sync();  // the previous tile's K/V are no longer read
    for (int i = tid; i < kTcKeys * (kD / 8); i += kTcThreads) {
      const int c = i / (kD / 8);
      const int part = i - c * (kD / 8);
      const int p = k0 + c;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (p < n_keys) {
        const long long row = row_of(p);
        kv = reinterpret_cast<const uint4*>(kbase + row * kD)[part];
        vv = reinterpret_cast<const uint4*>(vbase + row * kD)[part];
      }
      *reinterpret_cast<uint4*>(ks + c * kLdKV + part * 8) = kv;
      *reinterpret_cast<uint4*>(vs + c * kLdKV + part * 8) = vv;
    }
    sync();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + warp * 16 * kLdQ + kk, kLdQ);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ks + j * 16 * kLdKV + kk, kLdKV);
          wmma::mma_sync(sacc[j], a, b, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(ss + warp * 16 * kLdS + j * 16, sacc[j], kLdS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of row r over keys side*32 .. side*32+31 of the tile
    const float* srow = ss + r * kLdS + side * 32;
    const int p0 = k0 + side * 32;
    float mt = kMaskValue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool valid = p0 + j < n_keys && p0 + j <= q_pos;
      mt = fmaxf(mt, valid ? srow[j] * sm_scale : kMaskValue);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));  // the row's other side
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    __nv_bfloat16* prow = ps + r * kLdP + side * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool valid = p0 + j < n_keys && p0 + j <= q_pos;
      const float p = valid ? expf(srow[j] * sm_scale - m_new) : 0.f;
      psum += p;
      prow[j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // P V for this warp's 16 rows x 128 lanes, in two passes of 64 lanes
#pragma unroll
    for (int jb = 0; jb < 8; jb += 4) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < kTcKeys; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + warp * 16 * kLdP + kk, kLdP);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, vs + kk * kLdKV + (jb + j) * 16, kLdKV);
          wmma::mma_sync(oacc[j], a, b, oacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(os + warp * 16 * kLdO + (jb + j) * 16, oacc[j],
                                kLdO, wmma::mem_row_major);
    }
    __syncwarp();

    const float* pv = os + r * kLdO + side * 64;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(pv + i);
      o[i] = o[i] * alpha + v.x;
      o[i + 1] = o[i + 1] * alpha + v.y;
      o[i + 2] = o[i + 2] * alpha + v.z;
      o[i + 3] = o[i + 3] * alpha + v.w;
    }
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) orow[i] = __float2bfloat16(o[i] / l);
}

template <typename QMap, typename Rows>
__global__ void __launch_bounds__(kTcThreads) prefill_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
    __nv_bfloat16* __restrict__ out, QMap qmap,
    const int* __restrict__ qinfo, Rows rows, int hq, int hkv, int pad_tile,
    long long rows_total, int layer, float sm_scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  prefill_tile_tc(q, cache, out, qmap, qinfo, rows, hq, hkv, pad_tile,
                  rows_total, layer, sm_scale, blockIdx.x, blockIdx.y,
                  threadIdx.x, tc_smem, BlockSync{});
}

template <typename Kernel, typename T, typename QMap, typename Rows>
int launch_one(Kernel kernel, int threads, int smem_bytes, const void* q,
               const void* cache, void* out, QMap qmap,
               const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
               int pad_tile, long long rows_total, int layer, float sm_scale,
               cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int qtok = kRows / (hq / hkv);
  const dim3 grid(num_tokens / qtok, hkv);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache),
      static_cast<T*>(out), qmap, qinfo, rows, hq, hkv, pad_tile,
      rows_total, layer, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// q, out: [num_tokens, hq, 128]; cache: [L, 2, hkv, rows_total, 128];
// qinfo: [K, 2] (int32); `qmap` maps each pad_tile-row tile to (run, local
// tile) and `rows` each run's key positions to arena rows.  hq/hkv must
// divide 64, and 64/(hq/hkv) must divide pad_tile, which must divide
// num_tokens.
template <typename QMap, typename Rows>
int launch(const void* q, const void* cache, void* out, QMap qmap,
           const int* qinfo, Rows rows, int num_tokens, int hq, int hkv,
           int pad_tile, long long rows_total, int layer, float sm_scale,
           int dtype, void* stream) {
  if (num_tokens <= 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group <= 0 || kRows % group != 0 || pad_tile <= 0 ||
      pad_tile % (kRows / group) != 0 || num_tokens % pad_tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_one<decltype(&prefill_attention_kernel<float, QMap, Rows>), float>(
        prefill_attention_kernel<float, QMap, Rows>, kThreads, kSmemBytes, q,
        cache, out, qmap, qinfo, rows, num_tokens, hq, hkv, pad_tile,
        rows_total, layer, sm_scale, s);
  if (dtype == kBFloat16)
    return launch_one<decltype(&prefill_attention_tc_kernel<QMap, Rows>), __nv_bfloat16>(
        prefill_attention_tc_kernel<QMap, Rows>, kTcThreads, kTcSmemBytes, q,
        cache, out, qmap, qinfo, rows, num_tokens, hq, hkv, pad_tile,
        rows_total, layer, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace prefill
}  // namespace vattn
