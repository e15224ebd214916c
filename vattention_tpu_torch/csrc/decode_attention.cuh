// The batched GQA decode body shared by kernel C (two launches: pass 1,
// then the merge) and kernel F (POD: pass 1 and the merge in one launch).
//
// Both replace the TPU's _decode_kernel of vattention_tpu/ops/flash_decode.py
// (F its decode stream inside _pod_kernel of ops/pod_fused.py).  Slot b's
// single query token (Hq heads) attends arena rows of positions
// [0, seqlens[b]); position p lives at arena row tile_rows[b, p / sub] +
// p % sub.  Slots with seqlens[b] == 0 write zeros.
//
// Pass 1 (`decode_split`): one block of kWarps warps per (slot, kv head,
// split of `chunk` positions) covers the G = Hq/Hkv query heads sharing
// the head's K/V rows, so each row is read once for G heads; the warps take
// the split's positions round-robin, each reading one K and one V row per
// position (4 elements per lane), reducing the G scores across the warp and
// keeping an online softmax per head in registers; the warps' states are
// merged through shared memory into one unnormalised (max, sum, output) per
// split.  Splits past a slot's depth return at once.  The merge
// (`decode_merge`) combines the splits that hold positions, in split
// order, and normalises.
#pragma once

#include "common.cuh"

namespace vattn {
namespace decode {

constexpr int kD = 128;  // head dim (4 elements per lane)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// one split's partial state: acc[G][kD], then m[G], then l[G]
template <int G>
constexpr int kPartFloats = G * (kD + 2);

// shared memory of pass 1: acc[kWarps][G][kD], then m[kWarps][G], then
// l[kWarps][G]
template <int G>
constexpr int kSmemFloats = kWarps * G * (kD + 2);

// Pass 1 for split `split` of (slot, head) `bh = b * hkv + h`, run by the
// kThreads threads of one block over `smem` (kSmemFloats<G> floats).
// Writes the split's partial to `part` at [bh][split] of [.][nsplit] and
// returns true; returns false, writing nothing, when the split holds no
// position.  The early return is uniform over the block.
template <typename T, int G>
__device__ __forceinline__ bool decode_split(
    const T* __restrict__ q, const T* __restrict__ cache,
    float* __restrict__ part, const int* __restrict__ tile_rows,
    const int* __restrict__ seqlens, int hkv, int n_sub, int sub,
    long long rows_total, int layer, float sm_scale, int chunk, int bh,
    int split, int nsplit, float* smem) {
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = seqlens[b];
  const int start = split * chunk;
  if (start >= n) return false;  // the merge reads only splits that hold positions
  const int end = min(n, start + chunk);
  const int hq = hkv * G;

  float qr[G][4];
  const T* qb = q + (static_cast<long long>(b) * hq + h * G) * kD + lane * 4;
#pragma unroll
  for (int g = 0; g < G; ++g) load4(qb + g * kD, qr[g]);

  const long long head_stride = rows_total * kD;
  const T* kbase = cache + (static_cast<long long>(layer * 2) * hkv + h) * head_stride + lane * 4;
  const T* vbase = cache + (static_cast<long long>(layer * 2 + 1) * hkv + h) * head_stride + lane * 4;
  const int* trow = tile_rows + static_cast<long long>(b) * n_sub;

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }

  // software pipeline: the next position's K/V loads are issued before the
  // current position's arithmetic
  float kf[4], vf[4];
  int j = start + warp;
  if (j < end) {
    const long long row = trow[j / sub] + (j % sub);
    load4(kbase + row * kD, kf);
    load4(vbase + row * kD, vf);
  }
  for (; j < end; j += kWarps) {
    float kn[4], vn[4];
    const int jn = j + kWarps;
    if (jn < end) {
      const long long row = trow[jn / sub] + (jn % sub);
      load4(kbase + row * kD, kn);
      load4(vbase + row * kD, vn);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = qr[g][0] * kf[0] + qr[g][1] * kf[1] + qr[g][2] * kf[2] + qr[g][3] * kf[3];
      s = warp_sum(s) * sm_scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
      m[g] = m_new;
    }
    if (jn < end) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kf[i] = kn[i];
        vf[i] = vn[i];
      }
    }
  }

  // merge the warps' states into this split's unnormalised partial
  float* sm_acc = smem;                        // [kWarps][G][kD]
  float* sm_m = sm_acc + kWarps * G * kD;      // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;             // [kWarps][G]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[(warp * G + g) * kD + lane * 4 + i] = acc[g][i];
  __syncthreads();
  float* dst = part + (static_cast<long long>(bh) * nsplit + split) * kPartFloats<G>;
  for (int idx = threadIdx.x; idx < G * kD + G; idx += blockDim.x) {
    const int g = idx < G * kD ? idx / kD : idx - G * kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * G + g];
      if (mw == -INFINITY) continue;  // warp saw no position
      const float c = expf(mw - mx);
      lsum += sm_l[w * G + g] * c;
      if (idx < G * kD) osum += sm_acc[(w * G + g) * kD + idx - g * kD] * c;
    }
    if (idx < G * kD) {
      dst[idx] = osum;
    } else {
      dst[G * kD + g] = mx;  // finite: warp 0 saw position `start`
      dst[G * kD + G + g] = lsum;
    }
  }
  return true;
}

// The merge for one (slot, head): `src` is its [nsplit] partials, `o` its
// [G, kD] output, `n` the slot's depth; threads tid, tid + nthreads, ...
// each produce output lanes, combining the splits in split order (the
// same arithmetic whatever the thread count).  Partials are read through
// L2 (__ldcg): in kernel F other blocks wrote them during this launch.
template <typename T, int G>
__device__ __forceinline__ void decode_merge(const float* __restrict__ src,
                                             T* __restrict__ o, int n,
                                             int chunk, int tid,
                                             int nthreads) {
  const int used = n > 0 ? (n + chunk - 1) / chunk : 0;
  for (int idx = tid; idx < G * kD; idx += nthreads) {
    if (used == 0) {  // idle slot: zeros, never NaN
      o[idx] = from_float<T>(0.f);
      continue;
    }
    const int g = idx / kD;
    float mx = -INFINITY;
    for (int s = 0; s < used; ++s)
      mx = fmaxf(mx, __ldcg(src + s * kPartFloats<G> + G * kD + g));
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* ps = src + s * kPartFloats<G>;
      const float c = expf(__ldcg(ps + G * kD + g) - mx);
      lsum += __ldcg(ps + G * kD + G + g) * c;
      osum += __ldcg(ps + idx) * c;
    }
    o[idx] = from_float<T>(osum / lsum);
  }
}

}  // namespace decode
}  // namespace vattn
