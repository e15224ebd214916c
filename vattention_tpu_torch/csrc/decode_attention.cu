// Kernel C: batched GQA decode attention over the contiguous KV arena.
//
// Replaces the TPU kernel flash_decode (_decode_kernel) of
// vattention_tpu/ops/flash_decode.py.  Slot b's single query token (Hq
// heads) attends arena rows of positions [0, seqlens[b]); position p lives
// at arena row tile_rows[b, p / sub] + p % sub (the host-resolved extent
// table, ops/utils.tile_rows_from_segments).  Slots with seqlens[b] == 0
// write zeros.  Storage float32 or bfloat16, arithmetic float32.
//
// Bound: bytes.  The kernel reads each live K and V row once (2*Hkv*D
// elements per position) and the queries once; its arithmetic is ~1 FMA
// per byte, far below the card's ridge point.
// Design: split over positions (flash-decoding), so a batch of 8 slots
// still fills the card.  Pass 1: one block per (slot, kv head, split of
// `chunk` positions) covers the G = Hq/Hkv query heads sharing the head's
// K/V rows, so each row is read once for G heads; its 8 warps take the
// split's positions round-robin, each reading one K and one V row per
// position (4 elements per lane), reducing the G scores across the warp
// and keeping an online softmax per head in registers; the warps' states
// are merged through shared memory into one unnormalised (max, sum,
// output) per split.  Splits past a slot's depth exit at once.  Pass 2:
// one block per (slot, kv head) merges the splits that hold positions and
// normalises.
#include "common.cuh"

using namespace vattn;

namespace {

constexpr int kD = 128;  // head dim (4 elements per lane)
constexpr int kWarps = 8;

// one split's partial state: acc[G][kD], then m[G], then l[G]
template <int G>
constexpr int kPartFloats = G * (kD + 2);

template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ cache,
    float* __restrict__ part, const int* __restrict__ tile_rows,
    const int* __restrict__ seqlens, int hkv, int n_sub, int sub,
    long long rows_total, int layer, float sm_scale, int chunk) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int split = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = seqlens[b];
  const int start = split * chunk;
  if (start >= n) return;  // pass 2 reads only splits that hold positions
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
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][kD];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][g][lane * 4 + i] = acc[g][i];
  __syncthreads();
  float* dst = part + (static_cast<long long>(bh) * gridDim.y + split) * kPartFloats<G>;
  for (int idx = threadIdx.x; idx < G * kD + G; idx += blockDim.x) {
    const int g = idx < G * kD ? idx / kD : idx - G * kD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w][g];
      if (mw == -INFINITY) continue;  // warp saw no position
      const float c = expf(mw - mx);
      lsum += sm_l[w][g] * c;
      if (idx < G * kD) osum += sm_acc[w][g][idx - g * kD] * c;
    }
    if (idx < G * kD) {
      dst[idx] = osum;
    } else {
      dst[G * kD + g] = mx;  // finite: warp 0 saw position `start`
      dst[G * kD + G + g] = lsum;
    }
  }
}

template <typename T, int G>
__global__ void decode_merge_kernel(const float* __restrict__ part,
                                    T* __restrict__ out,
                                    const int* __restrict__ seqlens, int hkv,
                                    int nsplit, int chunk) {
  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int hq = hkv * G;
  const int n = seqlens[b];
  const int used = n > 0 ? (n + chunk - 1) / chunk : 0;
  T* o = out + (static_cast<long long>(b) * hq + h * G) * kD;
  const float* src = part + static_cast<long long>(bh) * nsplit * kPartFloats<G>;
  for (int idx = threadIdx.x; idx < G * kD; idx += blockDim.x) {
    if (used == 0) {  // idle slot: zeros, never NaN
      o[idx] = from_float<T>(0.f);
      continue;
    }
    const int g = idx / kD;
    float mx = -INFINITY;
    for (int s = 0; s < used; ++s)
      mx = fmaxf(mx, src[s * kPartFloats<G> + G * kD + g]);
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < used; ++s) {
      const float* ps = src + s * kPartFloats<G>;
      const float c = expf(ps[G * kD + g] - mx);
      lsum += ps[G * kD + G + g] * c;
      osum += ps[idx] * c;
    }
    o[idx] = from_float<T>(osum / lsum);
  }
}

template <typename T, int G>
int launch(const void* q, const void* cache, void* out, float* part,
           const int* tile_rows, const int* seqlens, int batch, int hkv,
           int n_sub, int sub, long long rows_total, int layer,
           float sm_scale, int chunk, int nsplit, cudaStream_t stream) {
  decode_partial_kernel<T, G><<<dim3(batch * hkv, nsplit), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), part,
      tile_rows, seqlens, hkv, n_sub, sub, rows_total, layer, sm_scale,
      chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, G><<<batch * hkv, 128, 0, stream>>>(
      part, static_cast<T*>(out), seqlens, hkv, nsplit, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int group, const void* q, const void* cache, void* out,
                   float* part, const int* tile_rows, const int* seqlens,
                   int batch, int hkv, int n_sub, int sub,
                   long long rows_total, int layer, float sm_scale, int chunk,
                   int nsplit, cudaStream_t stream) {
  switch (group) {
    case 1:
      return launch<T, 1>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 2:
      return launch<T, 2>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 4:
      return launch<T, 4>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    case 8:
      return launch<T, 8>(q, cache, out, part, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [batch, Hkv*group, 128]; cache: [L, 2, Hkv, rows_total, 128];
// tile_rows: [batch, n_sub] int32; seqlens: [batch] int32 (each at most
// chunk * nsplit); part: float32 scratch of batch * Hkv * nsplit *
// group * 130 elements.  group (Hq/Hkv) must be 1, 2, 4 or 8.
extern "C" int vattn_decode_attention(const void* q, const void* cache,
                                      void* out, void* part,
                                      const int* tile_rows,
                                      const int* seqlens, int batch, int hkv,
                                      int group, int n_sub, int sub,
                                      long long rows_total, int layer,
                                      float sm_scale, int chunk, int nsplit,
                                      int dtype, void* stream) {
  if (batch <= 0) return 0;
  if (chunk <= 0 || nsplit <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_group<float>(group, q, cache, out, p, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, s);
  if (dtype == kBFloat16)
    return dispatch_group<__nv_bfloat16>(group, q, cache, out, p, tile_rows, seqlens, batch, hkv, n_sub, sub, rows_total, layer, sm_scale, chunk, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
