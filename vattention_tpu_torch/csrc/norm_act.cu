// The layer's elementwise work around the projections, which the JAX step
// leaves to XLA: it fuses them into the jitted step, so the JAX package
// has no kernel for them (vattention_tpu/model_executor/layers/
// layernorm.py:1-5, activation.py:1-2, models/llama.py:115-136,
// models/falcon.py:69-91).  The reference's CUDA system has its own
// rms_norm and silu_and_mul kernels; these four replace no TPU kernel.
//
//   add_rms_norm   (x, r) -> (x + r, rms_norm(x + r, w))       llama family
//   add_layer_norm (x, o, mlp) -> (x + (o + mlp), layer_norm(...))  falcon
//   silu_and_mul   [T, 2I] -> bf16(silu(f32(gate))) * up
//   gelu_new       tanh GELU in float32 (as x sigmoid(2u)), one rounding
//
// Rounding follows the JAX step, one rounding to the model's type per
// JAX op boundary: the residual x + r (and falcon's o + mlp, then x + it)
// is rounded before it is squared or averaged, so the residual output
// equals the plain `x + r` bit for bit (a float32 sum of the two
// operands rounded once, as PyTorch adds two bfloat16 tensors on the
// card); the norm itself runs in float32 and rounds once at its output
// ((x * rsqrt(mean(x^2) + eps)) * w, two products, as the plain version).
// Falcon's variance takes two passes over the row, the mean and then the
// mean of squared deviations, as jnp.var computes it (E[x^2] - E[x]^2
// would cancel).  silu rounds to the model's type before the product
// with up, as the plain version casts before it multiplies.
//
// Bound: bytes.  A norm reads each input row once and writes its output
// (and the residual) once; at T = 2048, H = 4096, bf16, add_rms_norm
// moves 4 x 16.8 MB, 20 us at 3.35 TB/s; a decode row is a few KB, so
// there a launch and one DRAM round trip are the floor.
//
// add_rms_norm, silu_and_mul and gelu_new take their launch plan from the
// Python wrapper (ops/norm_act.py norm_plan, silu_plan, gelu_plan), which
// checks it against the limits below; the entry points check it again.
// - add_rms_norm: a row group of row_threads threads (whole warps) per
//   row, rows_per_block rows a block.  Each thread loads all its VPT
//   16-byte vectors of x, r and w at once, so a row has one DRAM round
//   trip on its critical path, and keeps them packed in registers from
//   the sum to the scale.  The sum is warp shuffles, and for a row of
//   several warps one pass through shared memory behind a named barrier
//   of the row's warps only (bar.sync 1 + group): no block-wide
//   __syncthreads, so the rows of a block never wait for each other.  A
//   row lives in one block, on one SM: it holds all of a row's loads in
//   flight, so splitting a row over SMs buys no latency.
// - silu_and_mul: a 2-D grid, the row from blockIdx.x and a tile of
//   threads x VPT vectors of the row from blockIdx.y, column indices in
//   32 bits (no 64-bit division); each thread loads its VPT gate/up pairs
//   before it computes any of them.
// - gelu_new: one vector a thread over the flat tensor, blocks in memory
//   order, and x / (1 + exp(-2u)) with __expf and __fdividef (the error
//   argument is at the kernel).
// Both launch plainly: launched with programmatic dependent launch (so
// each may start while the projection before it finishes, reading its
// inputs after griddepcontrol.wait), the captured decode step measured
// slower on the H100, though stream capture kept every programmatic edge.
//
// add_layer_norm is one block per row (block_sum's __syncthreads), each
// thread VPT vectors; falcon's 4544 bf16 values are 568 vectors, 142
// threads of 4 in a block of 160.
#include "common.cuh"

using namespace vattn;

namespace {

constexpr int kRowThreads = 256;   // add_layer_norm's block (one row) at most
constexpr int kMaxVecs = 8;        // 16-byte vectors a thread at most
constexpr int kNormThreads = 256;  // an add_rms_norm block's threads at most
constexpr int kActThreads = 256;   // a silu_and_mul or gelu_new block's threads at most
constexpr int kMaxActVecs = 2;     // silu_and_mul's gate/up pairs a thread at most
constexpr int kMaxActTiles = 65535;  // silu_and_mul's column tiles (gridDim.y)
constexpr int kMaxGeluVecs = 4;    // gelu_new's vectors a thread at most
// gelu_new's vectors at most: its 32-bit indices run a block past them
constexpr long long kMaxGeluVectors = 0x7fffffffLL - kActThreads * kMaxGeluVecs;

// one 16-byte vector of T (E values, kept packed) as E floats and back;
// round(x): x rounded to T
template <typename T>
struct V16;
template <>
struct V16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct V16<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[2 * j] = h.x;
      f[2 * j + 1] = h.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// x + y, each sum rounded to T
template <typename T>
__device__ __forceinline__ uint4 add_rounded(const uint4& x, const uint4& y) {
  constexpr int E = V16<T>::E;
  float a[E], b[E];
  V16<T>::unpack(x, a);
  V16<T>::unpack(y, b);
#pragma unroll
  for (int e = 0; e < E; ++e) a[e] = V16<T>::round(__fadd_rn(a[e], b[e]));
  return V16<T>::pack(a);
}

// The block's sum of v: warp shuffles, then one pass through `partial`
// (a warp's slot each), which every warp reads whole.  blockDim.x is a
// multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f);
}

// ---- add_rms_norm: a row group of whole warps per row ---------------- //
struct RmsArgs {
  uint4* res_out;      // [rows, nvec] x + r, or nullptr (no addend)
  uint4* out;          // [rows, nvec]
  const uint4* x;      // [rows, nvec]
  const uint4* r;      // [rows, nvec], or nullptr
  const uint4* w;      // [nvec]
  int rows, nvec;      // nvec: 16-byte vectors a row
  int row_threads;     // a row group's threads, a multiple of 32
  float eps, inv_width;
};

// Row group g = threadIdx.x / row_threads of block b normalizes row
// b * rows_per_block + g; its thread t holds the row's vectors t + i *
// row_threads, i < VPT.
template <typename T, int VPT>
__global__ void __launch_bounds__(kNormThreads) add_rms_norm_kernel(RmsArgs a) {
  constexpr int E = V16<T>::E;
  __shared__ float partial[kNormThreads / 32];
  const int group = threadIdx.x / a.row_threads;
  const int t = threadIdx.x - group * a.row_threads;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / a.row_threads) + group;
  const bool live = row < a.rows;
  const long long base = row * a.nvec;
  uint4 v[VPT], u[VPT], w[VPT];
  // every load of the row, the weight's too, before any use: one round trip
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * a.row_threads;
    if (!live || c >= a.nvec) continue;
    v[i] = a.x[base + c];
    if (a.r != nullptr) u[i] = a.r[base + c];
    w[i] = a.w[c];
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * a.row_threads;
    if (!live || c >= a.nvec) continue;
    if (a.r != nullptr) {
      v[i] = add_rounded<T>(v[i], u[i]);
      a.res_out[base + c] = v[i];
    }
    float f[E];
    V16<T>::unpack(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = warp_sum(ss);
  if (a.row_threads > 32) {
    // the row's warps only: their partials, then every warp sums them all
    const int lane = threadIdx.x & 31, warps = a.row_threads >> 5;
    if (lane == 0) partial[threadIdx.x >> 5] = ss;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(a.row_threads) : "memory");
    ss = warp_sum(lane < warps ? partial[group * warps + lane] : 0.f);
  }
  if (!live) return;
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_width), a.eps));
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * a.row_threads;
    if (c >= a.nvec) continue;
    float f[E], g[E];
    V16<T>::unpack(v[i], f);
    V16<T>::unpack(w[i], g);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], inv), g[e]);
    a.out[base + c] = V16<T>::pack(f);
  }
}

template <typename T>
int launch_rms(const RmsArgs& a, int vpt, int rows_per_block, cudaStream_t s) {
  const dim3 grid((a.rows + rows_per_block - 1) / rows_per_block);
  const dim3 block(a.row_threads * rows_per_block);
  switch (vpt) {
    case 1: add_rms_norm_kernel<T, 1><<<grid, block, 0, s>>>(a); break;
    case 2: add_rms_norm_kernel<T, 2><<<grid, block, 0, s>>>(a); break;
    case 4: add_rms_norm_kernel<T, 4><<<grid, block, 0, s>>>(a); break;
    default: add_rms_norm_kernel<T, kMaxVecs><<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- add_layer_norm: block b normalizes row b ------------------------- //
struct RowArgs {
  void* res_out;       // [rows, width] x + r, or nullptr (no addend)
  void* out;           // [rows, width]
  const void* x;       // [rows, width]
  const void* add1;    // o, or nullptr
  const void* add2;    // mlp (layer norm; added to o first), or nullptr
  const void* w;       // [width]
  const void* b;       // [width] (layer norm)
  int nvec;            // 16-byte vectors a row
  float eps, inv_width;
};

// The row's vector i of this thread (i < VPT), or -1 past the row's end.
__device__ __forceinline__ int vec_of(int i, int nvec) {
  const int c = threadIdx.x + i * blockDim.x;
  return c < nvec ? c : -1;
}

// Row b's residual into v, packed (VPT vectors a thread, vector i at
// vec_of(i)), stored to res_out when there is an addend.
template <typename T, int VPT>
__device__ __forceinline__ void load_residual(const RowArgs& a, uint4 (&v)[VPT]) {
  const long long base = static_cast<long long>(blockIdx.x) * a.nvec;
  const uint4* x = static_cast<const uint4*>(a.x) + base;
  uint4 u1[VPT], u2[VPT];
  // every load first, so the row's DRAM round trips overlap
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = vec_of(i, a.nvec);
    if (c < 0) continue;
    v[i] = x[c];
    if (a.add1 != nullptr) u1[i] = (static_cast<const uint4*>(a.add1) + base)[c];
    if (a.add2 != nullptr) u2[i] = (static_cast<const uint4*>(a.add2) + base)[c];
  }
  if (a.add1 == nullptr) return;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = vec_of(i, a.nvec);
    if (c < 0) continue;
    if (a.add2 != nullptr) u1[i] = add_rounded<T>(u1[i], u2[i]);  // o + mlp
    v[i] = add_rounded<T>(v[i], u1[i]);
    (static_cast<uint4*>(a.res_out) + base)[c] = v[i];
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kRowThreads) add_layer_norm_kernel(RowArgs a) {
  constexpr int E = V16<T>::E;
  __shared__ float partial[2][32];
  uint4 v[VPT];
  load_residual<T, VPT>(a, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (vec_of(i, a.nvec) < 0) continue;
    float f[E];
    V16<T>::unpack(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) s = __fadd_rn(s, f[e]);
  }
  const float mean = __fmul_rn(block_sum(s, partial[0]), a.inv_width);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (vec_of(i, a.nvec) < 0) continue;
    float f[E];
    V16<T>::unpack(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = __fsub_rn(f[e], mean);
      sq = fmaf(d, d, sq);
    }
  }
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(block_sum(sq, partial[1]), a.inv_width), a.eps));
  uint4* out = static_cast<uint4*>(a.out) + static_cast<long long>(blockIdx.x) * a.nvec;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = vec_of(i, a.nvec);
    if (c < 0) continue;
    float f[E], w[E], b[E];
    V16<T>::unpack(v[i], f);
    V16<T>::unpack(static_cast<const uint4*>(a.w)[c], w);
    V16<T>::unpack(static_cast<const uint4*>(a.b)[c], b);
#pragma unroll
    for (int e = 0; e < E; ++e)
      f[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), inv), w[e]), b[e]);
    out[c] = V16<T>::pack(f);
  }
}

template <typename T, int VPT>
struct LayerNormLaunch {
  static void launch(const RowArgs& a, int rows, int threads, cudaStream_t s) {
    add_layer_norm_kernel<T, VPT><<<rows, threads, 0, s>>>(a);
  }
};

// The fewest vectors a thread (1, 2, 4 or 8) that keep a row's block at
// kRowThreads or fewer.
template <typename T, template <typename, int> class K>
int launch_rows(RowArgs a, int rows, int width, cudaStream_t s) {
  constexpr int E = V16<T>::E;
  if (rows < 0 || width <= 0 || width % E || width / E > kMaxVecs * kRowThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  a.nvec = width / E;
  a.inv_width = 1.f / static_cast<float>(width);
  int vpt = 1;
  while ((a.nvec + vpt - 1) / vpt > kRowThreads) vpt *= 2;
  const int threads = ((a.nvec + vpt - 1) / vpt + 31) / 32 * 32;
  switch (vpt) {
    case 1: K<T, 1>::launch(a, rows, threads, s); break;
    case 2: K<T, 2>::launch(a, rows, threads, s); break;
    case 4: K<T, 4>::launch(a, rows, threads, s); break;
    default: K<T, kMaxVecs>::launch(a, rows, threads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <template <typename, int> class K>
int launch_rows_any(const RowArgs& a, int rows, int width, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_rows<float, K>(a, rows, width, s);
  if (dtype == kBFloat16) return launch_rows<__nv_bfloat16, K>(a, rows, width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- silu_and_mul: a block per (row, column tile) ---------------------- //
// out [rows, per_row] = round(silu(gate)) * up, gate and up the two halves
// of x's row [2 per_row] (16-byte vectors); silu(g) = g / (1 + exp(-g)) as
// PyTorch's.  Block (b, y) computes row b's vectors y * blockDim.x * VPT
// + i * blockDim.x + threadIdx.x, i < VPT.
template <typename T, int VPT>
__global__ void __launch_bounds__(kActThreads)
silu_and_mul_kernel(uint4* out, const uint4* x, int per_row) {
  constexpr int E = V16<T>::E;
  const long long row = blockIdx.x;
  const uint4* gate = x + row * 2 * per_row;
  const uint4* up = gate + per_row;
  uint4* o = out + row * per_row;
  const int c0 = blockIdx.y * blockDim.x * VPT + threadIdx.x;
  uint4 g[VPT], u[VPT];
  // every pair in flight before the first is computed
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = c0 + i * blockDim.x;
    if (c >= per_row) continue;
    g[i] = gate[c];
    u[i] = up[c];
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = c0 + i * blockDim.x;
    if (c >= per_row) continue;
    float gf[E], uf[E];
    V16<T>::unpack(g[i], gf);
    V16<T>::unpack(u[i], uf);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float silu = V16<T>::round(__fdiv_rn(gf[e], __fadd_rn(1.f, expf(-gf[e]))));
      gf[e] = __fmul_rn(silu, uf[e]);
    }
    o[c] = V16<T>::pack(gf);
  }
}

template <typename T>
int launch_silu(uint4* out, const uint4* x, int rows, int per_row, int vpt, int threads,
                int tiles, cudaStream_t s) {
  const dim3 grid(rows, tiles), block(threads);
  if (vpt == 1)
    silu_and_mul_kernel<T, 1><<<grid, block, 0, s>>>(out, x, per_row);
  else
    silu_and_mul_kernel<T, kMaxActVecs><<<grid, block, 0, s>>>(out, x, per_row);
  return static_cast<int>(cudaGetLastError());
}

// ---- gelu_new: one vector a thread over the flat tensor ---------------- //
// gelu_new(x) = 0.5 x (1 + tanh(u)), u = sqrt(2/pi) (x + 0.044715 x^3),
// computed as x sigmoid(2u) = x / (1 + exp(t)), t = -2u, in float32:
//   t = x (c1 + c2 x^2)     (c1 = -2 sqrt(2/pi), c2 = c1 * 0.044715; FMA)
//   out = __fdividef(x, 1 + __expf(t))
// Two MUFU operations and about seven others a value, where tanhf costs
// some twenty and the form PyTorch rounds (__fmul_rn, no FMA) seven more.
// (The kernel was not issue bound with those: what its time lost was the
// block order, below.)
// Error, against the exact function, in units of a float32 ulp of the
// output (2^-23 relative at most): t is off by a few ulps of itself;
// __expf by at most 2 + 1.173|t| ulps (CUDA's table) plus that of t; the
// sigmoid 1 / (1 + e) passes a relative error of e on damped by e / (1 +
// e); the sum rounds once and __fdividef errs by 2 ulps.  For x >= 0 (t
// <= 0, e <= 1), where the outputs are largest, e (2 + 3.2|t|) / (1 + e)
// stays below 2.2, so the output is within about 5 ulps of the function
// (3 in a float32 emulation with __expf's worst error, every 1.2e-5 from
// -12 to 12), and PyTorch's rounding adds about 1 (no cancellation there:
// 1 + tanh is in [1, 2]): under 1e-6 of itself.  For x < 0 the relative
// error grows with t, but the output |x| / (1 + e^t) shrinks faster: the
// absolute error stays below 1e-7 (largest near x = -1.2).  PyTorch's
// form itself cancels there: 1 + tanh(u) -> 0 keeps tanh's last bits
// only, and it rounds to 0 from x = -5.06, where the function is -1.5e-7,
// the largest gap between the two forms (tanh.approx in that form would
// cancel the same way at 2^-11 relative, so it is out).  This form does
// not cancel: 1 + e >= 1.  Past x = -10 (t > 87) e is infinite or above
// 2^126 and the output is 0, as PyTorch's.  So each output is within
// check_elementwise's 1e-6 of itself or of the largest output wherever
// that is 0.2 or more (any row of falcon's MLP), and in bfloat16 within
// one bf16 ulp (a float32 difference of a few ulps moves at most one
// rounding).  NaN and +-inf give what PyTorch gives.
constexpr float kGeluC1 = -1.5957691216057308f;        // -2 sqrt(2 / pi)
constexpr float kGeluC2 = -1.5957691216057308f * 0.044715f;

__device__ __forceinline__ float gelu_new_value(float x) {
  const float t = x * fmaf(kGeluC2, x * x, kGeluC1);
  return __fdividef(x, 1.f + __expf(t));
}

// One grid dimension over the flat tensor in memory order (an elementwise
// function has no rows): block b's thread t takes vectors b * blockDim.x
// * VPT + i * blockDim.x + t, i < VPT, loading all of them before it
// computes any; 32-bit indices (the plan keeps them below 2^31).  A
// (row, column tile) grid as silu_and_mul's pads each row's last tile
// and put neighbouring blocks a row apart: it measured slower call by
// call and inside falcon's captured steps.
template <typename T, int VPT>
__global__ void __launch_bounds__(kActThreads)
gelu_new_kernel(uint4* out, const uint4* x, int n_vec) {
  constexpr int E = V16<T>::E;
  const int c0 = blockIdx.x * blockDim.x * VPT + threadIdx.x;
  uint4 v[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = c0 + i * blockDim.x;
    if (c < n_vec) v[i] = x[c];
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = c0 + i * blockDim.x;
    if (c >= n_vec) continue;
    float f[E];
    V16<T>::unpack(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = gelu_new_value(f[e]);
    out[c] = V16<T>::pack(f);
  }
}

template <typename T>
int launch_gelu(uint4* out, const uint4* x, int n_vec, int vpt, int threads, int blocks,
                cudaStream_t s) {
  switch (vpt) {
    case 1: gelu_new_kernel<T, 1><<<blocks, threads, 0, s>>>(out, x, n_vec); break;
    case 2: gelu_new_kernel<T, 2><<<blocks, threads, 0, s>>>(out, x, n_vec); break;
    default: gelu_new_kernel<T, kMaxGeluVecs><<<blocks, threads, 0, s>>>(out, x, n_vec); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, res_out, out: [rows, width] of dtype (float32 or bfloat16); w:
// [width].  r == nullptr: the plain norm of x, res_out unused.  width a
// multiple of one 16-byte vector.  The plan (ops/norm_act.py norm_plan):
// vpt vectors a thread (1, 2, 4 or 8), row_threads threads a row (whole
// warps, together at least the row's vectors, no warp without one),
// rows_per_block rows a block of at most kNormThreads threads.
extern "C" int vattn_add_rms_norm(void* res_out, void* out, const void* x, const void* r,
                                  const void* w, int rows, int width, float eps, int dtype,
                                  int vpt, int row_threads, int rows_per_block, void* stream) {
  const int E = dtype == kFloat32 ? 4 : 8;
  if ((dtype != kFloat32 && dtype != kBFloat16) || rows < 0 || width <= 0 || width % E ||
      (vpt != 1 && vpt != 2 && vpt != 4 && vpt != kMaxVecs) || row_threads <= 0 ||
      row_threads % 32 || rows_per_block <= 0 || row_threads * rows_per_block > kNormThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = width / E;
  if (row_threads * vpt < nvec || (row_threads - 32) * vpt >= nvec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const RmsArgs a{static_cast<uint4*>(res_out), static_cast<uint4*>(out),
                  static_cast<const uint4*>(x), static_cast<const uint4*>(r),
                  static_cast<const uint4*>(w), rows, nvec, row_threads, eps,
                  1.f / static_cast<float>(width)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32 ? launch_rms<float>(a, vpt, rows_per_block, s)
                           : launch_rms<__nv_bfloat16>(a, vpt, rows_per_block, s);
}

// x, o, mlp, res_out, out: [rows, width]; w, b: [width].  res_out = x +
// (o + mlp), with mlp == nullptr x + o, with o == nullptr x itself (then
// mlp must be nullptr and res_out is unused).
extern "C" int vattn_add_layer_norm(void* res_out, void* out, const void* x, const void* o,
                                    const void* mlp, const void* w, const void* b, int rows,
                                    int width, float eps, int dtype, void* stream) {
  if (o == nullptr && mlp != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{res_out, out, x, o, mlp, w, b, 0, eps, 0.f};
  return launch_rows_any<LayerNormLaunch>(a, rows, width, dtype, stream);
}

// x: [rows, 2 inter] -> out: [rows, inter]; inter a multiple of one
// 16-byte vector.  The plan (ops/norm_act.py silu_plan): blocks of
// `threads` (whole warps, at most kActThreads), vpt vectors a thread (1
// or kMaxActVecs), tiles blocks a row (at most kMaxActTiles), together at
// least the row's vectors and no tile without one.
extern "C" int vattn_silu_and_mul(void* out, const void* x, int rows, int inter, int dtype,
                                  int vpt, int threads, int tiles, void* stream) {
  const int E = dtype == kFloat32 ? 4 : 8;
  if ((dtype != kFloat32 && dtype != kBFloat16) || rows < 0 || inter <= 0 || inter % E ||
      (vpt != 1 && vpt != kMaxActVecs) || threads <= 0 || threads % 32 || threads > kActThreads ||
      tiles <= 0 || tiles > kMaxActTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = inter / E;
  const long long tile = static_cast<long long>(threads) * vpt;
  if (tile * tiles < per_row || tile * (tiles - 1) >= per_row)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  uint4* o = static_cast<uint4*>(out);
  const uint4* i = static_cast<const uint4*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_silu<float>(o, i, rows, per_row, vpt, threads, tiles, s);
  return launch_silu<__nv_bfloat16>(o, i, rows, per_row, vpt, threads, tiles, s);
}

// x, out: n values (a multiple of one 16-byte vector).  The plan
// (ops/norm_act.py gelu_plan): blocks of `threads` (whole warps, at most
// kActThreads), vpt vectors a thread (1, 2 or kMaxGeluVecs; the plan takes
// 1, the others are there to be timed), `blocks` blocks, together at
// least the vectors and no block without one; at most kMaxGeluVectors.
extern "C" int vattn_gelu_new(void* out, const void* x, long long n, int dtype, int vpt,
                              int threads, int blocks, void* stream) {
  const int E = dtype == kFloat32 ? 4 : 8;
  if ((dtype != kFloat32 && dtype != kBFloat16) || n <= 0 || n % E ||
      (vpt != 1 && vpt != 2 && vpt != kMaxGeluVecs) || threads <= 0 || threads % 32 ||
      threads > kActThreads || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = n / E;
  const long long tile = static_cast<long long>(threads) * vpt;
  if (n_vec > kMaxGeluVectors || tile * blocks < n_vec || tile * (blocks - 1) >= n_vec)
    return static_cast<int>(cudaErrorInvalidValue);
  uint4* o = static_cast<uint4*>(out);
  const uint4* i = static_cast<const uint4*>(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = static_cast<int>(n_vec);
  if (dtype == kFloat32) return launch_gelu<float>(o, i, nv, vpt, threads, blocks, s);
  return launch_gelu<__nv_bfloat16>(o, i, nv, vpt, threads, blocks, s);
}
