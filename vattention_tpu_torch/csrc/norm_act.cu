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
//   gelu_new       tanh GELU in float32, one rounding
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
// there a launch and one DRAM round trip are the floor.  Design: the row
// norms are one block per row; each thread owns VPT 16-byte vectors of
// the row, kept packed in registers between the sum and the scale (no
// second read), the sum taken in float32 with warp shuffles and one pass through
// shared memory, which every warp reads whole, so no broadcast follows.
// Widths need not fill the block: falcon's 4544 bf16 values are 568
// vectors, 142 threads of 4 in a block of 160.  The activations are one
// grid-stride pass of 16-byte vectors.
#include "common.cuh"

using namespace vattn;

namespace {

constexpr int kRowThreads = 256;   // a row block's threads at most
constexpr int kMaxVecs = 8;        // 16-byte vectors a thread at most
constexpr int kPassThreads = 128;  // the activations' blocks
constexpr int kPassBlocks = 132 * 16;
// sqrt(2 / pi) and the cubic's coefficient, as PyTorch's tanh GELU
// rounds them to float
constexpr float kGeluBeta = 0.7978845608028654f;
constexpr float kGeluKappa = 0.044715f;

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

// ---- the row norms: block b normalizes row b ------------------------- //
struct RowArgs {
  void* res_out;       // [rows, width] x + r, or nullptr (no addend)
  void* out;           // [rows, width]
  const void* x;       // [rows, width]
  const void* add1;    // r (rms) or o (layer norm), or nullptr
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
__global__ void __launch_bounds__(kRowThreads) add_rms_norm_kernel(RowArgs a) {
  constexpr int E = V16<T>::E;
  __shared__ float partial[32];
  uint4 v[VPT];
  load_residual<T, VPT>(a, v);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (vec_of(i, a.nvec) < 0) continue;
    float f[E];
    V16<T>::unpack(v[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
  }
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss, partial), a.inv_width), a.eps));
  uint4* out = static_cast<uint4*>(a.out) + static_cast<long long>(blockIdx.x) * a.nvec;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = vec_of(i, a.nvec);
    if (c < 0) continue;
    float f[E], w[E];
    V16<T>::unpack(v[i], f);
    V16<T>::unpack(static_cast<const uint4*>(a.w)[c], w);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], inv), w[e]);
    out[c] = V16<T>::pack(f);
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
struct RmsLaunch {
  static void launch(const RowArgs& a, int rows, int threads, cudaStream_t s) {
    add_rms_norm_kernel<T, VPT><<<rows, threads, 0, s>>>(a);
  }
};
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

// ---- the activations: one grid-stride pass of 16-byte vectors -------- //
// out [rows, inter] = round(silu(gate)) * up, gate and up the two halves
// of x [rows, 2 inter]; silu(g) = g / (1 + exp(-g)) as PyTorch's
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
silu_and_mul_kernel(uint4* out, const uint4* x, int per_row, long long n_vec) {
  constexpr int E = V16<T>::E;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_vec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long t = i / per_row;
    const long long g = i + t * per_row;  // gate's vector in x's row t
    float gate[E], up[E];
    V16<T>::unpack(x[g], gate);
    V16<T>::unpack(x[g + per_row], up);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float silu = V16<T>::round(__fdiv_rn(gate[e], __fadd_rn(1.f, expf(-gate[e]))));
      gate[e] = __fmul_rn(silu, up[e]);
    }
    out[i] = V16<T>::pack(gate);
  }
}

// out = 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), in float32 in
// PyTorch's order of operations
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
gelu_new_kernel(uint4* out, const uint4* x, long long n_vec) {
  constexpr int E = V16<T>::E;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_vec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float f[E];
    V16<T>::unpack(x[i], f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = f[e];
      const float cube = __fmul_rn(__fmul_rn(v, v), v);
      const float inner = __fmul_rn(kGeluBeta, __fadd_rn(v, __fmul_rn(kGeluKappa, cube)));
      f[e] = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, tanhf(inner)));
    }
    out[i] = V16<T>::pack(f);
  }
}

int pass_blocks(long long n_vec) {
  const long long b = (n_vec + kPassThreads - 1) / kPassThreads;
  return static_cast<int>(b < kPassBlocks ? b : kPassBlocks);
}

}  // namespace

// x, r, res_out, out: [rows, width] of dtype (float32 or bfloat16); w:
// [width].  r == nullptr: the plain norm of x, res_out unused.  width a
// multiple of one 16-byte vector, at most 8 x 256 vectors.
extern "C" int vattn_add_rms_norm(void* res_out, void* out, const void* x, const void* r,
                                  const void* w, int rows, int width, float eps, int dtype,
                                  void* stream) {
  const RowArgs a{res_out, out, x, r, nullptr, w, nullptr, 0, eps, 0.f};
  return launch_rows_any<RmsLaunch>(a, rows, width, dtype, stream);
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
// 16-byte vector.
extern "C" int vattn_silu_and_mul(void* out, const void* x, int rows, int inter, int dtype,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kFloat32 ? 4 : 8;
  if (rows < 0 || inter <= 0 || inter % E || (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = static_cast<long long>(rows) * (inter / E);
  if (n_vec == 0) return 0;
  uint4* o = static_cast<uint4*>(out);
  const uint4* i = static_cast<const uint4*>(x);
  if (dtype == kFloat32)
    silu_and_mul_kernel<float><<<pass_blocks(n_vec), kPassThreads, 0, s>>>(o, i, inter / E, n_vec);
  else
    silu_and_mul_kernel<__nv_bfloat16><<<pass_blocks(n_vec), kPassThreads, 0, s>>>(o, i, inter / E,
                                                                                  n_vec);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n values (a multiple of one 16-byte vector).
extern "C" int vattn_gelu_new(void* out, const void* x, long long n, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kFloat32 ? 4 : 8;
  if (n < 0 || n % E || (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = n / E;
  if (n_vec == 0) return 0;
  uint4* o = static_cast<uint4*>(out);
  const uint4* i = static_cast<const uint4*>(x);
  if (dtype == kFloat32)
    gelu_new_kernel<float><<<pass_blocks(n_vec), kPassThreads, 0, s>>>(o, i, n_vec);
  else
    gelu_new_kernel<__nv_bfloat16><<<pass_blocks(n_vec), kPassThreads, 0, s>>>(o, i, n_vec);
  return static_cast<int>(cudaGetLastError());
}
