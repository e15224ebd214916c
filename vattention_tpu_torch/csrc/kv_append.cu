// Kernel A: rotate one step's Q and K (RoPE) and write its K/V rows into
// the arena, converting them to the arena's storage type, in one launch.
//
// Replaces the TPU kernels cache_append_tokens (_rmw_batch_kernel) and
// cache_append_run (_rmw_run_kernel) of vattention_tpu/ops/cache_append.py,
// with the quantization the JAX backend runs in XLA just before them
// (vattn_backend.py: _flush_fp8_subnormals, _quantize_int8), and it also
// carries the rotary embedding that the JAX step fuses in XLA in front of
// the append (models/llama.py: self.rope, then backend.append_kv).
//
// Token t's row of the qkv projection holds Hq query heads, then Hkv K
// heads, then Hkv V heads, D values each (float32 or bfloat16, the
// model's type).  A qkv bias (qwen, internlm: a row of the same layout)
// is added first and the sum rounded to the model's type, as the JAX
// step adds it in XLA before it splits the heads (models/llama.py:115-
// 116).  With the rotation on, each Q and K head is rotated
// rotate-half style at position positions[t] (times pos_scale, linear
// scaling) with the inverse frequencies inv_freq[D/2], and multiplied by
// post_scale (YaRN's mscale); the rotated Q goes to q_out[t] for every
// token, and K and V go to arena row rows[t] of layer `layer` unless
// rows[t] == -1 (prefill padding, idle slots).  Rows are distinct within
// a step, so every write is a plain store: the TPU's 32-row
// read-modify-write windows have no counterpart here.  An arena row
// wider than D (the arena pads the head to a multiple of 128) gets zeros
// past D.  With the rotation off (kv_append: separate K and V, no Q) the
// kernel is the plain scatter.
//
// Arithmetic, bit for bit with the plain version (RotaryEmbedding, then
// kv_append_plain) on the card: every product and sum rounds on its own
// (__fmul_rn, __fsub_rn, __fadd_rn: nvcc would contract to FMA);
// cosf / sinf of the float32 product float(pos) * inv_freq, as
// torch.cos / torch.sin; linear scaling multiplies the position by the
// float32 reciprocal of the factor, as PyTorch divides a CUDA tensor by a
// host scalar; a bfloat16 model rounds the rotation to bfloat16 and then
// rounds again after the post-scale, as the plain version casts before
// YaRN's multiply.  Storage:
//   the model's own type: the values are stored;
//   e4m3: |x| < 15 * 2^-10 is flushed to zero (no denormal pattern is
//     stored), the rest rounds to nearest even with saturation at +-448
//     (the JAX package's astype gives NaN past 464), in integer
//     arithmetic on the float's bits;
//   int8: clip(rint(x / kv_scale), -127, 127), an IEEE division.
//
// Bound: bytes.  Each token's qkv row is read once (Hq + 2 Hkv heads),
// its rotated Q written once, and each valid token's K and V rows written
// once in the arena's type; at T = 520 that is ~3 us at 3.35 TB/s, less
// than a launch and one DRAM round trip, so the design aims at latency.
// Design: one block per token (two or more past 512 threads), one thread
// per 16-byte piece of work: a thread owns E pairs (i, i + D/2) of one
// head, read as 16-byte vectors of each half and stored as 16-byte
// vectors (E = 4 for float32, 8 for bfloat16, 16 into a 1-byte arena), so
// no thread of the block is idle.  Every thread issues its source loads
// before reading rows[t], so the two DRAM round trips overlap; the
// token's D/2 cos/sin pairs are computed once per block into shared
// memory while those loads are in flight.
#include "common.cuh"

using namespace vattn;

namespace {

constexpr float kFp8Cutoff = 15.f / 1024.f;   // 15 * 2^-10
constexpr float kFp8MinNormal = 1.f / 64.f;   // 2^-6
constexpr float kInt8Clip = 127.f;
constexpr int kMaxThreads = 512;  // a block's threads (128 registers each)

// E values of type T as 16-byte vectors
template <typename T, int E>
struct Vec {
  static constexpr int N = E * static_cast<int>(sizeof(T)) / 16;
  uint4 v[N];
};

template <typename T, int E>
__device__ __forceinline__ void load_vec(Vec<T, E>& x, const T* p) {
#pragma unroll
  for (int i = 0; i < Vec<T, E>::N; ++i)
    x.v[i] = reinterpret_cast<const uint4*>(p)[i];
}

template <int E>
__device__ __forceinline__ void to_floats(const Vec<float, E>& x, float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    f[4 * i] = __uint_as_float(x.v[i].x);
    f[4 * i + 1] = __uint_as_float(x.v[i].y);
    f[4 * i + 2] = __uint_as_float(x.v[i].z);
    f[4 * i + 3] = __uint_as_float(x.v[i].w);
  }
}
template <int E>
__device__ __forceinline__ void to_floats(const Vec<__nv_bfloat16, E>& x,
                                          float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 8; ++i) {
    const uint32_t w[4] = {x.v[i].x, x.v[i].y, x.v[i].z, x.v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[8 * i + 2 * j] = v.x;
      f[8 * i + 2 * j + 1] = v.y;
    }
  }
}

// values already representable in T (no rounding happens here)
template <int E>
__device__ __forceinline__ void from_floats(Vec<float, E>& x, const float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    x.v[i] = make_uint4(__float_as_uint(f[4 * i]), __float_as_uint(f[4 * i + 1]),
                        __float_as_uint(f[4 * i + 2]), __float_as_uint(f[4 * i + 3]));
}
template <int E>
__device__ __forceinline__ void from_floats(Vec<__nv_bfloat16, E>& x,
                                            const float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[8 * i + 2 * j], f[8 * i + 2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
    x.v[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[E]) {
  Vec<T, E> x;
  from_floats(x, f);
#pragma unroll
  for (int i = 0; i < Vec<T, E>::N; ++i) reinterpret_cast<uint4*>(p)[i] = x.v[i];
}

// x rounded to the model's type, as a float
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- the arena's storage types: store E values at p ------------------- //
template <typename T>
struct StoreSame {
  static constexpr int kBytes = sizeof(T);
  template <int E>
  __device__ __forceinline__ void operator()(void* p, const float (&f)[E]) const {
    store_vec<T, E>(static_cast<T*>(p), f);
  }
};

// e4m3: |x| below the cutoff flushes to zero; from the cutoff (the
// midpoint between e4m3's largest denormal and least normal) up to the
// least normal rounds to the least normal; above it, round to nearest even
// on the float's bits (carry into the exponent included) and saturate at
// 448 (0x7E).  The same function as the plain version's cast after its
// flush, bit for bit: no e4m3 denormal is ever stored.
struct ToFp8 {
  static constexpr int kBytes = 1;
  static __device__ __forceinline__ uint32_t one(float x) {
    const uint32_t u = __float_as_uint(x);
    const uint32_t a = u & 0x7FFFFFFFu;
    const float ax = __uint_as_float(a);
    if (ax < kFp8Cutoff) return 0u;
    uint32_t b = 0x08u;  // 2^-6
    if (ax >= kFp8MinNormal) {
      const uint32_t r = a + 0x7FFFFu + ((a >> 20) & 1u);  // RNE at bit 20
      b = min((r >> 20) - (120u << 3), 0x7Eu);  // rebias 127 -> 7
    }
    return b | ((u >> 24) & 0x80u);
  }
  template <int E>
  __device__ __forceinline__ void operator()(void* p, const float (&f)[E]) const {
    static_assert(E == 16, "one 16-byte vector of 1-byte values");
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = one(f[4 * j]) | (one(f[4 * j + 1]) << 8) | (one(f[4 * j + 2]) << 16) |
             (one(f[4 * j + 3]) << 24);
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
struct ToInt8 {
  static constexpr int kBytes = 1;
  float scale;
  __device__ __forceinline__ uint32_t one(float x) const {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kInt8Clip), kInt8Clip);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
  }
  template <int E>
  __device__ __forceinline__ void operator()(void* p, const float (&f)[E]) const {
    static_assert(E == 16, "one 16-byte vector of 1-byte values");
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = one(f[4 * j]) | (one(f[4 * j + 1]) << 8) | (one(f[4 * j + 2]) << 16) |
             (one(f[4 * j + 3]) << 24);
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

struct Args {
  const void* q_src;     // token t's first Q head at q_src + t * src_stride
  const void* k_src;     // ... its first K head
  const void* v_src;     // ... its first V head
  long long src_stride;  // elements between tokens
  void* q_out;           // [T, Hq, D]
  void* cache;           // [L, 2, Hkv, rows_total, dp]
  const int* positions;  // [T] (the rotation only)
  const int* rows;       // [T], -1 skips the token's K/V
  const float* inv_freq; // [D / 2] (the rotation only)
  const void* bias;      // [(hq + 2 hkv) * D] of the source type, or nullptr
  int hq, hkv, head_dim, dp;
  long long rows_total;
  int layer;
  float pos_scale, post_scale;
  int rotate;
};

template <typename Src, typename Store, int E>
__global__ void __launch_bounds__(kMaxThreads)
rope_kv_append_kernel(Args a, Store store) {
  extern __shared__ float4 trig4[];  // cos [D/2], then sin [D/2]
  float* trig = reinterpret_cast<float*>(trig4);
  const int t = blockIdx.x;
  const int half = a.head_dim / 2;
  const int per_head = half / E;                    // threads per head
  const int n_units = (a.hq + 2 * a.hkv) * per_head;
  const int u = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = u < n_units;
  const int head = active ? u / per_head : 0;
  const int j = u - head * per_head;                // this thread's E pairs
  const int kv_head = head - a.hq;                  // < 0: a Q head
  const Src* src =
      static_cast<const Src*>(kv_head < 0 ? a.q_src : kv_head < a.hkv ? a.k_src : a.v_src) +
      t * a.src_stride +
      static_cast<long long>(kv_head < 0 ? head : kv_head < a.hkv ? kv_head : kv_head - a.hkv) *
          a.head_dim;
  // the source vectors first: nothing they need waits on another load
  Vec<Src, E> lo, hi, bias_lo, bias_hi;
  if (active) {
    load_vec(lo, src + j * E);
    load_vec(hi, src + half + j * E);
    if (a.bias != nullptr) {
      const Src* b = static_cast<const Src*>(a.bias) + static_cast<long long>(head) * a.head_dim;
      load_vec(bias_lo, b + j * E);
      load_vec(bias_hi, b + half + j * E);
    }
  }
  const int row = a.rows[t];
  if (a.rotate) {
    const float pos = __fmul_rn(__int2float_rn(a.positions[t]), a.pos_scale);
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const float f = __fmul_rn(pos, a.inv_freq[i]);
      trig[i] = cosf(f);
      trig[half + i] = sinf(f);
    }
    __syncthreads();
  }
  if (!active) return;
  float x1[E], x2[E];
  to_floats(lo, x1);
  to_floats(hi, x2);
  if (a.bias != nullptr) {
    float b1[E], b2[E];
    to_floats(bias_lo, b1);
    to_floats(bias_hi, b2);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x1[e] = round_to(__fadd_rn(x1[e], b1[e]), Src{});
      x2[e] = round_to(__fadd_rn(x2[e], b2[e]), Src{});
    }
  }
  if (a.rotate && kv_head < a.hkv) {
#pragma unroll
    for (int e4 = 0; e4 < E / 4; ++e4) {
      const float4 c4 = trig4[(j * E) / 4 + e4];
      const float4 s4 = trig4[(half + j * E) / 4 + e4];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * e4 + i;
        const float o1 = __fsub_rn(__fmul_rn(x1[e], c[i]), __fmul_rn(x2[e], s[i]));
        const float o2 = __fadd_rn(__fmul_rn(x2[e], c[i]), __fmul_rn(x1[e], s[i]));
        x1[e] = round_to(__fmul_rn(round_to(o1, Src{}), a.post_scale), Src{});
        x2[e] = round_to(__fmul_rn(round_to(o2, Src{}), a.post_scale), Src{});
      }
    }
  }
  if (kv_head < 0) {
    Src* q = static_cast<Src*>(a.q_out) + (static_cast<long long>(t) * a.hq + head) * a.head_dim;
    store_vec<Src, E>(q + j * E, x1);
    store_vec<Src, E>(q + half + j * E, x2);
    return;
  }
  if (row < 0) return;
  const int kv = kv_head >= a.hkv;
  const int h = kv_head - kv * a.hkv;
  char* dst = static_cast<char*>(a.cache) +
              ((((static_cast<long long>(a.layer) * 2 + kv) * a.hkv + h) * a.rows_total + row) *
               a.dp) * Store::kBytes;
  store(dst + j * E * Store::kBytes, x1);
  store(dst + (half + j * E) * Store::kBytes, x2);
  // the arena's padding past D: zeros, 16 bytes at a time
  uint4* tail = reinterpret_cast<uint4*>(dst + a.head_dim * Store::kBytes);
  const int tail_vecs = (a.dp - a.head_dim) * Store::kBytes / 16;
  for (int z = j; z < tail_vecs; z += per_head) tail[z] = make_uint4(0u, 0u, 0u, 0u);
}

template <typename Src, typename Store, int E>
int launch(const Args& a, int num_tokens, Store store, cudaStream_t s) {
  if (a.head_dim % (2 * E) || (a.dp - a.head_dim) * Store::kBytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_units = (a.hq + 2 * a.hkv) * (a.head_dim / (2 * E));
  const int blocks_per_token = (n_units + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((n_units + blocks_per_token - 1) / blocks_per_token + 31) / 32 * 32;
  const size_t smem = a.rotate ? a.head_dim * sizeof(float) : 0;
  rope_kv_append_kernel<Src, Store, E>
      <<<dim3(num_tokens, blocks_per_token), threads, smem, s>>>(a, store);
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int launch_for_arena(const Args& a, int num_tokens, int kv_dtype, float kv_scale,
                     cudaStream_t s) {
  if (kv_dtype == kFloat8E4M3) return launch<Src, ToFp8, 16>(a, num_tokens, ToFp8{}, s);
  if (kv_dtype == kInt8) return launch<Src, ToInt8, 16>(a, num_tokens, ToInt8{kv_scale}, s);
  constexpr int kSrc = sizeof(Src) == 4 ? kFloat32 : kBFloat16;
  if (kv_dtype != kSrc) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Src, StoreSame<Src>, static_cast<int>(16 / sizeof(Src))>(
      a, num_tokens, StoreSame<Src>{}, s);
}

int launch_any(const Args& a, int num_tokens, int src_dtype, int kv_dtype, float kv_scale,
               void* stream) {
  if (num_tokens <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == kFloat32) return launch_for_arena<float>(a, num_tokens, kv_dtype, kv_scale, s);
  if (src_dtype == kBFloat16)
    return launch_for_arena<__nv_bfloat16>(a, num_tokens, kv_dtype, kv_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The serving path.  qkv: [num_tokens, (hq + 2 hkv) * head_dim] of
// src_dtype (float32 or bfloat16); q_out: [num_tokens, hq, head_dim] of
// src_dtype; cache: [L, 2, hkv, rows_total, dp] of kv_dtype (src_dtype, e4m3
// or int8 in steps of kv_scale), dp >= head_dim; positions, rows:
// [num_tokens] int32; inv_freq: [head_dim / 2] float32; bias: [(hq + 2
// hkv) * head_dim] of src_dtype, or nullptr.  head_dim a multiple of 32.
extern "C" int vattn_rope_kv_append(void* q_out, void* cache, const void* qkv,
                                    const int* positions, const int* rows,
                                    const float* inv_freq, const void* bias,
                                    int num_tokens, int hq,
                                    int hkv, int head_dim, int dp, long long rows_total,
                                    int layer, int src_dtype, int kv_dtype,
                                    float pos_scale, float post_scale, float kv_scale,
                                    void* stream) {
  const size_t es = src_dtype == kFloat32 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  const Args a{base,
               base + static_cast<size_t>(hq) * head_dim * es,
               base + static_cast<size_t>(hq + hkv) * head_dim * es,
               static_cast<long long>(hq + 2 * hkv) * head_dim,
               q_out, cache, positions, rows, inv_freq, bias, hq, hkv, head_dim, dp,
               rows_total, layer, pos_scale, post_scale, 1};
  return launch_any(a, num_tokens, src_dtype, kv_dtype, kv_scale, stream);
}

// The same kernel with the rotation off: k, v: [num_tokens, hkv, head_dim]
// of src_dtype into cache [L, 2, hkv, rows_total, head_dim].
extern "C" int vattn_kv_append(void* cache, const void* k, const void* v,
                               const int* rows, int num_tokens, int hkv,
                               int head_dim, long long rows_total, int layer,
                               int src_dtype, int kv_dtype, float kv_scale,
                               void* stream) {
  const Args a{nullptr, k, v, static_cast<long long>(hkv) * head_dim, nullptr, cache,
               nullptr, rows, nullptr, nullptr, 0, hkv, head_dim, head_dim, rows_total, layer,
               1.f, 1.f, 0};
  return launch_any(a, num_tokens, src_dtype, kv_dtype, kv_scale, stream);
}
