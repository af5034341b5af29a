// Fused residual add + RMSNorm, the norm alone, and Mamba-2's gated
// norm, hand-written for Hopper: one kernel template, three routes.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, fused_rmsnorm_pallas
//   (body _rmsnorm_kernel). On the port's path it runs in front of every
//   sublayer (ln1, ln2, ln_f) of every model, and, on the gated route,
//   as the Mamba-2 mixer's norm(y * silu(z)) (src/repro/models/ssm.py's
//   expression with layers.rms_norm), which the JAX package leaves to
//   XLA and the port ran as five eager kernels before the norm.
//
// What it computes, in f32, rounding only where the plain versions
// (kernels/rmsnorm/ref.py) round:
//   MODE_ADD   t = x + residual (stored in x's type T);
//   MODE_NORM  t = x;
//   MODE_GATED t = T(T(y) * T(silu(f32 z))): y the SSD output in f32 or
//              in T, z the in-projection's slice in T, y and the gate
//              each rounded to T before the product and the product
//              rounded to T (silu = z / (1 + expf(-z)), as PyTorch's
//              CUDA silu computes it);
//   out = t * rsqrt(mean(t^2) + eps) * scale, stored in T, the norm
//   reading the f32 t (a sum rounded to bf16 is stored, never read).
//
// What bounds it on this card: bytes. It does a handful of operations a
// byte, far below the card's ridge. At the serve path's shapes (N 8 or
// 128 rows of 1536-3072 elements, a few KB to ~1.5 MB) a launch moves
// less than a microsecond of bytes, so what the design fights there is
// the latency chain of one launch: one round trip to L2 or device
// memory and one reduction. At the Zoo's (N 2048 rows of 5120) it is
// the bytes in flight an SM keeps, which registers bound.
//
// Design:
// * Every load is issued before any arithmetic: x and the residual (or y
//   and z) and the scale, each as 16-byte vector loads (two for an f32
//   operand of a bf16 row, 8 bytes for a bf16 scale of an f32 row) where
//   the wrapper found the pointer and the row stride aligned, else
//   element by element; the ragged tail of a row goes element by
//   element. Then one warp-shuffle reduction and, for a row of more
//   than one warp, one exchange through shared memory.
// * Operands stay in registers as the raw words they were loaded as (a
//   bf16 becomes an f32 by a shift), converted where they are used: the
//   add route recomputes x + residual after the reduction rather than
//   holding it in f32, and the gated route keeps its product, which is
//   a value of T, as T words. A unit of a bf16 row then costs 4
//   registers an operand, not 8.
// * Rows map to threads by d, with no power-of-two padding: a thread
//   owns NV units of E = 16 / sizeof(T) elements (unit k * tpr + j of
//   its row), tpr = the row's units / NV rounded up to a warp, so
//   mamba2's d 1536 and 3072 and pixtral-12b's d 5120 (bf16: 192, 384
//   and 640 threads) mask no lane, and a row of at most 4 warps shares a
//   block of 128 threads with others (a warp a row at d <= 256 bf16).
//   The wrapper's plan() picks NV: 1 for the short launches of the serve
//   path (the most threads on a row's latency chain), 2 for many wide
//   rows (twice the bytes in flight a thread), more where a row needs
//   it to fit 1024 threads. With more than one unit a thread the scale
//   is loaded after the reduction, from L2, to spare its registers.
// * Strided rows: x, the residual, y and z take a row stride with the
//   last dimension contiguous, so the gated route reads z straight out
//   of the (B, L, 6448) in-projection output, uncopied.
//
// No atomics and a fixed order of every sum (a thread's units in order,
// the xor butterfly, whose lanes all end on the same bits, then the
// row's warps in order): a pure function of the inputs, bitwise, launch
// after launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MODE_NORM = 0;
constexpr int MODE_ADD = 1;
constexpr int MODE_GATED = 2;
constexpr int MAX_THREADS = 1024;
// flags: the vector path of each operand (the outputs: out and t), and
// the types of y and of the scale where they differ from T
constexpr int V_A = 1, V_B = 2, V_S = 4, V_OUT = 8, A_F32 = 16, S_F32 = 32;

using bf16 = __nv_bfloat16;

// The raw 32-bit words of E elements of type S
template <typename S, int E>
struct Raw {
  static constexpr int W = E * static_cast<int>(sizeof(S)) / 4;
  uint32_t w[W];
};

// Element i of a raw unit as f32 (a bf16's bits are an f32's high half)
template <typename S, int E>
__device__ __forceinline__ float elem(const Raw<S, E>& u, int i) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(u.w[i]);
  } else {
    const uint32_t v = u.w[i >> 1];
    return __uint_as_float((i & 1) ? (v & 0xffff0000u) : (v << 16));
  }
}

// Element i of a T unit set to v, a value of T (the low element first)
template <typename T, int E>
__device__ __forceinline__ void set_elem(Raw<T, E>& u, int i, float v) {
  if constexpr (sizeof(T) == 4) {
    u.w[i] = __float_as_uint(v);
  } else {
    const uint32_t bits = __float_as_uint(v);
    u.w[i >> 1] = (i & 1) ? (u.w[i >> 1] | (bits & 0xffff0000u))
                          : (bits >> 16);
  }
}

// E elements of type S at p into u, zeros past `valid`: 16-byte loads
// (8 bytes for four bf16) when `vec` and the unit is whole, else
// element by element.
template <typename S, int E>
__device__ __forceinline__ void load(Raw<S, E>& u, const S* __restrict__ p,
                                     bool vec, int valid) {
  constexpr int W = Raw<S, E>::W;
  if (vec && valid >= E) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        u.w[4 * i] = v.x;
        u.w[4 * i + 1] = v.y;
        u.w[4 * i + 2] = v.z;
        u.w[4 * i + 3] = v.w;
      }
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      u.w[0] = v.x;
      u.w[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) u.w[i] = 0u;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (i < valid) {
        if constexpr (sizeof(S) == 4)
          u.w[i] = reinterpret_cast<const uint32_t*>(p)[i];
        else
          u.w[i >> 1] |=
              static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(p)[i])
              << (16 * (i & 1));
      }
    }
  }
}

// The scale's unit: f32 words (s_f32), or bf16 words in its first half,
// whatever T is (a bf16 scale of an f32 row: four bf16, one 8-byte load)
template <int E>
__device__ __forceinline__ void load_scale(Raw<float, E>& u,
                                           const void* scale, int e0,
                                           bool s_f32, bool vec, int valid) {
  if (s_f32) {
    load(u, static_cast<const float*>(scale) + e0, vec, valid);
  } else {
    Raw<bf16, E> h;
    load(h, static_cast<const bf16*>(scale) + e0, vec, valid);
#pragma unroll
    for (int i = 0; i < Raw<bf16, E>::W; ++i) u.w[i] = h.w[i];
  }
}

template <int E>
__device__ __forceinline__ float scale_elem(const Raw<float, E>& u, int i,
                                            bool s_f32) {
  if (s_f32) return elem(u, i);
  Raw<bf16, E> h;
#pragma unroll
  for (int k = 0; k < Raw<bf16, E>::W; ++k) h.w[k] = u.w[k];
  return elem(h, i);
}

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(const float* f, float) {
  return __float_as_uint(f[0]);
}
__device__ __forceinline__ uint32_t pack(const float* f, bf16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
  return *reinterpret_cast<uint32_t*>(&h);
}

// E = 16 / sizeof(T) values to p in T: one 16-byte store when `vec` and
// the unit is whole, else element by element up to `valid`.
template <typename T, int E>
__device__ __forceinline__ void store(T* __restrict__ p, bool vec,
                                      int valid, const float* f) {
  constexpr int PER_WORD = 4 / static_cast<int>(sizeof(T));
  if (vec && valid >= E) {
    uint4 w;
    w.x = pack(f, T());
    w.y = pack(f + PER_WORD, T());
    w.z = pack(f + 2 * PER_WORD, T());
    w.w = pack(f + 3 * PER_WORD, T());
    *reinterpret_cast<uint4*>(p) = w;
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (i < valid) {
        if constexpr (sizeof(T) == 4)
          p[i] = f[i];
        else
          p[i] = __float2bfloat16_rn(f[i]);
      }
    }
  }
}

// One row per tpr threads (a multiple of 32), blockDim.x / tpr rows a
// block. T: the rows' type (out, t, x, the residual, z); A: x's (T) or
// y's (T or float). b: the residual or z; out and t_out contiguous.
template <typename T, typename A, int MODE, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_kernel(const A* __restrict__ a, const T* __restrict__ b,
                   const void* __restrict__ scale, T* __restrict__ out,
                   T* __restrict__ t_out, int N, int d, int tpr,
                   long long sa, long long sb, float eps, int flags) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr bool EARLY_SCALE = NV == 1;
  __shared__ float red[MAX_THREADS / 32];
  const int row_local = threadIdx.x / tpr;
  const int j = threadIdx.x - row_local * tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + row_local;
  const bool live = row < N;
  const bool s_f32 = (flags & S_F32) != 0;

  // every load first
  Raw<A, E> ua[NV];
  Raw<T, E> ub[NV];
  Raw<float, E> us[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (k * tpr + j) * E;
    const int valid = live ? d - e0 : 0;
    load(ua[k], a + row * sa + e0, (flags & V_A) != 0, valid);
    if constexpr (MODE != MODE_NORM)
      load(ub[k], b + row * sb + e0, (flags & V_B) != 0, valid);
    if constexpr (EARLY_SCALE)
      load_scale(us[k], scale, e0, s_f32, (flags & V_S) != 0, valid);
  }

  // the sum of squares of t (zeros past d add nothing); the gated route
  // keeps t, a value of T, as T words (uv takes z's registers)
  Raw<T, E> uv[NV];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      float t;
      if constexpr (MODE == MODE_NORM) {
        t = elem(ua[k], i);
      } else if constexpr (MODE == MODE_ADD) {
        t = elem(ua[k], i) + elem(ub[k], i);
      } else {
        const float z = elem(ub[k], i);
        const float gate = round_to(z / (1.0f + expf(-z)), T());
        t = round_to(round_to(elem(ua[k], i), T()) * gate, T());
        set_elem(uv[k], i, t);
      }
      ss += t * t;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int wpr = tpr >> 5;
  if (wpr > 1) {  // uniform over the launch
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    const float* r = red + row_local * wpr;
    ss = r[0];
    for (int w = 1; w < wpr; ++w) ss += r[w];
  }
  if (!live) return;
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);

  const bool vec_out = (flags & V_OUT) != 0;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (k * tpr + j) * E;
    const int valid = d - e0;
    if (valid <= 0) break;
    if constexpr (!EARLY_SCALE)
      load_scale(us[k], scale, e0, s_f32, (flags & V_S) != 0, valid);
    float t[E], y[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if constexpr (MODE == MODE_NORM)
        t[i] = elem(ua[k], i);
      else if constexpr (MODE == MODE_ADD)
        t[i] = elem(ua[k], i) + elem(ub[k], i);
      else
        t[i] = elem(uv[k], i);
      y[i] = t[i] * rstd * scale_elem(us[k], i, s_f32);
    }
    store<T, E>(out + row * d + e0, vec_out, valid, y);
    if constexpr (MODE == MODE_ADD)
      store<T, E>(t_out + row * d + e0, vec_out, valid, t);
  }
}

struct Args {
  const void* a;
  const void* b;
  const void* scale;
  void* out;
  void* t_out;
  int N, d, tpr, rows;
  long long sa, sb;
  float eps;
  int flags;
};

template <typename T, typename A, int MODE, int NV>
int launch(const Args& g, cudaStream_t st) {
  const int blocks = (g.N + g.rows - 1) / g.rows;
  rmsnorm_kernel<T, A, MODE, NV><<<blocks, g.tpr * g.rows, 0, st>>>(
      static_cast<const A*>(g.a), static_cast<const T*>(g.b), g.scale,
      static_cast<T*>(g.out), static_cast<T*>(g.t_out), g.N, g.d, g.tpr,
      g.sa, g.sb, g.eps, g.flags);
  return static_cast<int>(cudaGetLastError());
}

// NV 1 and 2; 4 for f32 rows (a bf16 row of 16384 fits 2 units a thread)
template <typename T, typename A, int MODE>
int by_nv(int nv, const Args& g, cudaStream_t st) {
  switch (nv) {
    case 1:
      return launch<T, A, MODE, 1>(g, st);
    case 2:
      return launch<T, A, MODE, 2>(g, st);
    case 4:
      if constexpr (sizeof(T) == 4) return launch<T, A, MODE, 4>(g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_mode(int mode, int nv, const Args& g, cudaStream_t st) {
  switch (mode) {
    case MODE_NORM:
      return by_nv<T, T, MODE_NORM>(nv, g, st);
    case MODE_ADD:
      return by_nv<T, T, MODE_ADD>(nv, g, st);
    case MODE_GATED:
      if constexpr (sizeof(T) == 2)
        if (g.flags & A_F32) return by_nv<T, float, MODE_GATED>(nv, g, st);
      return by_nv<T, T, MODE_GATED>(nv, g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode: 0 the norm alone, 1 add + norm, 2 the gated norm; dtype of the
// rows (out, t_out, x, the residual, z): 0 float, 1 bf16; nv, tpr and
// rows from the wrapper's plan; sa, sb the row strides of a and b in
// elements; flags as above. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* a, const void* b,
                              const void* scale, void* out, void* t_out,
                              int N, int d, int mode, int dtype, int nv,
                              int tpr, int rows, long long sa, long long sb,
                              int flags, float eps, void* stream) {
  if (N <= 0 || d <= 0 || tpr <= 0 || tpr % 32 != 0 || rows <= 0 ||
      tpr * rows > MAX_THREADS || (long long)tpr * nv * (4 << dtype) < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{a, b, scale, out, t_out, N, d, tpr, rows, sa, sb, eps, flags};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return by_mode<bf16>(mode, nv, g, st);
  if (dtype == 0) return by_mode<float>(mode, nv, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
