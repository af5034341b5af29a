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
//
// The backward of the add and norm routes (rmsnorm_bwd_launch, below)
// lives in this file too: the train step's 33 norms a llama3.2-1b step;
// so does the gated route's (rmsnorm_gated_bwd_launch): Mamba-2's 48 a
// mamba2-780m step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MODE_NORM = 0;
constexpr int MODE_ADD = 1;
constexpr int MODE_GATED = 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_BWD_D = 16384;      // the wrapper's MAX_D
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
// element by element. STREAM: a read the kernel makes once (the
// backward's rows), marked evict-first.
template <typename S, int E, bool STREAM = false>
__device__ __forceinline__ void load(Raw<S, E>& u, const S* __restrict__ p,
                                     bool vec, int valid) {
  constexpr int W = Raw<S, E>::W;
  if (vec && valid >= E) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4* q = reinterpret_cast<const uint4*>(p) + i;
        const uint4 v = STREAM ? __ldcs(q) : __ldg(q);
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

// E values to p in T (E * sizeof(T) a multiple of 16 bytes): 16-byte
// stores when `vec` and the unit is whole, else element by element up to
// `valid`. STREAM: stores marked evict-first (the backward's outputs).
template <typename T, int E, bool STREAM = false>
__device__ __forceinline__ void store(T* __restrict__ p, bool vec,
                                      int valid, const float* f) {
  constexpr int PER_WORD = 4 / static_cast<int>(sizeof(T));
  constexpr int Q4 = E / PER_WORD / 4;  // 16-byte stores
  if (vec && valid >= E) {
#pragma unroll
    for (int q = 0; q < Q4; ++q) {
      const float* fq = f + 4 * q * PER_WORD;
      uint4 w;
      w.x = pack(fq, T());
      w.y = pack(fq + PER_WORD, T());
      w.z = pack(fq + 2 * PER_WORD, T());
      w.w = pack(fq + 3 * PER_WORD, T());
      if constexpr (STREAM)
        __stcs(reinterpret_cast<uint4*>(p) + q, w);
      else
        reinterpret_cast<uint4*>(p)[q] = w;
    }
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

// ------------------------------------------------------------------- //
// The backward of the add and norm routes (no TPU counterpart: the JAX
// package differentiates its plain rms_norm). With t = x (+ residual) in
// f32, rstd = rsqrt(mean(t^2) + eps), t^ = t rstd, g = dy * scale:
//   dx = d(residual) = rstd (g - t^ mean(t^ g)) + dt
//      = rstd g - t rstd^3 sum(t g) / d + dt,
//   dscale = sum over rows of dy t^.
// rstd is recomputed from x (and the residual), not saved by the forward:
// one more read of the row, which the backward reads anyway, and no
// buffer for the serve path's launches to carry. dt, the gradient of the
// add route's sum output, may be absent.
//
// The backward of the gated route (no TPU counterpart either: the JAX
// package differentiates rms_norm(y * silu(z))). With the forward's
// rounded values y^ = T(y), gate = T(silu(z)), v = T(y^ gate) and rstd,
// v^ = v rstd, g = dout * scale, in f32:
//   dv = rstd g - v rstd^3 sum(v g) / d,
//   dy = dv gate                                 (stored in y's type A),
//   dz = dv q, q = y^ sig(z) (1 + z (1 - sig(z))) (stored in T),
//   dscale = sum over rows of dout v^.
// v and the gate are recomputed from y and z (read through their row
// strides: z is the in-projection's slice, never copied): sig(z) = 1 /
// (1 + e^-z) and the gate from one expf an element, the gate rounded as
// the forward rounds it.
//
// Two launches. The rows' kernel (rmsnorm_bwd_kernel for add / norm,
// rmsnorm_gated_bwd_kernel, both over one body, bwd_rows: GATED puts y in
// the x slot and z in the residual's, and the dt slot holds v) maps rows
// to threads as the forward does (the wrapper's
// plan_bwd): a thread owns NV 16-byte units of its row (unit k * tpr +
// j; a unit is 16 bytes of the rows' type T, so an f32 y takes two), a
// row tpr threads, a block `rows` rows; block i walks rows i * rows +
// slot, then a grid's worth of rows further, and so on, one block an SM.
// Each row is read once, in 16-byte units where the wrapper found the
// operand aligned.
// HOLD, rows of up to BWD_HOLD_UNITS units a lane of BWD_HOLD_THREADS
// threads (d 8192 bf16, 4096 f32; d 2048 bf16 is 2 units a lane of four
// warps; a gated bf16 row up to 2 units a lane, d 4096, as 4 units of an
// f32 y spill): the scale's units are loaded once (a thread's columns are the
// same for every row); every unit of the row's operands is loaded before
// any arithmetic (16-byte loads, all in flight together, marked
// evict-first: they are read once), as the forward loads, and the raw
// words stay in registers (t = x (+ residual) in f32 recomputed where it
// is used; on the gated route with an f32 y, q, the gate and v replace y,
// z and the spare slot in the first pass, so the second computes no
// expf) while sum(t^2) and sum(t g) are reduced: the warp's butterfly,
// then the row's warps in order through shared memory behind a named
// barrier of the row's own warps, so the rows of a block do not wait for
// each other. Then the row's outputs are written. A slot keeps two rows
// in flight: the next row's loads are issued before this row's sums are
// exchanged. Each thread keeps its columns' dscale partial sums in
// registers over the rows it visits; at the end a block sums its row
// slots in slot order into its partial row of d sums.
// Wider rows (not HOLD: 8 units a lane, one row a block of up to 512
// threads; jamba's gated d 16384): the same two passes a unit at a time,
// the second re-reading the row's units from L1 or L2 (and, gated,
// recomputing sig(z) and the gate), and the dscale sums in shared memory,
// each thread its own columns.
// rmsnorm_dscale_kernel then sums the blocks' rows for each column in
// block order and stores dscale in the scale's type. No atomics: the
// gradients are the same bits every run.
//
// What bounds it: bytes (add / norm: x, the residual, dy, dt read, dx
// written once; gated: y, z, dout read, dy, dz written once); the partial
// rows (132 x d f32, 1 MB at d 2048) are summed by a second launch of d
// threads.
constexpr int BWD_THREADS = 256;
constexpr int BWD_BLOCKS = 264;       // 2 x the H100's 132 SMs
constexpr int BWD_HOLD_THREADS = 256; // a block of the register route
constexpr int BWD_HOLD_UNITS = 4;     // units a lane on the register route
constexpr int BWD_WIDE_THREADS = 512; // a block (one row) of the wide route
constexpr int BWD_WIDE_UNITS = 8;     // units a lane on the wide route
// flags of the backward: the residual and dt present, the scale in f32;
// the gated route's y in f32; the 16-byte paths (x or y, the residual or
// z, dy or dout, dt, the scale, the outputs)
constexpr int B_RES = 1, B_DT = 2, B_SF32 = 4, B_YF32 = 8;
constexpr int BV_X = 16, BV_R = 32, BV_DY = 64, BV_DT = 128, BV_S = 256,
              BV_DX = 512;

// the threads of row slot `slot` (tpr of them, whole warps) meet
__device__ __forceinline__ void row_barrier(int slot, int tpr) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "r"(tpr) : "memory");
}

// The raw units of a row that a thread holds: x (or y, type A), the
// residual (or z), dy (or dout) and dt (or, gated, v), 16-byte units of T
// as loaded, converted where they are used
template <typename T, typename A, int E, int NV>
struct RowUnits {
  Raw<A, E> x[NV];
  Raw<T, E> r[NV], g[NV], t[NV];
};

// The gated route's values of one element from y and z (f32): the gate
// and v rounded to T as the forward rounds them, and dz's factor q
template <typename T>
struct GateTerms {
  float gate, v, q;
  __device__ __forceinline__ GateTerms(float y, float z) {
    const float den = 1.0f + expf(-z);
    const float sig = 1.0f / den;
    const float yh = round_to(y, T());
    gate = round_to(z / den, T());
    v = round_to(yh * gate, T());
    q = yh * sig * (1.0f + z * (1.0f - sig));
  }
};

// threads a block of the register route at NV units a lane: twice
// BWD_HOLD_THREADS at one unit (at most 128 registers a thread)
__host__ __device__ constexpr int bwd_hold_threads(int nv) {
  return nv == 1 ? 2 * BWD_HOLD_THREADS : BWD_HOLD_THREADS;
}

// The rows of a backward launch (the two kernels below): T the rows'
// type, A x's (or y's) type
template <typename T, typename A, int NV, bool HOLD, bool GATED>
__device__ __forceinline__ void bwd_rows(
    const A* __restrict__ x, const T* __restrict__ res,
    const void* __restrict__ scale, const T* __restrict__ dy,
    const T* __restrict__ dt, A* __restrict__ dx, T* __restrict__ dz,
    float* __restrict__ partial, int N, int d, int tpr, long long sx,
    long long sr, float eps, int flags) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int NH = HOLD ? NV : 1;   // units held in registers
  // gated: q, the gate and v kept from the first pass (q needs f32 words)
  constexpr bool KEEP = GATED && HOLD && sizeof(A) == 4;
  using Units = RowUnits<T, A, E, NH>;
  // HOLD: rows x d, the slots' dscale sums at the end (rows > 1); else d,
  // the row's dscale sums throughout
  extern __shared__ float sums[];
  __shared__ float2 red[2][BWD_WIDE_THREADS / 32];
  const int rows = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr, j = threadIdx.x - slot * tpr;
  const int wpr = tpr >> 5, w = j >> 5;
  const bool has_res = GATED || (flags & B_RES) != 0;
  const bool has_dt = !GATED && (flags & B_DT) != 0;
  const bool s_f32 = (flags & B_SF32) != 0;
  const long long step = static_cast<long long>(gridDim.x) * rows;
  float acc[NH][E];
#pragma unroll
  for (int k = 0; k < NH; ++k)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[k][i] = 0.f;
  if constexpr (!HOLD) {
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int c = (k * tpr + j) * E + i;
        if (c < d) sums[c] = 0.f;
      }
  }

  // the scale's units (the same columns for every row a thread visits:
  // loaded once on the register route, with each unit on the wide one)
  Raw<float, E> sc[NH];
  auto load_scale_unit = [&](int k, int u) {
    const int e0 = (u * tpr + j) * E;
    load_scale(sc[k], scale, e0, s_f32, (flags & BV_S) != 0, d - e0);
  };
  // unit u of row `row` into register slot k of `o` (nothing read past N;
  // read once on the register route, so marked evict-first there)
  auto load_unit = [&](Units& o, int k, int u, long long row) {
    const int e0 = (u * tpr + j) * E;
    const int valid = row < N ? d - e0 : 0;
    load<A, E, HOLD>(o.x[k], x + row * sx + e0, (flags & BV_X) != 0, valid);
    if (has_res)
      load<T, E, HOLD>(o.r[k], res + row * sr + e0, (flags & BV_R) != 0,
                       valid);
    load<T, E, HOLD>(o.g[k], dy + row * d + e0, (flags & BV_DY) != 0, valid);
    if (has_dt)
      load<T, E, HOLD>(o.t[k], dt + row * d + e0, (flags & BV_DT) != 0,
                       valid);
  };
  auto t_of = [&](const Units& o, int k, int i) {  // x (+ residual), f32
    return has_res ? elem(o.x[k], i) + elem(o.r[k], i) : elem(o.x[k], i);
  };
  auto reduce_unit = [&](Units& o, int k, float& ss, float& dot) {
    if constexpr (GATED) {
      Raw<A, E> q;
      Raw<T, E> gate, v;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const GateTerms<T> gt(elem(o.x[k], i), elem(o.r[k], i));
        ss += gt.v * gt.v;
        dot += gt.v * (elem(o.g[k], i) * scale_elem(sc[k], i, s_f32));
        if constexpr (KEEP) {
          set_elem(q, i, gt.q);
          set_elem(gate, i, gt.gate);
          set_elem(v, i, gt.v);
        }
      }
      if constexpr (KEEP) {
        o.x[k] = q;
        o.r[k] = gate;
        o.t[k] = v;
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float t = t_of(o, k, i);
        ss += t * t;
        dot += t * (elem(o.g[k], i) * scale_elem(sc[k], i, s_f32));
      }
    }
  };
  // the row's sums: the warp's butterfly, then the row's warps in order
  // (a named barrier of the row's own warps; the halves of red alternate)
  int par = 0;
  auto row_sums = [&](float& ss, float& dot) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (wpr > 1) {  // uniform over the launch
      if ((threadIdx.x & 31) == 0)
        red[par][slot * wpr + w] = make_float2(ss, dot);
      row_barrier(slot, tpr);
      const float2* r = red[par] + slot * wpr;
      ss = r[0].x;
      dot = r[0].y;
      for (int q = 1; q < wpr; ++q) {
        ss += r[q].x;
        dot += r[q].y;
      }
      par ^= 1;
    }
  };
  // the outputs of unit u (register slot k of o) and its dscale terms
  auto write_unit = [&](const Units& o, int k, int u, long long row,
                        float rstd, float kk) {
    const int e0 = (u * tpr + j) * E;
    const int valid = d - e0;
    if (valid <= 0) return;
    float v[E], vz[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float gy = elem(o.g[k], i);
      float a;
      if constexpr (GATED) {
        float gate, vv, q;
        if constexpr (KEEP) {
          q = elem(o.x[k], i);
          gate = elem(o.r[k], i);
          vv = elem(o.t[k], i);
        } else {
          const GateTerms<T> gt(elem(o.x[k], i), elem(o.r[k], i));
          q = gt.q;
          gate = gt.gate;
          vv = gt.v;
        }
        const float dv = rstd * (gy * scale_elem(sc[k], i, s_f32)) - vv * kk;
        v[i] = dv * gate;
        vz[i] = dv * q;
        a = gy * (vv * rstd);
      } else {
        const float t = t_of(o, k, i);
        v[i] = rstd * (gy * scale_elem(sc[k], i, s_f32)) - t * kk;
        if (has_dt) v[i] += elem(o.t[k], i);
        a = gy * (t * rstd);
      }
      if constexpr (HOLD)
        acc[k][i] += a;
      else if (i < valid)
        sums[e0 + i] += a;
    }
    store<A, E, true>(dx + row * d + e0, (flags & BV_DX) != 0, valid, v);
    if constexpr (GATED)
      store<T, E, true>(dz + row * d + e0, (flags & BV_DX) != 0, valid, vz);
  };

  const long long first = static_cast<long long>(blockIdx.x) * rows;
  if constexpr (HOLD) {
    // Two rows in flight a slot: a row's loads are issued before the
    // previous row's reduction is exchanged and its outputs written.
    Units A0, B0;
#pragma unroll
    for (int k = 0; k < NV; ++k) load_scale_unit(k, k);
    auto load_row = [&](Units& o, long long row) {
#pragma unroll
      for (int k = 0; k < NV; ++k) load_unit(o, k, k, row);
    };
    auto finish_row = [&](Units& o, long long row, Units& next) {
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) reduce_unit(o, k, ss, dot);
      load_row(next, row + step);
      row_sums(ss, dot);
      if (row >= N) return;
      const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
      const float kk = rstd * rstd * rstd * dot / static_cast<float>(d);
#pragma unroll
      for (int k = 0; k < NV; ++k) write_unit(o, k, k, row, rstd, kk);
    };
    load_row(A0, first + slot);
    for (long long base = first; base < N; base += 2 * step) {
      finish_row(A0, base + slot, B0);
      if (base + step >= N) break;    // uniform over the block
      finish_row(B0, base + step + slot, A0);
    }
  } else {
    // one unit at a time: the reduction, then the row's units again (from
    // L1 or L2) for the outputs
    Units o;
    for (long long row = first + slot; row - slot < N; row += step) {
      float ss = 0.f, dot = 0.f;
#pragma unroll 1
      for (int u = 0; u < NV; ++u) {
        load_unit(o, 0, u, row);
        load_scale_unit(0, u);
        reduce_unit(o, 0, ss, dot);
      }
      row_sums(ss, dot);
      if (row >= N) continue;
      const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
      const float kk = rstd * rstd * rstd * dot / static_cast<float>(d);
#pragma unroll 1
      for (int u = 0; u < NV; ++u) {
        load_unit(o, 0, u, row);
        load_scale_unit(0, u);
        write_unit(o, 0, u, row, rstd, kk);
      }
    }
  }

  // the block's partial row: each slot's sums, slots in order
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  if constexpr (HOLD) {
    if (rows > 1) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int c = (k * tpr + j) * E + i;
          if (c < d) sums[slot * d + c] = acc[k][i];
        }
      __syncthreads();
      for (int c = threadIdx.x; c < d; c += blockDim.x) {
        float s = sums[c];
        for (int q = 1; q < rows; ++q) s += sums[q * d + c];
        out[c] = s;
      }
    } else {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int c = (k * tpr + j) * E + i;
          if (c < d) out[c] = acc[k][i];
        }
    }
  } else {  // one row a block: this thread's own columns
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int c = (k * tpr + j) * E + i;
        if (c < d) out[c] = sums[c];
      }
  }
}

// the add / norm routes' rows
template <typename T, int NV, bool HOLD>
__global__ void __launch_bounds__(HOLD ? bwd_hold_threads(NV)
                                       : BWD_WIDE_THREADS,
                                  1)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const void* __restrict__ scale,
                       const T* __restrict__ dy, const T* __restrict__ dt,
                       T* __restrict__ dx, float* __restrict__ partial,
                       int N, int d, int tpr, long long sx, long long sr,
                       float eps, int flags) {
  bwd_rows<T, T, NV, HOLD, false>(x, res, scale, dy, dt, dx, nullptr,
                                  partial, N, d, tpr, sx, sr, eps, flags);
}

// the gated route's rows: y (type A) in x's place, z in the residual's,
// dout in dy's; dy and dz out
template <typename T, typename A, int NV, bool HOLD>
__global__ void __launch_bounds__(HOLD ? bwd_hold_threads(NV)
                                       : BWD_WIDE_THREADS,
                                  1)
    rmsnorm_gated_bwd_kernel(const A* __restrict__ y,
                             const T* __restrict__ z,
                             const void* __restrict__ scale,
                             const T* __restrict__ dout, A* __restrict__ dy,
                             T* __restrict__ dz, float* __restrict__ partial,
                             int N, int d, int tpr, long long sy,
                             long long sz, float eps, int flags) {
  bwd_rows<T, A, NV, HOLD, true>(y, z, scale, dout, nullptr, dy, dz,
                                 partial, N, d, tpr, sy, sz, eps, flags);
}

// dscale[c] = the blocks' partial sums of column c, in block order
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_dscale_kernel(const float* __restrict__ partial, void* dscale,
                          int blocks, int d, int s_f32) {
  const int c = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int j = 0; j < blocks; ++j) s += partial[static_cast<long long>(j) * d + c];
  if (s_f32)
    static_cast<float*>(dscale)[c] = s;
  else
    static_cast<bf16*>(dscale)[c] = __float2bfloat16_rn(s);
}

// The arguments of one backward call (x: y on the gated route, res: z,
// dy: dout, dx: dy, dz only on the gated route)
struct BwdArgs {
  const void *x, *res, *scale, *dy, *dt;
  void *dx, *dz;
  float* partial;
  void* dscale;
  int N, d, tpr, rows;
  long long sx, sr;
  float eps;
  int flags, blocks;
};

template <typename T, typename A, int NV, bool HOLD, bool GATED>
int launch_bwd(const BwdArgs& g, cudaStream_t st) {
  auto kern = [] {
    if constexpr (GATED)
      return rmsnorm_gated_bwd_kernel<T, A, NV, HOLD>;
    else
      return rmsnorm_bwd_kernel<T, NV, HOLD>;
  }();
  if constexpr (!HOLD) {
    static bool opted = false;        // once per template, per process
    if (!opted) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MAX_BWD_D * static_cast<int>(sizeof(float)));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = true;
    }
  }
  const int bytes = (!HOLD || g.rows > 1)
                        ? g.rows * g.d * static_cast<int>(sizeof(float))
                        : 0;
  if constexpr (GATED)
    kern<<<g.blocks, g.tpr * g.rows, bytes, st>>>(
        static_cast<const A*>(g.x), static_cast<const T*>(g.res), g.scale,
        static_cast<const T*>(g.dy), static_cast<A*>(g.dx),
        static_cast<T*>(g.dz), g.partial, g.N, g.d, g.tpr, g.sx, g.sr,
        g.eps, g.flags);
  else
    kern<<<g.blocks, g.tpr * g.rows, bytes, st>>>(
        static_cast<const T*>(g.x), static_cast<const T*>(g.res), g.scale,
        static_cast<const T*>(g.dy), static_cast<const T*>(g.dt),
        static_cast<T*>(g.dx), g.partial, g.N, g.d, g.tpr, g.sx, g.sr,
        g.eps, g.flags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<<<(g.d + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS,
                          0, st>>>(g.partial, g.dscale, g.blocks, g.d,
                                   (g.flags & B_SF32) != 0);
  return static_cast<int>(cudaGetLastError());
}

// nv 1, 2 and 4 units a lane on the register route; 8 on the wide route
template <typename T, typename A, bool GATED>
int bwd_by_nv(int nv, const BwdArgs& g, cudaStream_t st) {
  if (nv == BWD_WIDE_UNITS) {
    if (g.rows != 1 || g.tpr > BWD_WIDE_THREADS)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd<T, A, BWD_WIDE_UNITS, false, GATED>(g, st);
  }
  if (g.tpr * g.rows > bwd_hold_threads(nv))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nv) {
    case 1:
      return launch_bwd<T, A, 1, true, GATED>(g, st);
    case 2:
      return launch_bwd<T, A, 2, true, GATED>(g, st);
    case 4:  // not for a gated bf16 row: its f32 y would spill
      if constexpr (!GATED || sizeof(T) == 4)
        return launch_bwd<T, A, 4, true, GATED>(g, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the checks both backward entries share
bool bad_bwd(const BwdArgs& g, int dtype, int nv) {
  return g.N <= 0 || g.d <= 0 || g.d > MAX_BWD_D || g.tpr <= 0 ||
         g.tpr % 32 != 0 || g.rows <= 0 || g.tpr * g.rows > MAX_THREADS ||
         static_cast<long long>(g.tpr) * nv * (4 << dtype) < g.d ||
         (g.rows > 1 && g.rows * g.d > 8192) || g.blocks <= 0 ||
         g.blocks > (g.N + g.rows - 1) / g.rows || g.blocks > BWD_BLOCKS;
}

}  // namespace

// The backward of the add (residual given) and norm routes. x, residual:
// (N, d) rows of dtype (0 float, 1 bf16) with row strides sx, sr (the
// last dimension contiguous; residual null on the norm route); scale
// (d,) f32 (flags & 4) or bf16; dy and dt (dt may be null) (N, d)
// contiguous; dx (N, d) contiguous output in the rows' type; nv 16-byte
// units a thread (1, 2 or 4 on the register route, at most 512 threads a
// block at 1, 256 else; 8 on the wide route, one row a block of at most
// 512), tpr
// threads a row (a multiple of 32), rows a block, from the wrapper's
// plan_bwd; the 16-byte paths in flags
// (16 x, 32 the residual, 64 dy, 128 dt, 256 the scale, 512 dx); partial
// an f32 (blocks, d) scratch buffer, blocks in [1, min(N / rows rounded
// up, 264)]; dscale (d,) output in the scale's type. Returns the first
// cudaGetLastError() that is not 0 after the two launches.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* res,
                                  const void* scale, const void* dy,
                                  const void* dt, void* dx, void* partial,
                                  void* dscale, int N, int d, int dtype,
                                  int nv, int tpr, int rows, long long sx,
                                  long long sr, int flags, int blocks,
                                  float eps, void* stream) {
  const BwdArgs g{x, res, scale, dy, dt, dx, nullptr,
                  static_cast<float*>(partial), dscale, N, d, tpr, rows, sx,
                  sr, eps, flags, blocks};
  if (bad_bwd(g, dtype, nv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return bwd_by_nv<bf16, bf16, false>(nv, g, st);
  if (dtype == 0) return bwd_by_nv<float, float, false>(nv, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of the gated route: the same launch as rmsnorm_bwd_launch
// with y in x's place (rows in f32, flags & 8, or in z's type; row stride
// sy), z in the residual's (dtype 0 float, 1 bf16; row stride sz; the
// last dimensions contiguous), dout in dy's ((N, d) contiguous, z's
// type), and two outputs, dy (N, d) contiguous in y's type and dz in
// z's; the 16-byte paths in flags (16 y, 32 z, 64 dout, 256 the scale,
// 512 the outputs); nv, tpr, rows and blocks from the wrapper's
// plan_bwd(..., "gated"). Returns the first cudaGetLastError() that is
// not 0 after the two launches.
extern "C" int rmsnorm_gated_bwd_launch(const void* y, const void* z,
                                        const void* scale, const void* dout,
                                        void* dy, void* dz, void* partial,
                                        void* dscale, int N, int d, int dtype,
                                        int nv, int tpr, int rows,
                                        long long sy, long long sz,
                                        int flags, int blocks, float eps,
                                        void* stream) {
  const BwdArgs g{y, z, scale, dout, nullptr, dy, dz,
                  static_cast<float*>(partial), dscale, N, d, tpr, rows, sy,
                  sz, eps, flags, blocks};
  if (bad_bwd(g, dtype, nv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (flags & B_YF32))
    return bwd_by_nv<bf16, float, true>(nv, g, st);
  if (dtype == 1) return bwd_by_nv<bf16, bf16, true>(nv, g, st);
  if (dtype == 0) return bwd_by_nv<float, float, true>(nv, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
