// Causal and/or windowed flash attention (online softmax), hand-written
// for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _flash_kernel: one head per program) and
//   flash_attention_gqa_pallas (body _flash_gqa_kernel: one program holds
//   a whole KV-head group). One template covers both: G = Hq / Hkv query
//   heads share every staged K/V tile, and G = 1 is the per-head kernel.
//   On the port's path it runs every cache-free self-attention
//   (forward_train, Model.prefill, the Zoo's model services).
//
// What it computes (exactly ref.attention_reference, with the Pallas
// kernel's tile arithmetic): query i attends to key j (positions from 0
// for both) where j <= i (causal) and j > i - window (window > 0), with
// scores (q . k) * 1/sqrt(hd) and q.k and p.v accumulated in f32 (p is
// not rounded to the input type). A masked score is the finite
// NEG_INF = -1e30, never -inf, as in the Pallas kernel: a row whose first
// live tile is wholly masked has m = -1e30, so exp(s - m) = 1 pollutes l
// and acc until a tile brings a real score, and then alpha = 0 wipes it;
// with -inf that row would become NaN. The finalize step maps l == 0 to
// 1. A tile is skipped on the Pallas kernel's test: causal needs
// k_lo <= q_hi, a window needs k_hi > q_lo - window.
//
// Shapes: q (B, Lq, Hq, hd), k and v (B, Lk, Hkv, hd), read in the
// model's own layout through strides (the last dimension contiguous), so
// no transposed copy is made; the output (B, Lq, Hq, hd) is contiguous,
// in q's type. Any Lq and Lk: the ragged last tiles are masked here,
// where Pallas asserts divisibility (keys past Lk take no part at all,
// rows past Lq are not stored). Any head_dim that is a multiple of 8 up
// to 256 (the wrapper checks): the d loops run to the runtime hd, and a
// thread's share of the output dimensions is a template bucket.
//
// Design (simple and correct first): one block of 256 threads per
// (batch, KV head, query tile) holds ROWS = 64 query rows, G * bq of
// them with bq = 64 / G (row r is head kvh * G + r / bq at query
// q_lo + r % bq, the Pallas GQA kernel's grouping). Every K/V tile of 64
// keys is read from device memory once for the whole group (16-byte
// loads) and staged in shared memory as f32 with rows padded by one word.
// Three phases per tile, each on the whole block: (1) scores, each thread
// a 4 x 4 register tile of S = Q K^T over hd; (2) the online softmax, 4
// threads per row, max and sum by shuffles, P written over S; (3) the PV
// product, each thread 4 rows x hd/16 output dimensions in registers.
// Query tiles are issued last-first, so the causal tiles with the most
// work start first. At hd 160 (pixtral-12b) the shared-memory tiles take
// 140 KB: the launcher opts in to more than 48 KB of dynamic shared
// memory with cudaFuncSetAttribute (at most 214 KB, at hd 256).
//
// What bounds it on this card: with f32 products on CUDA cores, the
// operations (4 * B * Hq * hd per live query-key pair, 67 TFLOP/s peak
// in f32) and, below that, shared-memory bandwidth: phase (1) issues 8
// shared loads per 16 FMAs. A tensor-core redesign (wgmma on bf16 tiles,
// TMA-fed) is later work; the bound that chip_smoke.py reports is the
// bf16 tensor-core one, the rate a redesign is held to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int ROWS = 64;              // query rows per block (G * bq)
constexpr int BK = 64;                // keys per tile
constexpr int TR = 4;                 // rows per thread (phases 1 and 3)
constexpr int LANES = THREADS / (ROWS / TR);  // 16 key / dimension lanes
constexpr int TK = BK / LANES;        // keys per thread (phase 1)
constexpr int SS = BK + 1;            // padded row stride of the S tile
constexpr int PARTS = THREADS / ROWS; // threads per row (phase 2)
constexpr unsigned FULL = 0xffffffffu;
static_assert(TK * LANES == BK, "key tile must split over the lanes");
static_assert(PARTS == 4, "phase 2 reduces over 4 lanes");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of K/V as f32: 4 floats or 8 bf16 values
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Lq, Lk, Hq, Hkv, G, bq, hd, causal, window;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  float scale;
};

__host__ __device__ inline int smem_floats(int hd) {
  return (ROWS + 2 * BK) * (hd + 1) + ROWS * SS + ROWS;
}

// ND: output dimensions per thread, ceil(hd / LANES) rounded up to the
// bucket of the launcher
template <typename T, int ND>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int hs = hd + 1;               // padded shared-memory row stride
  float* sQ = smem;                    // ROWS x hs
  float* sK = sQ + ROWS * hs;          // BK x hs
  float* sV = sK + BK * hs;            // BK x hs
  float* sS = sV + BK * hs;            // ROWS x SS: scores, then P
  float* sRow = sS + ROWS * SS;        // ROWS: alpha, at the end l

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int b = blockIdx.y / a.Hkv;
  const int kvh = blockIdx.y % a.Hkv;
  const int q_lo = qt * a.bq;
  const int q_hi = min(q_lo + a.bq, a.Lq) - 1;
  const int R = a.G * a.bq;            // live rows of the tile (<= ROWS)
  const int tid = threadIdx.x;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the query tile, rows past R or past Lq as zeros
  for (int i = tid; i < ROWS * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const int t = r % a.bq, g = r / a.bq;
    float x = 0.f;
    if (r < R && q_lo + t < a.Lq)
      x = to_f(q[(q_lo + t) * a.q_sl + (kvh * a.G + g) * a.q_sh + d]);
    sQ[r * hs + d] = x;
  }

  // phase 1 and 3 ownership: rows ry*TR .. ry*TR+3; keys / dims lx + LANES*j
  const int ry = tid / LANES, lx = tid % LANES;
  // phase 2 ownership: row pr, entries pp + PARTS*e
  const int pr = tid / PARTS, pp = tid % PARTS;
  int qpos1[TR];                       // query position of each phase-1 row
#pragma unroll
  for (int i = 0; i < TR; ++i) qpos1[i] = q_lo + (ry * TR + i) % a.bq;

  float m = NEG_INF, l = 0.f;          // phase-2 row state (row pr)
  float acc[TR][ND];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;

  constexpr int VN = Pack<T>::N;
  const int vpr = hd / VN;             // 16-byte loads per K/V row
  const int k_end = a.causal ? min(a.Lk, q_hi + 1) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    if (a.window && k0 + BK - 1 <= q_lo - a.window) continue;  // outside
    const int nvalid = min(BK, a.Lk - k0);  // keys of this tile inside Lk

    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * vpr; i += THREADS) {
      const int j = i / vpr, c = (i % vpr) * VN;
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      if (j < nvalid) {
        ku = *reinterpret_cast<const uint4*>(kp + (k0 + j) * a.k_sl + c);
        vu = *reinterpret_cast<const uint4*>(vp + (k0 + j) * a.v_sl + c);
      }
      float f[VN];
      Pack<T>::unpack(ku, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) sK[j * hs + c + e] = f[e];
      Pack<T>::unpack(vu, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) sV[j * hs + c + e] = f[e];
    }
    __syncthreads();

    // (1) scores of a 4 x 4 register tile, masked, into sS
    {
      float s[TR][TK];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
      const float* qr = sQ + ry * TR * hs;
      const float* kr = sK + lx * hs;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        float qa[TR], kb[TK];
#pragma unroll
        for (int i = 0; i < TR; ++i) qa[i] = qr[i * hs + d];
#pragma unroll
        for (int j = 0; j < TK; ++j) kb[j] = kr[j * LANES * hs + d];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TK; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          const int kk = lx + LANES * j, kpos = k0 + kk;
          bool ok = true;
          if (a.causal) ok = kpos <= qpos1[i];
          if (a.window) ok = ok && kpos > qpos1[i] - a.window;
          sS[(ry * TR + i) * SS + kk] = ok ? s[i][j] * a.scale : NEG_INF;
        }
    }
    __syncthreads();

    // (2) online softmax of row pr; keys past Lk take no part
    {
      float* sr = sS + pr * SS;
      float mt = NEG_INF;
#pragma unroll
      for (int e = 0; e < BK / PARTS; ++e) {
        const int kk = pp + PARTS * e;
        if (kk < nvalid) mt = fmaxf(mt, sr[kk]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float ls = 0.f;
#pragma unroll
      for (int e = 0; e < BK / PARTS; ++e) {
        const int kk = pp + PARTS * e;
        const float p = kk < nvalid ? expf(sr[kk] - m_new) : 0.f;
        sr[kk] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(FULL, ls, 1);
      ls += __shfl_xor_sync(FULL, ls, 2);
      l = alpha * l + ls;
      m = m_new;
      if (pp == 0) sRow[pr] = alpha;
    }
    __syncthreads();

    // (3) acc = acc * alpha + P V
    {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float al = sRow[ry * TR + i];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] *= al;
      }
      for (int j = 0; j < nvalid; ++j) {
#pragma unroll
        for (int i = 0; i < TR; ++i) pv[i] = sS[(ry * TR + i) * SS + j];
        const float* vr = sV + j * hs;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const int d = lx + LANES * c;
          const float x = d < hd ? vr[d] : 0.f;
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
        }
      }
    }
  }

  __syncthreads();
  if (pp == 0) sRow[pr] = l == 0.f ? 1.f : l;  // fully masked rows
  __syncthreads();
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ry * TR + i;
    const int t = r % a.bq, g = r / a.bq;
    if (r >= R || q_lo + t >= a.Lq) continue;
    const float lr = sRow[r];
    T* o = out + ((static_cast<long long>(b) * a.Lq + q_lo + t) * a.Hq +
                  kvh * a.G + g) * hd;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lx + LANES * c;
      if (d < hd) o[d] = from_f<T>(acc[i][c] / lr);
    }
  }
}

template <typename T, int ND>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = smem_floats(a.hd) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, ND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + a.bq - 1) / a.bq, a.B * a.Hkv);
  flash_attention_kernel<T, ND><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return launch<T, 2>(a, stream);
  if (a.hd <= 64) return launch<T, 4>(a, stream);
  if (a.hd <= 128) return launch<T, 8>(a, stream);
  if (a.hd <= 160) return launch<T, 10>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Lq, Hq, hd), k and v (B, Lk,
// Hkv, hd): strides in elements, the last dimension contiguous; K/V rows
// must start on 16-byte boundaries (the wrapper checks). hd a multiple of
// 8 in [8, 256]; G = Hq / Hkv in [1, 64]. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int Hq, int Hkv, int hd, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, int causal, int window,
    int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || hd < 8 || hd > 256 || hd % 8 != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.B = B;
  a.Lq = Lq;
  a.Lk = Lk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.bq = ROWS / a.G;
  a.hd = hd;
  a.causal = causal;
  a.window = window;
  a.q_sb = q_sb;
  a.q_sl = q_sl;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_sl = k_sl;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_sl = v_sl;
  a.v_sh = v_sh;
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
