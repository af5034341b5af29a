// The backward of causal and/or windowed flash attention, hand-written for
// Hopper: three launches, no atomics.
//
// Replaces: no TPU kernel. The JAX package trains by autodiff of its
//   plain attention (src/repro/models/layers.py, gqa_attention) and has
//   no Pallas backward. The port's forward is the flash kernel
//   (flash_attention.cu), whose probabilities are never stored, so its
//   backward recomputes them here, from q, k and the row's log-sum-exp
//   that the forward writes when a gradient is asked for. On the port's
//   path it runs once a layer in every train step (ROADMAP item 12a).
//
// What it computes (ref.attention_backward_reference, in f32): with
// scale = 1/sqrt(hd), p_ij = 2^(s_ij scale log2(e) - lse_i) for the live
// pairs (the forward's mask: j <= i causal, j > i - window with a
// window, j < Lk; positions from 0 for queries and keys) and 0 elsewhere,
//   D_i  = sum_d dO_id O_id                     (= sum_j p_ij dP_ij)
//   dV_j = sum_i p_ij dO_i      (bf16: p rounded to bf16 first, as the
//                                forward rounds it before the P V product)
//   dP_ij = dO_i . V_j,  dS_ij = p_ij (dP_ij - D_i)
//   dQ_i = scale sum_j dS_ij K_j,  dK_j = scale sum_i dS_ij Q_i,
// dK and dV summed over the G query heads of the KV head. Scores, p, the
// sums and the accumulators are f32; the outputs are stored in the
// inputs' type.
//
// Launches:
//   1. flash_bwd_dot_kernel: D, one warp a (b, query, head) row.
//   2. flash_bwd_dkdv_kernel: one block per (b, KV head, key tile of TK
//      keys). It holds the tile's K and V and walks the query tiles the
//      mask keeps, each tile the forward's grouping of 64 rows (the G
//      heads times 64 / G positions, so the K/V tile serves the whole
//      group), recomputing P and dS of the tile, then accumulating dV
//      and dK in registers.
//   3. flash_bwd_dq_kernel: one block per (b, KV head, query tile of the
//      same 64 grouped rows). It walks the key tiles the mask keeps,
//      recomputes dS the same way and accumulates dQ in registers.
// Each block owns its outputs, and every sum runs in a fixed order, so a
// step's gradients are the same bits launch after launch.
//
// Design, a simple one (a right kernel first): f32 arithmetic on the
// CUDA cores for both dtypes. Every tile is staged in shared memory as
// f32 with rows padded by one word (bank-conflict free for the row-wise
// reads of the products). 256 threads as 16 x 16: the score tile (64
// rows x TK keys) is a 4 x TK/16 register tile a thread for S and dP
// together; the accumulations give a thread TK/16 keys (dK, dV) or 4 rows
// (dQ) by HDT/16 dimensions. TK = 64 keys for head-dim tiles up to 128,
// 32 above (hd 160: pixtral-12b; 256), which keeps shared memory within
// the 227 KB of a block (214 KB at hd 256).
//
// What bounds it on this card: the operations, 10 hd per live pair and
// query head (S, dP, dV, dQ, dK: five products of 2 hd), against 989
// TFLOP/s of bf16 tensor cores for bf16 inputs; this design runs them on
// the CUDA cores (67 TFLOP/s f32) and reads two shared operands a pair of
// FMAs, so it stays several times off that bound. A tensor-core
// redesign (wgmma with TMA-fed tiles) is ROADMAP section 2's later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;       // grouped query rows a tile (G * bq)
constexpr int THREADS = 256;   // 16 x 16
constexpr int LANES = 16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // (B, Lq, Hq, hd), contiguous
  const void* dout;   // (B, Lq, Hq, hd), contiguous
  const float* lse;   // (B, Hq, Lq)
  float* dsum;        // D, (B, Hq, Lq)
  void* dq;           // (B, Lq, Hq, hd), contiguous
  void* dk;           // (B, Lk, Hkv, hd), contiguous
  void* dv;           // (B, Lk, Hkv, hd), contiguous
  int B, Lq, Lk, Hq, Hkv, G, bq, hd, causal, window;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, bf16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Shared floats of either tiled kernel (sP unused by the dQ kernel)
template <int HDT, int TK>
constexpr int smem_floats() {
  return 2 * TK * (HDT + 1) + 2 * ROWS * (HDT + 1) + 2 * ROWS * (TK + 1) +
         2 * ROWS;
}

// ------------------------------------------------------------------- //
// 1. D = rowsum(dO * O)
// ------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dot_kernel(Args a) {
  const long long rows = static_cast<long long>(a.B) * a.Lq * a.Hq;
  const int lane = threadIdx.x & 31;
  const long long n =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (n >= rows) return;
  const T* o = static_cast<const T*>(a.o) + n * a.hd;
  const T* d = static_cast<const T*>(a.dout) + n * a.hd;
  float s = 0.f;
  for (int c = lane; c < a.hd; c += 32) s += ld(o + c) * ld(d + c);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(attn::FULL, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(n % a.Hq);
    const long long bl = n / a.Hq;
    const int l = static_cast<int>(bl % a.Lq), b = static_cast<int>(bl / a.Lq);
    a.dsum[(static_cast<long long>(b) * a.Hq + h) * a.Lq + l] = s;
  }
}

// ------------------------------------------------------------------- //
// shared pieces of the tiled kernels
// ------------------------------------------------------------------- //
// The 64 grouped query rows at positions q_lo.. of KV head kvh: Q and dO
// (zeros past hd, past R rows and past Lq), each row's lse and D
template <typename T, int HDT>
__device__ __forceinline__ void load_rows(const Args& a, int b, int kvh,
                                          int q_lo, float* sQ, float* sdO,
                                          float* sL, float* sD) {
  constexpr int hs = HDT + 1;
  const int R = a.G * a.bq;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* dout = static_cast<const T*>(a.dout);
  for (int i = threadIdx.x; i < ROWS * HDT; i += THREADS) {
    const int r = i / HDT, c = i % HDT;
    const int t = r % a.bq, head = kvh * a.G + r / a.bq, pos = q_lo + t;
    const bool ok = r < R && pos < a.Lq && c < a.hd;
    float x = 0.f, y = 0.f;
    if (ok) {
      x = ld(q + pos * a.q_sl + head * a.q_sh + c);
      y = ld(dout + ((static_cast<long long>(b) * a.Lq + pos) * a.Hq + head) *
                        a.hd + c);
    }
    sQ[r * hs + c] = x;
    sdO[r * hs + c] = y;
  }
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int t = r % a.bq, head = kvh * a.G + r / a.bq, pos = q_lo + t;
    const bool ok = r < R && pos < a.Lq;
    const long long i = (static_cast<long long>(b) * a.Hq + head) * a.Lq + pos;
    sL[r] = ok ? a.lse[i] : 0.f;
    sD[r] = ok ? a.dsum[i] : 0.f;
  }
}

// TK keys of KV head kvh from k_lo: K and V (zeros past Lk and past hd)
template <typename T, int HDT, int TK>
__device__ __forceinline__ void load_keys(const Args& a, int b, int kvh,
                                          int k_lo, float* sK, float* sV) {
  constexpr int hs = HDT + 1;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int i = threadIdx.x; i < TK * HDT; i += THREADS) {
    const int r = i / HDT, c = i % HDT;
    const int key = k_lo + r;
    const bool ok = key < a.Lk && c < a.hd;
    sK[r * hs + c] = ok ? ld(k + key * a.k_sl + c) : 0.f;
    sV[r * hs + c] = ok ? ld(v + key * a.v_sl + c) : 0.f;
  }
}

// The score tile of 64 rows x TK keys: S and dP in registers (a thread
// rows ry * 4 + i, keys lx + 16 j), then dS (and, with sP, p rounded to
// T) into shared memory; a pair outside the mask gets p = dS = 0.
template <typename T, int HDT, int TK>
__device__ __forceinline__ void score_tile(const Args& a, int q_lo, int k_lo,
                                           const float* sQ, const float* sdO,
                                           const float* sK, const float* sV,
                                           const float* sL, const float* sD,
                                           float* sP, float* sdS) {
  constexpr int hs = HDT + 1, KJ = TK / LANES, SS = TK + 1;
  const int ry = threadIdx.x / LANES, lx = threadIdx.x % LANES;
  const int R = a.G * a.bq;
  float s[4][KJ], dp[4][KJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
  const float* qr = sQ + ry * 4 * hs;
  const float* orow = sdO + ry * 4 * hs;
  const float* kr = sK + lx * hs;
  const float* vr = sV + lx * hs;
#pragma unroll 4
  for (int d = 0; d < a.hd; ++d) {
    float qa[4], oa[4], kb[KJ], vb[KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qr[i * hs + d];
      oa[i] = orow[i * hs + d];
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      kb[j] = kr[j * LANES * hs + d];
      vb[j] = vr[j * LANES * hs + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
  const float sl2 = a.scale * attn::LOG2E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ry * 4 + i;
    const int pos = q_lo + r % a.bq;
    const bool row_ok = r < R && pos < a.Lq;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int kk = lx + LANES * j, key = k_lo + kk;
      bool ok = row_ok && key < a.Lk;
      if (a.causal) ok = ok && key <= pos;
      if (a.window) ok = ok && key > pos - a.window;
      const float p = ok ? exp2f(s[i][j] * sl2 - sL[r]) : 0.f;
      sdS[r * SS + kk] = p * (dp[i][j] - sD[r]);
      if (sP) sP[r * SS + kk] = round_p(p, T());
    }
  }
}

// ------------------------------------------------------------------- //
// 2. dK, dV: one block per (b, KV head, key tile)
// ------------------------------------------------------------------- //
template <typename T, int HDT, int TK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Args a) {
  constexpr int hs = HDT + 1, SS = TK + 1, KR = TK / LANES,
                NC = HDT / LANES;
  extern __shared__ float smem[];
  float* sK = smem;                 // TK x hs
  float* sV = sK + TK * hs;         // TK x hs
  float* sQ = sV + TK * hs;         // ROWS x hs
  float* sdO = sQ + ROWS * hs;      // ROWS x hs
  float* sP = sdO + ROWS * hs;      // ROWS x SS
  float* sdS = sP + ROWS * SS;      // ROWS x SS
  float* sL = sdS + ROWS * SS;      // ROWS
  float* sD = sL + ROWS;            // ROWS

  const int BH = a.B * a.Hkv;
  const int kt = static_cast<int>(blockIdx.x) / BH;
  const int b = blockIdx.x % BH / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int k_lo = kt * TK, k_hi = min(k_lo + TK, a.Lk) - 1;
  const int ry = threadIdx.x / LANES, lx = threadIdx.x % LANES;
  const int R = a.G * a.bq;
  const int nq = (a.Lq + a.bq - 1) / a.bq;
  // the query tiles the mask keeps for keys k_lo .. k_hi
  const int qt0 = a.causal ? min(nq, k_lo / a.bq) : 0;
  const int qt1 =
      a.window ? min(nq, (k_hi + a.window - 1) / a.bq + 1) : nq;

  load_keys<T, HDT, TK>(a, b, kvh, k_lo, sK, sV);
  float dk[KR][NC], dv[KR][NC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q_lo = qt * a.bq;
    __syncthreads();  // the previous tile's rows, P and dS are consumed
    load_rows<T, HDT>(a, b, kvh, q_lo, sQ, sdO, sL, sD);
    __syncthreads();
    score_tile<T, HDT, TK>(a, q_lo, k_lo, sQ, sdO, sK, sV, sL, sD, sP, sdS);
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      float p[KR], ds[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        p[i] = sP[r * SS + ry * KR + i];
        ds[i] = sdS[r * SS + ry * KR + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float o = sdO[r * hs + lx + LANES * c];
        const float x = sQ[r * hs + lx + LANES * c];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          dv[i][c] = fmaf(p[i], o, dv[i][c]);
          dk[i][c] = fmaf(ds[i], x, dk[i][c]);
        }
      }
    }
  }

  T* gk = static_cast<T*>(a.dk);
  T* gv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int key = k_lo + ry * KR + i;
    if (key >= a.Lk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Lk + key) * a.Hkv + kvh) * a.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lx + LANES * c;
      if (d < a.hd) {
        st(gk + base + d, dk[i][c] * a.scale);
        st(gv + base + d, dv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------------- //
// 3. dQ: one block per (b, KV head, query tile of grouped rows)
// ------------------------------------------------------------------- //
template <typename T, int HDT, int TK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int hs = HDT + 1, SS = TK + 1, NC = HDT / LANES;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TK * hs;
  float* sQ = sV + TK * hs;
  float* sdO = sQ + ROWS * hs;
  float* sdS = sdO + ROWS * hs;     // ROWS x SS
  float* sL = sdS + ROWS * SS;
  float* sD = sL + ROWS;

  const int BH = a.B * a.Hkv;
  const int qt = static_cast<int>(blockIdx.x) / BH;
  const int b = blockIdx.x % BH / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int q_lo = qt * a.bq, q_hi = min(q_lo + a.bq, a.Lq) - 1;
  const int ry = threadIdx.x / LANES, lx = threadIdx.x % LANES;
  // the key tiles the mask keeps: the forward's skips
  const int k_end = a.causal ? min(a.Lk, q_hi + 1) : a.Lk;
  int j0 = 0;
  if (a.window) {
    const int x = q_lo - a.window + 1;
    if (x > 0) j0 = x / TK;
  }
  const int j1 = (k_end + TK - 1) / TK;

  load_rows<T, HDT>(a, b, kvh, q_lo, sQ, sdO, sL, sD);
  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k_lo = j * TK;
    __syncthreads();  // the previous tile's K and dS are consumed
    load_keys<T, HDT, TK>(a, b, kvh, k_lo, sK, sV);
    __syncthreads();
    score_tile<T, HDT, TK>(a, q_lo, k_lo, sQ, sdO, sK, sV, sL, sD, nullptr,
                           sdS);
    __syncthreads();
    for (int kk = 0; kk < TK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(ry * 4 + i) * SS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float x = sK[kk * hs + lx + LANES * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(ds[i], x, dq[i][c]);
      }
    }
  }

  T* gq = static_cast<T*>(a.dq);
  const int R = a.G * a.bq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ry * 4 + i;
    const int pos = q_lo + r % a.bq, head = kvh * a.G + r / a.bq;
    if (r >= R || pos >= a.Lq) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Lq + pos) * a.Hq + head) * a.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lx + LANES * c;
      if (d < a.hd) st(gq + base + d, dq[i][c] * a.scale);
    }
  }
}

template <typename T, int HDT, int TK>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HDT, TK>() * static_cast<int>(sizeof(float));
  static bool opted = false;           // once per template, per process
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, HDT, TK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HDT, TK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const long long rows = static_cast<long long>(a.B) * a.Lq * a.Hq;
  const int per = THREADS / 32;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + per - 1) / per),
                            THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = a.B * a.Hkv;
  const int nk = (a.Lk + TK - 1) / TK, nq = (a.Lq + a.bq - 1) / a.bq;
  flash_bwd_dkdv_kernel<T, HDT, TK><<<nk * BH, THREADS, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HDT, TK><<<nq * BH, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tile(int hd_tile, const Args& a, cudaStream_t st) {
  switch (hd_tile) {
    case 32: return launch<T, 32, 64>(a, st);
    case 64: return launch<T, 64, 64>(a, st);
    case 128: return launch<T, 128, 64>(a, st);
    case 160: return launch<T, 160, 32>(a, st);
    case 256: return launch<T, 256, 32>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Lq, Hq, hd), k and v (B, Lk,
// Hkv, hd) as the forward took them (strides in elements, the last
// dimension contiguous); o and dout (B, Lq, Hq, hd) contiguous; lse the
// forward's (B, Hq, Lq) f32 buffer; dsum an f32 (B, Hq, Lq) scratch
// buffer; dq (B, Lq, Hq, hd), dk and dv (B, Lk, Hkv, hd) contiguous
// outputs in the inputs' type, each element written once. hd a multiple
// of 8 in [8, 256]; hd_tile one of 32, 64, 128, 160, 256 and >= hd; G =
// Hq / Hkv in [1, 64]. Returns the first cudaGetLastError() that is not
// 0 after the three launches (0 = all launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int Lq, int Lk, int Hq, int Hkv, int hd, int hd_tile,
    long long q_sb, long long q_sl, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || hd < 8 || hd > hd_tile || hd % 8 != 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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
  if (dtype == 1) return by_tile<bf16>(hd_tile, a, st);
  if (dtype == 0) return by_tile<float>(hd_tile, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
