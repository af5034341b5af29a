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
// inputs' type. bf16 also rounds dS to bf16 before the dK and dQ
// products (the operand type of the MMA), where the plain version keeps
// it in f32.
//
// Launches, on either route:
//   1. flash_bwd_dot_kernel: D, a row's 16-byte units over a group of
//      lanes (a power of two, up to a warp), summed by xor shuffles.
//   2. dK/dV: one block per (b, KV head, key tile). It holds the tile's K
//      and V and walks the query tiles the mask keeps, each tile the
//      forward's grouping of 64 rows (the G heads times 64 / G positions,
//      so the K/V tile serves the whole group and dK/dV are summed over
//      the G heads in the block), recomputing P and dS of the tile.
//   3. dQ: one block per (b, KV head, query tile of the same 64 grouped
//      rows). It walks the key tiles the mask keeps (the forward's
//      skips), recomputes dS the same way and accumulates dQ.
// Each block owns its outputs, and every sum runs in a fixed order, so a
// step's gradients are the same bits launch after launch.
//
// Two routes, by the inputs' dtype alone (the wrapper's plan_bwd):
//
// bf16 -> mma (FlashAttention-2 on mma.sync; helpers in attn_mma.cuh).
//   dK/dV (flash_bwd_dkdv_mma_kernel): 64 keys a block, 4 warps of 16
//   keys each. K and V are staged once; at head-dim tiles 32 and 64 their
//   fragments are then held in registers, above that re-read from shared
//   memory as A operands. Query tiles (Q, dO, and the rows' LSE and D)
//   stream through a 2-stage cp.async ring in bf16, rows padded by 16
//   bytes, so every ldmatrix is free of bank conflicts. For each tile,
//   in sub-steps of NR rows: S^T = K Q^T (m16n8k16, f32 accumulators,
//   keys as M, rows as N), P^T = exp2(S^T scale log2e - LSE) from the
//   accumulators, dV += P^T dO (P^T rounded to bf16 straight into the A
//   operand), dP^T = V dO^T, dS^T = P^T (dP^T - D) into the A operand,
//   dK += dS^T Q. A tile live for every (row, key) skips the mask
//   arithmetic. At head-dim tiles 160 and 256 the dK/dV accumulators of
//   16 keys would not fit a warp's registers: 8 warps share the block,
//   each pair of warps the same 16 keys, each warp half the dimensions of
//   dK and dV (both recompute the pair's S^T and dP^T).
//   dQ (flash_bwd_dq_mma_kernel): 4 warps x 16 of the 64 grouped rows; Q
//   and dO fragments held in registers (re-read from shared memory at
//   head-dim tiles 128 and above); key tiles through the forward's
//   2-stage K/V ring; S = Q K^T, P, dP = dO V^T, dS, dQ += dS K (K via
//   ldmatrix.trans), all on the tensor cores.
//
// f32 -> simt: the products in f32 on the CUDA cores, which the fp32
//   gate of 1e-4 against the plain version needs (TF32 and bf16 products
//   would not hold it). Every tile is staged in shared memory as f32 with
//   rows padded by one word; 256 threads as 16 x 16; TK = 64 keys for
//   head-dim tiles up to 128, 32 above.
//
// What bounds it on this card: the operations, 10 hd per live pair and
// query head (S, dP, dV, dQ, dK: five products of 2 hd; the dK/dV
// kernel's S and dP repeated by the dQ kernel are not counted), against
// 989 TFLOP/s of bf16 tensor cores; mma.sync reaches a fraction of that
// peak (wgmma with TMA-fed tiles is the further step), and the split
// templates at 160 and 256 do 1.5x the dK/dV kernel's products. The simt
// route is bound by its CUDA-core FMAs (67 TFLOP/s) and reads two shared
// operands a pair of FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;       // grouped query rows a tile (G * bq)
constexpr int THREADS = 256;   // the simt kernels: 16 x 16; the D launch
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

// ------------------------------------------------------------------- //
// 1. D = rowsum(dO * O): LPR lanes a row, 16-byte units
// ------------------------------------------------------------------- //
__device__ __forceinline__ float dot_unit(uint4 x, uint4 y, float) {
  return __uint_as_float(x.x) * __uint_as_float(y.x) +
         __uint_as_float(x.y) * __uint_as_float(y.y) +
         __uint_as_float(x.z) * __uint_as_float(y.z) +
         __uint_as_float(x.w) * __uint_as_float(y.w);
}
__device__ __forceinline__ float dot_word(uint32_t x, uint32_t y) {
  return __uint_as_float(x << 16) * __uint_as_float(y << 16) +
         __uint_as_float(x & 0xffff0000u) * __uint_as_float(y & 0xffff0000u);
}
__device__ __forceinline__ float dot_unit(uint4 x, uint4 y, bf16) {
  return dot_word(x.x, y.x) + dot_word(x.y, y.y) + dot_word(x.z, y.z) +
         dot_word(x.w, y.w);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dot_kernel(Args a,
                                                                int lpr) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const long long rows = static_cast<long long>(a.B) * a.Lq * a.Hq;
  const int lane = threadIdx.x & 31, sub = lane & (lpr - 1);
  const long long n =
      (static_cast<long long>(blockIdx.x) * (THREADS / 32) +
       (threadIdx.x >> 5)) * (32 / lpr) + lane / lpr;
  float s = 0.f;
  if (n < rows) {
    const uint4* o =
        reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + n * a.hd);
    const uint4* d = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.dout) + n * a.hd);
    for (int u = sub; u < a.hd / E; u += lpr)
      s += dot_unit(__ldg(o + u), __ldg(d + u), T());
  }
  for (int off = lpr >> 1; off; off >>= 1)
    s += __shfl_xor_sync(attn::FULL, s, off);
  if (n < rows && sub == 0) {
    const int h = static_cast<int>(n % a.Hq);
    const long long bl = n / a.Hq;
    const int l = static_cast<int>(bl % a.Lq), b = static_cast<int>(bl / a.Lq);
    a.dsum[(static_cast<long long>(b) * a.Hq + h) * a.Lq + l] = s;
  }
}

// ------------------------------------------------------------------- //
// bf16: tensor cores
// ------------------------------------------------------------------- //
constexpr int KEYS = 64;       // keys a dK/dV block (4 warp slices of 16)
constexpr int STAGES = 2;      // query (dK/dV) or key (dQ) tiles in the ring

template <int HDT>
constexpr int dkdv_smem_bytes() {  // K, V, the Q / dO ring, LSE and D
  return (2 * KEYS + 2 * STAGES * ROWS) * (HDT + 8) * 2 +
         2 * STAGES * ROWS * 4;
}

template <int HDT, int BK>
constexpr int dq_smem_bytes() {    // Q, dO, the K/V ring
  return (2 * ROWS + 2 * STAGES * BK) * (HDT + 8) * 2;
}

// The live test of (a row at position pos, key): the forward's mask
__device__ __forceinline__ bool live_pair(const Args& a, int pos, int key) {
  bool ok = key < a.Lk;
  if (a.causal) ok = ok && key <= pos;
  if (a.window) ok = ok && key > pos - a.window;
  return ok;
}

// HDT: head-dim tile; NR: query rows a sub-step (16, 32 or 64); KREG: K and
// V fragments held in registers; DS: warps sharing a 16-key slice, each
// owning HDT / DS of dK's and dV's dimensions (4 DS warps a block)
template <int HDT, int NR, bool KREG, int DS>
__global__ void __launch_bounds__(128 * DS)
    flash_bwd_dkdv_mma_kernel(Args a) {
  constexpr int STR = HDT + 8;         // padded shared row (elements)
  constexpr int KS = HDT / 16;         // k-steps of K Q^T and V dO^T
  constexpr int NT = NR / 8;           // n-tiles (rows) of S^T and dP^T
  constexpr int HD = HDT / DS;         // dK / dV dimensions a warp
  constexpr int NO = HD / 8;           // n-tiles of dK and dV
  constexpr int CPR = HDT / 8;         // 16-byte chunks a row
  constexpr int NTH = 128 * DS;
  static_assert(HDT % 16 == 0 && HD % 16 == 0 && ROWS % NR == 0 &&
                    ROWS * CPR % NTH == 0,
                "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // KEYS x STR
  bf16* sV = sK + KEYS * STR;                 // KEYS x STR
  bf16* sQ = sV + KEYS * STR;                 // STAGES x ROWS x STR
  bf16* sdO = sQ + STAGES * ROWS * STR;       // STAGES x ROWS x STR
  float* sL = reinterpret_cast<float*>(sdO + STAGES * ROWS * STR);
  float* sD = sL + STAGES * ROWS;             // STAGES x ROWS each
  // each grouped row's position in its tile (r % bq; -1 past R), its
  // head and the head's offset in q: the same for every query tile
  __shared__ int sPos[ROWS], sHead[ROWS], sQh[ROWS];

  const int BH = a.B * a.Hkv;
  const int kt = static_cast<int>(blockIdx.x) / BH;
  const int b = blockIdx.x % BH / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int k_lo = kt * KEYS, k_hi = min(k_lo + KEYS, a.Lk) - 1;
  const int R = a.G * a.bq;
  const int nq = (a.Lq + a.bq - 1) / a.bq;
  // the query tiles the mask keeps for keys k_lo .. k_hi
  const int qt0 = a.causal ? min(nq, k_lo / a.bq) : 0;
  const int qt1 =
      a.window ? min(nq, (k_hi + a.window - 1) / a.bq + 1) : nq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = (warp & 3) * 16;      // the warp's 16 keys of the tile
  const int dh = (warp >> 2) * HD;     // its slice of dK's dimensions

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* dout = static_cast<const bf16*>(a.dout) +
                     static_cast<long long>(b) * a.Lq * a.Hq * a.hd;
  const float* lse = a.lse + static_cast<long long>(b) * a.Hq * a.Lq;
  const float* dsum = a.dsum + static_cast<long long>(b) * a.Hq * a.Lq;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const long long o_sl = static_cast<long long>(a.Hq) * a.hd;
  for (int r = tid; r < ROWS; r += NTH) {
    const int head = kvh * a.G + r / a.bq;
    sPos[r] = r < R ? r % a.bq : -1;
    sHead[r] = head;
    sQh[r] = static_cast<int>(head * a.q_sh);
  }
  __syncthreads();

  // K and V (keys past Lk and dimensions past hd zero-filled) ride in the
  // first copy group with the first query tile
  for (int i = tid; i < KEYS * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int key = k_lo + r;
    const bool ok = key < a.Lk && c < a.hd;
    attn::cp_async16(sK + r * STR + c, kp + (ok ? key * a.k_sl + c : 0), ok);
    attn::cp_async16(sV + r * STR + c, vp + (ok ? key * a.v_sl + c : 0), ok);
  }
  // query tile qt into stage st: Q and dO rows, each row's LSE and D,
  // zero-filled past R, past Lq and past hd; one copy group (empty past
  // the last tile, so the count of groups in flight stays the same)
  auto stage_rows = [&](int qt, int st) {
    if (qt < qt1) {
      const int q_lo = qt * a.bq;
#pragma unroll
      for (int it = 0; it < ROWS * CPR / NTH; ++it) {
        const int i = tid + it * NTH;
        const int r = i / CPR, c = (i % CPR) * 8;
        const int t = sPos[r], pos = q_lo + t;
        const bool ok = t >= 0 && pos < a.Lq && c < a.hd;
        const int dst = (st * ROWS + r) * STR + c;
        attn::cp_async16(sQ + dst, q + (ok ? pos * a.q_sl + sQh[r] + c : 0),
                         ok);
        attn::cp_async16(
            sdO + dst, dout + (ok ? pos * o_sl + sHead[r] * a.hd + c : 0),
            ok);
      }
      for (int i = tid; i < 2 * ROWS; i += NTH) {
        const int r = i % ROWS;
        const int t = sPos[r], pos = q_lo + t;
        const bool ok = t >= 0 && pos < a.Lq;
        // (b, head, pos) of (B, Hq, Lq): the head's row of positions
        const long long gi =
            ok ? static_cast<long long>(sHead[r]) * a.Lq + pos : 0;
        if (i < ROWS)
          attn::cp_async4(sL + st * ROWS + r, lse + gi, ok);
        else
          attn::cp_async4(sD + st * ROWS + r, dsum + gi, ok);
      }
    }
    attn::cp_async_commit();
  };
  stage_rows(qt0, 0);

  const bf16* kl = attn::q_lane<STR>(sK + wk * STR, lane);  // A operands
  const bf16* vl = attn::q_lane<STR>(sV + wk * STR, lane);
  uint32_t kf[KREG ? KS : 1][4], vf[KREG ? KS : 1][4];
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2 = a.scale * attn::LOG2E;
  const int key0 = k_lo + wk + (lane >> 2);  // this lane's keys: +0, +8
  const int c2 = 2 * (lane & 3);             // its first row of an n-tile

  int st = 0;
  for (int qt = qt0; qt < qt1; ++qt) {
    stage_rows(qt + 1, st ^ 1);        // the other stage is consumed
    attn::cp_async_wait<STAGES - 1>(); // tile qt has landed
    __syncthreads();                   // ... for every thread
    if constexpr (KREG) {
      if (qt == qt0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          attn::ldsm_x4(kf[ks], kl + ks * 16);
          attn::ldsm_x4(vf[ks], vl + ks * 16);
        }
      }
    }
    const int q_lo = qt * a.bq;
    // every (row, key) pair of the tile live: no mask arithmetic
    bool whole = true;
    if (a.causal) whole = k_lo + KEYS - 1 <= q_lo;
    if (a.window) whole = whole && k_lo > q_lo + a.bq - 1 - a.window;
    const bf16* tQ = sQ + st * ROWS * STR;
    const bf16* tdO = sdO + st * ROWS * STR;
    const float* tL = sL + st * ROWS;
    const float* tD = sD + st * ROWS;
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += NR) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S^T = K Q^T: the sub-step's rows as the B operand
      const bf16* ql = attn::k_lane<STR>(tQ + r0 * STR, lane);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (KREG) {
          attn::qk_step<NT, STR>(s, kf[ks], ql, ks);
        } else {
          uint32_t ka[4];
          attn::ldsm_x4(ka, kl + ks * 16);
          attn::qk_step<NT, STR>(s, ka, ql, ks);
        }
      }
      // P^T from each row's LSE; a masked pair's p is 0
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = r0 + n * 8 + c2;
        const float2 l2 = *reinterpret_cast<const float2*>(tL + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * sl2 - ((e & 1) ? l2.y : l2.x));
          if (!whole && !live_pair(a, q_lo + sPos[r + (e & 1)],
                                   key0 + 8 * (e >> 1)))
            p = 0.f;
          s[n][e] = p;
        }
      }
      // dV += P^T dO (P^T rounded to bf16 into the A operand)
      attn::pv_tile<NT, NO, STR>(dv, s, tdO + r0 * STR + dh, lane);
      // dP^T = V dO^T
      const bf16* ol = attn::k_lane<STR>(tdO + r0 * STR, lane);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (KREG) {
          attn::qk_step<NT, STR>(dp, vf[ks], ol, ks);
        } else {
          uint32_t va[4];
          attn::ldsm_x4(va, vl + ks * 16);
          attn::qk_step<NT, STR>(dp, va, ol, ks);
        }
      }
      // dS^T = P^T (dP^T - D), then dK += dS^T Q (dS^T rounded to bf16)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(tD + r0 + n * 8 + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
      }
      attn::pv_tile<NT, NO, STR>(dk, dp, tQ + r0 * STR + dh, lane);
    }
    __syncthreads();                   // stage st is consumed
    st ^= 1;
  }
  attn::cp_async_wait<0>();

  bf16* gk = static_cast<bf16*>(a.dk);
  bf16* gv = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= a.Lk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Lk + key) * a.Hkv + kvh) * a.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = dh + n * 8 + c2;
      if (d < a.hd) {
        *reinterpret_cast<__nv_bfloat162*>(gk + base + d) =
            __floats2bfloat162_rn(dk[n][2 * h] * a.scale,
                                  dk[n][2 * h + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(gv + base + d) =
            __floats2bfloat162_rn(dv[n][2 * h], dv[n][2 * h + 1]);
      }
    }
  }
}

// HDT: head-dim tile; BK: keys a tile; QREG: Q's and dO's fragments held
// in registers (else re-read from shared memory). Up to a head-dim tile
// of 64, three blocks an SM (at most 168 registers a thread).
template <int HDT, int BK, bool QREG>
__global__ void __launch_bounds__(128, HDT <= 64 ? 3 : 1)
    flash_bwd_dq_mma_kernel(Args a) {
  constexpr int STR = HDT + 8;
  constexpr int KS = HDT / 16;         // k-steps of Q K^T and dO V^T
  constexpr int NS = BK / 8;           // n-tiles (keys) of S and dP
  constexpr int NO = HDT / 8;          // n-tiles of dQ
  constexpr int CPR = HDT / 8;
  static_assert(HDT % 16 == 0 && BK % 16 == 0, "tile shapes");
  static_assert(BK * CPR % 128 == 0, "tile must split evenly");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // ROWS x STR
  bf16* sdO = sQ + ROWS * STR;                // ROWS x STR
  bf16* sK = sdO + ROWS * STR;                // STAGES x BK x STR
  bf16* sV = sK + STAGES * BK * STR;          // STAGES x BK x STR

  const int BH = a.B * a.Hkv;
  const int nq = gridDim.x / BH;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int b = blockIdx.x % BH / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int q_lo = qt * a.bq, q_hi = min(q_lo + a.bq, a.Lq) - 1;
  const int R = a.G * a.bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the key tiles the mask keeps: the forward's skips
  const int k_end = a.causal ? min(a.Lk, q_hi + 1) : a.Lk;
  int j0 = 0;
  if (a.window) {
    const int x = q_lo - a.window + 1;
    if (x > 0) j0 = x / BK;
  }
  const int j1 = (k_end + BK - 1) / BK;

  auto load_tile = [&](int j, int st) {
    if (j < j1) {
#pragma unroll
      for (int it = 0; it < BK * CPR / 128; ++it) {
        const int i = tid + it * 128;
        const int r = i / CPR, c = (i % CPR) * 8;
        const int key = j * BK + r;
        const bool ok = key < a.Lk && c < a.hd;
        const int dst = (st * BK + r) * STR + c;
        attn::cp_async16(sK + dst, kp + (ok ? key * a.k_sl + c : 0), ok);
        attn::cp_async16(sV + dst, vp + (ok ? key * a.v_sl + c : 0), ok);
      }
    }
    attn::cp_async_commit();
  };
  // Q and dO ride in the first group
  for (int i = tid; i < ROWS * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = r % a.bq, head = kvh * a.G + r / a.bq, pos = q_lo + t;
    const bool ok = r < R && pos < a.Lq && c < a.hd;
    attn::cp_async16(sQ + r * STR + c,
                     q + (ok ? pos * a.q_sl + head * a.q_sh + c : 0), ok);
    attn::cp_async16(
        sdO + r * STR + c,
        dout + (ok ? ((static_cast<long long>(b) * a.Lq + pos) * a.Hq +
                      head) * a.hd + c
                   : 0),
        ok);
  }
  load_tile(j0, 0);

  const int wrow = warp * 16;
  const bool live = wrow < R;          // uniform across the warp
  // this lane's rows g and g + 8: positions, heads, LSE and D
  const int ra = wrow + (lane >> 2);
  float L[2], D[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const int pos = q_lo + r % a.bq, head = kvh * a.G + r / a.bq;
    const bool ok = r < R && pos < a.Lq;
    const long long gi = (static_cast<long long>(b) * a.Hq + head) * a.Lq + pos;
    L[h] = ok ? a.lse[gi] : 0.f;
    D[h] = ok ? a.dsum[gi] : 0.f;
    qpos[h] = pos;
  }
  const bf16* ql = attn::q_lane<STR>(sQ + wrow * STR, lane);
  const bf16* ol = attn::q_lane<STR>(sdO + wrow * STR, lane);
  uint32_t qf[QREG ? KS : 1][4], of[QREG ? KS : 1][4];
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float sl2 = a.scale * attn::LOG2E;

  int st = 0;
  for (int j = j0; j < j1; ++j) {
    load_tile(j + 1, st ^ 1);
    attn::cp_async_wait<STAGES - 1>();
    __syncthreads();
    if constexpr (QREG) {
      if (j == j0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          attn::ldsm_x4(qf[ks], ql + ks * 16);
          attn::ldsm_x4(of[ks], ol + ks * 16);
        }
      }
    }
    if (live) {
      const bf16* tK = sK + st * BK * STR;
      const bf16* kl = attn::k_lane<STR>(tK, lane);
      const bf16* vl = attn::k_lane<STR>(sV + st * BK * STR, lane);
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (QREG) {
          attn::qk_step<NS, STR>(s, qf[ks], kl, ks);
        } else {
          uint32_t qa[4];
          attn::ldsm_x4(qa, ql + ks * 16);
          attn::qk_step<NS, STR>(s, qa, kl, ks);
        }
      }
      const int k0 = j * BK;
      bool whole = k0 + BK <= a.Lk;
      if (a.causal) whole = whole && k0 + BK - 1 <= q_lo;
      if (a.window) whole = whole && k0 > q_hi - a.window;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * sl2 - L[e >> 1]);
          if (!whole) {
            const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            const int qp = qpos[e >> 1];
            bool ok = key < a.Lk;
            if (a.causal) ok = ok && key <= qp;
            if (a.window) ok = ok && key > qp - a.window;
            if (!ok) p = 0.f;
          }
          s[n][e] = p;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (QREG) {
          attn::qk_step<NS, STR>(dp, of[ks], vl, ks);
        } else {
          uint32_t oa[4];
          attn::ldsm_x4(oa, ol + ks * 16);
          attn::qk_step<NS, STR>(dp, oa, vl, ks);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - D[e >> 1]);
      // dQ += dS K (dS rounded to bf16 into the A operand, K transposed)
      attn::pv_tile<NS, NO, STR>(dq, dp, tK, lane);
    }
    __syncthreads();
    st ^= 1;
  }
  attn::cp_async_wait<0>();
  if (!live) return;

  bf16* gq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const int head = kvh * a.G + r / a.bq;
    if (r >= R || qpos[h] >= a.Lq) continue;
    bf16* row = gq + ((static_cast<long long>(b) * a.Lq + qpos[h]) * a.Hq +
                      head) * a.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * (lane & 3);
      if (d < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
            dq[n][2 * h] * a.scale, dq[n][2 * h + 1] * a.scale);
    }
  }
}

// ------------------------------------------------------------------- //
// f32: CUDA cores (the design of the port's first version)
// ------------------------------------------------------------------- //
// Shared floats of either simt kernel (sP unused by the dQ kernel)
template <int HDT, int TK>
constexpr int smem_floats() {
  return 2 * TK * (HDT + 1) + 2 * ROWS * (HDT + 1) + 2 * ROWS * (TK + 1) +
         2 * ROWS;
}

// The 64 grouped query rows at positions q_lo.. of KV head kvh: Q and dO
// (zeros past hd, past R rows and past Lq), each row's lse and D
template <int HDT>
__device__ __forceinline__ void load_rows(const Args& a, int b, int kvh,
                                          int q_lo, float* sQ, float* sdO,
                                          float* sL, float* sD) {
  constexpr int hs = HDT + 1;
  const int R = a.G * a.bq;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* dout = static_cast<const float*>(a.dout);
  for (int i = threadIdx.x; i < ROWS * HDT; i += THREADS) {
    const int r = i / HDT, c = i % HDT;
    const int t = r % a.bq, head = kvh * a.G + r / a.bq, pos = q_lo + t;
    const bool ok = r < R && pos < a.Lq && c < a.hd;
    float x = 0.f, y = 0.f;
    if (ok) {
      x = q[pos * a.q_sl + head * a.q_sh + c];
      y = dout[((static_cast<long long>(b) * a.Lq + pos) * a.Hq + head) *
                   a.hd + c];
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
template <int HDT, int TK>
__device__ __forceinline__ void load_keys(const Args& a, int b, int kvh,
                                          int k_lo, float* sK, float* sV) {
  constexpr int hs = HDT + 1;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  for (int i = threadIdx.x; i < TK * HDT; i += THREADS) {
    const int r = i / HDT, c = i % HDT;
    const int key = k_lo + r;
    const bool ok = key < a.Lk && c < a.hd;
    sK[r * hs + c] = ok ? k[key * a.k_sl + c] : 0.f;
    sV[r * hs + c] = ok ? v[key * a.v_sl + c] : 0.f;
  }
}

// The score tile of 64 rows x TK keys: S and dP in registers (a thread
// rows ry * 4 + i, keys lx + 16 j), then dS (and, with sP, p) into shared
// memory; a pair outside the mask gets p = dS = 0.
template <int HDT, int TK>
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
      if (sP) sP[r * SS + kk] = p;
    }
  }
}

// dK, dV: one block per (b, KV head, key tile)
template <int HDT, int TK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(Args a) {
  constexpr int hs = HDT + 1, SS = TK + 1, KR = TK / LANES,
                NC = HDT / LANES;
  extern __shared__ float smemf[];
  float* sK = smemf;                 // TK x hs
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

  load_keys<HDT, TK>(a, b, kvh, k_lo, sK, sV);
  float dk[KR][NC], dv[KR][NC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q_lo = qt * a.bq;
    __syncthreads();  // the previous tile's rows, P and dS are consumed
    load_rows<HDT>(a, b, kvh, q_lo, sQ, sdO, sL, sD);
    __syncthreads();
    score_tile<HDT, TK>(a, q_lo, k_lo, sQ, sdO, sK, sV, sL, sD, sP, sdS);
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

  float* gk = static_cast<float*>(a.dk);
  float* gv = static_cast<float*>(a.dv);
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
        gk[base + d] = dk[i][c] * a.scale;
        gv[base + d] = dv[i][c];
      }
    }
  }
}

// dQ: one block per (b, KV head, query tile of grouped rows)
template <int HDT, int TK>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int hs = HDT + 1, SS = TK + 1, NC = HDT / LANES;
  extern __shared__ float smemf[];
  float* sK = smemf;
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

  load_rows<HDT>(a, b, kvh, q_lo, sQ, sdO, sL, sD);
  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k_lo = j * TK;
    __syncthreads();  // the previous tile's K and dS are consumed
    load_keys<HDT, TK>(a, b, kvh, k_lo, sK, sV);
    __syncthreads();
    score_tile<HDT, TK>(a, q_lo, k_lo, sQ, sdO, sK, sV, sL, sD, nullptr,
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

  float* gq = static_cast<float*>(a.dq);
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
      if (d < a.hd) gq[base + d] = dq[i][c] * a.scale;
    }
  }
}

// ------------------------------------------------------------------- //
// launchers
// ------------------------------------------------------------------- //
template <typename T>
int launch_dot(const Args& a, cudaStream_t stream) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  int lpr = 1;                         // lanes a row: the units, to a power
  while (lpr < 32 && lpr * E < a.hd) lpr <<= 1;
  const long long rows = static_cast<long long>(a.B) * a.Lq * a.Hq;
  const long long per = (THREADS / 32) * (32 / lpr);
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + per - 1) / per),
                            THREADS, 0, stream>>>(a, lpr);
  return static_cast<int>(cudaGetLastError());
}

template <int HDT, int NR, bool KREG, int DS, int BK, bool QREG>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int kv_bytes = dkdv_smem_bytes<HDT>();
  constexpr int q_bytes = dq_smem_bytes<HDT, BK>();
  static bool opted = false;           // once per template, per process
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma_kernel<HDT, NR, KREG, DS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HDT, BK, QREG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 q_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  int err = launch_dot<bf16>(a, stream);
  if (err != 0) return err;
  const int BH = a.B * a.Hkv;
  const int nk = (a.Lk + KEYS - 1) / KEYS, nq = (a.Lq + a.bq - 1) / a.bq;
  flash_bwd_dkdv_mma_kernel<HDT, NR, KREG, DS>
      <<<nk * BH, 128 * DS, kv_bytes, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dq_mma_kernel<HDT, BK, QREG><<<nq * BH, 128, q_bytes, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int HDT, int TK>
int launch_simt(const Args& a, cudaStream_t stream) {
  constexpr int bytes =
      smem_floats<HDT, TK>() * static_cast<int>(sizeof(float));
  static bool opted = false;           // once per template, per process
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HDT, TK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HDT, TK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  int err = launch_dot<float>(a, stream);
  if (err != 0) return err;
  const int BH = a.B * a.Hkv;
  const int nk = (a.Lk + TK - 1) / TK, nq = (a.Lq + a.bq - 1) / a.bq;
  flash_bwd_dkdv_kernel<HDT, TK><<<nk * BH, THREADS, bytes, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dq_kernel<HDT, TK><<<nq * BH, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (simt), 1 = bfloat16 (mma). q (B, Lq, Hq, hd), k
// and v (B, Lk, Hkv, hd) as the forward took them (strides in elements,
// the last dimension contiguous, rows on 16-byte boundaries); o and dout
// (B, Lq, Hq, hd) contiguous, 16-byte aligned; lse the forward's (B, Hq,
// Lq) f32 buffer; dsum an f32 (B, Hq, Lq) scratch buffer; dq (B, Lq, Hq,
// hd), dk and dv (B, Lk, Hkv, hd) contiguous outputs in the inputs' type,
// each element written once. hd a multiple of 8 in [8, 256]; hd_tile one
// of 32, 64, 128, 160, 256 and >= hd; key_tile the keys of a dK/dV block
// that the wrapper's plan_bwd names for the route and tile (checked
// here); G = Hq / Hkv in [1, 64]. Returns the first cudaGetLastError()
// that is not 0 after the three launches (0 = all launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int Lq, int Lk, int Hq, int Hkv, int hd, int hd_tile,
    int key_tile, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, int causal, int window, int dtype,
    void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || hd < 8 || hd > hd_tile || hd % 8 != 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int want_tile = dtype == 1 ? KEYS : (hd_tile <= 128 ? 64 : 32);
  if (key_tile != want_tile) return static_cast<int>(cudaErrorInvalidValue);
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
  if (dtype == 1) {
    // <HDT, rows a dK/dV sub-step, K/V in registers, warps a key slice,
    //  keys a dQ tile, Q/dO in registers>
    switch (hd_tile) {
      case 32: return launch_mma<32, 64, true, 1, 64, true>(a, st);
      case 64: return launch_mma<64, 64, true, 1, 32, true>(a, st);
      case 128: return launch_mma<128, 16, false, 1, 64, false>(a, st);
      case 160: return launch_mma<160, 64, false, 2, 64, false>(a, st);
      case 256: return launch_mma<256, 16, false, 2, 32, false>(a, st);
    }
  } else if (dtype == 0) {
    switch (hd_tile) {
      case 32: return launch_simt<32, 64>(a, st);
      case 64: return launch_simt<64, 64>(a, st);
      case 128: return launch_simt<128, 64>(a, st);
      case 160: return launch_simt<160, 32>(a, st);
      case 256: return launch_simt<256, 32>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
