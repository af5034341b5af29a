// Causal and/or windowed flash attention (online softmax), hand-written
// for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (body _flash_kernel: one head per program) and
//   flash_attention_gqa_pallas (body _flash_gqa_kernel: one program holds
//   a whole KV-head group). One grouping covers both: G = Hq / Hkv query
//   heads share every staged K/V tile, and G = 1 is the per-head kernel.
//   On the port's path it runs every cache-free self-attention
//   (forward_train, Model.prefill, the Zoo's model services).
//
// What it computes (ref.attention_reference, with the Pallas kernel's
// tile arithmetic): query i attends to key j (positions from 0 for
// both) where j <= i (causal) and j > i - window (window > 0), with
// scores (q . k) * 1/sqrt(hd) and q.k and p.v accumulated in f32. A
// masked score is the finite NEG_INF = -1e30, never -inf, as in the
// Pallas kernel: a row whose first live tile is wholly masked has
// m = -1e30, so exp(s - m) = 1 pollutes l and acc until a tile brings a
// real score, and then alpha = 0 wipes it; with -inf that row would
// become NaN. The finalize step maps l == 0 to 1. A tile is skipped on
// the Pallas kernel's test: causal needs k_lo <= q_hi, a window needs
// k_hi > q_lo - window.
//
// Two templates, chosen by the inputs' dtype alone:
//   bf16 -> flash_mma_kernel: products on the tensor cores. p is rounded
//     to bf16 before the P V product (the operand type of the MMA); that
//     is what the JAX model's plain route (gqa_attention) does, while the
//     Pallas kernel keeps p in f32. Sums stay in f32.
//   f32  -> flash_f32_kernel: products in f32 on the CUDA cores with p
//     in f32, the Pallas kernel's arithmetic to the last rounding (TF32
//     would not hold the 1e-4 gate against the plain version).
//
// Shapes: q (B, Lq, Hq, hd), k and v (B, Lk, Hkv, hd), read in the
// model's own layout through strides (the last dimension contiguous), so
// no transposed copy is made; the output (B, Lq, Hq, hd) is contiguous,
// in q's type. Any Lq and Lk: the ragged last tiles are masked here,
// where Pallas asserts divisibility (keys past Lk take no part at all,
// rows past Lq are not stored). Any head_dim that is a multiple of 8 up
// to 256 (the wrapper checks): the work runs on a head-dim tile HDT of
// 32, 64, 128, 160 or 256 (the wrapper's plan picks the smallest that
// holds hd), and the dimensions past hd are zeros (zero-padded k-steps
// on the tensor cores).
//
// Grouping (both templates): one block per (batch, KV head, query tile)
// holds ROWS = 64 query rows, G * bq of them with bq = 64 / G (row r is
// head kvh * G + r / bq at query q_lo + r % bq, the Pallas GQA kernel's
// grouping), so every K/V tile is read from device memory once for the
// whole group. Query tiles are issued last-first (the causal tiles with
// the most work start first), across all heads.
//
// bf16 design (FlashAttention-2 on mma.sync; helpers in attn_mma.cuh):
// 4 warps, each owning 16 of the 64 rows. Every copy into shared memory
// is a 16-byte cp.async (registers and L1 bypassed; rows past the end,
// the padded dimensions and the rows no query fills zero-filled): Q
// rides in the first copy group with the first K/V tile, and its
// fragments are then held in registers (for HDT 256 re-read from shared
// memory each tile instead, to stay clear of spills). K/V tiles of BK
// keys are staged in bf16 in a 2-stage ring, the next tile in flight
// while the current one is consumed. S = Q K^T runs as m16n8k16 MMAs
// with f32 accumulators; the online softmax works on the accumulator
// fragments (row max over the 4 lanes of a quad, exp2 with the scale
// folded in); a tile whose every key is live for every row of the block
// (below the diagonal, inside the window, inside Lk) skips the mask
// arithmetic. P goes from the accumulators, rounded to bf16, straight
// into the A operand of the P V MMA; O accumulates in f32 registers.
// Shared rows are padded by 16 bytes, so every ldmatrix is free of bank
// conflicts. At hd 160 (pixtral-12b) a block takes 105 KB of shared
// memory, two blocks an SM (a third stage would leave one).
//
// What bounds it on this card: the operations, 4 * B * Hq * hd per live
// query-key pair against 989 TFLOP/s of bf16 tensor cores, for every
// timed case but G = 1 at hd 128 (bytes). mma.sync reaches a fraction of
// that peak (wgmma with TMA-fed tiles is the further step), and a block
// re-reads each K/V tile for every 64 rows, from L2; the f32 template
// is bound by its CUDA-core FMAs (67 TFLOP/s) and, below that, by
// shared-memory bandwidth (8 shared loads per 16 FMAs).
//
// No atomics and a fixed order of every sum: the output is a pure
// function of the inputs, bitwise, launch after launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

using attn::NEG_INF;
using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;              // query rows per block (G * bq)

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

// --------------------------------------------------------------------- //
// bf16: tensor cores
// --------------------------------------------------------------------- //
constexpr int MMA_THREADS = 128;      // 4 warps x 16 rows
constexpr int STAGES = 2;             // K/V tiles in the ring

template <int HDT, int BK>
constexpr int mma_smem_bytes() {
  return (ROWS + 2 * STAGES * BK) * (HDT + 8) * 2;  // Q, the K/V ring
}

// HDT: head-dim tile (a multiple of 16, >= hd); BK: keys a tile; QREG:
// Q's fragments in registers (else re-read from shared memory)
template <int HDT, int BK, bool QREG>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_mma_kernel(Args a) {
  constexpr int STR = HDT + 8;        // padded shared row (elements)
  constexpr int KS = HDT / 16;        // k-steps of Q K^T
  constexpr int NS = BK / 8;          // n-tiles of S
  constexpr int NO = HDT / 8;         // n-tiles of O
  constexpr int CPR = HDT / 8;        // 16-byte chunks a row
  static_assert(HDT % 16 == 0 && BK % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // ROWS x STR
  bf16* sK = sQ + ROWS * STR;                // STAGES x BK x STR
  bf16* sV = sK + STAGES * BK * STR;         // STAGES x BK x STR

  const int BH = a.B * a.Hkv;
  const int nq = gridDim.x / BH;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;  // heavy first
  const int b = blockIdx.x % BH / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int q_lo = qt * a.bq;
  const int q_hi = min(q_lo + a.bq, a.Lq) - 1;
  const int R = a.G * a.bq;            // live rows of the tile (<= ROWS)
  const int hd = a.hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the key tiles this block visits: the Pallas kernel's skips
  const int k_end = a.causal ? min(a.Lk, q_hi + 1) : a.Lk;
  int j0 = 0;
  if (a.window) {
    const int x = q_lo - a.window + 1;  // tiles wholly at or below it go
    if (x > 0) j0 = x / BK;
  }
  const int j1 = (k_end + BK - 1) / BK;

  // K and V rows of tile j into stage st, keys past Lk and dimensions
  // past hd zero-filled, as one copy group (an empty group past the last
  // tile keeps the count of groups in flight the same every iteration)
  auto load_tile = [&](int j, int st) {
    if (j < j1) {
#pragma unroll
      for (int it = 0; it < BK * CPR / MMA_THREADS; ++it) {
        const int i = tid + it * MMA_THREADS;
        const int r = i / CPR, c = (i % CPR) * 8;
        const int key = j * BK + r;
        const bool ok = key < a.Lk && c < hd;
        const int dst = (st * BK + r) * STR + c;
        attn::cp_async16(sK + dst, kp + (ok ? key * a.k_sl + c : 0), ok);
        attn::cp_async16(sV + dst, vp + (ok ? key * a.v_sl + c : 0), ok);
      }
    }
    attn::cp_async_commit();
  };
  static_assert(BK * CPR % MMA_THREADS == 0, "tile must split evenly");

  // Q rides in the first group: rows past R or past Lq and dimensions
  // past hd zero-filled
  for (int i = tid; i < ROWS * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = r % a.bq, g = r / a.bq;
    const bool ok = r < R && q_lo + t < a.Lq && c < hd;
    attn::cp_async16(sQ + r * STR + c,
                     q + (ok ? (q_lo + t) * a.q_sl + (kvh * a.G + g) * a.q_sh
                                   + c : 0), ok);
  }
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) load_tile(j0 + p, p);

  const int wrow = warp * 16;
  const bool live = wrow < R;          // uniform across the warp
  const bf16* ql = attn::q_lane<STR>(sQ + wrow * STR, lane);
  uint32_t qf[QREG ? KS : 1][4];
  // this lane's rows g and g + 8 of the warp's 16, and their positions
  const int ra = wrow + (lane >> 2), rb = ra + 8;
  const int qpos[2] = {q_lo + ra % a.bq, q_lo + rb % a.bq};
  const float sl2 = a.scale * attn::LOG2E;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int st = 0;                          // the stage of tile j
  for (int j = j0; j < j1; ++j) {
    // the stage of tile j - 1 is consumed: tile j + STAGES - 1 goes there
    load_tile(j + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);
    attn::cp_async_wait<STAGES - 1>();  // tile j has landed
    __syncthreads();                    // ... for every thread
    if constexpr (QREG) {
      if (j == j0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) attn::ldsm_x4(qf[ks], ql + ks * 16);
      }
    }
    if (live) {
      float s[NS][4];
      const bf16* kl = attn::k_lane<STR>(sK + st * BK * STR, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
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
      // scale into the log2 domain and mask; a tile whose every key is
      // live for every row of the block needs no mask at all
      const int k0 = j * BK;
      bool whole = k0 + BK <= a.Lk;
      if (a.causal) whole = whole && k0 + BK - 1 <= q_lo;
      if (a.window) whole = whole && k0 > q_hi - a.window;
      if (whole) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            const int qp = qpos[e >> 1];
            bool ok = true;
            if (a.causal) ok = key <= qp;
            if (a.window) ok = ok && key > qp - a.window;
            float x = ok ? s[n][e] * sl2 : NEG_INF;
            if (key >= a.Lk) x = attn::minus_inf();  // takes no part
            s[n][e] = x;
          }
      }
      attn::softmax_step<NS, NO>(s, o, m, l);
      attn::pv_tile<NS, NO, STR>(o, s, sV + st * BK * STR, lane);
    }
    __syncthreads();                   // stage st is consumed
    st = st == STAGES - 1 ? 0 : st + 1;
  }
  attn::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(attn::FULL, l[h], 1);
    l[h] += __shfl_xor_sync(attn::FULL, l[h], 2);
  }
  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    const int t = r % a.bq, g = r / a.bq;
    if (r >= R || q_lo + t >= a.Lq) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);  // fully masked
    bf16* orow = out + ((static_cast<long long>(b) * a.Lq + q_lo + t) *
                            a.Hq + kvh * a.G + g) * hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * (lane & 3);
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
  }
}

template <int HDT, int BK, bool QREG>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<HDT, BK>();
  static bool opted = false;           // once per template, per process
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<HDT, BK, QREG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const int nq = (a.Lq + a.bq - 1) / a.bq;
  const dim3 grid(nq * a.B * a.Hkv);
  flash_mma_kernel<HDT, BK, QREG><<<grid, MMA_THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- //
// f32: CUDA cores, p in f32 (the design of the port's first version)
// --------------------------------------------------------------------- //
// One block of 256 threads per (batch, KV head, query tile). Every K/V
// tile of 64 keys is staged in shared memory as f32 with rows padded by
// one word; three phases per tile, each on the whole block: (1) scores,
// each thread a 4 x 4 register tile of S = Q K^T over hd; (2) the
// online softmax, 4 threads per row, max and sum by shuffles, P written
// over S; (3) the PV product, each thread 4 rows x hd/16 output
// dimensions in registers.
constexpr int THREADS = 256;
constexpr int BK = 64;                // keys per tile
constexpr int TR = 4;                 // rows per thread (phases 1 and 3)
constexpr int LANES = THREADS / (ROWS / TR);  // 16 key / dimension lanes
constexpr int TK = BK / LANES;        // keys per thread (phase 1)
constexpr int SS = BK + 1;            // padded row stride of the S tile
constexpr int PARTS = THREADS / ROWS; // threads per row (phase 2)
static_assert(TK * LANES == BK, "key tile must split over the lanes");
static_assert(PARTS == 4, "phase 2 reduces over 4 lanes");

__host__ __device__ inline int smem_floats(int hd) {
  return (ROWS + 2 * BK) * (hd + 1) + ROWS * SS + ROWS;
}

// ND: output dimensions per thread, the head-dim tile / LANES
template <int ND>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(Args a) {
  extern __shared__ float smemf[];
  const int hd = a.hd;
  const int hs = hd + 1;               // padded shared-memory row stride
  float* sQ = smemf;                   // ROWS x hs
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

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* kp =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // the query tile, rows past R or past Lq as zeros
  for (int i = tid; i < ROWS * hd; i += THREADS) {
    const int r = i / hd, d = i % hd;
    const int t = r % a.bq, g = r / a.bq;
    float x = 0.f;
    if (r < R && q_lo + t < a.Lq)
      x = q[(q_lo + t) * a.q_sl + (kvh * a.G + g) * a.q_sh + d];
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

  const int vpr = hd / 4;              // 16-byte loads per K/V row
  const int k_end = a.causal ? min(a.Lk, q_hi + 1) : a.Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    if (a.window && k0 + BK - 1 <= q_lo - a.window) continue;  // outside
    const int nvalid = min(BK, a.Lk - k0);  // keys of this tile inside Lk

    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * vpr; i += THREADS) {
      const int j = i / vpr, c = (i % vpr) * 4;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (j < nvalid) {
        kf = *reinterpret_cast<const float4*>(kp + (k0 + j) * a.k_sl + c);
        vf = *reinterpret_cast<const float4*>(vp + (k0 + j) * a.v_sl + c);
      }
      float* dk = sK + j * hs + c;
      float* dv = sV + j * hs + c;
      dk[0] = kf.x; dk[1] = kf.y; dk[2] = kf.z; dk[3] = kf.w;
      dv[0] = vf.x; dv[1] = vf.y; dv[2] = vf.z; dv[3] = vf.w;
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
      mt = fmaxf(mt, __shfl_xor_sync(attn::FULL, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(attn::FULL, mt, 2));
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
      ls += __shfl_xor_sync(attn::FULL, ls, 1);
      ls += __shfl_xor_sync(attn::FULL, ls, 2);
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
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ry * TR + i;
    const int t = r % a.bq, g = r / a.bq;
    if (r >= R || q_lo + t >= a.Lq) continue;
    const float lr = sRow[r];
    float* o = out + ((static_cast<long long>(b) * a.Lq + q_lo + t) * a.Hq +
                      kvh * a.G + g) * hd;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lx + LANES * c;
      if (d < hd) o[d] = acc[i][c] / lr;
    }
  }
}

template <int ND>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int bytes = smem_floats(a.hd) * static_cast<int>(sizeof(float));
  static bool opted = false;           // once per template, per process
  if (!opted) {
    // the most a call of this template needs: hd <= ND * LANES
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(ND * LANES) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid((a.Lq + a.bq - 1) / a.bq, a.B * a.Hkv);
  flash_f32_kernel<ND><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Lq, Hq, hd), k and v (B, Lk,
// Hkv, hd): strides in elements, the last dimension contiguous; q, K and
// V rows must start on 16-byte boundaries (the wrapper checks). hd a multiple of
// 8 in [8, 256]; hd_tile one of 32, 64, 128, 160, 256 and >= hd (the
// wrapper's plan); G = Hq / Hkv in [1, 64]. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int Hq, int Hkv, int hd, int hd_tile, long long q_sb,
    long long q_sl, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > ROWS || hd < 8 || hd > hd_tile || hd % 8 != 0 ||
      window < 0)
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
  if (dtype == 1) {
    switch (hd_tile) {
      case 32: return launch_mma<32, 64, true>(a, st);
      case 64: return launch_mma<64, 64, true>(a, st);
      case 128: return launch_mma<128, 64, true>(a, st);
      case 160: return launch_mma<160, 64, true>(a, st);
      case 256: return launch_mma<256, 32, false>(a, st);
    }
  } else if (dtype == 0) {
    switch (hd_tile) {
      case 32: return launch_f32<2>(a, st);
      case 64: return launch_f32<4>(a, st);
      case 128: return launch_f32<8>(a, st);
      case 160: return launch_f32<10>(a, st);
      case 256: return launch_f32<16>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
