// Decode attention over a contiguous KV ring or a paged KV pool,
// hand-written for Hopper.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_pallas (body _decode_kernel), the Pallas TPU kernel
//   behind every cached decode step and every chunked-prefill extend, and
//   paged_decode_attention_pallas (body _paged_decode_kernel), the same
//   work over a paged cache (Engine(paged=True)).
//
// What it computes (decode_attention_reference): T query rows of each
// sequence attend, with an online softmax in f32, over its cache of S
// slots. Masks: slot valid (pos >= 0), causal (pos <= q_pos) and an
// optional sliding window (pos > q_pos - window), all by position, from
// the staged pos tile and the rows' q_pos. A masked score is the finite
// NEG_INF = -1e30, never -inf, so a row whose every slot is masked
// returns the mean of V over the S slots, as the reference does; for
// that no tile is ever skipped, even when all of its slots are masked.
//
// Paged layout: K/V live in a pool (P+1, ps, Hkv, hd) whose last page is
// the trash page; logical row s of sequence b is pool page
// bt[b, s / ps] at offset s % ps. The paged kernel is the same template
// instantiated with PAGED = true: only the address of a K/V row differs,
// and the plan (route, splits, split boundaries) depends on the logical
// shape alone, so the paged kernel gives exactly the contiguous kernel's
// output on the same logical data (S = NB * ps). Any page size whose
// rows keep 16-byte alignment works, independent of the tile BK: a tile
// may span pages. Where the Pallas kernel fetches a page per grid step
// through a scalar-prefetch index map, each thread here reads the
// block-table entry of the row it copies.
//
// Layout: K/V are read in the model's cache layout (B, S, Hkv, hd)
// through strides (the last dimension contiguous), so no transposed copy
// of the cache is ever made. q is (B, T, Hq, hd) with strides, q_pos
// (B, T) int32 contiguous, pos (B, S) int32 with a row stride, and the
// output (B, T, Hq, hd) contiguous in q's type. Row r of a sequence's
// R = T * G rows is query token r / G and query head kvh * G + r % G,
// the grouping of the Pallas kernel: one KV head's K/V tile serves all
// of its rows.
//
// Routes, picked by the wrapper's plan (kernels/decode_attention/
// kernel.py: plan) from the shapes and the dtype alone:
//   bf16, R > 16 (every admitted chunk; "mma_rows"): tensor cores. A
//     block holds 64 rows, 4 warps of 16; each warp runs S = Q K^T and
//     P V over the whole tile as m16n8k16 MMAs (f32 accumulators, p
//     rounded to bf16 for the P V operand, as the JAX model's plain
//     route rounds it), with the online softmax on the accumulator
//     fragments (helpers shared with flash attention, attn_mma.cuh).
//   bf16, R <= 16 (every decode step, R = G; "mma_keys"): the same
//     product code on one 16-row tile, the 4 warps taking a quarter of
//     each tile's slots each; their (m, l, acc) are combined through
//     shared memory at the end in a fixed order.
//   f32 ("simt"): products on the CUDA cores, p in f32, no split (the
//     port's first design, kept for the fp32 gates: TF32 would not hold
//     1e-4 against the plain version).
// On both bf16 routes K/V tiles of BK = 64 slots and their pos entries
// are staged in bf16 in a 2-stage ring filled by cp.async, the next
// tile in flight while the current one is consumed (the block's Q rows
// ride in the first copy group), rows padded by 16 bytes so every
// ldmatrix is free of bank conflicts. When the
// (sequence, KV head, row tile) grid alone would leave the 132 SMs
// short, the plan splits S over blocks (flash-decoding): split i covers
// slots [i * per, (i + 1) * per), per a multiple of BK, and writes its
// rows' unnormalized (m, l, acc) in f32 to scratch the wrapper
// allocates; a second kernel combines the splits in a fixed order, no
// atomics. A split whose slots are all masked carries m = NEG_INF, so a
// fully masked row still averages V over all S slots.
//
// What bounds it: at decode the K/V bytes it must read, 2*B*S*Hkv*hd*elt
// (16.8 MB at B=8, S=1024, Hkv=8, hd=64 in bf16: >= 5.0 us at 3.35
// TB/s); the split puts 256 blocks on the card so the reads are spread
// over every SM. At the chunk (B=1, T=128) the operations, 4 * T * Hq *
// S * hd against the tensor cores (the K/V tile is read once per 64
// rows, from L2 after the first row tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

using attn::NEG_INF;
using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* qpos;
  void* out;
  int B, T, Hq, Hkv, S, G, R, window;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long pos_sb;
  float scale;
  // paged only: block table (B, NB) int32 contiguous, page size, and the
  // pool's page strides (k_sb/v_sb are unused)
  const int* bt;
  int NB, ps;
  long long k_sp, v_sp;
  // split over S: splits of per slots each; with splits > 1 the partial
  // (m, l) of each row go to ws_ml (splits, B*T*Hq, 2) and acc to ws_acc
  // (splits, B*T*Hq, hd), both f32
  int splits, per;
  float* ws_acc;
  float* ws_ml;
};

// --------------------------------------------------------------------- //
// bf16: tensor cores
// --------------------------------------------------------------------- //
constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int BK = 64;            // slots a K/V tile

template <int HD, int WR>
constexpr int mma_smem_bytes() {
  return (16 * WR + 4 * BK) * (HD + 8) * 2 + 2 * BK * 4;
}

// WR: row groups of 16 in a block (4: "mma_rows", 1: "mma_keys"); the
// 4 / WR warps of a row group split each tile's slots between them
template <int HD, int WR, bool PAGED>
__global__ void __launch_bounds__(MMA_THREADS)
    decode_mma_kernel(Args a) {
  constexpr int WK = 4 / WR;          // warps sharing a row group
  constexpr int KW = BK / WK;         // slots a warp takes of each tile
  constexpr int STR = HD + 8;         // padded shared row (elements)
  constexpr int ROWSB = 16 * WR;      // rows a block
  constexpr int CPR = HD / 8;         // 16-byte chunks a row
  constexpr int NS = KW / 8;          // n-tiles of a warp's S
  constexpr int NO = HD / 8;          // n-tiles of O
  constexpr int KS = HD / 16;         // k-steps of Q K^T
  // Q's fragments stay in registers up to hd 64; at hd 128 they are
  // re-read from shared memory each tile, which keeps the 64-row tile
  // clear of spills
  constexpr bool QREG = HD <= 64;
  static_assert(BK * CPR % MMA_THREADS == 0, "tile must split evenly");
  static_assert(NS % 2 == 0, "P V takes 16-slot k-steps");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // ROWSB x STR
  bf16* sK = sQ + ROWSB * STR;               // 2 stages x BK x STR
  bf16* sV = sK + 2 * BK * STR;              // 2 stages x BK x STR
  int* sPos = reinterpret_cast<int*>(sV + 2 * BK * STR);  // 2 x BK

  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int r0 = blockIdx.y * ROWSB;
  const int split = blockIdx.z;
  const int s_lo = split * a.per;
  const int s_hi = min(a.S, s_lo + a.per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp % WR, wk = warp / WR;

  const bf16* q = static_cast<const bf16*>(a.q);
  // K/V row s of this (sequence, head): kc + row offset, 64-bit
  const bf16* kc = static_cast<const bf16*>(a.k) + kvh * a.k_sh;
  const bf16* vc = static_cast<const bf16*>(a.v) + kvh * a.v_sh;
  if constexpr (!PAGED) {
    kc += b * a.k_sb;
    vc += b * a.v_sb;
  }
  const int* btr = PAGED ? a.bt + static_cast<long long>(b) * a.NB : nullptr;
  const int* pos = a.pos + b * a.pos_sb;

  auto load = [&](int k0, int st) {
    bf16* dk = sK + st * BK * STR;
    bf16* dv = sV + st * BK * STR;
#pragma unroll
    for (int it = 0; it < BK * CPR / MMA_THREADS; ++it) {
      const int i = tid + it * MMA_THREADS;
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < s_hi;
      const int s = ok ? k0 + r : s_lo;  // a valid row when not copied
      long long ko, vo;
      if constexpr (PAGED) {
        const long long page = btr[s / a.ps];
        const long long off = s % a.ps;
        ko = page * a.k_sp + off * a.k_ss;
        vo = page * a.v_sp + off * a.v_ss;
      } else {
        ko = s * a.k_ss;
        vo = s * a.v_ss;
      }
      attn::cp_async16(dk + r * STR + c, kc + ko + c, ok);
      attn::cp_async16(dv + r * STR + c, vc + vo + c, ok);
    }
    if (tid < BK) {
      const bool ok = k0 + tid < s_hi;
      attn::cp_async4(sPos + st * BK + tid, pos + (ok ? k0 + tid : s_lo),
                      ok);
    }
  };

  // Q rides in the first copy group with tile 0: rows past R zero-filled
  for (int i = tid; i < ROWSB * CPR; i += MMA_THREADS) {
    const int r = r0 + i / CPR, c = (i % CPR) * 8;
    const bool ok = r < a.R;
    const int t = ok ? r / a.G : 0, head = kvh * a.G + (ok ? r % a.G : 0);
    attn::cp_async16(sQ + (i / CPR) * STR + c,
                     q + (ok ? b * a.q_sb + t * a.q_st + head * a.q_sh + c
                             : 0), ok);
  }
  const int ntiles = (s_hi - s_lo + BK - 1) / BK;
  load(s_lo, 0);
  attn::cp_async_commit();

  const int wrow = wr * 16;            // the warp's rows in the block
  const bool live = r0 + wrow < a.R;   // uniform across the warp
  uint32_t qf[QREG ? KS : 1][4];
  const bf16* ql = attn::q_lane<STR>(sQ + wrow * STR, lane);
  // this lane's rows g and g + 8 of the warp's 16, and their positions
  const int ra = r0 + wrow + (lane >> 2), rb = ra + 8;
  const int qpos[2] = {ra < a.R ? a.qpos[b * a.T + ra / a.G] : 0,
                       rb < a.R ? a.qpos[b * a.T + rb / a.G] : 0};
  const float sl2 = a.scale * attn::LOG2E;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    const int k0 = s_lo + j * BK;
    if (j + 1 < ntiles) load(k0 + BK, st ^ 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();          // tile j has landed (this thread's)
    __syncthreads();                   // ... and every thread's
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) attn::ldsm_x4(qf[ks], ql + ks * 16);
      }
    }
    if (live) {
      const bf16* tK = sK + (st * BK + wk * KW) * STR;
      const bf16* tV = sV + (st * BK + wk * KW) * STR;
      const int* tP = sPos + st * BK + wk * KW;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* kl = attn::k_lane<STR>(tK, lane);
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
      // mask by position, scale into the log2 domain; slots past the
      // split's end take no part at all
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = n * 8 + 2 * (lane & 3) + (e & 1);
          const int qp = qpos[e >> 1];
          const int ps = tP[kk];
          const bool ok = ps >= 0 && ps <= qp &&
                          (a.window == 0 || ps > qp - a.window);
          float x = ok ? s[n][e] * sl2 : NEG_INF;
          if (k0 + wk * KW + kk >= s_hi) x = attn::minus_inf();
          s[n][e] = x;
        }
      attn::softmax_step<NS, NO>(s, o, m, l);
      attn::pv_tile<NS, NO, STR>(o, s, tV, lane);
    }
    __syncthreads();                   // stage st is consumed
  }
  attn::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }
  if constexpr (WK > 1) {
    // the warps of a row group hand (m, l, o) to its first warp, through
    // the consumed K/V ring, lane-major so the copies are conflict-free
    constexpr int NV = 4 + 4 * NO;     // values a lane hands over
    static_assert((WK - 1) * WR * NV * 32 * 4 <= 4 * BK * STR * 2,
                  "the hand-over fits in the ring");
    float* red = reinterpret_cast<float*>(sK);
    if (wk > 0 && live) {
      float* dst = red + ((wk - 1) * WR + wr) * NV * 32 + lane;
      dst[0] = m[0];
      dst[32] = m[1];
      dst[64] = l[0];
      dst[96] = l[1];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (wk > 0 || !live) return;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int w = 1; w < WK; ++w) {
      const float* src = red + ((w - 1) * WR + wr) * NV * 32 + lane;
      mx[0] = fmaxf(mx[0], src[0]);
      mx[1] = fmaxf(mx[1], src[32]);
    }
    float f[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    l[0] *= f[0];
    l[1] *= f[1];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= f[e >> 1];
#pragma unroll
    for (int w = 1; w < WK; ++w) {
      const float* src = red + ((w - 1) * WR + wr) * NV * 32 + lane;
      f[0] = exp2f(src[0] - mx[0]);
      f[1] = exp2f(src[32] - mx[1]);
      l[0] += src[64] * f[0];
      l[1] += src[96] * f[1];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] += src[(4 + 4 * n + e) * 32] * f[e >> 1];
    }
    m[0] = mx[0];
    m[1] = mx[1];
  }
  if (!live) return;

  const long long NR = static_cast<long long>(a.B) * a.T * a.Hq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= a.R) continue;
    const int t = r / a.G, head = kvh * a.G + r % a.G;
    const long long row = (static_cast<long long>(b) * a.T + t) * a.Hq + head;
    if (a.splits == 1) {
      const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
      bf16* orow = static_cast<bf16*>(a.out) + row * HD;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    } else {
      const long long prow = split * NR + row;
      float* wa = a.ws_acc + prow * HD;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(wa + n * 8 + 2 * (lane & 3)) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if ((lane & 3) == 0) {
        a.ws_ml[2 * prow] = m[h];
        a.ws_ml[2 * prow + 1] = l[h];
      }
    }
  }
}

// out[row, d] from the splits' partials, in split order: the online
// softmax's merge of (m, l, acc) in the log2 domain, l == 0 -> 1
__global__ void decode_combine_kernel(const float* ws_acc,
                                      const float* ws_ml, bf16* out,
                                      long long NR, int hd, int splits) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= NR * hd) return;
  const long long row = i / hd;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_ml[2 * (s * NR + row)]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float f = exp2f(ws_ml[2 * (s * NR + row)] - mx);
    l += ws_ml[2 * (s * NR + row) + 1] * f;
    acc += ws_acc[s * NR * hd + i] * f;
  }
  out[i] = __float2bfloat16(acc * (1.f / (l == 0.f ? 1.f : l)));
}

template <int HD, int WR, bool PAGED>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<HD, WR>();
  static bool opted = false;           // once per template, per process
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<HD, WR, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid(a.B * a.Hkv, (a.R + 16 * WR - 1) / (16 * WR), a.splits);
  decode_mma_kernel<HD, WR, PAGED><<<grid, MMA_THREADS, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const long long NR = static_cast<long long>(a.B) * a.T * a.Hq;
  const long long n = NR * HD;
  decode_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          stream>>>(a.ws_acc, a.ws_ml,
                                    static_cast<bf16*>(a.out), NR, HD,
                                    a.splits);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- //
// f32: CUDA cores (the design of the port's first version)
// --------------------------------------------------------------------- //
// One thread block per (sequence, KV head, tile of 16 of the R rows).
// The block walks S in tiles of BK slots staged in shared memory as f32
// (rows padded by one word so the score loop is free of bank conflicts)
// and masks the ragged last tile itself. K/V tiles are read with
// 16-byte loads, and the next tile is loaded into registers while the
// current one is consumed. The 4 warps take the rows round-robin (warp
// w owns rows w, w+4, w+8, w+12 of the tile): a lane scores BK/32
// slots, the warp reduces max and sum with shuffles, and a lane
// accumulates hd/32 output dimensions.
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD, int BKS, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(Args a) {
  constexpr int NK = BKS / 32;  // slots a lane scores per tile
  constexpr int ND = HD / 32;   // output dimensions a lane accumulates
  constexpr int KSTR = HD + 1;  // padded shared-memory row stride
  constexpr int VPR = HD / 4;   // 16-byte loads per slot row
  constexpr int NV = BKS * VPR / THREADS;  // loads per thread per tile
  static_assert(BKS * VPR % THREADS == 0, "tile must split evenly");
  static_assert(BKS <= THREADS, "one thread per slot position");
  __shared__ float sK[BKS * KSTR];
  __shared__ float sV[BKS * KSTR];
  __shared__ float sQ[ROWS * HD];
  __shared__ int sPos[BKS];

  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int r0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* q = static_cast<const float*>(a.q);
  const float* kc = static_cast<const float*>(a.k) + kvh * a.k_sh;
  const float* vc = static_cast<const float*>(a.v) + kvh * a.v_sh;
  if constexpr (!PAGED) {
    kc += b * a.k_sb;
    vc += b * a.v_sb;
  }
  const int* btr = PAGED ? a.bt + static_cast<long long>(b) * a.NB : nullptr;
  const int* pos = a.pos + b * a.pos_sb;

  // sQ row i holds tile row i; warp w owns tile rows w, w + WARPS, ...
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = r0 + i / HD, d = i % HD;
    float x = 0.f;
    if (r < a.R) {
      const int t = r / a.G, head = kvh * a.G + r % a.G;
      x = q[b * a.q_sb + t * a.q_st + head * a.q_sh + d];
    }
    sQ[i] = x;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][ND];
  int qp[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = r0 + rr * WARPS + warp;
    live[rr] = r < a.R;
    qp[rr] = live[rr] ? a.qpos[b * a.T + r / a.G] : 0;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[rr][i] = 0.f;
  }

  // the next tile waits in registers while the current one is consumed
  float4 kreg[NV], vreg[NV];
  int preg = -1;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * THREADS;
      const int s = k0 + i / VPR, c = (i % VPR) * 4;
      kreg[j] = vreg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < a.S) {
        long long ko, vo;
        if constexpr (PAGED) {
          const long long page = btr[s / a.ps];
          const long long off = s % a.ps;
          ko = page * a.k_sp + off * a.k_ss;
          vo = page * a.v_sp + off * a.v_ss;
        } else {
          ko = s * a.k_ss;
          vo = s * a.v_ss;
        }
        kreg[j] = *reinterpret_cast<const float4*>(kc + ko + c);
        vreg[j] = *reinterpret_cast<const float4*>(vc + vo + c);
      }
    }
    preg = tid < BKS && k0 + tid < a.S ? pos[k0 + tid] : -1;
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * THREADS;
      const int kk = i / VPR, c = (i % VPR) * 4;
      float* dk = sK + kk * KSTR + c;
      float* dv = sV + kk * KSTR + c;
      dk[0] = kreg[j].x; dk[1] = kreg[j].y; dk[2] = kreg[j].z;
      dk[3] = kreg[j].w;
      dv[0] = vreg[j].x; dv[1] = vreg[j].y; dv[2] = vreg[j].z;
      dv[3] = vreg[j].w;
    }
    if (tid < BKS) sPos[tid] = preg;
  };

  load(0);
  for (int k0 = 0; k0 < a.S; k0 += BKS) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    stash();
    __syncthreads();
    if (k0 + BKS < a.S) load(k0 + BKS);
    const int nvalid = min(BKS, a.S - k0);  // slots of this tile inside S

#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      if (!live[rr]) continue;  // uniform across the warp
      const float* qr = sQ + (rr * WARPS + warp) * HD;
      float s[NK], p[NK];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int kk = j * 32 + lane;
        const float* kr = sK + kk * KSTR;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // 4 independent chains
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          d0 += qr[d] * kr[d];
          d1 += qr[d + 1] * kr[d + 1];
          d2 += qr[d + 2] * kr[d + 2];
          d3 += qr[d + 3] * kr[d + 3];
        }
        const float dot = (d0 + d1) + (d2 + d3);
        const int ps = sPos[kk];
        const bool ok = kk < nvalid && ps >= 0 && ps <= qp[rr] &&
                        (a.window == 0 || ps > qp[rr] - a.window);
        s[j] = ok ? dot * a.scale : NEG_INF;
        if (kk < nvalid) mt = fmaxf(mt, s[j]);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m[rr], mt);
      const float alpha = expf(m[rr] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        // slots past S (the ragged tail) take no part at all
        p[j] = j * 32 + lane < nvalid ? expf(s[j] - m_new) : 0.f;
        ls += p[j];
      }
      l[rr] = l[rr] * alpha + warp_sum(ls);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[rr][i] *= alpha;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        for (int src = 0; src < 32; ++src) {
          const int kk = j * 32 + src;
          if (kk >= nvalid) break;  // uniform across the warp
          const float pk = __shfl_sync(FULL, p[j], src);
#pragma unroll
          for (int i = 0; i < ND; ++i)
            acc[rr][i] += pk * sV[kk * KSTR + lane + 32 * i];
        }
      }
      m[rr] = m_new;
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    if (!live[rr]) continue;
    const int r = r0 + rr * WARPS + warp;
    const int t = r / a.G, head = kvh * a.G + r % a.G;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    float* o = out + ((static_cast<long long>(b) * a.T + t) * a.Hq + head) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[lane + 32 * i] = acc[rr][i] * inv;
  }
}

template <int HD, bool PAGED>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int BKS = HD <= 64 ? 64 : 32;  // keeps shared memory < 48 KB
  const dim3 grid(a.B * a.Hkv, (a.R + ROWS - 1) / ROWS);
  decode_f32_kernel<HD, BKS, PAGED><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 = f32 CUDA cores, 1 = bf16 "mma_rows", 2 = bf16 "mma_keys"
template <bool PAGED>
int launch_route(const Args& a, int hd, int route, cudaStream_t st) {
  switch (route * 1000 + hd) {
    case 32: return launch_f32<32, PAGED>(a, st);
    case 64: return launch_f32<64, PAGED>(a, st);
    case 128: return launch_f32<128, PAGED>(a, st);
    case 1032: return launch_mma<32, 4, PAGED>(a, st);
    case 1064: return launch_mma<64, 4, PAGED>(a, st);
    case 1128: return launch_mma<128, 4, PAGED>(a, st);
    case 2032: return launch_mma<32, 1, PAGED>(a, st);
    case 2064: return launch_mma<64, 1, PAGED>(a, st);
    case 2128: return launch_mma<128, 1, PAGED>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The checks and the argument block both entry points share; returns
// false on an input the launch does not take
bool fill(Args& a, int B, int T, int Hq, int Hkv, int S, int hd,
          int window, int dtype, int route, int splits, int per,
          float* ws_acc, float* ws_ml) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      window < 0 || splits < 1 || per < 1 || (dtype == 0) != (route == 0) ||
      (dtype != 0 && dtype != 1) || (route == 2 && T * (Hq / Hkv) > 16) ||
      (splits > 1 && (route == 0 || per % BK != 0 || !ws_acc || !ws_ml ||
                      static_cast<long long>(per) * (splits - 1) >= S)) ||
      static_cast<long long>(per) * splits < S)
    return false;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.G = Hq / Hkv;
  a.R = T * a.G;
  a.window = window;
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  a.splits = splits;
  a.per = per;
  a.ws_acc = ws_acc;
  a.ws_ml = ws_ml;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route, splits and per (slots a
// split, a multiple of 64 when splits > 1) from the wrapper's plan;
// ws_acc (splits, B*T*Hq, hd) and ws_ml (splits, B*T*Hq, 2) f32 scratch
// when splits > 1, else null. Strides are in elements; q, K and V rows
// must start on 16-byte boundaries (the wrapper checks). Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* qpos, void* out, void* ws_acc, void* ws_ml, int B, int T,
    int Hq, int Hkv, int S, int hd, int route, int splits, int per,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long pos_sb, int window, int dtype, void* stream) {
  Args a;
  if (!fill(a, B, T, Hq, Hkv, S, hd, window, dtype, route, splits, per,
            static_cast<float*>(ws_acc), static_cast<float*>(ws_ml)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.qpos = static_cast<const int*>(qpos);
  a.out = out;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.pos_sb = pos_sb;
  a.bt = nullptr;
  a.NB = a.ps = 0;
  a.k_sp = a.v_sp = 0;
  return launch_route<false>(a, hd, route,
                             static_cast<cudaStream_t>(stream));
}

// The paged entry point. kp, vp: pools (P+1, ps, Hkv, hd) with strides
// k_sp/v_sp (page), k_ss/v_ss (row in page), k_sh/v_sh (head); bt: (B,
// NB) int32 contiguous, every entry in [0, P]; pos: (B, NB*ps) int32
// with row stride pos_sb. Other arguments as above, with S = NB * ps.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, const void* bt,
    const void* pos, const void* qpos, void* out, void* ws_acc,
    void* ws_ml, int B, int T, int Hq, int Hkv, int NB, int ps, int hd,
    int route, int splits, int per, long long q_sb, long long q_st,
    long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long pos_sb,
    int window, int dtype, void* stream) {
  Args a;
  if (NB <= 0 || ps <= 0 ||
      !fill(a, B, T, Hq, Hkv, NB * ps, hd, window, dtype, route, splits,
            per, static_cast<float*>(ws_acc), static_cast<float*>(ws_ml)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k = kp;
  a.v = vp;
  a.pos = static_cast<const int*>(pos);
  a.qpos = static_cast<const int*>(qpos);
  a.out = out;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.k_sb = 0;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = 0;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.pos_sb = pos_sb;
  a.bt = static_cast<const int*>(bt);
  a.NB = NB;
  a.ps = ps;
  a.k_sp = k_sp;
  a.v_sp = v_sp;
  return launch_route<true>(a, hd, route, static_cast<cudaStream_t>(stream));
}
