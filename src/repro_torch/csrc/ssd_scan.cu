// The Mamba-2 SSD scan, hand-written for Hopper: the sequential
// recurrence from an explicit state (ssd_extend) and the chunked dual
// form from a given or zero state (ssd).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py,
//   ssd_extend_pallas (body _ssd_extend_kernel), the Pallas TPU kernel
//   behind every cached forward of an SSM stack (each decode step and
//   each chunk of a chunked admission), and
//   ssd_pallas (body _ssd_kernel), the kernel behind the cache-free
//   forward (Model.prefill, forward_train).
//
// Shapes (the JAX package's): x (b, l, h, p), dt (b, l, h) f32, A (h,)
// f32 < 0, B/C (b, l, g, n), D (h,) f32; head h reads group h / (h/g).
// States are (b, h, p, n) f32. Every input is read through its strides
// (batch, time, head or group; the last dimension contiguous), so the
// x/B/C slices of the model's conv output are never copied.
//
// ssd_extend: s' = exp(dt*A)*s + (dt*x) B^T, y = C s'^T + D*x, token by
// token. The state rows of a batch row are numbered through the heads
// (row h*p + r); a block owns `rows` consecutive ones (an even number up
// to 32, never across a group) and holds them in registers for the whole
// token loop: a warp owns 2 rows of one head, a lane n/32 columns (lane,
// lane + 32, ...), so at n 128 a thread keeps 8 floats. The only serial
// work per state element and token is one multiply and one FMA; the
// design takes the rest off that chain and spreads it over the card:
// - Deferred readout. Tokens go in tiles of TT (16 on the chunk route, 1
//   on the decode route). Within a tile the state advances through every
//   token, each lane keeping its partial of C s'^T over its columns for
//   every (token, row) item (TT x 2 of them); then the warp reduces all
//   of them at once by a transposed butterfly over the lane bits 16, 8, 4,
//   2, 1 (31 shuffles for 32 items, where one butterfly a token took 5 or
//   6), after which lane l holds item l (item = token * 2 + row) and
//   writes its y. The tile's token loop is unrolled (a full tile has no
//   mask), so token t + 1's update issues while token t's readout runs.
// - Prefetched staging. A tile's B and C (block-wide) and each warp's x
//   and dt slices go to shared memory by cp.async, B and C 16 bytes a
//   copy where the pointers and strides allow (4 otherwise), into a ring
//   of 3 buffers filled two tiles ahead (60 KB at n 128: dynamic shared
//   memory), so T 128 waits on one round trip, the first, which overlaps
//   the state's load. A warp turns its x and dt into x*dt and exp(dt*A)
//   once a tile.
// - The card filled at batch 1. The plan (kernels/ssd_scan/kernel.py::
//   extend_plan) takes the fewest rows a block that keep the grid within
//   one block per SM: at mamba2's b 1, 24 rows (12 warps, 3 on each of an
//   SM's 4 schedulers) in 128 blocks, where one block per (head, 32 rows)
//   gave 96 blocks of 8 warps; where 32 rows a block cannot (decode at b
//   8: 768 blocks) it takes 32.
// The state is read once and written once (in place when the caller
// passes the same buffer: every thread reads the elements it later
// writes, before it writes any), and the incoming state goes to the
// checkpoint buffer on the way (the cache's ssm_ckpt leaf), so the
// engine pays no separate copy.
// Exactness: both routes run one arithmetic per token: the same column
// to lane map, the same sequential FMA chain over a lane's columns, the
// same tree over the lane bits 16, 8, 4, 2, 1 (IEEE addition commutes,
// so which lane ends up holding an item does not change its bits), and
// explicit _rn intrinsics, so no contraction choice of the compiler can
// differ between two call sites. So a token's bits depend neither on T,
// nor on where its tile starts, nor on the route: extending by t1 then
// t2 tokens gives the bits of extending by t1 + t2, and the T = 1 launch
// is the single decode step. A token with dt = 0 is an identity step:
// expf(-0.0f) is exactly 1 without --use_fast_math (this file is built
// without it) and the update adds a signed zero.
// What bounds it: at decode (T = 1, b = 8) the bytes of the state, read
// once and written twice (state and checkpoint): 37.7 MB at h 48, p 64,
// n 128, 11 us at 3.35 TB/s. At a chunk (b = 1, T = 128) the bound counts
// 0.25 GFLOP at 67 TFLOP/s (3.8 us), but the kernel issues about 55
// instructions a warp per token (24 for the update and the readout's
// FMAs, 9 shared-memory loads, 10 for its share of the butterfly, the
// rest for a tile's copies and x*dt and decay): instruction issue binds
// it, the readout's reduction and the staging costing as much as the
// arithmetic.
//
// ssd (chunked): the dual form, its two routes and what bounds them are
// described at the head of its section below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "ssd_common.cuh"

namespace {

using ssd::FULL;

// --------------------------------------------------------------------- //
// ssd_extend
// --------------------------------------------------------------------- //
constexpr int EXT_RPW = 2;         // state rows a warp
constexpr int EXT_MAX_WARPS = 16;  // 32 rows a block at most
constexpr int EXT_TILE = 16;       // tokens a tile on the chunk route
constexpr int EXT_STAGES = 3;      // the staging ring: tiles k .. k + 2

struct ExtArgs {
  const float* s_in;
  float* s_out;
  float* ckpt;  // may be null
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* D;
  float* y;
  int T, H, G, P, rows;
  bool vec_bc;  // B and C go 16 bytes a copy
  long long s_in_sb, s_out_sb, ckpt_sb;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

// A tile's staged inputs (a ring of EXT_STAGES) and the per-warp
// products made from them once a tile: x*dt for each (token, row) item
// and exp(dt*A) for each token. 60 KB at TT 16, n 128: dynamic shared
// memory.
template <int TT, int N>
struct __align__(16) ExtSmem {
  float b[EXT_STAGES][TT][N];
  float c[EXT_STAGES][TT][N];
  float x[EXT_STAGES][EXT_MAX_WARPS][TT][EXT_RPW];
  float dt[EXT_STAGES][EXT_MAX_WARPS][TT];
  float xdt[EXT_MAX_WARPS][TT][EXT_RPW];
  float da[EXT_MAX_WARPS][TT];
};

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// One level of warp_item_sums at lane bit M: with HALF > 0 the lane swaps
// HALF items with its partner and keeps the half its bit selects, else a
// plain butterfly step on its one item. Every level is a template, so
// every index into v[] is a constant and v[] stays in registers.
template <int K, int HALF, int M>
__device__ __forceinline__ void item_level(float (&v)[K], int lane) {
  if constexpr (M >= 1) {
    if constexpr (HALF >= 1) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const float send = up ? v[k] : v[k + HALF];
        const float keep = up ? v[k + HALF] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, M));
      }
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], M));
    }
    item_level<K, HALF / 2, M / 2>(v, lane);
  }
}

// The sums over the warp of K items, each lane holding one partial of
// every item in v[]: a transposed butterfly halves the items a lane holds
// at each lane bit 16, 8, ... (the lane with the bit set keeps the upper
// half and adds its partner's), and a plain butterfly finishes the bits
// left once a lane holds one item. Every item is summed by the same tree
// over the lane bits 16, 8, 4, 2, 1 whatever K is; lane l ends up with
// item l >> (5 - log2 K), in 32 / K lanes alike.
template <int K>
__device__ __forceinline__ float warp_item_sums(float (&v)[K], int lane) {
  item_level<K, K / 2, 16>(v, lane);
  return v[0];
}

// The first nt tokens of a tile (nt = TT: no mask): the state advances
// token by token; part[token * EXT_RPW + row] receives the lane's partial
// of that token's readout of that row (0 for a masked token).
template <int NPL, int TT>
__device__ __forceinline__ void ext_tokens(float (&s)[EXT_RPW][NPL],
                                           float (&part)[TT * EXT_RPW],
                                           const float* bs, const float* cs,
                                           const float* xdt, const float* da,
                                           int lane, int nt) {
  constexpr int N = 32 * NPL;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    if (tt < nt) {
      const float dA = da[tt];
      static_assert(EXT_RPW == 2, "a token's x*dt is read as a float2");
      const float2 xd = *reinterpret_cast<const float2*>(xdt + tt * 2);
      const float xv[EXT_RPW] = {xd.x, xd.y};
      float bv[NPL], cv[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        bv[j] = bs[tt * N + lane + 32 * j];
        cv[j] = cs[tt * N + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < EXT_RPW; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          s[i][j] = __fmaf_rn(xv[i], bv[j], __fmul_rn(s[i][j], dA));
          acc = __fmaf_rn(s[i][j], cv[j], acc);
        }
        part[tt * EXT_RPW + i] = acc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < EXT_RPW; ++i) part[tt * EXT_RPW + i] = 0.f;
    }
  }
}

// A block owns a.rows consecutive state rows (numbered h * P + r) of
// batch row blockIdx.y, starting at blockIdx.x * a.rows; NPL columns a
// lane (n = 32 * NPL), TT tokens a tile. One block an SM is all the
// plan asks for, so ptxas may use 128 registers a thread at 512 threads.
template <int NPL, int TT>
__global__ void __launch_bounds__(EXT_MAX_WARPS * 32, 1)
    ssd_extend_kernel(const ExtArgs a) {
  constexpr int N = 32 * NPL;
  constexpr int K = TT * EXT_RPW;  // (token, row) items of a warp's tile
  constexpr int SHIFT = 5 - log2i(K);
  static_assert(K <= 32 && (K & (K - 1)) == 0, "a tile's items fit a warp");
  extern __shared__ __align__(16) unsigned char ext_smem[];
  ExtSmem<TT, N>& sm = *reinterpret_cast<ExtSmem<TT, N>*>(ext_smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const int fr0 = blockIdx.x * a.rows;
  const int fr = fr0 + EXT_RPW * warp;  // the warp's first row
  const int h = fr / a.P, r = fr % a.P;
  const int g = fr0 / a.P / (a.H / a.G);
  const float Ah = a.A[h], Dh = a.D[h];
  const int ntiles = (a.T + TT - 1) / TT;
  const float* Bb = a.B + b * a.b_sb + (long long)g * a.b_sg;
  const float* Cb = a.C + b * a.c_sb + (long long)g * a.c_sg;
  const float* xw = a.x + b * a.x_sb + (long long)h * a.x_sh + r;
  const float* dtw = a.dt + b * a.dt_sb + h;

  // tile k's copies into buffer k % EXT_STAGES (only its tokens before
  // T: a masked token's slots are never read into the state or y); one
  // commit group a tile, an empty one past the last
  auto stage = [&](int k) {
    if (k < ntiles) {
      const int buf = k % EXT_STAGES, t0 = k * TT;
      const int nt = min(TT, a.T - t0);
      const float* Bt = Bb + t0 * a.b_st;
      const float* Ct = Cb + t0 * a.c_st;
      if (a.vec_bc) {
        for (int i = threadIdx.x; i < nt * (N / 4); i += blockDim.x) {
          const int tt = i / (N / 4), c = 4 * (i % (N / 4));
          attn::cp_async16(&sm.b[buf][tt][c], Bt + tt * a.b_st + c, true);
          attn::cp_async16(&sm.c[buf][tt][c], Ct + tt * a.c_st + c, true);
        }
      } else {
        for (int i = threadIdx.x; i < nt * N; i += blockDim.x) {
          const int tt = i / N, c = i % N;
          attn::cp_async4(&sm.b[buf][tt][c], Bt + tt * a.b_st + c, true);
          attn::cp_async4(&sm.c[buf][tt][c], Ct + tt * a.c_st + c, true);
        }
      }
      if (lane < nt * EXT_RPW) {
        const int tt = lane / EXT_RPW, i = lane % EXT_RPW;
        attn::cp_async4(&sm.x[buf][warp][tt][i],
                        xw + (t0 + tt) * a.x_st + i, true);
      }
      if (lane < nt)
        attn::cp_async4(&sm.dt[buf][warp][lane], dtw + (t0 + lane) * a.dt_st,
                        true);
    }
    attn::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < EXT_STAGES - 1; ++k) stage(k);

  // the state, while the first tiles are in flight; the incoming state
  // to the checkpoint
  float s[EXT_RPW][NPL];
  const long long so = (long long)fr * N + lane;
  const float* sp = a.s_in + b * a.s_in_sb + so;
#pragma unroll
  for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
    for (int j = 0; j < NPL; ++j) s[i][j] = sp[i * N + 32 * j];
  if (a.ckpt != nullptr) {
    float* cp = a.ckpt + b * a.ckpt_sb + so;
#pragma unroll
    for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
      for (int j = 0; j < NPL; ++j) cp[i * N + 32 * j] = s[i][j];
  }

  const long long ystep = (long long)a.H * a.P;
  float* yw = a.y + b * a.T * ystep + fr;
  for (int k = 0; k < ntiles; ++k) {
    attn::cp_async_wait<EXT_STAGES - 2>();  // this thread's copies of k
    __syncthreads();  // everyone's copies of k; tile k - 1 is consumed
    stage(k + EXT_STAGES - 1);
    const int buf = k % EXT_STAGES, t0 = k * TT;
    const int nt = min(TT, a.T - t0);
    if (lane < K) {
      const int tt = lane / EXT_RPW, i = lane % EXT_RPW;
      sm.xdt[warp][tt][i] =
          __fmul_rn(sm.x[buf][warp][tt][i], sm.dt[buf][warp][tt]);
    }
    if (lane < TT)
      sm.da[warp][lane] = expf(__fmul_rn(sm.dt[buf][warp][lane], Ah));
    __syncwarp();
    float part[K];
    const float* bs = &sm.b[buf][0][0];
    const float* cs = &sm.c[buf][0][0];
    if (nt == TT)
      ext_tokens<NPL, TT>(s, part, bs, cs, &sm.xdt[warp][0][0],
                          sm.da[warp], lane, TT);
    else
      ext_tokens<NPL, TT>(s, part, bs, cs, &sm.xdt[warp][0][0],
                          sm.da[warp], lane, nt);
    const float tot = warp_item_sums<K>(part, lane);
    const int item = lane >> SHIFT, tt = item / EXT_RPW, i = item % EXT_RPW;
    if ((lane & ((1 << SHIFT) - 1)) == 0 && tt < nt)
      yw[(t0 + tt) * ystep + i] =
          __fmaf_rn(Dh, sm.x[buf][warp][tt][i], tot);
  }

  float* op = a.s_out + b * a.s_out_sb + so;
#pragma unroll
  for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
    for (int j = 0; j < NPL; ++j) op[i * N + 32 * j] = s[i][j];
}

template <int NPL, int TT>
int launch_extend(const ExtArgs& a, dim3 grid, int threads,
                  cudaStream_t stream) {
  const int bytes = (int)sizeof(ExtSmem<TT, 32 * NPL>);
  auto kern = ssd_extend_kernel<NPL, TT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<grid, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------- //
// ssd (chunked dual form)
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_pallas (body
// _ssd_kernel), whose grid walks the chunks of a (batch row, head) in
// order, the carried state in VMEM scratch. On Hopper nothing carries
// from one block to the next, so the chunk axis is split into the plain
// version's three steps (kernels/ssd_scan/ref.py). Two routes, picked by
// kernels/ssd_scan/kernel.py::chunk_plan from the dtype and the chunk.
//
// mma (bf16 x, B, C; a chunk that is a multiple of 16). The work runs in
// sub-chunks of Q tokens, the plan's pick among the divisors of the
// caller's chunk up to 128 (in exact arithmetic the dual form's result
// does not depend on the chunk length), in three launches:
//  (a) ssd_chunk_states_kernel, one block per (sub-chunk, head, batch
//      row): the sub-chunk's own end state S_c = sum_k exp(cum_end -
//      cum_k) dt_k x_k^T B_k (p x n) into the workspace, and its decay
//      exp(cum_end) (cum: the inclusive sum of dt A within the sub-chunk);
//  (b) ssd_state_pass_kernel, a thread per 4 state elements of a (batch
//      row, head): S_in[c + 1] = exp(cum_end,c) S_in[c] + S_c in the order
//      of c, from the initial state or zero, each S_in[c] written as the
//      split pair (c) reads, the last state to the final state;
//  (c) ssd_chunk_out_kernel, one block per 64 query rows (at most) of a
//      (sub-chunk, head, batch row), a warp per 16 rows i: y_i = D x_i +
//      sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i)
//      C_i S_in^T.
// (b) and (c) are launched as programmatic dependents: (b) waits for
// (a) to end before it reads a chunk state, and (c) runs its first part,
// which needs no state, while (b) runs, waiting for (b) only before it
// loads S_in. No atomics and fixed orders throughout: two calls give the
// same bits.
// The four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate, attn_mma.cuh's ldmatrix fragment loads). C B^T takes
// the bf16 inputs as they are: its products are exact in f32. The other
// three have one f32 operand: x w in (a) (w_k = exp(cum_end - cum_k)
// dt_k), the weights W in (c) and the carried state S_in in (c). Each
// enters as a split pair of bf16, hi = bf16(v) and lo = bf16(v - hi)
// (v - hi is exact in f32), against a partner that is exactly bf16 (B,
// x and C), so two products replace one: the pair keeps 16 significant
// bits, |v - hi - lo| <= 2^-16 |v|, each product lands within 1.6e-5 of
// its f32 value before the f32 sums, under the 1e-4 gate against the
// plain version, which one bf16 rounding (2^-8) would miss. A warp skips
// the key blocks above its diagonal; only the diagonal block masks (j >
// i weighs 0, and no exp of a positive number is used).
// What bounds it: bytes. At b 1, l 1024, h 48, p 64, n 128 the inputs
// and outputs are 21.2 MB, 6.3 us at 3.35 TB/s, where the unmasked
// pairs' 4.06 GFLOP take 4.1 us at 989 TFLOP/s. The split adds the
// workspace, 4 b h (l / Q) p n bytes written by (a), read and written by
// (b) and read by (c) (12.6 MB at Q 128), the re-reads of B and C by
// every head of a group (from L2) and three launches; a block's loads,
// products and stores run one after another, so the card's time goes to
// latency, with 12 warps an SM. (a) and (c) stage their tiles in shared
// memory by cp.async, 16 bytes a copy where the pointers and strides
// allow (2-byte loads otherwise); (c) holds C and, in turn, B and x,
// then the split state (70 KB at Q 128: 3 blocks an SM). At mamba2's
// b 1, l 1024 the grids are 384 and 768 blocks, where one block per
// (head, batch row) gave 48.
//
// simt (f32 inputs, or a chunk that is no multiple of 16):
// ssd_chunk_kernel, one block per (batch row, head) walks the chunks in
// order with the carried (p, n) state in shared memory (32 KB at p 64,
// n 128). Within a chunk: dA = dt*A and its inclusive cumulative sum
// (warp scans); then per tile of 64 query rows i, for each tile of 64 key
// rows j <= i: scores C_i . B_j, weighted by exp(cum_i - cum_j)*dt_j
// where j <= i (0 above the diagonal), times x_j; plus exp(cum_i) * C_i .
// state and D*x_i. Then the state advances: exp(cum_end)*state + sum_j
// exp(cum_end - cum_j)*dt_j x_j B_j^T. Tiles live in shared memory as f32
// with rows padded by one word; a thread computes a 4 x 4 block of scores
// strided by 16 rows and columns; f32 FMAs on CUDA cores. It is bound by
// its operations (0.0606 ms at 67 TFLOP/s at the shape above) and fills
// only h x b SMs.
// --------------------------------------------------------------------- //
constexpr int SSD_THREADS = 256;
constexpr int TILE = 64;
constexpr int MAX_CHUNK = 256;

struct ChunkArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* s0;  // may be null: zero initial state
  float* y;
  float* s_final;
  int L, Q, H, G;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

template <int P, int N>
constexpr size_t chunk_smem_floats() {
  return (size_t)P * (N + 1)           // carried state
         + 2 * (size_t)TILE * (N + 1)  // C query tile, B key tile
         + (size_t)TILE * (P + 1)      // x key tile
         + (size_t)TILE * (TILE + 1)   // weights
         + 2 * MAX_CHUNK               // dt, cumulative dA
         + TILE + 32;                  // state-update decay, warp totals
}

// stage rows [r0, r0 + nr) of a (time, last) slice into a padded f32 tile
template <typename Tin, int W>
__device__ __forceinline__ void stage(float* dst, const Tin* src,
                                      long long st, int r0, int nr) {
  ssd::stage_tile<Tin, W, TILE, SSD_THREADS>(dst, src, st, r0, nr);
}

template <typename Tin, int P, int N>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_chunk_kernel(const ChunkArgs a) {
  constexpr int PC = P / 16;  // output columns a thread owns (stride 16)
  constexpr int SR = P / 8;   // state rows a thread owns (stride 8)
  constexpr int NC = N / 32;  // state columns a thread owns (stride 32)
  extern __shared__ float smem[];
  float* st = smem;                       // [P][N + 1]
  float* cq = st + P * (N + 1);           // [TILE][N + 1]
  float* bk = cq + TILE * (N + 1);        // [TILE][N + 1]
  float* xk = bk + TILE * (N + 1);        // [TILE][P + 1]
  float* w = xk + TILE * (P + 1);         // [TILE][TILE + 1]
  float* dtv = w + TILE * (TILE + 1);     // [MAX_CHUNK]
  float* cum = dtv + MAX_CHUNK;           // [MAX_CHUNK]
  float* dec = cum + MAX_CHUNK;           // [TILE]
  float* tot = dec + TILE;                // [32]

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = tid >> 4, tj = tid & 15;
  const int g = h / (a.H / a.G);
  const int Q = a.Q;
  const float Ah = a.A[h], Dh = a.D[h];
  const Tin* xb = (const Tin*)a.x + b * a.x_sb + (long long)h * a.x_sh;
  const Tin* Bb = (const Tin*)a.B + b * a.b_sb + (long long)g * a.b_sg;
  const Tin* Cb = (const Tin*)a.C + b * a.c_sb + (long long)g * a.c_sg;
  const float* dtb = a.dt + b * a.dt_sb + h;
  const long long hoff = (long long)h * P * N;

  for (int idx = tid; idx < P * N; idx += SSD_THREADS) {
    const int r = idx / N, c = idx % N;
    st[r * (N + 1) + c] =
        a.s0 != nullptr ? a.s0[b * (long long)a.H * P * N + hoff + idx] : 0.f;
  }

  for (int c0 = 0; c0 < a.L; c0 += Q) {
    // dt and the inclusive cumulative sum of dt*A over the chunk
    __syncthreads();
    for (int k = tid; k < Q; k += SSD_THREADS)
      dtv[k] = dtb[(long long)(c0 + k) * a.dt_st];
    __syncthreads();
    {
      const int k = tid;  // Q <= MAX_CHUNK == SSD_THREADS
      float v = k < Q ? dtv[k] * Ah : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) tot[warp] = v;
      __syncthreads();
      float base = 0.f;
      for (int w2 = 0; w2 < warp; ++w2) base += tot[w2];
      if (k < Q) cum[k] = base + v;
    }
    __syncthreads();

    // outputs, one tile of query rows at a time
    for (int q0 = 0; q0 < Q; q0 += TILE) {
      const int nq = min(TILE, Q - q0);
      stage<Tin, N>(cq, Cb, a.c_st, c0 + q0, nq);
      float acc[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[i][c] = 0.f;
      for (int k0 = 0; k0 <= q0; k0 += TILE) {
        const int nk = min(TILE, Q - k0);
        stage<Tin, N>(bk, Bb, a.b_st, c0 + k0, nk);
        stage<Tin, P>(xk, xb, a.x_st, c0 + k0, nk);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cq[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bk[(tj + 16 * j) * (N + 1) + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qi = q0 + ti + 16 * i, kj = k0 + tj + 16 * j;
            float wv = 0.f;
            if (kj <= qi && qi < Q && kj < Q)
              wv = sc[i][j] * expf(cum[qi] - cum[kj]) * dtv[kj];
            w[(ti + 16 * i) * (TILE + 1) + tj + 16 * j] = wv;
          }
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
          float wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = w[(ti + 16 * i) * (TILE + 1) + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const float xv = xk[j * (P + 1) + tj + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], xv, acc[i][c]);
          }
        }
        if (k0 < q0) __syncthreads();  // the last key tile stays: x_i
      }
      // the carried state's contribution, D*x, and the store
      float off[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) off[i][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cq[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float sv = st[(tj + 16 * c) * (N + 1) + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) off[i][c] = fmaf(cv[i], sv, off[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ti + 16 * i;
        if (r >= nq) continue;
        const float e = expf(cum[q0 + r]);
        float* yr = a.y + ((b * a.L + c0 + q0 + r) * a.H + h) * P;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int col = tj + 16 * c;
          const float xv = xk[r * (P + 1) + col];
          yr[col] = fmaf(Dh, xv, fmaf(off[i][c], e, acc[i][c]));
        }
      }
      __syncthreads();  // cq, bk, xk are restaged next
    }

    // state update over the chunk's key tiles
    const float cend = cum[Q - 1];
    float sacc[SR][NC];
    const float ed = expf(cend);
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        sacc[i][c] = st[(warp + 8 * i) * (N + 1) + lane + 32 * c] * ed;
    for (int k0 = 0; k0 < Q; k0 += TILE) {
      const int nk = min(TILE, Q - k0);
      stage<Tin, N>(bk, Bb, a.b_st, c0 + k0, nk);
      stage<Tin, P>(xk, xb, a.x_st, c0 + k0, nk);
      if (tid < TILE)
        dec[tid] = tid < nk ? expf(cend - cum[k0 + tid]) * dtv[k0 + tid] : 0.f;
      __syncthreads();
      for (int j = 0; j < nk; ++j) {
        const float dj = dec[j];
        float bv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) bv[c] = bk[j * (N + 1) + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const float xv = xk[j * (P + 1) + warp + 8 * i] * dj;
#pragma unroll
          for (int c = 0; c < NC; ++c) sacc[i][c] = fmaf(xv, bv[c], sacc[i][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        st[(warp + 8 * i) * (N + 1) + lane + 32 * c] = sacc[i][c];
  }
  __syncthreads();
  float* sf = a.s_final + b * (long long)a.H * P * N + hoff;
  for (int idx = tid; idx < P * N; idx += SSD_THREADS)
    sf[idx] = st[(idx / N) * (N + 1) + idx % N];
}

template <typename Tin, int P, int N>
int launch_chunk(const ChunkArgs& a, int batch, cudaStream_t stream) {
  const size_t bytes = chunk_smem_floats<P, N>() * sizeof(float);
  auto kern = ssd_chunk_kernel<Tin, P, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<dim3(a.H, batch), SSD_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch_chunk(const ChunkArgs& a, int batch, int P, int N,
                   cudaStream_t stream) {
#define SSD_CASE(PP, NN) \
  if (P == PP && N == NN) return launch_chunk<Tin, PP, NN>(a, batch, stream);
  SSD_CASE(32, 32) SSD_CASE(32, 64) SSD_CASE(32, 128)
  SSD_CASE(64, 32) SSD_CASE(64, 64) SSD_CASE(64, 128)
  SSD_CASE(128, 128)
#undef SSD_CASE
  return -1;
}


// ------------------------------ mma route ------------------------------ //
using ssd::MMA_MAX_SUB;              // the largest sub-chunk (4 a lane in
                                     // sub_cumsum, 8 warps in (c))
using ssd::launch_pdl;
using ssd::pdl_trigger;
using ssd::pdl_wait;
using ssd::split2;
using ssd::stage_rows;
using ssd::sub_cumsum;
constexpr int STATES_THREADS = 128;  // (a): 4 warps over the p x n state
                                     // (8 at p 128: a warp a 16-row
                                     // m-tile, states_threads)
constexpr int PASS_THREADS = 256;    // (b)
constexpr int OUT_ROWS = 64;         // (c): query rows a block at most
constexpr int PASS_DEPTH = 8;        // (b): chunk states in flight a thread

struct MmaArgs {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* D;
  const float* s0;  // may be null: zero initial state
  float* y;
  float* s_final;
  float* ws;              // (b, h, l / Q, p, n) f32: S_c from (a)
  float* decay;           // (b, h, l / Q) f32: exp(cum_end) of each
  __nv_bfloat16* s_in;    // (b, h, l / Q, 2, p, n): S_in[c] from (b) as
                          // its hi and lo planes
  int L, Q, H, G;
  bool vec;  // x, B and C staged 16 bytes a copy
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

// Shared memory of (a): B [Q][N + 8], x w hi and lo [Q][P + 8] (bf16; x
// is staged into the hi tile and split in place), w and cum (f32). Of
// (c): C of its query rows [min(Q, OUT_ROWS)][N + 8], then a region that
// holds B [Q][N + 8] and x [Q][P + 8] (the keys up to its last row) and
// later the split state (hi and lo [P][N + 8]), and dt and cum. Every
// row is a multiple of 16 bytes.
template <int P, int N>
__host__ __device__ constexpr int out_region(int Q) {
  return 2 * P * (N + 8) > Q * (N + P + 16) ? 2 * P * (N + 8)
                                            : Q * (N + P + 16);
}
template <int P, int N>
__host__ __device__ constexpr int states_smem_bytes(int Q) {
  return 2 * Q * (N + 8) + 4 * Q * (P + 8) + 8 * MMA_MAX_SUB;
}
template <int P, int N>
__host__ __device__ constexpr int out_smem_bytes(int Q) {
  return 2 * ((Q < OUT_ROWS ? Q : OUT_ROWS) * (N + 8) + out_region<P, N>(Q)) +
         8 * MMA_MAX_SUB;
}

// (a)'s threads: 4 warps, or one a 16-row m-tile of the state where p
// has more than 4 (p 128: 8 warps)
__host__ __device__ constexpr int states_threads(int P) {
  return P / 16 > 4 ? P / 16 * 32 : STATES_THREADS;
}

// (a) S_c (P x N) = (x w)^T B over the sub-chunk's Q tokens: x w is the A
// operand (rows: state rows, k: tokens), read transposed by ldmatrix from
// its [token][row] tile; B the B operand from its [token][column] tile.
// Warp (mt, nw) owns state rows 16 mt .. and columns nw N / WN ...
template <int P, int N>
__global__ void __launch_bounds__(states_threads(P))
    ssd_chunk_states_kernel(const MmaArgs a) {
  constexpr int SN = N + 8, SP = P + 8;
  constexpr int THREADS = states_threads(P);
  constexpr int WM = P / 16;      // m-tiles of state rows
  constexpr int WN = THREADS / 32 / WM;  // warps along the state columns
  constexpr int NT = N / 8 / WN;  // n-tiles a warp
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0,
                "the warps tile the state");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int Q = a.Q;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* xh = bs + Q * SN;
  __nv_bfloat16* xl = xh + Q * SP;
  float* wv = reinterpret_cast<float*>(xl + Q * SP);
  float* cum = wv + MMA_MAX_SUB;

  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = h / (a.H / a.G);
  const long long t0 = (long long)c * Q;
  const __nv_bfloat16* xb =
      a.x + b * a.x_sb + t0 * a.x_st + (long long)h * a.x_sh;
  const __nv_bfloat16* Bb =
      a.B + b * a.b_sb + t0 * a.b_st + (long long)g * a.b_sg;
  const float* dtb = a.dt + b * a.dt_sb + t0 * a.dt_st + h;

  pdl_trigger();  // (b) may be scheduled now; it waits for this grid
  stage_rows<N, SN>(bs, Bb, a.b_st, Q, a.vec);
  stage_rows<P, SP>(xh, xb, a.x_st, Q, a.vec);
  attn::cp_async_commit();
  for (int k = tid; k < Q; k += THREADS) wv[k] = dtb[k * a.dt_st];
  __syncthreads();
  if (warp == 0) sub_cumsum(cum, wv, a.A[h], Q, lane);
  __syncthreads();
  const float cend = cum[Q - 1];
  for (int k = tid; k < Q; k += THREADS)
    wv[k] = __fmul_rn(expf(__fsub_rn(cend, cum[k])), wv[k]);
  if (tid == 0) a.decay[(b * a.H + h) * nc + c] = expf(cend);
  attn::cp_async_wait<0>();
  __syncthreads();
  // x w as hi + lo, laid out [token][row] like x: x's tile becomes hi
  for (int i = tid; i < Q * P; i += THREADS) {
    const int k = i / P, r = i % P;
    const float v = __fmul_rn(__bfloat162float(xh[k * SP + r]), wv[k]);
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    xh[k * SP + r] = hi;
    xl[k * SP + r] = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
  __syncthreads();

  const int mt = warp % WM, nw = warp / WM;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // A fragment of rows 16 mt.., tokens 16 ks..: 8 x 8 matrices (tokens
  // 0-7, rows 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), transposed
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * SP +
                    ((lane >> 3) & 1) * 8 + mt * 16;
  const __nv_bfloat16* bl =
      bs + (lane & 15) * SN + (lane >> 4) * 8 + nw * (N / WN);
  for (int ks = 0; ks < Q / 16; ++ks) {
    uint32_t ah[4], al[4];
    attn::ldsm_x4_t(ah, xh + a_off + ks * 16 * SP);
    attn::ldsm_x4_t(al, xl + a_off + ks * 16 * SP);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t vb[4];
      attn::ldsm_x4_t(vb, bl + ks * 16 * SN + np * 16);
      attn::mma_bf16(acc[2 * np], ah, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * np + 1], ah, vb[2], vb[3]);
      attn::mma_bf16(acc[2 * np], al, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * np + 1], al, vb[2], vb[3]);
    }
  }
  float* out = a.ws + ((b * a.H + h) * nc + c) * (long long)(P * N);
  const int r0 = mt * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = nw * (N / WN) + n * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(out + r0 * N + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (r0 + 8) * N + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// (b) the state pass: thread i owns 4 consecutive state elements of one
// (batch row, head) and walks its nc sub-chunks in order, PASS_DEPTH
// chunk states loaded ahead of the chain; S_in[c] goes out split, as the
// hi and lo planes (c) stages as they are
__global__ void __launch_bounds__(PASS_THREADS)
    ssd_state_pass_kernel(const float* s0, const float* ws,
                          const float* decay, __nv_bfloat16* s_in,
                          float* s_final, int nc, int pn4, long long total4) {
  pdl_trigger();  // (c) may be scheduled now: its first half needs no state
  pdl_wait();     // every chunk state of (a) is written
  const long long i = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= total4) return;
  const long long bh = i / pn4, e = i - bh * pn4;
  float4 s = s0 != nullptr ? reinterpret_cast<const float4*>(s0)[i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* w = reinterpret_cast<const float4*>(ws) + bh * nc * pn4 + e;
  uint2* so = reinterpret_cast<uint2*>(s_in) + bh * nc * 2 * pn4 + e;
  const float* dc = decay + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += PASS_DEPTH) {
    float4 sc[PASS_DEPTH];
#pragma unroll
    for (int j = 0; j < PASS_DEPTH; ++j)
      if (c0 + j < nc) sc[j] = w[(long long)(c0 + j) * pn4];
#pragma unroll
    for (int j = 0; j < PASS_DEPTH; ++j)
      if (c0 + j < nc) {
        uint2 hi, lo;
        split2(s.x, s.y, hi.x, lo.x);
        split2(s.z, s.w, hi.y, lo.y);
        so[(long long)(c0 + j) * 2 * pn4] = hi;
        so[(long long)(c0 + j) * 2 * pn4 + pn4] = lo;
        const float d = dc[c0 + j];
        s = make_float4(__fmaf_rn(d, s.x, sc[j].x), __fmaf_rn(d, s.y, sc[j].y),
                        __fmaf_rn(d, s.z, sc[j].z),
                        __fmaf_rn(d, s.w, sc[j].w));
      }
  }
  reinterpret_cast<float4*>(s_final)[i] = s;
}

// (c) the outputs of R = min(Q, OUT_ROWS) query rows of a sub-chunk,
// rows q0 .. q0 + R - 1 (blockIdx.x = sub-chunk * Q / R + q0 / R): warp w
// owns rows q0 + 16 w .. q0 + 16 w + 15, a lane rows ra = q0 + 16 w +
// lane / 4 and ra + 8, over the keys 0 .. ra of the sub-chunk
// 3 blocks an SM up to p 64 (70 KB of shared memory a block at Q 128);
// at p 128 two (86 KB each), which leaves a thread the registers of O and
// the state's product, 64 floats each
template <int P, int N>
__global__ void __launch_bounds__(OUT_ROWS / 16 * 32, P > 64 ? 2 : 3)
    ssd_chunk_out_kernel(const MmaArgs a) {
  constexpr int SN = N + 8, SP = P + 8;
  constexpr int NO = P / 8;  // output n-tiles
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int Q = a.Q, R = Q < OUT_ROWS ? Q : OUT_ROWS;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* reg = cs + R * SN;
  float* dtv = reinterpret_cast<float*>(reg + out_region<P, N>(Q));
  float* cum = dtv + MMA_MAX_SUB;
  __nv_bfloat16* bs = reg;           // B [Q][SN]
  __nv_bfloat16* xs = reg + Q * SN;  // and x [Q][SP]
  __nv_bfloat16* sh = reg;           // later: S_in hi [P][SN]
  __nv_bfloat16* sl = reg + P * SN;  // and lo [P][SN]

  const int parts = Q / R, c = blockIdx.x / parts, nc = gridDim.x / parts;
  const int q0 = (blockIdx.x % parts) * R, nk = q0 + R;  // rows, keys
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = h / (a.H / a.G);
  const long long t0 = (long long)c * Q;
  const __nv_bfloat16* xb =
      a.x + b * a.x_sb + t0 * a.x_st + (long long)h * a.x_sh;
  const __nv_bfloat16* Bb =
      a.B + b * a.b_sb + t0 * a.b_st + (long long)g * a.b_sg;
  const __nv_bfloat16* Cb =
      a.C + b * a.c_sb + (t0 + q0) * a.c_st + (long long)g * a.c_sg;
  const float* dtb = a.dt + b * a.dt_sb + t0 * a.dt_st + h;

  const __nv_bfloat16* sp =
      a.s_in + ((b * a.H + h) * nc + c) * (long long)(2 * P * N);
  stage_rows<N, SN>(cs, Cb, a.c_st, R, a.vec);
  stage_rows<N, SN>(bs, Bb, a.b_st, nk, a.vec);
  stage_rows<P, SP>(xs, xb, a.x_st, nk, a.vec);
  attn::cp_async_commit();
  for (int k = tid; k < Q; k += blockDim.x) dtv[k] = dtb[k * a.dt_st];
  __syncthreads();
  if (warp == 0) sub_cumsum(cum, dtv, a.A[h], Q, lane);
  attn::cp_async_wait<0>();
  __syncthreads();

  const int i0 = 16 * warp, tq = lane & 3;   // i0: the warp's first C row
  const int ra = q0 + i0 + (lane >> 2), rb = ra + 8;
  const float cum_a = cum[ra], cum_b = cum[rb];
  // o starts as D x_i
  const float Dh = a.D[h];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tq;
    const float2 xa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xs + ra * SP + col));
    const float2 xr = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xs + rb * SP + col));
    o[n][0] = __fmul_rn(Dh, xa.x);
    o[n][1] = __fmul_rn(Dh, xa.y);
    o[n][2] = __fmul_rn(Dh, xr.x);
    o[n][3] = __fmul_rn(Dh, xr.y);
  }
  const __nv_bfloat16* ql = attn::q_lane<SN>(cs + i0 * SN, lane);

  // the sub-chunk's own tokens, which need no state (so this half
  // overlaps the state pass): key blocks of 16 up to the diagonal
  const __nv_bfloat16* vl = xs + (lane & 15) * SP + (lane >> 4) * 8;
  for (int kk = 0; kk <= q0 / 16 + warp; ++kk) {
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const __nv_bfloat16* kb = attn::k_lane<SN>(bs + kk * 16 * SN, lane);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t qa[4];
      attn::ldsm_x4(qa, ql + ks * 16);
      attn::qk_step<2, SN>(s, qa, kb, ks);
    }
    // W_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ra : rb;
        const int j = kk * 16 + n * 8 + 2 * tq + (e & 1);
        const float ci = e < 2 ? cum_a : cum_b;
        s[n][e] = j <= i ? __fmul_rn(__fmul_rn(s[n][e],
                                               expf(__fsub_rn(ci, cum[j]))),
                                     dtv[j])
                         : 0.f;
      }
    uint32_t wh[4], wl[4];
    ssd::split_frag(s, wh, wl);
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t vb[4];
      attn::ldsm_x4_t(vb, vl + kk * 16 * SP + dp * 16);
      attn::mma_bf16(o[2 * dp], wh, vb[0], vb[1]);
      attn::mma_bf16(o[2 * dp + 1], wh, vb[2], vb[3]);
      attn::mma_bf16(o[2 * dp], wl, vb[0], vb[1]);
      attn::mma_bf16(o[2 * dp + 1], wl, vb[2], vb[3]);
    }
  }

  // the carried state, once the state pass is done: the split state
  // replaces B and x; o += exp(cum_i) C_i (S_hi + S_lo)^T
  pdl_wait();
  __syncthreads();
  stage_rows<N, SN>(sh, sp, N, P, true);
  stage_rows<N, SN>(sl, sp + P * N, N, P, true);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();
  {
    float t[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
    const __nv_bfloat16* kh = attn::k_lane<SN>(sh, lane);
    const __nv_bfloat16* kl = attn::k_lane<SN>(sl, lane);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t qa[4];
      attn::ldsm_x4(qa, ql + ks * 16);
      attn::qk_step<NO, SN>(t, qa, kh, ks);
      attn::qk_step<NO, SN>(t, qa, kl, ks);
    }
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] = __fmaf_rn(ea, t[n][0], o[n][0]);
      o[n][1] = __fmaf_rn(ea, t[n][1], o[n][1]);
      o[n][2] = __fmaf_rn(eb, t[n][2], o[n][2]);
      o[n][3] = __fmaf_rn(eb, t[n][3], o[n][3]);
    }
  }

  float* ya = a.y + ((b * a.L + t0 + ra) * a.H + h) * P;  // ra: in-chunk
  float* yb = ya + 8LL * a.H * P;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(ya + col) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(yb + col) = make_float2(o[n][2], o[n][3]);
  }
}

// the sub-steps in `steps` (1: (a), 2: (b), 4: (c)) in that order
template <int P, int N>
int launch_mma(const MmaArgs& a, int batch, int steps, cudaStream_t stream) {
  auto ka = ssd_chunk_states_kernel<P, N>;
  auto kc = ssd_chunk_out_kernel<P, N>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
        states_smem_bytes<P, N>(MMA_MAX_SUB));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem_bytes<P, N>(MMA_MAX_SUB));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int nc = a.L / a.Q;
  const int rows = a.Q < OUT_ROWS ? a.Q : OUT_ROWS;
  const dim3 grid(nc, a.H, batch), out_grid(nc * (a.Q / rows), a.H, batch);
  cudaError_t e = cudaSuccess;
  if (steps & 1) {
    ka<<<grid, states_threads(P), states_smem_bytes<P, N>(a.Q), stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (steps & 2) {
    const long long total4 = (long long)batch * a.H * (P * N / 4);
    e = launch_pdl(ssd_state_pass_kernel,
                   dim3((unsigned)((total4 + PASS_THREADS - 1) /
                                   PASS_THREADS)),
                   PASS_THREADS, 0, stream, a.s0, (const float*)a.ws,
                   (const float*)a.decay, a.s_in, a.s_final, nc, P * N / 4,
                   total4);
    if (e != cudaSuccess) return (int)e;
  }
  if (steps & 4) {
    e = launch_pdl(kc, out_grid, rows / 16 * 32, out_smem_bytes<P, N>(a.Q),
                   stream, a);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// ssd_extend: T recurrence steps from s_in; the new state goes to s_out
// (may equal s_in), the incoming one to ckpt when it is not null. p in
// {32, 64, 128} (any even p runs: the kernel numbers state rows through
// the heads), n in {32, 64, 128}; every buffer f32. The plan (rows a
// block, tokens a tile) comes from kernels/ssd_scan/kernel.py::
// extend_plan: rows an even number up to 32 that divides a group's
// (h / g) * p rows, tt 1 or 16. Returns a cudaError_t, or -1 for a shape
// or plan without an instance.
extern "C" int ssd_extend_launch(
    const void* s_in, void* s_out, void* ckpt, const void* x, const void* dt,
    const void* A, const void* B, const void* C, const void* D, void* y,
    int batch, int T, int H, int G, int P, int N, int rows, int tt,
    long long s_in_sb, long long s_out_sb, long long ckpt_sb, long long x_sb,
    long long x_st, long long x_sh, long long dt_sb, long long dt_st,
    long long b_sb, long long b_st, long long b_sg, long long c_sb,
    long long c_st, long long c_sg, void* stream) {
  if (P % EXT_RPW || G < 1 || H % G || rows < EXT_RPW ||
      rows > EXT_RPW * EXT_MAX_WARPS || rows % EXT_RPW ||
      (H / G * P) % rows)
    return -1;
  const bool vec_bc = ((uintptr_t)B | (uintptr_t)C) % 16 == 0 &&
                      (b_sb | b_st | b_sg | c_sb | c_st | c_sg) % 4 == 0;
  ExtArgs a{(const float*)s_in, (float*)s_out, (float*)ckpt,
            (const float*)x, (const float*)dt, (const float*)A,
            (const float*)B, (const float*)C, (const float*)D, (float*)y,
            T, H, G, P, rows, vec_bc, s_in_sb, s_out_sb, ckpt_sb,
            x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg, c_sb, c_st,
            c_sg};
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(H * P / rows, batch);
  const int threads = rows / EXT_RPW * 32;
#define EXT_CASE(NN, TT)                                       \
  if (N == NN && tt == TT)                                     \
    return launch_extend<NN / 32, TT>(a, grid, threads, s);
  EXT_CASE(32, 1) EXT_CASE(64, 1) EXT_CASE(128, 1)
  EXT_CASE(32, EXT_TILE) EXT_CASE(64, EXT_TILE) EXT_CASE(128, EXT_TILE)
#undef EXT_CASE
  return -1;
}

// ssd, the simt route: x, B, C in dtype (0 f32, 1 bf16); dt, A, D, s0
// f32; y (b, l, h, p) and s_final (b, h, p, n) f32 contiguous; s0 (b, h,
// p, n) contiguous or null. l % Q == 0, Q <= 256. Returns a cudaError_t,
// or -1 for a shape without an instance.
extern "C" int ssd_chunk_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* s0, void* y, void* s_final,
    int batch, int L, int Q, int H, int G, int P, int N, int dtype,
    long long x_sb, long long x_st, long long x_sh, long long dt_sb,
    long long dt_st, long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg, void* stream) {
  if (Q < 1 || Q > MAX_CHUNK || L % Q) return -1;
  ChunkArgs a{x, (const float*)dt, (const float*)A, B, C, (const float*)D,
              (const float*)s0, (float*)y, (float*)s_final, L, Q, H, G,
              x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
              c_sb, c_st, c_sg};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_chunk<float>(a, batch, P, N, s);
  if (dtype == 1) return dispatch_chunk<__nv_bfloat16>(a, batch, P, N, s);
  return -1;
}

// ssd, the mma route: bf16 x, B, C; dt, A, D, s0 f32; y (b, l, h, p),
// s_final (b, h, p, n), ws (b, h, l / Q, p, n) and decay (b, h, l / Q)
// f32 and s_in (b, h, l / Q, 2, p, n) bf16, contiguous, allocated by the
// caller; s0 (b, h, p, n) contiguous (16-byte aligned) or null. Q (the sub-chunk) a multiple of 16 up to 128 dividing l; steps
// the sub-steps to launch (7: all three; 1, 2, 4 alone time them). Three
// launches a call. Returns a cudaError_t, or -1 for a shape without an
// instance.
extern "C" int ssd_chunk_mma_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* s0, void* y, void* s_final,
    void* ws, void* decay, void* s_in, int batch, int L, int Q, int H,
    int G, int P, int N, int steps, long long x_sb, long long x_st, long long x_sh,
    long long dt_sb, long long dt_st, long long b_sb, long long b_st,
    long long b_sg, long long c_sb, long long c_st, long long c_sg,
    void* stream) {
  if (Q < 16 || Q > MMA_MAX_SUB || Q % 16 || L % Q || G < 1 || H % G ||
      steps < 1 || steps > 7)
    return -1;
  const bool vec =
      ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16 == 0 &&
      (x_sb | x_st | x_sh | b_sb | b_st | b_sg | c_sb | c_st | c_sg) % 8 == 0;
  MmaArgs a{(const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
            (const __nv_bfloat16*)B, (const __nv_bfloat16*)C,
            (const float*)D, (const float*)s0, (float*)y, (float*)s_final,
            (float*)ws, (float*)decay, (__nv_bfloat16*)s_in, L, Q, H, G,
            vec,
            x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
            c_sb, c_st, c_sg};
  cudaStream_t s = (cudaStream_t)stream;
#define MMA_CASE(PP, NN) \
  if (P == PP && N == NN) return launch_mma<PP, NN>(a, batch, steps, s);
  MMA_CASE(32, 32) MMA_CASE(32, 64) MMA_CASE(32, 128)
  MMA_CASE(64, 32) MMA_CASE(64, 64) MMA_CASE(64, 128)
  MMA_CASE(128, 128)
#undef MMA_CASE
  return -1;
}
