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
// ssd (chunked): one block per (batch row, head) walks the chunks in
// order with the carried (p, n) state in shared memory (32 KB at p 64,
// n 128). Within a chunk: dA = dt*A and its inclusive cumulative sum
// (warp scans); then per tile of 64 query rows i, for each tile of 64
// key rows j <= i: scores C_i . B_j, weighted by exp(cum_i - cum_j)*dt_j
// where j <= i (0 above the diagonal, never exp of a positive number),
// times x_j; plus exp(cum_i) * C_i . state and D*x_i. Then the state
// advances: exp(cum_end)*state + sum_j exp(cum_end - cum_j)*dt_j x_j B_j^T.
// Tiles live in shared memory as f32 with rows padded by one word (no
// bank conflicts in the dot products); a thread computes a 4 x 4 block of
// scores strided by 16 rows and columns. f32 FMAs on CUDA cores.
// What bounds it: operations. At b 1, l 1024, chunk 256, h 48, p 64,
// n 128 the work this design does is about 4.4 GFLOP (the masked half of
// each diagonal tile included); the bound counts the unmasked pairs
// only. 48 blocks fill 48 of the 132 SMs at b = 1: splitting the chunks'
// state work over more blocks (chunk states, state passing, chunk scan)
// and tensor-core products are what a faster version changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
  for (int idx = threadIdx.x; idx < TILE * W; idx += SSD_THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * (W + 1) + c] = r < nr ? to_f(src[(r0 + r) * st + c]) : 0.f;
  }
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
#undef SSD_CASE
  return -1;
}

}  // namespace

extern "C" {

// ssd_extend: T recurrence steps from s_in; the new state goes to s_out
// (may equal s_in), the incoming one to ckpt when it is not null. p in
// {32, 64}, n in {32, 64, 128}; every buffer f32. The plan (rows a
// block, tokens a tile) comes from kernels/ssd_scan/kernel.py::
// extend_plan: rows an even number up to 32 that divides a group's
// (h / g) * p rows, tt 1 or 16. Returns a cudaError_t, or -1 for a shape
// or plan without an instance.
int ssd_extend_launch(const void* s_in, void* s_out, void* ckpt,
                      const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D, void* y,
                      int batch, int T, int H, int G, int P, int N, int rows,
                      int tt, long long s_in_sb, long long s_out_sb,
                      long long ckpt_sb, long long x_sb, long long x_st,
                      long long x_sh, long long dt_sb, long long dt_st,
                      long long b_sb, long long b_st, long long b_sg,
                      long long c_sb, long long c_st, long long c_sg,
                      void* stream) {
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

// ssd (chunked): x, B, C in dtype (0 f32, 1 bf16); dt, A, D, s0 f32;
// y (b, l, h, p) and s_final (b, h, p, n) f32 contiguous; s0 (b, h, p,
// n) contiguous or null. l % Q == 0, Q <= 256. Returns a cudaError_t, or
// -1 for a shape without an instance.
int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* D,
                     const void* s0, void* y, void* s_final, int batch, int L,
                     int Q, int H, int G, int P, int N, int dtype,
                     long long x_sb, long long x_st, long long x_sh,
                     long long dt_sb, long long dt_st, long long b_sb,
                     long long b_st, long long b_sg, long long c_sb,
                     long long c_st, long long c_sg, void* stream) {
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

}  // extern "C"
