// The backward of the Mamba-2 SSD dual form, hand-written for Hopper: a
// tensor-core route for bf16 and PR 32's CUDA-core route, no atomics.
//
// Replaces: no TPU kernel. The JAX package trains by autodiff of its
//   plain chunked scan (src/repro/kernels/ssd_scan/ref.py,
//   ssd_reference) and has no Pallas backward. The port's forward is the
//   dual form of ssd_scan.cu (ssd_cuda), which keeps no per-chunk state;
//   its backward, here, recomputes what it needs from the inputs. On the
//   port's path it runs once a Mamba-2 layer in every train step
//   (ROADMAP item 12b).
//
// What it computes (ref.ssd_backward_reference, in f32), per (b, h) and
// chunk of Q tokens, with c_i = sum_{t<=i} dt_t A_h in the chunk, x^ =
// dt x, S_in the chunk's incoming state and G = dS_out the gradient of
// its outgoing one (the final state's gradient, or 0, for the last):
//   dS_in = sum_i e^{c_i} dy_i C_i^T + e^{c_Q} G
//   dx^_j = sum_{i>=j} (C_i.B_j) e^{c_i-c_j} dy_i + e^{c_Q-c_j} G B_j
//   dC_i  = sum_{j<=i} e^{c_i-c_j} (dy_i.x^_j) B_j + e^{c_i} S_in^T dy_i
//   dB_j  = sum_{i>=j} e^{c_i-c_j} (dy_i.x^_j) C_i + e^{c_Q-c_j} G^T x^_j
//   dc    = row sums - column sums of M_ij = (C_i.B_j)(dy_i.x^_j)
//           e^{c_i-c_j}, + e^{c_i} dy_i.(S_in C_i) - m_i, m_j = e^{c_Q-c_j}
//           x^_j.(G B_j), and at the chunk's last token + sum_j m_j +
//           e^{c_Q} <G, S_in>
//   d(dt A) = the reverse cumulative sum of dc within the chunk;
//   dx = dt dx^ + D dy, ddt = x.dx^ + A d(dt A), dA = sum dt d(dt A),
//   dD = sum dy.x; dB and dC summed over the heads of a group.
//
// Two routes, picked by kernels/ssd_scan/kernel.py::bwd_plan from the
// dtype and the chunk, as the forward's chunk_plan picks its own:
//
// mma (bf16 x, B, C; a chunk that is a multiple of 16). The backward's
// function does not depend on the chunk, so it works in sub-chunks of Q
// tokens, the first of BWD_SUBS (128, 64, ...) that divides the chunk
// and whose main kernel fits a block (64 at p 128). Five launches:
//  (1) ssd_bwd_states_mma_kernel, a block per (sub-chunk, head, batch
//      row, side): the sub-chunk's own state and its decay (side 0), and
//      sum_i e^{c_i} dy_i C_i^T (side 1), p x n each;
//  (2) ssd_bwd_pass_mma_kernel, a thread per 4 state elements: the
//      forward pass into each sub-chunk's S_in, the reverse pass into its
//      G = dS_out, both written as split bf16 pairs, with <G, S_in> by
//      warp; what is left is the initial state's gradient;
//  (3) ssd_bwd_mma_kernel, a block per (sub-chunk, head, batch row), Q /
//      16 warps, warp w owning query and key rows 16 w ..: dC, dB, dx,
//      the row and column sums of M, the state terms, then the
//      sub-chunk's dc, its reverse cumulative sum, ddt and the block's
//      partial sums of dA and dD, all in one block (no sum crosses
//      blocks);
//  then ssd_bwd_group_kernel (dB, dC over a group's heads) and
//  ssd_bwd_param_kernel (dA, dD), shared with the simt route. (2) and
//  (3) are programmatic dependents: (3) runs its query side's own-token
//  products, which need no state, while (2) runs.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate; attn_mma.cuh's ldmatrix loads). The scores C_i.B_j take
// the bf16 inputs as they are (exact products); an f32 operand (dy, the
// weights W and P, x w and e^c dy in (1), S_in, G) enters as a split pair
// hi = bf16(v), lo = bf16(v - hi) (ssd_common.cuh's split2, as the
// forward's mma route): two products against an exactly-bf16 partner,
// three (hi hi + hi lo + lo hi) where both sides are f32 (P^T dy and
// dy S_in). Tiles are staged by 16-byte cp.async copies.
// What bounds it: the bytes (x, B, C, dt, dy read, dx, ddt, dB, dC
// written once: 106 MB at mamba2-780m's train shape, b 4, l 1024, h 48,
// p 64, n 128, 0.032 ms at 3.35 TB/s). The operations (the live (i, j <=
// i) pairs' 6n + 4p + 6 and the state products' 12 p n + 6 p a token)
// fall with the sub-chunk: 21.1 GFLOP at 16, 0.021 ms at 989 TFLOP/s;
// 32.5 GFLOP at the 128 this route runs, 0.033 ms. On top the route
// moves its workspace: the states (4 b h (l / Q) p n bytes each of own,
// into, the f32 S_in and the two split planes, 25 MB at Q 128), and dB
// and dC a head, wdB / wdC (b l h n f32 each, 101 MB at mamba2), written
// by (3) and read by the group sum: 403 MB, 0.12 ms at 3.35 TB/s. The
// round trip is kept without a measured alternative: with no atomics, a
// group's heads meet in one block or in a chain of blocks in head order,
// and mamba2 has one group of 48 heads, so one block would own 48 heads
// (32 blocks for 132 SMs, and dB and dC held across heads in registers
// the key side already fills) and a chain would serialise them.
// What the design does about the simt route's costs: (i) the products run
// on the tensor cores; (ii) one block owns a sub-chunk's queries and keys,
// so dC, dB, dx and both sums of M come from one block, and each tile of
// scores is computed once for each side (see (3)); (iii) it works in the
// sub-chunk that measured fastest, not the caller's 256, which cut the
// live pairs; (iv) bf16 tiles come in by 16-byte cp.async copies, 163 KB
// at Q 128 (one block of 8 warps an SM), 101 KB at 64 (two); (v) only a
// diagonal tile masks, and no tile above it is visited; (vi) dB and dC a
// head stay a workspace round trip (above).
//
// simt (f32 inputs, or a chunk that is no multiple of 16): PR 32's seven
// launches, unchanged (so the f32 train step on the card keeps its bits;
// a simple design, a right kernel first: f32 on the CUDA
// cores, every tile staged in shared memory as f32 with rows padded by
// one word, 256 threads as 16 x 16, each a 4 x 4 block of a 64 x 64
// score tile, as ssd_scan.cu's simt route):
//   1. ssd_bwd_states_kernel, a block per (chunk, head, batch row, side):
//      the chunk's own state sum_j e^{c_Q-c_j} x^_j B_j^T (side 0, and
//      the chunk's decay e^{c_Q}) and sum_i e^{c_i} dy_i C_i^T (side 1),
//      each p x n into the workspace.
//   2. ssd_bwd_pass_kernel, a thread per state element: the forward
//      pass over the chunks turns the own states into incoming states
//      (from the initial state or 0), then the reverse pass turns the
//      sums of side 1 into each chunk's dS_out (from the final state's
//      gradient or 0); what is left is the initial state's gradient.
//   3. ssd_bwd_query_kernel, a block per (64 queries i, chunk, head,
//      batch row): walks the key tiles j <= i recomputing C_i.B_j,
//      dy_i.x^_j and e^{c_i-c_j}, accumulates dC_i and the row sums of
//      M, then the S_in terms over S_in's rows in tiles of 64.
//   4. ssd_bwd_key_kernel, a block per (64 keys j, ...): walks the query
//      tiles i >= j the same way, accumulates dx^_j, dB_j and the column
//      sums of M, then the G terms over G's rows; writes dx and each
//      key's dc, m, x.dx^ and dy.x.
//   5. ssd_bwd_dt_kernel, a block per (chunk, head, batch row): the
//      chunk's dc, its reverse cumulative sum, ddt, and this chunk's
//      partial sums of dA and dD.
//   6. ssd_bwd_group_kernel: dB and dC summed over a group's heads in
//      head order (the query and key kernels write them per head).
//   7. ssd_bwd_param_kernel: dA and dD summed over the partials in
//      (batch row, chunk) order.
// It is bound by its operations on the CUDA cores (67 TFLOP/s f32), with
// two shared-memory reads a pair of FMAs.
// Each block owns what it writes and every sum runs in a fixed order, on
// both routes (no atomics), so the gradients are the same bits launch
// after launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ssd::FULL;

constexpr int THREADS = 256;   // 16 x 16
constexpr int TILE = 64;       // rows of a staged tile
constexpr int MAX_CHUNK = 256;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* s0;      // (b, h, p, n) contiguous, may be null
  const float* dy;      // (b, l, h, p) contiguous
  const float* dfinal;  // (b, h, p, n) contiguous, may be null
  void* dx;             // (b, l, h, p) contiguous, x's type
  float* ddt;           // (b, l, h) contiguous
  void* dB;             // (b, l, g, n) contiguous, B's type
  void* dC;
  float* dA;            // (h,)
  float* dD;
  float* dinit;         // (b, h, p, n), may be null
  // workspace
  float* s_in;          // (b, h, chunks, p, n): own states -> S_in
  float* g_out;         // (b, h, chunks, p, n): side 1 -> dS_out
  float* decay;         // (b, h, chunks): e^{c_Q}
  float* pos;           // (5, b, h, l): a token's dc of the query
                        // kernel, dc of the key kernel, m, x.dx^, dy.x
  float* wdB;           // (b, l, h, n): dB a head
  float* wdC;
  float* part;          // (2, b, chunks, h): dA, dD partial sums
  int batch, L, Q, H, G, nc;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

template <typename Tin, int W>
__device__ __forceinline__ void stage(float* dst, const Tin* src,
                                      long long st, int r0, int nr) {
  ssd::stage_tile<Tin, W, TILE, THREADS>(dst, src, st, r0, nr);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The chunk's dt into dtv and the inclusive cumulative sum of dt * A into
// cum (Q <= THREADS: a thread a token), as the forward's simt route scans.
__device__ __forceinline__ void chunk_cum(const BwdArgs& a, long long b,
                                          int h, int c0, float* dtv,
                                          float* cum, float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = 0.f;
  if (tid < a.Q) {
    const float d = a.dt[b * a.dt_sb + (long long)(c0 + tid) * a.dt_st + h];
    dtv[tid] = d;
    v = d * a.A[h];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += tot[w];
  if (tid < a.Q) cum[tid] = base + v;
  __syncthreads();
}

// The block's sum of v, the warps in order (every thread gets it)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();                    // red of an earlier sum is read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// The sum over the 16 threads of a row group (tj = 0..15, one half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int P, int N>
constexpr size_t states_smem_floats() {
  return (size_t)TILE * (P + 1) + (size_t)TILE * (N + 1) + TILE
         + 2 * MAX_CHUNK + 32;
}

template <int P, int N>
constexpr size_t query_smem_floats() {
  return 2 * (size_t)TILE * (N + 1) + 2 * (size_t)TILE * (P + 1)
         + (size_t)TILE * (TILE + 1) + 2 * MAX_CHUNK + 32;
}

template <int P, int N>
constexpr size_t key_smem_floats() {
  return query_smem_floats<P, N>() + (size_t)TILE * (TILE + 1);
}

// 1. A chunk's own state (side 0) or its output gradient into the state
// (side 1), p x n: a thread rows warp + 8 i, columns lane + 32 c.
template <typename Tin, int P, int N>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_states_kernel(const BwdArgs a) {
  constexpr int SR = P / 8, NC = N / 32;
  extern __shared__ float smem[];
  float* rt = smem;                   // [TILE][P + 1]: x or dy
  float* ct = rt + TILE * (P + 1);    // [TILE][N + 1]: B or C
  float* wv = ct + TILE * (N + 1);    // [TILE]: the tokens' weights
  float* dtv = wv + TILE;             // [MAX_CHUNK]
  float* cum = dtv + MAX_CHUNK;       // [MAX_CHUNK]
  float* tot = cum + MAX_CHUNK;       // [32]
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z >> 1;
  const bool side1 = blockIdx.z & 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = h / (a.H / a.G), Q = a.Q, c0 = c * Q;
  chunk_cum(a, b, h, c0, dtv, cum, tot);
  const float cend = cum[Q - 1];
  float acc[SR][NC];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;
  for (int k0 = 0; k0 < Q; k0 += TILE) {
    const int nk = min(TILE, Q - k0);
    if (side1) {
      stage<float, P>(rt, a.dy + (b * a.L * a.H + h) * P,
                      (long long)a.H * P, c0 + k0, nk);
      stage<Tin, N>(ct, static_cast<const Tin*>(a.C) + b * a.c_sb
                    + g * a.c_sg, a.c_st, c0 + k0, nk);
    } else {
      stage<Tin, P>(rt, static_cast<const Tin*>(a.x) + b * a.x_sb
                    + h * a.x_sh, a.x_st, c0 + k0, nk);
      stage<Tin, N>(ct, static_cast<const Tin*>(a.B) + b * a.b_sb
                    + g * a.b_sg, a.b_st, c0 + k0, nk);
    }
    if (tid < TILE)
      wv[tid] = tid >= nk ? 0.f
                : side1 ? expf(cum[k0 + tid])
                        : expf(cend - cum[k0 + tid]) * dtv[k0 + tid];
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float w = wv[j];
      float cv[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) cv[k] = ct[j * (N + 1) + lane + 32 * k];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float r = rt[j * (P + 1) + warp + 8 * i] * w;
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[i][k] = fmaf(r, cv[k], acc[i][k]);
      }
    }
    __syncthreads();
  }
  float* out = (side1 ? a.g_out : a.s_in)
               + ((b * a.H + h) * a.nc + c) * (long long)(P * N);
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int k = 0; k < NC; ++k)
      out[(warp + 8 * i) * N + lane + 32 * k] = acc[i][k];
  if (!side1 && tid == 0) a.decay[(b * a.H + h) * a.nc + c] = expf(cend);
}

// 2. The state passes, a thread an element of a (b, h) state.
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_pass_kernel(const BwdArgs a, int PN) {
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.H * PN) return;
  const long long bh = e / PN;
  const int idx = static_cast<int>(e - bh * PN);
  const float* dec = a.decay + bh * a.nc;
  float* si = a.s_in + bh * a.nc * PN + idx;
  float* go = a.g_out + bh * a.nc * PN + idx;
  float s = a.s0 != nullptr ? a.s0[e] : 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const float own = si[(long long)c * PN];
    si[(long long)c * PN] = s;
    s = s * dec[c] + own;
  }
  float gs = a.dfinal != nullptr ? a.dfinal[e] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const float into = go[(long long)c * PN];
    go[(long long)c * PN] = gs;
    gs = into + dec[c] * gs;
  }
  if (a.dinit != nullptr) a.dinit[e] = gs;
}

// 3. A tile of 64 queries i: dC_i and the row sums of M, then the S_in
// terms.
template <typename Tin, int P, int N>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_query_kernel(const BwdArgs a) {
  constexpr int NCOL = N / 16;
  constexpr int PT = P < TILE ? P : TILE, JU = PT / 16;
  extern __shared__ float smem[];
  float* cq = smem;                     // [TILE][N + 1]: C_i
  float* dyq = cq + TILE * (N + 1);     // [TILE][P + 1]: dy_i
  float* bk = dyq + TILE * (P + 1);     // [TILE][N + 1]: B_j, S_in rows
  float* xk = bk + TILE * (N + 1);      // [TILE][P + 1]: x_j
  float* wt = xk + TILE * (P + 1);      // [TILE][TILE + 1]
  float* dtv = wt + TILE * (TILE + 1);  // [MAX_CHUNK]
  float* cum = dtv + MAX_CHUNK;         // [MAX_CHUNK]
  float* tot = cum + MAX_CHUNK;         // [32]
  const int QT = (a.Q + TILE - 1) / TILE;
  const int c = blockIdx.x / QT, qt = blockIdx.x % QT, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int g = h / (a.H / a.G), Q = a.Q, c0 = c * Q;
  const int q0 = qt * TILE, nq = min(TILE, Q - q0);
  const Tin* xb = static_cast<const Tin*>(a.x) + b * a.x_sb + h * a.x_sh;
  const Tin* Bb = static_cast<const Tin*>(a.B) + b * a.b_sb + g * a.b_sg;
  const Tin* Cb = static_cast<const Tin*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dyb = a.dy + (b * a.L * a.H + h) * P;
  chunk_cum(a, b, h, c0, dtv, cum, tot);
  stage<Tin, N>(cq, Cb, a.c_st, c0 + q0, nq);
  stage<float, P>(dyq, dyb, (long long)a.H * P, c0 + q0, nq);
  float acc[4][NCOL], dcr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dcr[i] = 0.f;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) acc[i][k] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TILE, nk = min(TILE, Q - k0);
    stage<Tin, N>(bk, Bb, a.b_st, c0 + k0, nk);
    stage<Tin, P>(xk, xb, a.x_st, c0 + k0, nk);
    __syncthreads();
    float sc[4][4], yx[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = yx[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = cq[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = bk[(tj + 16 * j) * (N + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(u[i], v[j], sc[i][j]);
    }
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = dyq[(ti + 16 * i) * (P + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = xk[(tj + 16 * j) * (P + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yx[i][j] = fmaf(u[i], v[j], yx[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + ti + 16 * i, kj = k0 + tj + 16 * j;
        float w = 0.f;
        if (kj <= qi && qi < Q) {
          w = expf(cum[qi] - cum[kj]) * yx[i][j] * dtv[kj];
          dcr[i] = fmaf(sc[i][j], w, dcr[i]);
        }
        wt[(ti + 16 * i) * (TILE + 1) + tj + 16 * j] = w;
      }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = wt[(ti + 16 * i) * (TILE + 1) + j];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const float v = bk[j * (N + 1) + tj + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(w[i], v, acc[i][k]);
      }
    }
    __syncthreads();
  }
  // the incoming state's terms, on dy_i scaled by e^{c_i}
  for (int idx = tid; idx < nq * P; idx += THREADS) {
    const int r = idx / P;
    dyq[r * (P + 1) + idx % P] *= expf(cum[q0 + r]);
  }
  const float* sinp = a.s_in + ((b * a.H + h) * a.nc + c) * (long long)(P * N);
#pragma unroll
  for (int pi = 0; pi < P / PT; ++pi) {
    const int p0 = pi * PT;
    __syncthreads();                  // dyq scaled; bk free
    stage<float, N>(bk, sinp, N, p0, PT);
    __syncthreads();
    float u[4][JU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JU; ++j) u[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float cv[4], sv[JU];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cq[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
      for (int j = 0; j < JU; ++j) sv[j] = bk[(tj + 16 * j) * (N + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JU; ++j) u[i][j] = fmaf(cv[i], sv[j], u[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JU; ++j)
        dcr[i] = fmaf(dyq[(ti + 16 * i) * (P + 1) + p0 + tj + 16 * j],
                      u[i][j], dcr[i]);
    for (int pp = 0; pp < PT; ++pp) {
      float yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yv[i] = dyq[(ti + 16 * i) * (P + 1) + p0 + pp];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const float v = bk[pp * (N + 1) + tj + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(yv[i], v, acc[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dcr[i] = row_sum(dcr[i]);
  float* pos0 = a.pos + (b * a.H + h) * a.L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ti + 16 * i;
    if (r >= nq) continue;
    const long long t = c0 + q0 + r;
    float* dst = a.wdC + ((b * a.L + t) * a.H + h) * N;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) dst[tj + 16 * k] = acc[i][k];
    if (tj == 0) pos0[t] = dcr[i];
  }
}

// 4. A tile of 64 keys j: dx^_j, dB_j and the column sums of M, then the
// G terms; dx and the keys' per-token sums.
template <typename Tin, int P, int N>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_key_kernel(const BwdArgs a) {
  constexpr int NCOL = N / 16, PCOL = P / 16;
  constexpr int PT = P < TILE ? P : TILE, JU = PT / 16;
  extern __shared__ float smem[];
  float* bk = smem;                     // [TILE][N + 1]: B_j
  float* xk = bk + TILE * (N + 1);      // [TILE][P + 1]: x_j
  float* cq = xk + TILE * (P + 1);      // [TILE][N + 1]: C_i, G rows
  float* dyq = cq + TILE * (N + 1);     // [TILE][P + 1]: dy_i
  float* pt = dyq + TILE * (P + 1);     // [TILE][TILE + 1]
  float* wt = pt + TILE * (TILE + 1);   // [TILE][TILE + 1]
  float* dtv = wt + TILE * (TILE + 1);  // [MAX_CHUNK]
  float* cum = dtv + MAX_CHUNK;         // [MAX_CHUNK]
  float* tot = cum + MAX_CHUNK;         // [32]
  const int QT = (a.Q + TILE - 1) / TILE;
  const int c = blockIdx.x / QT, kt = blockIdx.x % QT, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int g = h / (a.H / a.G), Q = a.Q, c0 = c * Q;
  const int k0 = kt * TILE, nk = min(TILE, Q - k0);
  const Tin* xb = static_cast<const Tin*>(a.x) + b * a.x_sb + h * a.x_sh;
  const Tin* Bb = static_cast<const Tin*>(a.B) + b * a.b_sb + g * a.b_sg;
  const Tin* Cb = static_cast<const Tin*>(a.C) + b * a.c_sb + g * a.c_sg;
  const float* dyb = a.dy + (b * a.L * a.H + h) * P;
  chunk_cum(a, b, h, c0, dtv, cum, tot);
  stage<Tin, N>(bk, Bb, a.b_st, c0 + k0, nk);
  stage<Tin, P>(xk, xb, a.x_st, c0 + k0, nk);
  float dxb[4][PCOL], dba[4][NCOL], dcc[4], mp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dcc[i] = mp[i] = 0.f;
#pragma unroll
    for (int k = 0; k < PCOL; ++k) dxb[i][k] = 0.f;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) dba[i][k] = 0.f;
  }
  for (int qt = kt; qt < QT; ++qt) {
    const int q0 = qt * TILE, nq = min(TILE, Q - q0);
    stage<Tin, N>(cq, Cb, a.c_st, c0 + q0, nq);
    stage<float, P>(dyq, dyb, (long long)a.H * P, c0 + q0, nq);
    __syncthreads();
    float sc[4][4], yx[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = yx[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = bk[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = cq[(tj + 16 * j) * (N + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(u[i], v[j], sc[i][j]);
    }
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float u[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = xk[(ti + 16 * i) * (P + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = dyq[(tj + 16 * j) * (P + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yx[i][j] = fmaf(u[i], v[j], yx[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + ti + 16 * i, qi = q0 + tj + 16 * j;
        float pv = 0.f, wv = 0.f;
        if (kj <= qi && qi < Q) {
          const float e = expf(cum[qi] - cum[kj]);
          pv = sc[i][j] * e;
          wv = e * yx[i][j] * dtv[kj];
          dcc[i] = fmaf(sc[i][j], wv, dcc[i]);
        }
        pt[(ti + 16 * i) * (TILE + 1) + tj + 16 * j] = pv;
        wt[(ti + 16 * i) * (TILE + 1) + tj + 16 * j] = wv;
      }
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      float pr[4], wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = pt[(ti + 16 * i) * (TILE + 1) + q];
        wr[i] = wt[(ti + 16 * i) * (TILE + 1) + q];
      }
#pragma unroll
      for (int k = 0; k < PCOL; ++k) {
        const float v = dyq[q * (P + 1) + tj + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) dxb[i][k] = fmaf(pr[i], v, dxb[i][k]);
      }
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const float v = cq[q * (N + 1) + tj + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) dba[i][k] = fmaf(wr[i], v, dba[i][k]);
      }
    }
    __syncthreads();
  }
  // the outgoing state's terms: fs = e^{c_Q - c_j}, fx = fs dt_j
  const float cend = cum[Q - 1];
  float fs[4], fx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ti + 16 * i;
    fs[i] = kj < Q ? expf(cend - cum[kj]) : 0.f;
    fx[i] = kj < Q ? fs[i] * dtv[kj] : 0.f;
  }
  const float* gc = a.g_out + ((b * a.H + h) * a.nc + c) * (long long)(P * N);
#pragma unroll
  for (int pi = 0; pi < P / PT; ++pi) {
    const int p0 = pi * PT;
    stage<float, N>(cq, gc, N, p0, PT);
    __syncthreads();
    float u[4][JU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JU; ++j) u[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float bv[4], gv[JU];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = bk[(ti + 16 * i) * (N + 1) + k];
#pragma unroll
      for (int j = 0; j < JU; ++j) gv[j] = cq[(tj + 16 * j) * (N + 1) + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JU; ++j) u[i][j] = fmaf(bv[i], gv[j], u[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JU; ++j) {
        dxb[i][pi * JU + j] = fmaf(fs[i], u[i][j], dxb[i][pi * JU + j]);
        mp[i] = fmaf(fx[i] * xk[(ti + 16 * i) * (P + 1) + p0 + tj + 16 * j],
                     u[i][j], mp[i]);
      }
    for (int pp = 0; pp < PT; ++pp) {
      float xr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xr[i] = xk[(ti + 16 * i) * (P + 1) + p0 + pp] * fx[i];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        const float v = cq[pp * (N + 1) + tj + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) dba[i][k] = fmaf(xr[i], v, dba[i][k]);
      }
    }
    __syncthreads();
  }
  // dx, dB a head, and the keys' sums
  const float Dh = a.D[h];
  float ddx[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ti + 16 * i;
    ddx[i] = dd[i] = 0.f;
    if (kj >= Q) continue;
    const long long t = c0 + kj;
    const float* dyr = a.dy + ((b * a.L + t) * a.H + h) * P;
    Tin* dxr = static_cast<Tin*>(a.dx) + ((b * a.L + t) * a.H + h) * P;
#pragma unroll
    for (int k = 0; k < PCOL; ++k) {
      const int col = tj + 16 * k;
      const float xv = xk[(ti + 16 * i) * (P + 1) + col], gy = dyr[col];
      store(dxr + col, fmaf(dtv[kj], dxb[i][k], Dh * gy));
      ddx[i] = fmaf(xv, dxb[i][k], ddx[i]);
      dd[i] = fmaf(gy, xv, dd[i]);
    }
    float* dst = a.wdB + ((b * a.L + t) * a.H + h) * N;
#pragma unroll
    for (int k = 0; k < NCOL; ++k) dst[tj + 16 * k] = dba[i][k];
  }
  const long long plane = (long long)a.batch * a.H * a.L;
  float* pos = a.pos + (b * a.H + h) * a.L + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float cs = row_sum(dcc[i]), m = row_sum(mp[i]);
    const float sx = row_sum(ddx[i]), sd = row_sum(dd[i]);
    const int kj = k0 + ti + 16 * i;
    if (tj == 0 && kj < Q) {
      pos[plane + kj] = -cs - m;
      pos[2 * plane + kj] = m;
      pos[3 * plane + kj] = sx;
      pos[4 * plane + kj] = sd;
    }
  }
}

// 5. A chunk's dc, its reverse cumulative sum, ddt and the chunk's
// partial sums of dA and dD; a thread a token.
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_dt_kernel(const BwdArgs a, int PN) {
  __shared__ float dcs[MAX_CHUNK];
  __shared__ float red[THREADS / 32];
  __shared__ float tot[THREADS / 32];
  const int c = blockIdx.x, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, c0 = c * Q;
  const long long plane = (long long)a.batch * a.H * a.L;
  const float* pos = a.pos + (b * a.H + h) * a.L + c0;
  const long long bhc = (b * a.H + h) * a.nc + c;
  float dc = 0.f, m = 0.f;
  if (tid < Q) {
    dc = pos[tid] + pos[plane + tid];
    m = pos[2 * plane + tid];
  }
  const float msum = block_sum(m, red);
  const float* gc = a.g_out + bhc * PN;
  const float* sc = a.s_in + bhc * PN;
  float gs = 0.f;
  for (int e = tid; e < PN; e += THREADS) gs = fmaf(gc[e], sc[e], gs);
  gs = block_sum(gs, red);
  if (tid == Q - 1) dc += msum + a.decay[bhc] * gs;
  if (tid < Q) dcs[tid] = dc;
  __syncthreads();
  // the reverse inclusive scan: thread k takes token Q - 1 - k
  float v = tid < Q ? dcs[Q - 1 - tid] : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += tot[w];
  v += base;
  float pa = 0.f, pd = 0.f;
  if (tid < Q) {
    const int k = Q - 1 - tid;
    const long long t = c0 + k;
    a.ddt[(b * a.L + t) * a.H + h] = pos[3 * plane + k] + a.A[h] * v;
    pa = a.dt[b * a.dt_sb + t * a.dt_st + h] * v;
    pd = pos[4 * plane + k];
  }
  pa = block_sum(pa, red);
  pd = block_sum(pd, red);
  if (tid == 0) {
    a.part[(b * a.nc + c) * a.H + h] = pa;
    a.part[((long long)a.batch * a.nc + b * a.nc + c) * a.H + h] = pd;
  }
}

// 6. dB (blockIdx.y 0) and dC (1): a group's heads summed in order.
template <typename Tout>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_group_kernel(const BwdArgs a, int N) {
  const long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (e >= (long long)a.batch * a.L * a.G * N) return;
  const int col = static_cast<int>(e % N);
  const long long r = e / N;
  const int g = static_cast<int>(r % a.G);
  const long long bt = r / a.G;
  const int rep = a.H / a.G;
  const float* src = (blockIdx.y ? a.wdC : a.wdB)
                     + (bt * a.H + (long long)g * rep) * N + col;
  float s = 0.f;
  for (int k = 0; k < rep; ++k) s += src[(long long)k * N];
  store(static_cast<Tout*>(blockIdx.y ? a.dC : a.dB) + e, s);
}

// 7. dA and dD: the chunks' partial sums in (batch row, chunk) order.
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_param_kernel(const BwdArgs a) {
  const int h = blockIdx.x * THREADS + threadIdx.x;
  if (h >= a.H) return;
  const long long n = (long long)a.batch * a.nc;
  float sa = 0.f, sd = 0.f;
  for (long long k = 0; k < n; ++k) {
    sa += a.part[k * a.H + h];
    sd += a.part[(n + k) * a.H + h];
  }
  a.dA[h] = sa;
  a.dD[h] = sd;
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename Tin, int P, int N>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const size_t s1 = states_smem_floats<P, N>() * sizeof(float);
  const size_t s3 = query_smem_floats<P, N>() * sizeof(float);
  const size_t s4 = key_smem_floats<P, N>() * sizeof(float);
  static bool configured = false;     // once per template, per process
  if (!configured) {
    int e = allow_smem(ssd_bwd_states_kernel<Tin, P, N>, s1);
    if (!e) e = allow_smem(ssd_bwd_query_kernel<Tin, P, N>, s3);
    if (!e) e = allow_smem(ssd_bwd_key_kernel<Tin, P, N>, s4);
    if (e) return e;
    configured = true;
  }
  const int QT = (a.Q + TILE - 1) / TILE, PN = P * N;
  ssd_bwd_states_kernel<Tin, P, N>
      <<<dim3(a.nc, a.H, 2 * a.batch), THREADS, s1, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long states = (long long)a.batch * a.H * PN;
  ssd_bwd_pass_kernel<<<static_cast<unsigned>((states + THREADS - 1)
                                              / THREADS),
                        THREADS, 0, st>>>(a, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_query_kernel<Tin, P, N>
      <<<dim3(a.nc * QT, a.H, a.batch), THREADS, s3, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_key_kernel<Tin, P, N>
      <<<dim3(a.nc * QT, a.H, a.batch), THREADS, s4, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dt_kernel<<<dim3(a.nc, a.H, a.batch), THREADS, 0, st>>>(a, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)a.batch * a.L * a.G * N;
  ssd_bwd_group_kernel<Tin>
      <<<dim3(static_cast<unsigned>((rows + THREADS - 1) / THREADS), 2),
         THREADS, 0, st>>>(a, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_param_kernel<<<(a.H + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_bwd(const BwdArgs& a, int P, int N, cudaStream_t st) {
#define SSD_BWD_CASE(PP, NN) \
  if (P == PP && N == NN) return launch_bwd<Tin, PP, NN>(a, st);
  SSD_BWD_CASE(32, 32) SSD_BWD_CASE(32, 64) SSD_BWD_CASE(32, 128)
  SSD_BWD_CASE(64, 32) SSD_BWD_CASE(64, 64) SSD_BWD_CASE(64, 128)
  SSD_BWD_CASE(128, 128)
#undef SSD_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------ mma route ------------------------------ //
using ssd::MMA_MAX_SUB;
using ssd::split2;
using ssd::split_frag;
using ssd::stage_rows;
using ssd::sub_cumsum;

constexpr int MMA_STATES_THREADS = 128;  // 4 warps; a warp a 16-row m-tile
                                         // of the state above p 64
constexpr int MMA_PASS_THREADS = 256;    // a thread 4 state elements
constexpr int MMA_PASS_DEPTH = 8;        // chunk states in flight a thread
constexpr int MMA_MAIN_THREADS = MMA_MAX_SUB / 16 * 32;  // a warp 16 rows

struct MmaBwdArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* D;
  const float* s0;      // (b, h, p, n), 16-byte aligned, may be null
  const float* dy;      // (b, l, h, p) contiguous, 16-byte aligned
  const float* dfinal;  // (b, h, p, n), 16-byte aligned, may be null
  bf16* dx;             // (b, l, h, p) contiguous
  float* ddt;           // (b, l, h) contiguous
  float* dinit;         // (b, h, p, n), may be null
  // workspace
  float* own;           // (b, h, chunks, p, n): own states -> S_in (f32)
  float* into;          // (b, h, chunks, p, n): sum_i e^{c_i} dy_i C_i^T
  float* decay;         // (b, h, chunks): e^{c_Q}
  float* gdot;          // (b, h, chunks, p n / 128): <G, S_in> by warp
  float* wdB;           // (b, l, h, n): dB a head
  float* wdC;
  float* part;          // (2, b, chunks, h): dA, dD partial sums
  bf16* s_in2;          // (b, h, chunks, 2, p, n): S_in as hi, lo planes
  bf16* g2;             // (b, h, chunks, 2, p, n): G = dS_out as hi, lo
  int batch, L, Q, H, G, nc;
  bool vec;             // x, B and C staged 16 bytes a copy
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

// (1)'s threads: 4 warps, or one a 16-row m-tile of the state where p has
// more than 4 (p 128: 8 warps)
__host__ __device__ constexpr int bwd_states_threads(int P) {
  return P / 16 > 4 ? P / 16 * 32 : MMA_STATES_THREADS;
}

// Shared memory of (1): the column operand [Q][N + 8] (B or C), the row
// operand's hi and lo [Q][P + 8] (bf16), then dt, cum and the weights
template <int P, int N>
__host__ __device__ constexpr int bwd_states_smem(int Q) {
  return 2 * Q * (N + 8) + 4 * Q * (P + 8) + 12 * MMA_MAX_SUB;
}

// Shared memory of (3): C, B [Q][N + 8], x and dy's hi and lo [Q][P + 8]
// (bf16), the state region (S_in's hi and lo, then G's: 2 [P][N + 8]),
// then seven f32 rows of MMA_MAX_SUB (dt, cum, the query and the key
// halves of dc, x.dx^, dy.x, m)
template <int P, int N>
__host__ __device__ constexpr int bwd_main_smem(int Q) {
  return 2 * (2 * Q * (N + 8) + 3 * Q * (P + 8) + 2 * P * (N + 8)) +
         28 * MMA_MAX_SUB;
}

// the most shared memory a block may take, and (3)'s at the largest
// sub-chunk that fits it (64 at p 128)
constexpr int SMEM_LIMIT = 232448;
template <int P, int N>
__host__ __device__ constexpr int bwd_main_max_smem() {
  return bwd_main_smem<P, N>(MMA_MAX_SUB) <= SMEM_LIMIT
             ? bwd_main_smem<P, N>(MMA_MAX_SUB)
             : bwd_main_smem<P, N>(MMA_MAX_SUB / 2);
}

// s (16 x 8 NT) += (hi + lo) K^T for one 16-deep k-step: the split A
// operand against one K fragment (rows at kl, from attn::k_lane)
template <int NT, int STR>
__device__ __forceinline__ void qk_step2(float (&s)[NT][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const bf16* kl, int ks) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t kb[4];
    attn::ldsm_x4(kb, kl + np * 16 * STR + ks * 16);
    attn::mma_bf16(s[2 * np], ah, kb[0], kb[1]);
    attn::mma_bf16(s[2 * np + 1], ah, kb[2], kb[3]);
    attn::mma_bf16(s[2 * np], al, kb[0], kb[1]);
    attn::mma_bf16(s[2 * np + 1], al, kb[2], kb[3]);
  }
}

// o (16 x 8 NO) += a V over one 16-deep k-step of V's rows: vl is the
// lane's address in the step's first row, (lane % 16) rows down and
// (lane / 16) * 8 columns in (V is read transposed by ldmatrix)
template <int NO, int STR>
__device__ __forceinline__ void pv_step(float (&o)[NO][4],
                                        const uint32_t (&a)[4],
                                        const bf16* vl) {
#pragma unroll
  for (int dp = 0; dp < NO / 2; ++dp) {
    uint32_t vb[4];
    attn::ldsm_x4_t(vb, vl + dp * 16);
    attn::mma_bf16(o[2 * dp], a, vb[0], vb[1]);
    attn::mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
  }
}

// the same for a split A operand: o += (hi + lo) V, V's fragments loaded
// once
template <int NO, int STR>
__device__ __forceinline__ void pv_step2(float (&o)[NO][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const bf16* vl) {
#pragma unroll
  for (int dp = 0; dp < NO / 2; ++dp) {
    uint32_t vb[4];
    attn::ldsm_x4_t(vb, vl + dp * 16);
    attn::mma_bf16(o[2 * dp], ah, vb[0], vb[1]);
    attn::mma_bf16(o[2 * dp + 1], ah, vb[2], vb[3]);
    attn::mma_bf16(o[2 * dp], al, vb[0], vb[1]);
    attn::mma_bf16(o[2 * dp + 1], al, vb[2], vb[3]);
  }
}

// the sum over the 4 lanes of a quad (the lanes of one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// the sum over a warp of v, every lane getting it (a fixed tree)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (1) one block per (sub-chunk, head, batch row, side): side 0 the
// sub-chunk's own state sum_j (e^{c_Q - c_j} dt_j x_j)^T B_j and its
// decay e^{c_Q}, side 1 sum_i (e^{c_i} dy_i)^T C_i, each p x n (f32) into
// the workspace. The row operand (x w, or e^c dy) is f32: it enters as a
// split bf16 pair against B or C, which are exactly bf16 (two products).
// Warp (mt, nw) owns state rows 16 mt .. and columns nw N / WN ...
template <int P, int N>
__global__ void __launch_bounds__(bwd_states_threads(P))
    ssd_bwd_states_mma_kernel(const MmaBwdArgs a) {
  constexpr int SN = N + 8, SP = P + 8;
  constexpr int THREADS = bwd_states_threads(P);
  constexpr int WM = P / 16;
  constexpr int WN = THREADS / 32 / WM;
  constexpr int NT = N / 8 / WN;
  static_assert(WM * WN * 32 == THREADS && NT % 2 == 0,
                "the warps tile the state");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int Q = a.Q;
  bf16* cs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* rh = cs + Q * SN;
  bf16* rl = rh + Q * SP;
  float* dtv = reinterpret_cast<float*>(rl + Q * SP);
  float* cum = dtv + MMA_MAX_SUB;
  float* wv = cum + MMA_MAX_SUB;

  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const long long b = blockIdx.z >> 1;
  const bool side1 = (blockIdx.z & 1) != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = h / (a.H / a.G);
  const long long t0 = (long long)c * Q;

  ssd::pdl_trigger();  // (2) may be scheduled now; it waits for this grid
  if (side1) {
    stage_rows<N, SN>(cs, a.C + b * a.c_sb + t0 * a.c_st + g * a.c_sg,
                      a.c_st, Q, a.vec);
  } else {
    stage_rows<N, SN>(cs, a.B + b * a.b_sb + t0 * a.b_st + g * a.b_sg,
                      a.b_st, Q, a.vec);
    stage_rows<P, SP>(rh, a.x + b * a.x_sb + t0 * a.x_st + h * a.x_sh,
                      a.x_st, Q, a.vec);
  }
  attn::cp_async_commit();
  const float* dtb = a.dt + b * a.dt_sb + t0 * a.dt_st + h;
  for (int k = tid; k < Q; k += THREADS) dtv[k] = dtb[k * a.dt_st];
  __syncthreads();
  if (warp == 0) sub_cumsum(cum, dtv, a.A[h], Q, lane);
  __syncthreads();
  const float cend = cum[Q - 1];
  for (int k = tid; k < Q; k += THREADS)
    wv[k] = side1 ? expf(cum[k])
                  : __fmul_rn(expf(__fsub_rn(cend, cum[k])), dtv[k]);
  if (!side1 && tid == 0) a.decay[(b * a.H + h) * nc + c] = expf(cend);
  attn::cp_async_wait<0>();
  __syncthreads();
  if (side1) {  // e^{c_k} dy_k, split, from dy's f32 rows
    ssd::stage_split_f32<P, SP>(rh, rl,
                                a.dy + ((b * a.L + t0) * a.H + h) * P,
                                (long long)a.H * P, Q, wv);
  } else {  // x w, split in place: x's tile becomes hi
    for (int i = tid; i < Q * P; i += THREADS) {
      const int k = i / P, r = i % P;
      const float v = __fmul_rn(__bfloat162float(rh[k * SP + r]), wv[k]);
      const bf16 hi = __float2bfloat16_rn(v);
      rh[k * SP + r] = hi;
      rl[k * SP + r] =
          __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
    }
  }
  __syncthreads();

  const int mt = warp % WM, nw = warp / WM;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the row operand's fragment of rows 16 mt.., tokens 16 ks..: read
  // transposed from its [token][row] tile
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * SP +
                    ((lane >> 3) & 1) * 8 + mt * 16;
  const bf16* cl = cs + (lane & 15) * SN + (lane >> 4) * 8 + nw * (N / WN);
  for (int ks = 0; ks < Q / 16; ++ks) {
    uint32_t ah[4], al[4];
    attn::ldsm_x4_t(ah, rh + a_off + ks * 16 * SP);
    attn::ldsm_x4_t(al, rl + a_off + ks * 16 * SP);
    pv_step2<NT, SN>(acc, ah, al, cl + ks * 16 * SN);
  }
  float* out = (side1 ? a.into : a.own) +
               ((b * a.H + h) * nc + c) * (long long)(P * N);
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

// (2) the state passes: thread i owns 4 consecutive elements of one (batch
// row, head) state. The forward pass turns the own states into incoming
// states S_in (from the initial state or 0), written as split pairs for
// (3) and, in f32, over the own states; the reverse pass turns the sums
// of side 1 into each sub-chunk's G = dS_out (from the final state's
// gradient or 0), written as split pairs, and takes each sub-chunk's
// <G, S_in> over its warp (a fixed tree), one partial a warp; what is
// left is the initial state's gradient. MMA_PASS_DEPTH states are loaded
// ahead of each chain.
__global__ void __launch_bounds__(MMA_PASS_THREADS)
    ssd_bwd_pass_mma_kernel(const MmaBwdArgs a, int pn4) {
  ssd::pdl_trigger();  // (3) may be scheduled: its first half needs no state
  ssd::pdl_wait();     // every state of (1) is written
  const long long i = (long long)blockIdx.x * MMA_PASS_THREADS + threadIdx.x;
  if (i >= (long long)a.batch * a.H * pn4) return;  // whole warps
  const int nc = a.nc, lane = threadIdx.x & 31;
  const long long bh = i / pn4, e = i - bh * pn4;
  float4* own = reinterpret_cast<float4*>(a.own) + bh * nc * pn4 + e;
  const float4* into =
      reinterpret_cast<const float4*>(a.into) + bh * nc * pn4 + e;
  uint2* si = reinterpret_cast<uint2*>(a.s_in2) + bh * nc * 2 * pn4 + e;
  uint2* gi = reinterpret_cast<uint2*>(a.g2) + bh * nc * 2 * pn4 + e;
  const float* dc = a.decay + bh * nc;
  auto put = [&](uint2* dst, const float4& v) {
    uint2 hi, lo;
    split2(v.x, v.y, hi.x, lo.x);
    split2(v.z, v.w, hi.y, lo.y);
    dst[0] = hi;
    dst[pn4] = lo;
  };
  auto fma4 = [](float d, const float4& s, const float4& o) {
    return make_float4(__fmaf_rn(d, s.x, o.x), __fmaf_rn(d, s.y, o.y),
                       __fmaf_rn(d, s.z, o.z), __fmaf_rn(d, s.w, o.w));
  };
  float4 s = a.s0 != nullptr ? reinterpret_cast<const float4*>(a.s0)[i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += MMA_PASS_DEPTH) {
    float4 sc[MMA_PASS_DEPTH];
#pragma unroll
    for (int j = 0; j < MMA_PASS_DEPTH; ++j)
      if (c0 + j < nc) sc[j] = own[(long long)(c0 + j) * pn4];
#pragma unroll
    for (int j = 0; j < MMA_PASS_DEPTH; ++j)
      if (c0 + j < nc) {
        put(si + (long long)(c0 + j) * 2 * pn4, s);
        own[(long long)(c0 + j) * pn4] = s;
        s = fma4(dc[c0 + j], s, sc[j]);
      }
  }
  const int wp = pn4 / 32;
  const long long wq = e >> 5;
  float4 gs = a.dfinal != nullptr
                  ? reinterpret_cast<const float4*>(a.dfinal)[i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c1 = nc - 1; c1 >= 0; c1 -= MMA_PASS_DEPTH) {
    float4 in[MMA_PASS_DEPTH], sv[MMA_PASS_DEPTH];
#pragma unroll
    for (int j = 0; j < MMA_PASS_DEPTH; ++j)
      if (c1 - j >= 0) {
        in[j] = into[(long long)(c1 - j) * pn4];
        sv[j] = own[(long long)(c1 - j) * pn4];
      }
#pragma unroll
    for (int j = 0; j < MMA_PASS_DEPTH; ++j) {
      const int c = c1 - j;
      if (c >= 0) {  // uniform over the warp
        put(gi + (long long)c * 2 * pn4, gs);
        float dot = __fmul_rn(gs.x, sv[j].x);
        dot = __fmaf_rn(gs.y, sv[j].y, dot);
        dot = __fmaf_rn(gs.z, sv[j].z, dot);
        dot = __fmaf_rn(gs.w, sv[j].w, dot);
        dot = warp_sum(dot);
        if (lane == 0) a.gdot[(bh * nc + c) * wp + wq] = dot;
        gs = fma4(dc[c], gs, in[j]);
      }
    }
  }
  if (a.dinit != nullptr) reinterpret_cast<float4*>(a.dinit)[i] = gs;
}

// (3) one block per (sub-chunk, head, batch row), Q / 16 warps: warp w
// owns the sub-chunk's query rows i and key rows j in 16 w .. 16 w + 15.
//  Query side, over the key tiles kk <= w: s = C_i.B_j, yx = dy_i.x_j,
//  W_ij = e^{c_i - c_j} dt_j yx (j <= i), M = s W: dC_i = sum W_ij B_j,
//  the row sums of M; then, once (2) is done, e^{c_i} S_in^T dy_i into
//  dC_i and e^{c_i} C_i.(S_in^T dy_i) into dc_i.
//  Key side: e^{c_Q - c_j} G B_j into dx^_j (and m_j from it),
//  e^{c_Q - c_j} dt_j G^T x_j into dB_j; then over the query tiles qq >=
//  w: s^T, yx^T as above, dB_j += sum W_ij C_i, dx^_j += sum P_ij dy_i
//  with P = s e^{c_i - c_j}, and the column sums of M.
//  Then the sub-chunk's dc, its reverse cumulative sum, ddt, dx and the
//  block's partial sums of dA and dD.
// A tile's scores are computed once for each side: the key side needs
// them transposed across warps, which would cost 2 Q^2 f32 of shared
// memory or a barrier a tile with the triangle's later steps half idle;
// computing them again costs 32 of a tile pair's 152 products and gives
// every warp Q / 16 + 1 tiles.
template <int P, int N>
__global__ void __launch_bounds__(MMA_MAIN_THREADS, 1)
    ssd_bwd_mma_kernel(const MmaBwdArgs a) {
  constexpr int SN = N + 8, SP = P + 8;
  constexpr int NN = N / 8, NP = P / 8;  // n-tiles over n and over p
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int Q = a.Q, NW = Q >> 4;
  bf16* cs = reinterpret_cast<bf16*>(bwd_smem);  // C [Q][SN]
  bf16* bs = cs + Q * SN;                         // B [Q][SN]
  bf16* xs = bs + Q * SN;                         // x [Q][SP]
  bf16* yh = xs + Q * SP;                         // dy hi [Q][SP]
  bf16* yl = yh + Q * SP;                         // dy lo [Q][SP]
  bf16* sh = yl + Q * SP;                         // S_in, then G: hi
  bf16* sl = sh + P * SN;                         //                lo
  float* dtv = reinterpret_cast<float*>(sl + P * SN);
  float* cum = dtv + MMA_MAX_SUB;
  float* dq = cum + MMA_MAX_SUB;   // dc's query terms
  float* dk = dq + MMA_MAX_SUB;    // dc's key terms
  float* sx = dk + MMA_MAX_SUB;    // x_j.dx^_j
  float* sd = sx + MMA_MAX_SUB;    // dy_j.x_j
  float* mm = sd + MMA_MAX_SUB;    // m_j

  const int c = blockIdx.x, h = blockIdx.y, nc = gridDim.x;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = h / (a.H / a.G), tq = lane & 3;
  const long long t0 = (long long)c * Q, bhc = (b * a.H + h) * nc + c;
  const float* dyb = a.dy + ((b * a.L + t0) * a.H + h) * P;
  const long long dy_st = (long long)a.H * P;

  stage_rows<N, SN>(cs, a.C + b * a.c_sb + t0 * a.c_st + g * a.c_sg, a.c_st,
                    Q, a.vec);
  stage_rows<N, SN>(bs, a.B + b * a.b_sb + t0 * a.b_st + g * a.b_sg, a.b_st,
                    Q, a.vec);
  stage_rows<P, SP>(xs, a.x + b * a.x_sb + t0 * a.x_st + h * a.x_sh, a.x_st,
                    Q, a.vec);
  attn::cp_async_commit();
  const float* dtb = a.dt + b * a.dt_sb + t0 * a.dt_st + h;
  for (int k = tid; k < Q; k += blockDim.x) dtv[k] = dtb[k * a.dt_st];
  ssd::stage_split_f32<P, SP>(yh, yl, dyb, dy_st, Q, nullptr);
  __syncthreads();
  if (warp == 0) sub_cumsum(cum, dtv, a.A[h], Q, lane);
  attn::cp_async_wait<0>();
  __syncthreads();

  const int r0 = 16 * warp;               // the warp's rows (queries, keys)
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const float ca = cum[ra], cb = cum[rb];
  const bf16* cq = attn::q_lane<SN>(cs + r0 * SN, lane);   // C_i
  const bf16* yq = attn::q_lane<SP>(yh + r0 * SP, lane);   // dy_i hi
  const bf16* yq2 = attn::q_lane<SP>(yl + r0 * SP, lane);  // dy_i lo
  const int v_off = (lane & 15) * SN + (lane >> 4) * 8;    // V-like rows
  const int v_offp = (lane & 15) * SP + (lane >> 4) * 8;

  // ---- query side: the sub-chunk's own tokens (no state needed) ----
  float acc[NN][4];
  float rsa = 0.f, rsb = 0.f;  // row sums of M
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kk = 0; kk <= warp; ++kk) {
    float s[2][4], yx[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = yx[n][e] = 0.f;
    const bf16* kb = attn::k_lane<SN>(bs + kk * 16 * SN, lane);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t qa[4];
      attn::ldsm_x4(qa, cq + ks * 16);
      attn::qk_step<2, SN>(s, qa, kb, ks);
    }
    const bf16* xb = attn::k_lane<SP>(xs + kk * 16 * SP, lane);
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t ah[4], al[4];
      attn::ldsm_x4(ah, yq + ks * 16);
      attn::ldsm_x4(al, yq2 + ks * 16);
      qk_step2<2, SP>(yx, ah, al, xb, ks);
    }
    // W_ij = e^{c_i - c_j} dt_j yx_ij for j <= i (only the diagonal tile
    // masks); M_ij = s_ij W_ij
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ra : rb;
        const int j = kk * 16 + n * 8 + 2 * tq + (e & 1);
        float w = 0.f;
        if (j <= i) {
          w = __fmul_rn(__fmul_rn(expf(__fsub_rn(e < 2 ? ca : cb, cum[j])),
                                  dtv[j]),
                        yx[n][e]);
          const float m = __fmul_rn(s[n][e], w);
          if (e < 2)
            rsa = __fadd_rn(rsa, m);
          else
            rsb = __fadd_rn(rsb, m);
        }
        s[n][e] = w;
      }
    uint32_t wh[4], wl[4];
    split_frag(s, wh, wl);
    pv_step2<NN, SN>(acc, wh, wl, bs + kk * 16 * SN + v_off);
  }
  rsa = quad_sum(rsa);
  rsb = quad_sum(rsb);

  // ---- query side: the incoming state, once (2) is done ----
  ssd::pdl_wait();
  const bf16* sp = a.s_in2 + bhc * (long long)(2 * P * N);
  stage_rows<N, SN>(sh, sp, N, P, true);
  stage_rows<N, SN>(sl, sp + P * N, N, P, true);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();
  {
    float v[NN][4];  // S_in^T dy_i = dy_i S_in: 3 products of split pairs
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t ah[4], al[4];
      attn::ldsm_x4(ah, yq + ks * 16);
      attn::ldsm_x4(al, yq2 + ks * 16);
      pv_step2<NN, SN>(v, ah, al, sh + ks * 16 * SN + v_off);
      pv_step<NN, SN>(v, ah, sl + ks * 16 * SN + v_off);
    }
    const float ea = expf(ca), eb = expf(cb);
    float da = 0.f, db = 0.f;  // e^{c_i} C_i.(S_in^T dy_i)
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * tq;
      const float2 cA = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(cs + ra * SN + col));
      const float2 cB = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(cs + rb * SN + col));
      v[n][0] = __fmul_rn(ea, v[n][0]);
      v[n][1] = __fmul_rn(ea, v[n][1]);
      v[n][2] = __fmul_rn(eb, v[n][2]);
      v[n][3] = __fmul_rn(eb, v[n][3]);
      da = __fmaf_rn(cA.x, v[n][0], __fmaf_rn(cA.y, v[n][1], da));
      db = __fmaf_rn(cB.x, v[n][2], __fmaf_rn(cB.y, v[n][3], db));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], v[n][e]);
    }
    da = quad_sum(da);
    db = quad_sum(db);
    if (tq == 0) {
      dq[ra] = __fadd_rn(rsa, da);
      dq[rb] = __fadd_rn(rsb, db);
    }
  }
  {
    float* wa = a.wdC + ((b * a.L + t0 + ra) * a.H + h) * N;
    float* wb = wa + 8LL * a.H * N;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(wa + col) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(wb + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();  // S_in is read: G takes its place
  const bf16* gp = a.g2 + bhc * (long long)(2 * P * N);
  stage_rows<N, SN>(sh, gp, N, P, true);
  stage_rows<N, SN>(sl, gp + P * N, N, P, true);
  attn::cp_async_commit();
  attn::cp_async_wait<0>();
  __syncthreads();

  // ---- key side: the outgoing state's terms ----
  const float cend = cum[Q - 1];
  const float fa = expf(__fsub_rn(cend, ca)), fb = expf(__fsub_rn(cend, cb));
  const float dta = dtv[ra], dtb2 = dtv[rb];
  const bf16* bq = attn::q_lane<SN>(bs + r0 * SN, lane);  // B_j
  const bf16* xq = attn::q_lane<SP>(xs + r0 * SP, lane);  // x_j
  float dxa[NP][4];  // dx^_j
  float ma, mb;      // m_j = e^{c_Q - c_j} dt_j x_j.(G B_j)
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[n][e] = 0.f;
  {
    const bf16* gk = attn::k_lane<SN>(sh, lane);
    const bf16* gk2 = attn::k_lane<SN>(sl, lane);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ba[4];
      attn::ldsm_x4(ba, bq + ks * 16);
      attn::qk_step<NP, SN>(dxa, ba, gk, ks);
      attn::qk_step<NP, SN>(dxa, ba, gk2, ks);
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int col = n * 8 + 2 * tq;
      const float2 xA = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + ra * SP + col));
      const float2 xB = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + rb * SP + col));
      dxa[n][0] = __fmul_rn(fa, dxa[n][0]);
      dxa[n][1] = __fmul_rn(fa, dxa[n][1]);
      dxa[n][2] = __fmul_rn(fb, dxa[n][2]);
      dxa[n][3] = __fmul_rn(fb, dxa[n][3]);
      pa = __fmaf_rn(xA.x, dxa[n][0], __fmaf_rn(xA.y, dxa[n][1], pa));
      pb = __fmaf_rn(xB.x, dxa[n][2], __fmaf_rn(xB.y, dxa[n][3], pb));
    }
    ma = __fmul_rn(dta, quad_sum(pa));
    mb = __fmul_rn(dtb2, quad_sum(pb));
  }
  float dba[NN][4];  // dB_j
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dba[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < P / 16; ++ks) {
    uint32_t xa[4];
    attn::ldsm_x4(xa, xq + ks * 16);
    pv_step<NN, SN>(dba, xa, sh + ks * 16 * SN + v_off);
    pv_step<NN, SN>(dba, xa, sl + ks * 16 * SN + v_off);
  }
  {
    const float ua = __fmul_rn(fa, dta), ub = __fmul_rn(fb, dtb2);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      dba[n][0] = __fmul_rn(ua, dba[n][0]);
      dba[n][1] = __fmul_rn(ua, dba[n][1]);
      dba[n][2] = __fmul_rn(ub, dba[n][2]);
      dba[n][3] = __fmul_rn(ub, dba[n][3]);
    }
  }

  // ---- key side: the sub-chunk's own tokens, query tiles qq >= w ----
  float csa = 0.f, csb = 0.f;  // column sums of M
  for (int qq = warp; qq < NW; ++qq) {
    float s[2][4], yx[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = yx[n][e] = 0.f;
    const bf16* ck = attn::k_lane<SN>(cs + qq * 16 * SN, lane);
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ba[4];
      attn::ldsm_x4(ba, bq + ks * 16);
      attn::qk_step<2, SN>(s, ba, ck, ks);
    }
    const bf16* yk = attn::k_lane<SP>(yh + qq * 16 * SP, lane);
    const bf16* yk2 = attn::k_lane<SP>(yl + qq * 16 * SP, lane);
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t xa[4];
      attn::ldsm_x4(xa, xq + ks * 16);
      attn::qk_step<2, SP>(yx, xa, yk, ks);
      attn::qk_step<2, SP>(yx, xa, yk2, ks);
    }
    // rows j (keys), columns i (queries): W^T, and P^T = s^T e^{c_i - c_j}
    float pt[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? ra : rb;
        const int i = qq * 16 + n * 8 + 2 * tq + (e & 1);
        float w = 0.f, p = 0.f;
        if (i >= j) {
          const float E = expf(__fsub_rn(cum[i], e < 2 ? ca : cb));
          w = __fmul_rn(__fmul_rn(E, e < 2 ? dta : dtb2), yx[n][e]);
          p = __fmul_rn(s[n][e], E);
          const float m = __fmul_rn(s[n][e], w);
          if (e < 2)
            csa = __fadd_rn(csa, m);
          else
            csb = __fadd_rn(csb, m);
        }
        s[n][e] = w;
        pt[n][e] = p;
      }
    uint32_t wh[4], wl[4], ph[4], pl[4];
    split_frag(s, wh, wl);
    split_frag(pt, ph, pl);
    pv_step2<NN, SN>(dba, wh, wl, cs + qq * 16 * SN + v_off);
    pv_step2<NP, SP>(dxa, ph, pl, yh + qq * 16 * SP + v_offp);
    pv_step<NP, SP>(dxa, ph, yl + qq * 16 * SP + v_offp);
  }
  csa = quad_sum(csa);
  csb = quad_sum(csb);

  // ---- key side: dx, dB a head, the keys' sums ----
  {
    const float Dh = a.D[h];
    float* wa = a.wdB + ((b * a.L + t0 + ra) * a.H + h) * N;
    float* wb = wa + 8LL * a.H * N;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(wa + col) =
          make_float2(dba[n][0], dba[n][1]);
      *reinterpret_cast<float2*>(wb + col) =
          make_float2(dba[n][2], dba[n][3]);
    }
    const float* ya = dyb + ra * dy_st;
    const float* yb = dyb + rb * dy_st;
    bf16* oa = a.dx + ((b * a.L + t0 + ra) * a.H + h) * P;
    bf16* ob = oa + 8LL * a.H * P;
    float xda = 0.f, xdb = 0.f, yxa = 0.f, yxb = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int col = n * 8 + 2 * tq;
      const float2 xA = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + ra * SP + col));
      const float2 xB = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + rb * SP + col));
      const float2 gA = *reinterpret_cast<const float2*>(ya + col);
      const float2 gB = *reinterpret_cast<const float2*>(yb + col);
      *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
          __fmaf_rn(dta, dxa[n][0], __fmul_rn(Dh, gA.x)),
          __fmaf_rn(dta, dxa[n][1], __fmul_rn(Dh, gA.y)));
      *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
          __fmaf_rn(dtb2, dxa[n][2], __fmul_rn(Dh, gB.x)),
          __fmaf_rn(dtb2, dxa[n][3], __fmul_rn(Dh, gB.y)));
      xda = __fmaf_rn(xA.x, dxa[n][0], __fmaf_rn(xA.y, dxa[n][1], xda));
      xdb = __fmaf_rn(xB.x, dxa[n][2], __fmaf_rn(xB.y, dxa[n][3], xdb));
      yxa = __fmaf_rn(gA.x, xA.x, __fmaf_rn(gA.y, xA.y, yxa));
      yxb = __fmaf_rn(gB.x, xB.x, __fmaf_rn(gB.y, xB.y, yxb));
    }
    xda = quad_sum(xda);
    xdb = quad_sum(xdb);
    yxa = quad_sum(yxa);
    yxb = quad_sum(yxb);
    if (tq == 0) {
      dk[ra] = -__fadd_rn(csa, ma);
      dk[rb] = -__fadd_rn(csb, mb);
      sx[ra] = xda;
      sx[rb] = xdb;
      sd[ra] = yxa;
      sd[rb] = yxb;
      mm[ra] = ma;
      mm[rb] = mb;
    }
  }
  __syncthreads();

  // ---- the sub-chunk: dc, its reverse cumulative sum, ddt, dA, dD ----
  if (warp == 0) {
    constexpr int MAXPER = MMA_MAX_SUB / 32;
    const int per = (Q + 31) >> 5;
    // sum_j m_j and <G, S_in> (the pass's warp partials): fixed trees
    float msum = 0.f, gsum = 0.f;
#pragma unroll
    for (int k = 0; k < MAXPER; ++k) {
      const int r = lane * per + k;
      if (k < per && r < Q) msum = __fadd_rn(msum, mm[r]);
    }
    const int wp = P * N / 128;
    for (int k = lane; k < wp; k += 32)
      gsum = __fadd_rn(gsum, a.gdot[bhc * wp + k]);
    msum = warp_sum(msum);
    gsum = warp_sum(gsum);
    const float extra = __fmaf_rn(expf(cend), gsum, msum);
    // lane l takes tokens Q - 1 - (l per + k): the reverse inclusive sum
    float v[MAXPER], run = 0.f;
#pragma unroll
    for (int k = 0; k < MAXPER; ++k) {
      const int r = lane * per + k, t = Q - 1 - r;
      if (k < per && r < Q) {
        float d = __fadd_rn(dq[t], dk[t]);
        if (r == 0) d = __fadd_rn(d, extra);
        run = __fadd_rn(run, d);
      }
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, u);
    }
    float base = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) base = 0.f;
    const float Ah = a.A[h];
    float pa = 0.f, pd = 0.f;
#pragma unroll
    for (int k = 0; k < MAXPER; ++k) {
      const int r = lane * per + k, t = Q - 1 - r;
      if (k < per && r < Q) {
        const float da = __fadd_rn(base, v[k]);
        a.ddt[(b * a.L + t0 + t) * a.H + h] = __fmaf_rn(Ah, da, sx[t]);
        pa = __fmaf_rn(dtv[t], da, pa);
        pd = __fadd_rn(pd, sd[t]);
      }
    }
    pa = warp_sum(pa);
    pd = warp_sum(pd);
    if (lane == 0) {
      a.part[(b * nc + c) * a.H + h] = pa;
      a.part[((long long)a.batch * nc + b * nc + c) * a.H + h] = pd;
    }
  }
}

template <int P, int N>
int launch_bwd_mma(const MmaBwdArgs& a, const BwdArgs& ga, cudaStream_t st) {
  auto k1 = ssd_bwd_states_mma_kernel<P, N>;
  auto k3 = ssd_bwd_mma_kernel<P, N>;
  static bool configured = false;     // once per template, per process
  if (!configured) {
    int e = allow_smem(k1, bwd_states_smem<P, N>(MMA_MAX_SUB));
    if (!e) e = allow_smem(k3, bwd_main_max_smem<P, N>());
    if (e) return e;
    configured = true;
  }
  const int nc = a.nc;
  k1<<<dim3(nc, a.H, 2 * a.batch), bwd_states_threads(P),
       bwd_states_smem<P, N>(a.Q), st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pn4 = P * N / 4;
  const long long total4 = (long long)a.batch * a.H * pn4;
  e = ssd::launch_pdl(ssd_bwd_pass_mma_kernel,
                      dim3(static_cast<unsigned>(
                          (total4 + MMA_PASS_THREADS - 1) / MMA_PASS_THREADS)),
                      MMA_PASS_THREADS, 0, st, a, pn4);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = ssd::launch_pdl(k3, dim3(nc, a.H, a.batch), a.Q / 16 * 32,
                      bwd_main_smem<P, N>(a.Q), st, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)a.batch * a.L * a.G * N;
  ssd_bwd_group_kernel<bf16>
      <<<dim3(static_cast<unsigned>((rows + THREADS - 1) / THREADS), 2),
         THREADS, 0, st>>>(ga, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_param_kernel<<<(a.H + THREADS - 1) / THREADS, THREADS, 0, st>>>(ga);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of ssd_chunk_launch / ssd_chunk_mma_launch (the same
// function whatever the route or the chunk the forward ran). x, B, C of
// dtype (0 float, 1 bf16) with the forward's strides (x (b, l, h, p), B
// and C (b, l, g, n), the last dimension contiguous); dt (b, l, h) f32
// with strides dt_sb, dt_st (heads contiguous); A, D (h,) f32; s0 the
// initial state and dfinal the final state's gradient, (b, h, p, n) f32
// contiguous, either may be null; dy (b, l, h, p) f32 contiguous.
// Outputs, contiguous: dx (b, l, h, p) in x's type, ddt (b, l, h) f32, dB
// and dC (b, l, g, n) in B's type, dA and dD (h,) f32, dinit (b, h, p, n)
// f32 (may be null). Workspace (f32, from the wrapper's bwd_workspace):
// s_in and g_out (b, h, l / chunk, p, n), decay (b, h, l / chunk), pos (5,
// b, h, l), wdB and wdC (b, l, h, n), part (2, b, l / chunk, h). Returns
// the first cudaGetLastError() that is not 0 after the seven launches.
extern "C" int ssd_bwd_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const float* D, const float* s0, const float* dy,
    const float* dfinal, void* dx, float* ddt, void* dB, void* dC,
    float* dA, float* dD, float* dinit, float* s_in, float* g_out,
    float* decay, float* pos, float* wdB, float* wdC, float* part,
    int batch, int L, int chunk, int H, int G, int P, int N, int dtype,
    long long x_sb, long long x_st, long long x_sh, long long dt_sb,
    long long dt_st, long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg, void* stream) {
  if (batch <= 0 || L <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      L % chunk || H <= 0 || G <= 0 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dt, A, B, C, D, s0, dy, dfinal, dx, ddt, dB, dC, dA,
                  dD, dinit, s_in, g_out, decay, pos, wdB, wdC, part,
                  batch, L, chunk, H, G, L / chunk,
                  x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
                  c_sb, c_st, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch_bwd<bf16>(a, P, N, st);
  if (dtype == 0) return dispatch_bwd<float>(a, P, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward on the mma route (bf16 x, B, C; sub-chunks of Q tokens, a
// multiple of 16 up to 128 dividing L whose main kernel's shared memory
// fits, from the wrapper's bwd_plan): the same inputs and outputs as
// ssd_bwd_launch, x, B, C, dx, dB and dC bf16, x, B and C 16-byte
// aligned where `vec`; dy, s0 and dfinal 16-byte aligned. Workspace, f32
// (from the wrapper's bwd_mma_workspace): own and into (b, h, L / Q, p,
// n), wdB and wdC (b, L, h, n), decay (b, h, L / Q), gdot (b, h, L / Q,
// p n / 128), part (2, b, L / Q, h); bf16: s_in2 and g2 (b, h, L / Q,
// 2, p, n). Five launches: (1) the sub-chunks' states, (2) the state
// passes and (3) the main kernel (both programmatic dependents), then
// the group and parameter sums. Returns the first error after them.
extern "C" int ssd_bwd_mma_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const float* D, const float* s0, const float* dy,
    const float* dfinal, void* dx, float* ddt, void* dB, void* dC,
    float* dA, float* dD, float* dinit, float* own, float* into,
    float* wdB, float* wdC, float* decay, float* gdot, float* part,
    void* s_in2, void* g2, int batch, int L, int Q, int H, int G, int P,
    int N, long long x_sb, long long x_st, long long x_sh, long long dt_sb,
    long long dt_st, long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg, void* stream) {
  if (batch <= 0 || L <= 0 || Q < 16 || Q > MMA_MAX_SUB || Q % 16 ||
      L % Q || H <= 0 || G <= 0 || H % G ||
      (((uintptr_t)dy | (uintptr_t)s0 | (uintptr_t)dfinal) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      ((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) % 16 == 0 &&
      (x_sb | x_st | x_sh | b_sb | b_st | b_sg | c_sb | c_st | c_sg) % 8 == 0;
  const MmaBwdArgs a{static_cast<const bf16*>(x), dt, A,
                     static_cast<const bf16*>(B),
                     static_cast<const bf16*>(C), D, s0, dy, dfinal,
                     static_cast<bf16*>(dx), ddt, dinit, own, into, decay,
                     gdot, wdB, wdC, part, static_cast<bf16*>(s_in2),
                     static_cast<bf16*>(g2), batch, L, Q, H, G, L / Q, vec,
                     x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
                     c_sb, c_st, c_sg};
  // the group and parameter sums read these fields of the simt route's
  const BwdArgs ga{x, dt, A, B, C, D, s0, dy, dfinal, dx, ddt, dB, dC, dA,
                   dD, dinit, nullptr, nullptr, decay, nullptr, wdB, wdC,
                   part, batch, L, Q, H, G, L / Q,
                   x_sb, x_st, x_sh, dt_sb, dt_st, b_sb, b_st, b_sg,
                   c_sb, c_st, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_BWD_MMA_CASE(PP, NN)                           \
  if (P == PP && N == NN) {                                \
    if (bwd_main_smem<PP, NN>(Q) > SMEM_LIMIT)             \
      return static_cast<int>(cudaErrorInvalidValue);      \
    return launch_bwd_mma<PP, NN>(a, ga, st);              \
  }
  SSD_BWD_MMA_CASE(32, 32) SSD_BWD_MMA_CASE(32, 64) SSD_BWD_MMA_CASE(32, 128)
  SSD_BWD_MMA_CASE(64, 32) SSD_BWD_MMA_CASE(64, 64) SSD_BWD_MMA_CASE(64, 128)
  SSD_BWD_MMA_CASE(128, 128)
#undef SSD_BWD_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
