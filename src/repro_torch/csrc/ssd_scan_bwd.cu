// The backward of the Mamba-2 SSD dual form, hand-written for Hopper:
// seven launches, no atomics.
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
// Launches (a simple design, a right kernel first: f32 on the CUDA
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
// Each block owns what it writes and every sum runs in a fixed order, so
// the gradients are the same bits launch after launch.
//
// What bounds it on this card: the operations. At mamba2-780m's train
// shape (b 4, l 1024, h 48, p 64, n 128, chunk 256) the intra-chunk
// products are 2 (2 n + p) flops a live (i, j) pair and head in each of
// kernels 3 and 4 (one product fewer of n in 3, one more of p in 4) and
// the state products 2 p n a token and head in each of 1 (two sides), 3
// and 4. This design runs them on the CUDA cores (67 TFLOP/s f32) with
// two shared-memory reads a pair of FMAs, over tiles that also compute
// the masked half of the diagonal tiles; the tensor-core redesign on the
// forward's split-bf16 mma.sync products is ROADMAP section 2's later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
