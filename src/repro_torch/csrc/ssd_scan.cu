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
// token. One block per (batch row, head, 32 state rows) holds its rows
// of the (p, n) state in registers for the whole token loop (2 blocks
// per head at p 64): 8 warps own 4 rows each, a lane owns n/32 columns,
// so at n 128 a thread keeps 16 floats. Tiles of 16 tokens' x, B, C and
// dt are staged in shared memory, so the loop pays one global round trip
// per tile, not per token. A warp's 4 row sums y_r over n are reduced
// together by a transposed butterfly (6 shuffles, not 4 x 5), which
// shortens each token's dependent chain. The state is read once and
// written once (in place when the caller passes the same buffer: each
// block reads all of its rows before it writes any), and the incoming
// state is written to the checkpoint buffer on the way (the cache's
// ssm_ckpt leaf), so the engine pays no separate copy.
// Exactness: the arithmetic of a token is the same whatever T is and
// where a tile starts (explicit _rn intrinsics, so no contraction choice
// of the compiler can differ between two call sites), so extending by t1
// then t2 tokens gives the bits of extending by t1 + t2, and the T = 1
// launch is the single decode step. A token with dt = 0 is an identity
// step: expf(-0.0f) is exactly 1 without --use_fast_math (this file is
// built without it) and the update adds a signed zero.
// What bounds it: at decode (T = 1, b = 8) the bytes of the state, read
// once and written twice (state and checkpoint): 37.7 MB at h 48, p 64,
// n 128, 11 us at 3.35 TB/s. At a chunk (b = 1, T = 128) the 96 blocks
// walk 128 dependent steps each, so latency, not the 0.25 GFLOP, bounds
// it.
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

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// --------------------------------------------------------------------- //
// ssd_extend
// --------------------------------------------------------------------- //
constexpr int EXT_WARPS = 8;
constexpr int EXT_THREADS = EXT_WARPS * 32;
constexpr int EXT_RPW = 4;                     // state rows per warp
constexpr int EXT_ROWS = EXT_WARPS * EXT_RPW;  // state rows per block
constexpr int EXT_TT = 16;                     // tokens staged per tile

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
  int T, H, G, P;
  long long s_in_sb, s_out_sb, ckpt_sb;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

// The sums over the warp of its RPW row partials v[] by a transposed
// butterfly: each halving step swaps half of the rows with the partner
// lane (RPW/2 + RPW/4 + ... shuffles), then the lanes that hold the same
// row finish with a plain butterfly. Returns the total of row *row (all
// lanes of a row group get the same bits); the same arithmetic on every
// call.
template <int RPW>
__device__ __forceinline__ float warp_row_sums(float (&v)[RPW], int lane,
                                               int* row) {
  int m = 16, sel = 0;
#pragma unroll
  for (int half = RPW / 2; half >= 1; half >>= 1) {
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = up ? v[k] : v[k + half];
      const float keep = up ? v[k + half] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, m));
    }
    if (up) sel += half;
    m >>= 1;
  }
#pragma unroll
  for (; m >= 1; m >>= 1)
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], m));
  *row = sel;
  return v[0];
}

// A block owns EXT_ROWS rows of one (batch row, head) state (blockIdx.z
// picks which); NPL columns per lane (n = 32 * NPL).
template <int NPL>
__global__ void __launch_bounds__(EXT_THREADS)
    ssd_extend_kernel(const ExtArgs a) {
  constexpr int N = 32 * NPL;
  __shared__ float xs[EXT_TT][EXT_ROWS];
  __shared__ float bs[EXT_TT][N];
  __shared__ float cs[EXT_TT][N];
  __shared__ float dts[EXT_TT];

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.z * EXT_ROWS;  // the block's first state row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = h / (a.H / a.G);
  const float Ah = a.A[h];
  const float Dh = a.D[h];
  const long long soff = ((long long)h * a.P + r0) * N;

  float s[EXT_RPW][NPL];
  const float* sp = a.s_in + b * a.s_in_sb + soff;
#pragma unroll
  for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      s[i][j] = sp[(warp + EXT_WARPS * i) * N + lane + 32 * j];
  if (a.ckpt != nullptr) {
    float* cp = a.ckpt + b * a.ckpt_sb + soff;
#pragma unroll
    for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        cp[(warp + EXT_WARPS * i) * N + lane + 32 * j] = s[i][j];
  }

  const float* xb = a.x + b * a.x_sb + (long long)h * a.x_sh + r0;
  const float* dtb = a.dt + b * a.dt_sb + h;
  const float* Bb = a.B + b * a.b_sb + (long long)g * a.b_sg;
  const float* Cb = a.C + b * a.c_sb + (long long)g * a.c_sg;
  float* yb = a.y + (b * a.T * a.H + h) * a.P + r0;

  for (int t0 = 0; t0 < a.T; t0 += EXT_TT) {
    const int nt = min(EXT_TT, a.T - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < nt * EXT_ROWS; idx += EXT_THREADS) {
      const int tt = idx / EXT_ROWS, r = idx % EXT_ROWS;
      xs[tt][r] = xb[(t0 + tt) * a.x_st + r];
    }
    for (int idx = threadIdx.x; idx < nt * N; idx += EXT_THREADS) {
      const int tt = idx / N, c = idx % N;
      bs[tt][c] = Bb[(t0 + tt) * a.b_st + c];
      cs[tt][c] = Cb[(t0 + tt) * a.c_st + c];
    }
    if (threadIdx.x < nt) dts[threadIdx.x] = dtb[(t0 + threadIdx.x) * a.dt_st];
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float d = dts[tt];
      const float dA = expf(__fmul_rn(d, Ah));
      float bv[NPL], cv[NPL], part[EXT_RPW];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        bv[j] = bs[tt][lane + 32 * j];
        cv[j] = cs[tt][lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < EXT_RPW; ++i) {
        const float xdt = __fmul_rn(xs[tt][warp + EXT_WARPS * i], d);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          s[i][j] = __fmaf_rn(xdt, bv[j], __fmul_rn(s[i][j], dA));
          acc = __fmaf_rn(s[i][j], cv[j], acc);
        }
        part[i] = acc;
      }
      int i;
      const float tot = warp_row_sums<EXT_RPW>(part, lane, &i);
      if ((lane & (32 / EXT_RPW - 1)) == 0) {  // one lane per row
        const int r = warp + EXT_WARPS * i;
        yb[(long long)(t0 + tt) * a.H * a.P + r] =
            __fmaf_rn(Dh, xs[tt][r], tot);
      }
    }
  }

  float* op = a.s_out + b * a.s_out_sb + soff;
#pragma unroll
  for (int i = 0; i < EXT_RPW; ++i)
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      op[(warp + EXT_WARPS * i) * N + lane + 32 * j] = s[i][j];
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
// {32, 64}, n in {32, 64, 128}; every buffer f32. Returns a cudaError_t,
// or -1 for a shape without an instance.
int ssd_extend_launch(const void* s_in, void* s_out, void* ckpt,
                      const void* x, const void* dt, const void* A,
                      const void* B, const void* C, const void* D, void* y,
                      int batch, int T, int H, int G, int P, int N,
                      long long s_in_sb, long long s_out_sb,
                      long long ckpt_sb, long long x_sb, long long x_st,
                      long long x_sh, long long dt_sb, long long dt_st,
                      long long b_sb, long long b_st, long long b_sg,
                      long long c_sb, long long c_st, long long c_sg,
                      void* stream) {
  if (P % EXT_ROWS || P > 2 * EXT_ROWS) return -1;
  ExtArgs a{(const float*)s_in, (float*)s_out, (float*)ckpt,
            (const float*)x, (const float*)dt, (const float*)A,
            (const float*)B, (const float*)C, (const float*)D, (float*)y,
            T, H, G, P, s_in_sb, s_out_sb, ckpt_sb, x_sb, x_st, x_sh,
            dt_sb, dt_st, b_sb, b_st, b_sg, c_sb, c_st, c_sg};
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(H, batch, P / EXT_ROWS);
#define EXT_CASE(NN)                                            \
  if (N == NN) {                                                \
    ssd_extend_kernel<NN / 32><<<grid, EXT_THREADS, 0, s>>>(a); \
    return (int)cudaGetLastError();                             \
  }
  EXT_CASE(32) EXT_CASE(64) EXT_CASE(128)
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
