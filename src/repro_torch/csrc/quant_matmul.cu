// Fused dequantize-matmul for int8 and int4 weights, hand-written for
// Hopper.
//
// Replaces: src/repro/kernels/quant_matmul/kernel.py,
//   quant_matmul_int8_pallas (body _qmm_int8_kernel) and
//   quant_matmul_int4_pallas (body _qmm_int4_kernel), the Pallas TPU
//   kernels behind every quantized projection (models/layers.linear with
//   a QTensor weight: the edge profile's int4 weights, --quant int8).
//
// What it computes (exactly the plain versions in
// kernels/quant_matmul/ref.py, up to the order of the f32 sums):
//   int8: y[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
//         q (K, N) int8 row-major, scale (N,) f32: the per-channel scale
//         is applied to the f32 accumulator in the epilogue.
//   int4: y[m, n] = sum_k x[m, k] * (q(k, n) * scale[k / gs, n])
//         q4 (K/2, N) int8 row-major, byte i of a column holding row 2i
//         in its low nibble and row 2i+1 in its high one, each a signed
//         4-bit value ((nibble ^ 8) - 8, the sign extension of the JAX
//         package's (p << 28) >> 28); scale (K/gs, N) f32 applied per
//         group before accumulation. The group of every unpacked row is
//         row / gs, so an odd gs (17 for K = 34), whose groups split a
//         byte's two rows, is handled like any other.
// x is (M, K) in float32 or bfloat16 with a row stride (bfloat16 rows
// on 4-byte boundaries); the product accumulates in f32 and y (M, N) is
// written contiguous in x's type. Any M, N, K and gs: every edge is
// masked here, where the Pallas kernel asserted M and N divisible by its
// tiles.
//
// What bounds it: at decode (M = 8) the weight bytes. llama3.2-1b's
// (K, N) = (2048, 8192) projection moves 16.8 MB in int8 (>= 5.07 us at
// 3.35 TB/s) and 10.6 MB in int4 with its scales (>= 3.18 us), against
// 0.27 GFLOP. At the admitting chunk (M = 128) int4 is bound by its 4.3
// GFLOP (>= 4.34 us at 989 TFLOP/s), int8 still by its bytes (>= 5.80 us).
//
// Two routes; kernels/quant_matmul/kernel.py's mma_plan picks one from
// the bits, the shapes and the dtype alone.
//
// simt (fp32 x; int4 under a group that is not a multiple of 16; an N
// that is not a multiple of 4; int8 under a K that is not a multiple of
// 8). A block of 128 threads owns a tile
// of 8 rows of x by 128 columns of y and a range of K (the split); two
// blocks fit an SM. Each thread owns 16 adjacent columns and a run of 8
// (int8) or 16 (int4) unpacked rows of every K tile. The K tiles stream
// through a ring of 4 shared-memory stages filled by cp.async (16-byte
// copies of weight rows, 4-byte copies of x); a thread copies exactly
// the weight bytes it later reads. Weights
// are unpacked in registers with byte permutes into the float bit pattern
// of 2^23 + value (one permute and one add a value), scaled (int4) and
// multiplied on the CUDA cores in f32. The 16 partial sums of a column
// are reduced with shuffles inside each warp, then across the 4 warps in
// shared memory. With 128 columns a tile, N = 512 gives 4 column tiles,
// so the wrapper (plan) splits K until about 528 blocks run; a split
// writes f32 partial sums to a workspace and qmm_finalize adds the
// splits in order, applies the int8 scale and casts.
//
// mma (bf16 x: int4 with gs a multiple of 16, int8): qmm_mma_kernel, on
// the tensor cores. Every int8 value and every nibble is exact in bf16,
// and a product of two bf16 values is exact in f32, so mma.sync m16n8k16
// over bf16 weights and bf16 x with f32 accumulators computes the plain
// version's formula itself; only the order of the f32 sums differs.
// int4: y = sum_g (x_g @ q_g) * s_g, each group's contraction in a fresh
// fragment, multiplied by its f32 scale and added to the running f32
// sum. int8: y = (x @ q) * s, one running f32 sum over all of K, scaled
// per column in the epilogue after the splits are added. The weights
// are never rounded with their scales. The product runs transposed,
// y^T = W^T x^T: the weights are the A operand (16 output columns a
// m-tile) and x the B operand (8 rows of x an n-tile), so decode's 8
// rows fill every product. A block of 4 warps owns 8 NT rows of x (NT 1
// for decode's M <= 8, else 4) by 128 columns, a warp 32 columns as 2
// m-tiles. K tiles of 64 rows (int4: 32 packed bytes a column, and their
// scale rows; int8: 64 bytes) and the x tile stream through a ring of 4
// cp.async stages; each thread's copies are set up once per block.
// A fragments straight from the QTensor bytes. Inside a warp's 32
// columns, m-tile j's rows g and g + 8 are the physical columns 4g + j
// and 4g + 2 + j, so one 32-bit shared load of a stored row gives bytes
// of 4 adjacent columns for both m-tiles. int4: a0 of m16n8k16 is (row
// g; k 2t, 2t+1), one packed byte, so the word at packed row t gives a0
// and a1 of both m-tiles (row t + 4: a2, a3); a byte becomes a bf16x2
// exactly with one permute, one lop3 ((nibble ^ 8) | 0x4300 is bf16 128
// + q + 8) and one bf16x2 subtract of 136. int8: k 2t and 2t+1 lie in
// two rows, so the words at rows 2t, 2t+1, 2t+8 and 2t+9 give the four
// registers of both m-tiles, paired byte by byte with one permute; a
// signed byte b is (128 + (b & 0x7f)) - (128 + (b & 0x80)), both bf16
// under 0x4300, so two lop3 and one bf16x2 subtract give b exactly
// (2 instructions a weight; the simt route's f32 magic takes 2.5). Row
// strides of 160 (int4 packed) and 144 (int8) bytes put a warp's 32
// loads on 32 banks. A thread's accumulators are the 4 adjacent columns
// 4g .. 4g + 3 of rows 2t and 2t + 1: its int4 scales for a group and
// its int8 column scales are one float4 load and its outputs 8-byte
// stores. K is split only when the column and row tiles give fewer than
// 132 blocks, into splits of at least 3 tiles; the splits of a tile run
// as one thread-block cluster and add their f32 sums through distributed
// shared memory in a fixed order, so a call is one launch, needs no
// workspace and is bitwise deterministic run to run; an unsplit call is
// a plain launch, with no cluster attribute. Ragged M, N (N % 4 == 0)
// and K are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attn_mma.cuh"

namespace {

constexpr int TX = 8;                 // threads along N within a warp
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TK = THREADS / TX;      // row runs per block (16)
constexpr int CN = 16;                // columns per thread
constexpr int BN = TX * CN;           // columns per block (128)
constexpr int BM = 8;                 // rows of x per block
constexpr int STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 (weights) or 4 (x) bytes global -> shared, asynchronously; with
// pred false the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte j of word w as the f32 2^23 + byte (one permute, no conversion)
__device__ __forceinline__ float magic_byte(unsigned w, int j) {
  return __int_as_float(
      static_cast<int>(__byte_perm(w, 0x4B000000u, 0x7650u + j)));
}

template <bool INT4, typename T> struct Tile {
  static constexpr int RK = INT4 ? 16 : 8;        // unpacked rows per run
  static constexpr int BK = TK * RK;              // unpacked rows per tile
  static constexpr int WROWS = INT4 ? BK / 2 : BK;  // stored rows per tile
  static constexpr int XE = 4 / sizeof(T);        // x elements per copy
  static constexpr int XRUN = RK + XE;            // padded run of x in smem
  static constexpr int XROW = TK * XRUN;          // smem stride of an x row
  static constexpr int W_BYTES = WROWS * BN;
  static constexpr int X_BYTES = BM * XROW * sizeof(T);
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

constexpr int RED_BYTES = WARPS * BM * BN * 4;    // cross-warp sums

// The copies of one K tile into a stage: every thread its own weight
// rows (16 bytes each), and the block the x tile (4 bytes each).
template <typename T, bool INT4, bool VEC>
__device__ __forceinline__ void load_tile(
    unsigned char* stage, const T* x, long long x_sm, const int8_t* q,
    int M, int N, int m0, int n, int k0, int ke, int tx, int tk, int tid) {
  using TL = Tile<INT4, T>;
  constexpr int RK = TL::RK, XE = TL::XE;
  constexpr int RP = INT4 ? RK / 2 : RK;          // stored rows per run
  const int kt = k0 + tk * RK;
  unsigned char* w = stage + (tk * RP) * BN + tx * CN;
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int k = kt + (INT4 ? 2 * r : r);        // first unpacked row
    const long long row = INT4 ? (kt >> 1) + r : k;
    const bool ok = k < ke && n < N;
    const int8_t* src = q + row * N + n;
    if (VEC) {
      cp_async16(w + r * BN, ok ? src : q, ok);
    } else {                 // ragged or unaligned N: plain byte loads
      unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int c = 0; c < CN; ++c)
        if (ok && n + c < N)
          v[c >> 2] |= (static_cast<unsigned>(__ldg(src + c)) & 0xffu)
                       << (8 * (c & 3));
      *reinterpret_cast<uint4*>(w + r * BN) = make_uint4(v[0], v[1], v[2],
                                                         v[3]);
    }
  }
  T* xs = reinterpret_cast<T*>(stage + TL::W_BYTES);
  constexpr int COPIES = BM * TL::BK / XE;
  for (int i = tid; i < COPIES; i += THREADS) {
    const int m = i / (TL::BK / XE);
    const int kk = (i - m * (TL::BK / XE)) * XE;  // k within the tile
    const int gm = m0 + m, k = k0 + kk;
    const bool ok = gm < M && k < ke;             // ke is even for bf16
    const T* src = x + static_cast<long long>(gm) * x_sm + k;
    cp_async4(xs + m * TL::XROW + (kk / RK) * TL::XRUN + kk % RK,
              ok ? src : x, ok);
  }
}

template <typename T, bool INT4, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
qmm_kernel(const T* __restrict__ x, long long x_sm,
           const int8_t* __restrict__ q, const float* __restrict__ scale,
           T* __restrict__ out, float* __restrict__ ws, int M, int N,
           int K, int gs, int kper, int splits) {
  using TL = Tile<INT4, T>;
  constexpr int RK = TL::RK, BK = TL::BK;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane & (TX - 1);
  const int tk = warp * (32 / TX) + (lane / TX);
  const int n0 = blockIdx.x * BN;
  const int n = n0 + tx * CN;
  const int m0 = blockIdx.y * BM;
  const int z = blockIdx.z;
  const int kb = z * kper;
  const int ke = min(K, kb + kper);
  const int tiles = (ke - kb + BK - 1) / BK;

  float acc[BM][CN];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[m][c] = 0.f;
  float sc[CN];
#pragma unroll
  for (int c = 0; c < CN; ++c) sc[c] = 0.f;
  int cur_g = -1;

  // prologue: the first STAGES - 1 tiles in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      load_tile<T, INT4, VEC>(smem + s * TL::STAGE_BYTES, x, x_sm, q, M, N,
                              m0, n, kb + s * BK, ke, tx, tk, tid);
    cp_async_commit();
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();          // this thread's copies of tile t
    __syncthreads();                      // everyone's; tile t-1 consumed
    {
      const int tn = t + STAGES - 1;
      if (tn < tiles)
        load_tile<T, INT4, VEC>(smem + (tn % STAGES) * TL::STAGE_BYTES, x,
                                x_sm, q, M, N, m0, n, kb + tn * BK, ke, tx,
                                tk, tid);
      cp_async_commit();
    }
    const unsigned char* stage = smem + (t % STAGES) * TL::STAGE_BYTES;
    const T* xs = reinterpret_cast<const T*>(stage + TL::W_BYTES) +
                  tk * TL::XRUN;
    const int k0 = kb + t * BK + tk * RK;    // this thread's first row
    if (!INT4) {
      const unsigned char* w = stage + (tk * RK) * BN + tx * CN;
#pragma unroll 2
      for (int r = 0; r < RK; ++r) {
        uint4 raw = *reinterpret_cast<const uint4*>(w + r * BN);
        float xv[BM];
#pragma unroll
        for (int m = 0; m < BM; ++m) xv[m] = to_f(xs[m * TL::XROW + r]);
        const unsigned wd[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          // (byte ^ 0x80) = value + 128
          const float f = magic_byte(wd[c >> 2], c & 3) - 8388736.f;
#pragma unroll
          for (int m = 0; m < BM; ++m) acc[m][c] = fmaf(xv[m], f, acc[m][c]);
        }
      }
    } else {
      constexpr int RP = RK / 2;
      const unsigned char* w = stage + (tk * RP) * BN + tx * CN;
#pragma unroll 1
      for (int r = 0; r < RP; ++r) {
        const uint4 raw = *reinterpret_cast<const uint4*>(w + r * BN);
        const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // rows past K carry zero weights and zero x; clamp their group
          const int g = min(k0 + 2 * r + h, K - 1) / gs;
          if (g != cur_g) {
            if (n < N) {
              const float* p = scale + static_cast<long long>(g) * N + n;
              if (VEC) {
#pragma unroll
                for (int j = 0; j < CN / 4; ++j) {
                  const float4 f = __ldg(reinterpret_cast<const float4*>(p) +
                                         j);
                  sc[4 * j] = f.x;
                  sc[4 * j + 1] = f.y;
                  sc[4 * j + 2] = f.z;
                  sc[4 * j + 3] = f.w;
                }
              } else {
#pragma unroll
                for (int c = 0; c < CN; ++c)
                  sc[c] = (n + c < N) ? __ldg(p + c) : 0.f;
              }
            }
            cur_g = g;
          }
          float xv[BM];
#pragma unroll
          for (int m = 0; m < BM; ++m)
            xv[m] = to_f(xs[m * TL::XROW + 2 * r + h]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // the 4 nibbles of this half, each (nibble ^ 8) = value + 8
            const unsigned nib =
                ((h ? wd[j] >> 4 : wd[j]) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = 4 * j + b;
              const float f = (magic_byte(nib, b) - 8388616.f) * sc[c];
#pragma unroll
              for (int m = 0; m < BM; ++m)
                acc[m][c] = fmaf(xv[m], f, acc[m][c]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the stages are free

  // the 4 row runs of a warp (lanes tx, tx + 8, tx + 16, tx + 24)
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      acc[m][c] = v;
    }
  float* red = reinterpret_cast<float*>(smem);
  if (lane < TX) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int c = 0; c < CN; c += 4)
        *reinterpret_cast<float4*>(red + (warp * BM + m) * BN + tx * CN + c) =
            make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2],
                        acc[m][c + 3]);
  }
  __syncthreads();
  // then the 4 warps, and the epilogue
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN, col = i - m * BN;
    const int gm = m0 + m, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * BM + m) * BN + col];
    const long long o = static_cast<long long>(gm) * N + gn;
    if (splits == 1) {
      if (!INT4) s *= __ldg(scale + gn);
      out[o] = from_f<T>(s);
    } else {
      ws[static_cast<long long>(z) * M * N + o] = s;
    }
  }
}

// Adds the splits' partial sums, applies the int8 per-channel scale (not
// for int4, whose scales were applied per group) and casts.
template <typename T, bool SCALE>
__global__ void qmm_finalize(const float* __restrict__ ws,
                             const float* __restrict__ scale,
                             T* __restrict__ out, int M, int N,
                             int splits) {
  const long long total = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * total + i];
  if (SCALE) s *= __ldg(scale + i % N);
  out[i] = from_f<T>(s);
}

template <typename T, bool INT4, bool VEC>
int launch(const void* x, long long x_sm, const void* q, const void* scale,
           void* out, void* ws, int M, int N, int K, int gs, int kper,
           int splits, cudaStream_t st) {
  using TL = Tile<INT4, T>;
  static_assert(TL::SMEM >= RED_BYTES, "the sums reuse the stages");
  static bool attr = false;             // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<T, INT4, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<T, INT4, VEC><<<grid, THREADS, TL::SMEM, st>>>(
      static_cast<const T*>(x), x_sm, static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(ws), M, N, K, gs, kper, splits);
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>((total + 255) / 256);
    qmm_finalize<T, !INT4><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale),
        static_cast<T*>(out), M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(bool int4, bool vec, const void* x, long long x_sm,
                const void* q, const void* scale, void* out, void* ws,
                int M, int N, int K, int gs, int kper, int splits,
                cudaStream_t st) {
  if (int4)
    return vec ? launch<T, true, true>(x, x_sm, q, scale, out, ws, M, N, K,
                                       gs, kper, splits, st)
               : launch<T, true, false>(x, x_sm, q, scale, out, ws, M, N,
                                        K, gs, kper, splits, st);
  return vec ? launch<T, false, true>(x, x_sm, q, scale, out, ws, M, N, K,
                                      gs, kper, splits, st)
             : launch<T, false, false>(x, x_sm, q, scale, out, ws, M, N,
                                       K, gs, kper, splits, st);
}

// ---------------------------------------------------------------------
// The mma route: bf16 x; int4 weights with gs a multiple of 16, or int8
// ---------------------------------------------------------------------
namespace mma {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = WARPS * 32;          // columns of y a block
constexpr int BK = 64;                  // unpacked rows of a K tile
constexpr int STEPS = BK / 16;          // k-steps of a tile
constexpr int STAGES = 4;
constexpr int MAX_SPLITS = 16;          // a (non-portable) cluster
constexpr int XSTR = BK + 8;            // x-row stride in elements
constexpr int YSTR = BN + 4;            // f32 row stride of a split's sums

// The weights of a K tile in shared memory. int4: 32 packed rows at a
// stride of 160 bytes (S / 4 = 40) and the scale rows of the groups the
// tile touches, at most one a k-step. int8: 64 rows at 144 bytes (S / 4
// = 36) and no scale rows (one scale a column, applied in the
// epilogue). Either stride puts a warp's 32 fragment loads on 32 banks.
template <int BITS> struct W {
  static constexpr int ROWS = BITS == 4 ? BK / 2 : BK;   // stored rows
  static constexpr int QSTR = BN + (BITS == 4 ? 32 : 16);
  static constexpr int Q_BYTES = ROWS * QSTR;
  static constexpr int S_ROWS = BITS == 4 ? STEPS : 0;
  static constexpr int S_BYTES = S_ROWS * BN * 4;
};

// NT n-tiles of 8 rows of x a block
template <int BITS, int NT> struct Tile {
  static constexpr int BM = 8 * NT;
  static constexpr int X_OFF = W<BITS>::Q_BYTES + W<BITS>::S_BYTES;
  static constexpr int STAGE = X_OFF + BM * XSTR * 2;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(SMEM >= BM * YSTR * 4, "a split's sums reuse the stages");
};

// Four bf16x2 registers from one 32-bit word of packed int4 bytes: byte
// j holds k 2t (low nibble) and 2t+1 (high) of one column, the two
// halves of r[j]; (nibble ^ 8) | 0x4300 is bf16 128 + (q + 8) (one
// lop3), and subtracting 136 leaves q exactly
__device__ __forceinline__ void dequant4(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t hi = w >> 4;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t p = __byte_perm(w, hi, j | ((4 + j) << 8));
    uint32_t u;
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"       // (p & mask) ^ magic
        : "=r"(u) : "r"(p), "r"(0x000F000Fu), "r"(0x43084308u));
    __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&u), off);
    r[j] = *reinterpret_cast<uint32_t*>(&h);
  }
}

// One bf16x2 register from byte c of two words of int8 rows: the low
// half from word lo (row k), the high half from word hi (row k + 1). A
// signed byte b is (b & 0x7f) - (b & 0x80); under 0x4300 (bf16 128) each
// part is a bf16, 128 + (b & 0x7f) and 128 or 256, so the bf16x2
// difference is b exactly: one permute, two lop3, one subtract
__device__ __forceinline__ uint32_t dequant8(uint32_t lo, uint32_t hi,
                                             int c) {
  const uint32_t p = __byte_perm(lo, hi, c | ((4 + c) << 8));
  uint32_t a = (p & 0x007F007Fu) | 0x43004300u;
  uint32_t s = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&h);
}

// A thread's share of the copies of one K tile into a stage, set up once
// per block: fixed source pointers and shared-memory offsets that only
// move by a tile's stride, so that issuing a tile costs a few adds.
// Weight rows go QV bytes a copy (a thread's copies share one column
// and lie RSTEP stored rows apart); int4's scale rows of the groups the
// tile touches and the x tile 16 bytes a copy; past N, M or ke the copy
// zero-fills.
template <int BITS, int NT, int QV> struct Loader {
  using WT = W<BITS>;
  static constexpr int QC = BN / QV;                  // copies a row
  static constexpr int QN = WT::ROWS * QC / THREADS;  // a thread's rows
  static constexpr int RSTEP = THREADS / QC;          // rows between them
  static constexpr int XCOPIES = Tile<BITS, NT>::BM * (BK / 8);
  static constexpr int XN = (XCOPIES + THREADS - 1) / THREADS;
  static_assert(QN * THREADS == WT::ROWS * QC, "whole weight copies");
  static_assert(WT::S_ROWS * (BN / 4) <= THREADS, "one scale copy a thread");
  const int8_t* qs;
  long long qstep;                    // RSTEP rows of q, in bytes
  int qd, qr;
  bool qok;
  const __nv_bfloat16* xs[XN];
  int xd[XN], xc[XN];
  bool xok[XN], xon[XN];
  const float* ss;
  int sd, sr;
  bool sok;

  __device__ __forceinline__ Loader(const __nv_bfloat16* x, long long x_sm,
                                    const int8_t* q, const float* scale,
                                    int M, int N, int m0, int n0, int tid) {
    const int r = tid / QC, qc = (tid % QC) * QV;
    qok = n0 + qc < N;
    qs = qok ? q + static_cast<long long>(r) * N + n0 + qc : q;
    qstep = static_cast<long long>(RSTEP) * N;
    qd = r * WT::QSTR + qc;
    qr = BITS == 4 ? 2 * r : r;             // its first unpacked row
#pragma unroll
    for (int u = 0; u < XN; ++u) {
      const int i = tid + u * THREADS, m = i / (BK / 8), c = i % (BK / 8);
      xon[u] = i < XCOPIES;
      xok[u] = xon[u] && m0 + m < M;
      xs[u] = xok[u] ? x + static_cast<long long>(m0 + m) * x_sm + 8 * c
                     : x;
      xd[u] = Tile<BITS, NT>::X_OFF + (m * XSTR + 8 * c) * 2;
      xc[u] = 8 * c;
    }
    sr = tid / (BN / 4);
    const int sc = (tid % (BN / 4)) * 4;
    sok = BITS == 4 && n0 + sc < N;
    ss = sok ? scale + static_cast<long long>(sr) * N + n0 + sc : scale;
    sd = WT::Q_BYTES + (sr * BN + sc) * 4;
  }

  // the tile [k0, min(k0 + BK, ke)); int4: its first group g0 and the
  // number of groups it touches
  __device__ __forceinline__ void load(unsigned char* stage, int k0, int ke,
                                       int g0, int groups, int N) const {
    const int8_t* q0 =
        qs + static_cast<long long>(BITS == 4 ? k0 >> 1 : k0) * N;
    const int left = ke - k0 - qr;          // unpacked rows left from qr
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      const bool ok = qok && u * RSTEP * (BITS == 4 ? 2 : 1) < left;
      void* dst = stage + qd + u * RSTEP * WT::QSTR;
      const int8_t* src = ok ? q0 + u * qstep : qs;
      if (QV == 16)
        attn::cp_async16(dst, src, ok);
      else
        attn::cp_async4(dst, src, ok);
    }
    if (BITS == 4 && sr < groups)
      attn::cp_async16(stage + sd,
                       sok ? ss + static_cast<long long>(g0) * N : ss, sok);
#pragma unroll
    for (int u = 0; u < XN; ++u) {
      if (!xon[u]) continue;
      const bool ok = xok[u] && k0 + xc[u] < ke;
      attn::cp_async16(stage + xd[u], ok ? xs[u] + k0 : xs[u], ok);
    }
  }
};

// The groups of K met in order, without a division a tile: the group g
// of row k and k's offset r in it
struct GroupCursor {
  int g, r;
  __device__ __forceinline__ void advance(int rows, int gs) {
    r += rows;
    while (r >= gs) {
      r -= gs;
      ++g;
    }
  }
  // the number of groups that the next `rows` rows touch
  __device__ __forceinline__ int span(int rows, int gs) const {
    int n = 1;
    for (int left = gs - r; left < rows; left += gs) ++n;
    return n;
  }
};

}  // namespace mma

// y for one 8 NT x 128 tile of the (M, N) output, computed transposed:
// y^T = W^T x^T, the weights the A operand (16 output columns a m-tile)
// and x the B operand (8 rows of x an n-tile), so that decode's 8 rows
// fill the product. Warp w owns columns 32 w .. 32 w + 31 as two m-tiles:
// m-tile j's rows g and g + 8 are the physical columns 4g + j and
// 4g + 2 + j, so one 32-bit load of a stored row at columns 4g .. 4g + 3
// feeds both m-tiles, and the thread's accumulators are the 4 adjacent
// columns 4g .. 4g + 3 of rows 2t and 2t + 1 of each n-tile. int4 (BITS
// 4): the word at packed row t (t + 4) holds a0, a1 (a2, a3) of both
// m-tiles; each group is summed in a fresh fragment and added to the
// running sum times its scale. int8: the words at rows 2t, 2t + 1,
// 2t + 8 and 2t + 9 hold them, paired byte by byte; one running sum over
// all of K, multiplied by the column's scale in the epilogue.
// Split z of a cluster of `splits` blocks covers the rows
// [z kper, min(K, (z + 1) kper)) of K; the cluster's blocks add their
// f32 sums through distributed shared memory in the order z = 0, 1, ..,
// each block writing a share of y.
template <int BITS, int NT, int QV>
__global__ void __launch_bounds__(mma::THREADS)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, long long x_sm,
               const int8_t* __restrict__ q, const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int M, int N, int K, int gs,
               int kper, int splits) {
  constexpr bool INT4 = BITS == 4;
  using TL = mma::Tile<BITS, NT>;
  using WT = mma::W<BITS>;
  // the route's tiles (the simt route's names mean other sizes)
  constexpr int BN = mma::BN, BK = mma::BK, STAGES = mma::STAGES;
  constexpr int STEPS = mma::STEPS, QSTR = WT::QSTR;
  constexpr int XSTR = mma::XSTR, YSTR = mma::YSTR;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TL::BM;
  const int z = blockIdx.z;
  const int kb = z * kper, ke = min(K, kb + kper);
  const int tiles = (ke - kb + BK - 1) / BK;

  // [n-tile][m-tile j][c0..c3]: the running f32 sum and, int4, the
  // group's
  float acc[NT][2][4], accg[NT][2][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = accg[nt][j][e] = 0.f;
  int gcur = INT4 ? kb / gs : 0;          // the group being accumulated
  int gend = INT4 ? min((gcur + 1) * gs, ke) : 0;  // the row that ends it
  const mma::Loader<BITS, NT, QV> ld(x, x_sm, q, scale, M, N, m0, n0, tid);
  mma::GroupCursor lc{gcur, kb - gcur * gs};    // the next tile to load
  mma::GroupCursor cc = lc;                     // the tile computed
  auto fetch = [&](int t) {               // tile t into its stage
    const int k0 = kb + t * BK;
    unsigned char* stage = smem + (t % STAGES) * TL::STAGE;
    if constexpr (INT4) {
      ld.load(stage, k0, ke, lc.g, lc.span(min(BK, ke - k0), gs), N);
      lc.advance(BK, gs);
    } else {
      ld.load(stage, k0, ke, 0, 0, N);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) fetch(s);
    attn::cp_async_commit();
  }

  for (int t = 0; t < tiles; ++t) {
    attn::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < tiles) fetch(t + STAGES - 1);
    attn::cp_async_commit();
    const unsigned char* stage = smem + (t % STAGES) * TL::STAGE;
    const int k0 = kb + t * BK;
    const int steps = (min(BK, ke - k0) + 15) / 16;
    // every fragment of the tile first, so their latencies overlap: the
    // weight words of each k-step at columns 4g .. 4g + 3 (int4: packed
    // rows 8 ks + t and 8 ks + 4 + t; int8: rows 16 ks + 2t, + 1, + 8,
    // + 9); x's B fragments of two k-steps an ldmatrix (rows 8 nt +
    // l % 8, columns 8 (l / 8) of the pair)
    constexpr int WORDS = INT4 ? 2 : 4;
    uint32_t w[STEPS][WORDS], xb[NT][STEPS / 2][4];
    {
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(
          stage + (INT4 ? tq : 2 * tq) * QSTR + warp * 32 + 4 * gr);
#pragma unroll
      for (int ks = 0; ks < STEPS; ++ks)
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
          const int row = INT4 ? ks * 8 + 4 * i
                               : ks * 16 + (i & 1) + 8 * (i >> 1);
          w[ks][i] = qw[row * QSTR / 4];
        }
      const __nv_bfloat16* xl =
          reinterpret_cast<const __nv_bfloat16*>(stage + TL::X_OFF) +
          (lane & 7) * XSTR + (lane >> 3) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int kp = 0; kp < STEPS / 2; ++kp)
          attn::ldsm_x4(xb[nt][kp], xl + nt * 8 * XSTR + kp * 32);
    }
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      if (ks >= steps) break;
      // m-tile j: a0 (column 4g + j; k 2t, 2t+1), a1 (4g + 2 + j; the
      // same k), a2 and a3 (k 2t+8, 2t+9)
      uint32_t a[2][4];
      if constexpr (INT4) {
        uint32_t r0[4], r1[4];
        mma::dequant4(w[ks][0], r0);      // a0, a1 of m-tiles 0 and 1
        mma::dequant4(w[ks][1], r1);      // a2, a3
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = r0[j];
          a[j][1] = r0[2 + j];
          a[j][2] = r1[j];
          a[j][3] = r1[2 + j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = mma::dequant8(w[ks][0], w[ks][1], j);
          a[j][1] = mma::dequant8(w[ks][0], w[ks][1], 2 + j);
          a[j][2] = mma::dequant8(w[ks][2], w[ks][3], j);
          a[j][3] = mma::dequant8(w[ks][2], w[ks][3], 2 + j);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t b0 = xb[nt][ks / 2][2 * (ks % 2)];
          const uint32_t b1 = xb[nt][ks / 2][2 * (ks % 2) + 1];
          if constexpr (INT4)
            attn::mma_bf16(accg[nt][j], a[j], b0, b1);
          else
            attn::mma_bf16(acc[nt][j], a[j], b0, b1);
        }
      if (INT4 && k0 + 16 * ks + 16 == gend) {  // the group is complete
        // columns 4g + j (c0, c1) and 4g + 2 + j (c2, c3) of m-tile j
        const float4 sv = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(stage + WT::Q_BYTES) +
            (gcur - cc.g) * BN + warp * 32 + 4 * gr);
        const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[nt][j][e] = fmaf(accg[nt][j][e], s[(e & 2) + j],
                                   acc[nt][j][e]);
              accg[nt][j][e] = 0.f;
            }
          }
        ++gcur;
        gend = min(gend + gs, ke);
      }
    }
    if constexpr (INT4) cc.advance(BK, gs);
  }
  attn::cp_async_wait<0>();

  // int8: the scales of 4 adjacent columns from n (1 for int4, whose
  // groups were scaled), applied to the f32 sum just before the cast
  auto col_scale = [&](int n) {
    return !INT4 && n < N
               ? __ldg(reinterpret_cast<const float4*>(scale + n))
               : make_float4(1.f, 1.f, 1.f, 1.f);
  };
  // the thread's 4 adjacent columns 4g .. 4g + 3 of row 2t + h of each
  // n-tile: m-tile 0's c(2h), m-tile 1's c(2h), m-tile 0's c(2h + 2),
  // m-tile 1's c(2h + 2)... with c0/c2 at row 2t and c1/c3 at 2t + 1
  const int cl = warp * 32 + 4 * gr;
  if (splits == 1) {
    const float4 s = col_scale(n0 + cl);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + nt * 8 + 2 * tq + h, n = n0 + cl;
        if (row >= M || n >= N) continue;
        uint2 v;
        v.x = attn::pack_bf16(acc[nt][0][h] * s.x, acc[nt][1][h] * s.y);
        v.y = attn::pack_bf16(acc[nt][0][2 + h] * s.z,
                              acc[nt][1][2 + h] * s.w);
        *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * N + n) =
            v;
      }
    return;
  }
  // a split: its f32 sums as a (BM, BN) tile in its own shared memory,
  // then every block of the cluster adds a share of the rows over all
  // splits, in split order (bitwise the same on every call)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* ys = reinterpret_cast<float*>(smem);
  __syncthreads();                        // the stages are free
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(ys + (nt * 8 + 2 * tq + h) * YSTR + cl) =
          make_float4(acc[nt][0][h], acc[nt][1][h], acc[nt][0][2 + h],
                      acc[nt][1][2 + h]);
  cluster.sync();
  constexpr int CHUNKS = TL::BM * (BN / 4);
  const int per = (CHUNKS + splits - 1) / splits;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * per + tid; i < min(CHUNKS, (rank + 1) * per);
       i += mma::THREADS) {
    const int r = i / (BN / 4), c = (i - r * (BN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(ys + r * YSTR + c, s));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const int row = m0 + r, n = n0 + c;
    if (row < M && n < N) {
      const float4 s = col_scale(n);
      uint2 o;
      o.x = attn::pack_bf16(v.x * s.x, v.y * s.y);
      o.y = attn::pack_bf16(v.z * s.z, v.w * s.w);
      *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * N + n) =
          o;
    }
  }
  cluster.sync();                         // the sums are read: free them
}

template <int BITS, int NT, int QV>
int launch_mma(const void* x, long long x_sm, const void* q,
               const void* scale, void* out, int M, int N, int K, int gs,
               int kper, int splits, cudaStream_t st) {
  using TL = mma::Tile<BITS, NT>;
  const auto kernel = qmm_mma_kernel<BITS, NT, QV>;
  static bool attr = false;              // once per instance
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e == cudaSuccess)               // clusters of up to 16 blocks
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + mma::BN - 1) / mma::BN, (M + TL::BM - 1) / TL::BM,
                  splits);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (splits == 1) {                     // no cluster: a plain launch
    qmm_mma_kernel<BITS, NT, QV><<<grid, mma::THREADS, TL::SMEM, st>>>(
        xb, x_sm, qb, sb, ob, M, N, K, gs, kper, splits);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(mma::THREADS);
  cfg.dynamicSmemBytes = TL::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;        // the splits of one tile
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xb, x_sm, qb, sb,
                                           ob, M, N, K, gs, kper, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int NT>
int launch_mma_qv(const void* x, long long x_sm, const void* q,
                  const void* scale, void* out, int M, int N, int K, int gs,
                  int kper, int splits, cudaStream_t st) {
  return N % 16 == 0
             ? launch_mma<BITS, NT, 16>(x, x_sm, q, scale, out, M, N, K, gs,
                                        kper, splits, st)
             : launch_mma<BITS, NT, 4>(x, x_sm, q, scale, out, M, N, K, gs,
                                       kper, splits, st);
}

template <int BITS>
int launch_mma_nt(const void* x, long long x_sm, const void* q,
                  const void* scale, void* out, int M, int N, int K, int gs,
                  int nt, int kper, int splits, cudaStream_t st) {
  return nt == 1 ? launch_mma_qv<BITS, 1>(x, x_sm, q, scale, out, M, N, K,
                                          gs, kper, splits, st)
                 : launch_mma_qv<BITS, 4>(x, x_sm, q, scale, out, M, N, K,
                                          gs, kper, splits, st);
}

}  // namespace

// x: (M, K) with row stride x_sm (elements), last dimension contiguous;
// bfloat16 x needs K and x_sm even and a 4-byte aligned base. q: (K, N)
// int8 (int4 = 0) or (K/2, N) packed int8 (int4 = 1), contiguous;
// scale: (N,) or (K/gs, N) f32 contiguous; out: (M, N) contiguous in x's
// type (dtype 0 = float32, 1 = bfloat16). splits > 1 needs ws: (splits,
// M, N) f32; split z covers rows [z*kper, min(K, (z+1)*kper)), kper
// even. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int quant_matmul_launch(const void* x, long long x_sm,
                                   const void* q, const void* scale,
                                   void* out, void* ws, int M, int N, int K,
                                   int gs, int kper, int splits, int int4,
                                   int dtype, void* stream) {
  const bool bad_split = splits < 1 || kper < 2 || kper % 2 ||
                         static_cast<long long>(splits - 1) * kper >= K ||
                         static_cast<long long>(splits) * kper < K ||
                         (splits > 1 && ws == nullptr);
  const bool bad_int4 = int4 && (K % 2 || gs < 1 || K % gs);
  const bool bad_x = dtype == 1 &&
                     (K % 2 || (M > 1 && x_sm % 2) ||
                      reinterpret_cast<uintptr_t>(x) % 4 != 0);
  if (M < 1 || N < 1 || K < 1 || (M > 1 && x_sm < K) || bad_split ||
      bad_int4 || bad_x)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % CN == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_kind<float>(int4 != 0, vec, x, x_sm, q, scale, out, ws, M,
                              N, K, gs, kper, splits, st);
  if (dtype == 1)
    return launch_kind<__nv_bfloat16>(int4 != 0, vec, x, x_sm, q, scale,
                                      out, ws, M, N, K, gs, kper, splits,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mma route (bf16 x): x (M, K) bf16 with row stride x_sm (a
// multiple of 8 elements) on a 16-byte boundary; q (K, N) int8 (bits 8)
// or (K/2, N) packed int8 (bits 4) and scale (N,) or (K/gs, N) f32,
// contiguous, on 16-byte boundaries; out (M, N) bf16 contiguous. N a
// multiple of 4; int4: gs a multiple of 16 dividing K; int8: K a
// multiple of 8 (gs unused). nt: the n-tiles of 8 rows of x a block (1
// or 4). Split z (one block of a cluster of `splits`, at most 16) covers
// rows [z*kper, min(K, (z+1)*kper)), kper a multiple of 64. Returns the
// launch's error (0 = launched).
extern "C" int quant_matmul_mma_launch(const void* x, long long x_sm,
                                       const void* q, const void* scale,
                                       void* out, int M, int N, int K, int gs,
                                       int bits, int nt, int kper, int splits,
                                       void* stream) {
  const bool bad_split = splits < 1 || splits > mma::MAX_SPLITS ||
                         kper < mma::BK || kper % mma::BK ||
                         static_cast<long long>(splits - 1) * kper >= K ||
                         static_cast<long long>(splits) * kper < K;
  const bool bad_bits = bits == 4 ? gs < 16 || gs % 16 || K % gs
                                  : bits != 8 || K % 8;
  const bool bad_shape = M < 1 || N < 1 || K < 1 || N % 4 || bad_bits ||
                         (nt != 1 && nt != 4);
  const bool bad_align = reinterpret_cast<uintptr_t>(x) % 16 ||
                         reinterpret_cast<uintptr_t>(q) % 16 ||
                         reinterpret_cast<uintptr_t>(scale) % 16 ||
                         (M > 1 && (x_sm % 8 || x_sm < K));
  if (bad_split || bad_shape || bad_align)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return launch_mma_nt<4>(x, x_sm, q, scale, out, M, N, K, gs, nt, kper,
                            splits, st);
  return launch_mma_nt<8>(x, x_sm, q, scale, out, M, N, K, gs, nt, kper,
                          splits, st);
}
