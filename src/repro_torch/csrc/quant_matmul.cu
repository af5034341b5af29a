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
// 0.27 GFLOP. At the admitting chunk (M = 128) the operations: 4.3 GFLOP,
// which this kernel runs on the CUDA cores in f32.
//
// Design. A block of 128 threads owns a tile of 8 rows of x by 128
// columns of y and a range of K (the split); two blocks fit an SM. Each
// thread owns 16 adjacent columns and a run of 8 (int8) or 16 (int4)
// unpacked rows of every K tile. The K tiles stream through a ring of 4
// shared-memory stages filled by cp.async (16-byte copies of weight rows,
// 4-byte copies of x), so up to three tiles' loads are in flight while
// one is consumed and no register holds a load in flight; a thread
// copies exactly the weight bytes it later reads. Weights are unpacked
// in registers with byte permutes into the float bit pattern of 2^23 +
// value (one permute and one add a value, no int-to-float conversion),
// scaled (int4) and multiplied on the CUDA cores into 8 x 16 f32
// accumulators per thread. The 16 partial sums of a column (one per row
// run) are reduced with shuffles inside each warp, then across the 4
// warps in shared memory.
//
// Occupancy at decode: with 128 columns a tile, N = 512 (wk, wv) gives 4
// column tiles. The wrapper therefore splits K so that about 528 blocks
// (two waves of 2 blocks on each of 132 SMs) are launched; a split
// writes its f32 partial sums to a workspace and a second small kernel
// adds the splits, applies the int8 scale and casts. A split covers a
// multiple of 64 rows of K and there are at most 16 of them. Tensor-core
// mma/wgmma with a dequantizing prologue is the next thing a faster
// version changes (the M = 128 product is bound by the CUDA cores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
