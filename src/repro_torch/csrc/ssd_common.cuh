// What the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: the element loads and the f32 tile staging of the simt routes,
// and the pieces of the tensor-core (mma) routes: bf16 row staging by
// cp.async, the sub-chunk's cumulative sum, the split of an f32 operand
// into a bf16 pair and programmatic dependent launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace ssd {

constexpr unsigned FULL = 0xffffffffu;
// the largest sub-chunk of the mma routes (4 tokens a lane in sub_cumsum)
constexpr int MMA_MAX_SUB = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [r0, r0 + nr) of a (time, last) slice with row stride st into a
// padded f32 tile dst[ROWS][W + 1] (rows past nr zero), THREADS threads.
template <typename Tin, int W, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, const Tin* src,
                                           long long st, int r0, int nr) {
  for (int idx = threadIdx.x; idx < ROWS * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * (W + 1) + c] = r < nr ? to_f(src[(r0 + r) * st + c]) : 0.f;
  }
}

// rows [0, nr) of W bf16 values (row stride st) into shared rows of
// stride STR: cp.async 16 bytes a copy when vec, else one element a load
template <int W, int STR>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int nr, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nr * (W / 8); i += blockDim.x) {
      const int r = i / (W / 8), c = 8 * (i % (W / 8));
      attn::cp_async16(dst + r * STR + c, src + r * st + c, true);
    }
  } else {
    for (int i = threadIdx.x; i < nr * W; i += blockDim.x) {
      const int r = i / W, c = i % W;
      dst[r * STR + c] = src[r * st + c];
    }
  }
}

// cum[k] = dt[0] A + ... + dt[k] A for k < Q <= MMA_MAX_SUB, by one warp:
// a lane sums its (Q + 31) / 32 consecutive terms in order, a warp scan
// adds the lanes before it. Every kernel of a route calls it alike, so the
// decays that one kernel hands to another come from the same bits.
__device__ __forceinline__ void sub_cumsum(float* cum, const float* dtv,
                                           float Ah, int Q, int lane) {
  constexpr int MAXPER = MMA_MAX_SUB / 32;
  const int per = (Q + 31) >> 5;
  float v[MAXPER];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < MAXPER; ++i) {
    const int k = lane * per + i;
    if (i < per && k < Q) run = __fadd_rn(run, __fmul_rn(dtv[k], Ah));
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, u);
  }
  float base = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) base = 0.f;
#pragma unroll
  for (int i = 0; i < MAXPER; ++i) {
    const int k = lane * per + i;
    if (i < per && k < Q) cum[k] = __fadd_rn(base, v[i]);
  }
}

// two f32 values as split bf16 pairs, packed as one operand register
// each: hi = bf16(v), lo = bf16(v - hi) (v - hi is exact in f32)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A 16 x 16 tile held as two neighbouring 8-column accumulator n-tiles
// (s[0], s[1]: mma.sync's C layout) as the split A operand of one 16-deep
// k-step: the C layout of two n-tiles is the A layout of one k-step
__device__ __forceinline__ void split_frag(const float (&s)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(s[0][0], s[0][1], hi[0], lo[0]);
  split2(s[0][2], s[0][3], hi[1], lo[1]);
  split2(s[1][0], s[1][1], hi[2], lo[2]);
  split2(s[1][2], s[1][3], hi[3], lo[3]);
}

// rows [0, nr) of P f32 values (row stride st, 16-byte aligned), each
// times w[row] when w is given, into shared bf16 rows of stride STR as
// split pairs (hi, lo): NB float4 loads a thread in flight at a time
template <int P, int STR, int NB = 8>
__device__ __forceinline__ void stage_split_f32(__nv_bfloat16* hi,
                                                __nv_bfloat16* lo,
                                                const float* src,
                                                long long st, int nr,
                                                const float* w) {
  const int total = nr * (P / 4), stride = blockDim.x;
  for (int i0 = threadIdx.x; i0 < total; i0 += NB * stride) {
    float4 v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = i0 + j * stride;
      if (i < total)
        v[j] = *reinterpret_cast<const float4*>(src + (i / (P / 4)) * st +
                                                4 * (i % (P / 4)));
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = i0 + j * stride;
      if (i < total) {
        const int k = i / (P / 4), r = 4 * (i % (P / 4));
        float4 u = v[j];
        if (w != nullptr) {
          const float s = w[k];
          u = make_float4(__fmul_rn(u.x, s), __fmul_rn(u.y, s),
                          __fmul_rn(u.z, s), __fmul_rn(u.w, s));
        }
        uint2 h, l;
        split2(u.x, u.y, h.x, l.x);
        split2(u.z, u.w, h.y, l.y);
        *reinterpret_cast<uint2*>(hi + k * STR + r) = h;
        *reinterpret_cast<uint2*>(lo + k * STR + r) = l;
      }
    }
  }
}

// Programmatic dependent launch: a kernel launched with the programmatic
// stream serialization attribute may start before the kernel ahead of it
// in the stream ends, once every block of that kernel has called
// pdl_trigger; pdl_wait then blocks until that kernel has completed and
// its writes are visible (a no-op in a kernel launched without the
// attribute).
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// a launch that may begin before the kernel ahead of it in the stream
// ends (see pdl_trigger / pdl_wait)
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kern)(Params...), dim3 grid, int threads,
                       int smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace ssd
