// What the SSD scan's forward (ssd_scan.cu) and backward (ssd_scan_bwd.cu)
// share: the element loads and the f32 tile staging of the dual form's
// simt route, which the backward's kernels reuse for their tiles.
#pragma once

#include <cuda_bf16.h>

namespace ssd {

constexpr unsigned FULL = 0xffffffffu;

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

}  // namespace ssd
