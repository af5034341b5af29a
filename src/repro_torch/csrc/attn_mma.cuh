// Warp-tile building blocks of the bf16 tensor-core kernels
// (flash_attention.cu, decode_attention.cu and quant_matmul.cu's mma
// route; ssd_scan.cu's recurrence stages its tiles with the copies):
// asynchronous global -> shared copies, ldmatrix fragment
// loads and the m16n8k16 bf16 product with f32 accumulation, plus the
// online-softmax step the two attention kernels share.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, the same cols),
//                a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, those cols);
//   B (16 x 8):  b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the S = Q K^T accumulator of two neighbouring 8-key n-tiles is, as
// it stands, the A operand of one 16-key k-step of P V: P never leaves
// registers.
//
// Shared tiles hold rows of bf16 with a stride of (width + 8) elements:
// the 16 extra bytes put the 8 rows that one ldmatrix phase reads on 8
// different 16-byte bank groups, so fragment loads are free of bank
// conflicts for every width that is a multiple of 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;   // the Pallas kernels' finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// -inf: the score of a key that takes no part at all (past the end)
__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// pred false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared (zero-filled when pred is false)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, register i receives it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand of P V's k-step kk from the probabilities of n-tiles
// 2kk and 2kk+1: p rounded to bf16 (the JAX model's plain route rounds
// p to v's type the same way)
template <int NT>
__device__ __forceinline__ void p_fragment(uint32_t (&pa)[4],
                                           const float (&s)[NT][4], int kk) {
  pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// One online-softmax step on a warp's 16 x (8 NT) score tile, already
// scaled to the log2 domain and masked (a masked score is NEG_INF, a
// key that takes no part is -inf). Rows g and g+8 of the tile are this
// lane's rows 0 and 1; the row max is reduced over the 4 lanes of a
// quad, the row sum l stays a per-lane partial (reduced once at the
// end). Overwrites s with p and rescales the NO output n-tiles in o.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&o)[NO][4],
                                             float (&m)[2], float (&l)[2]) {
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
    mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      ls[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// The ldmatrix row address of a lane in a K tile at sK (stride STR):
// keys (lane / 16) * 8 + lane % 8, dimensions ((lane / 8) % 2) * 8
template <int STR>
__device__ __forceinline__ const __nv_bfloat16* k_lane(
    const __nv_bfloat16* sK, int lane) {
  return sK + ((lane >> 4) * 8 + (lane & 7)) * STR + ((lane >> 3) & 1) * 8;
}

// One 16-dimension k-step of S (16 x 8 NT) += Q K^T for a warp: qa is
// Q's fragment of the step, kl the lane's address from k_lane
template <int NT, int STR>
__device__ __forceinline__ void qk_step(float (&s)[NT][4],
                                        const uint32_t (&qa)[4],
                                        const __nv_bfloat16* kl, int ks) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t kb[4];
    ldsm_x4(kb, kl + np * 16 * STR + ks * 16);
    mma_bf16(s[2 * np], qa, kb[0], kb[1]);
    mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
  }
}

// o (16 x 8 NO) += P V for a warp: P in the score registers s (16 x 8
// NT), V rows of the tile at sV with stride STR
template <int NT, int NO, int STR>
__device__ __forceinline__ void pv_tile(float (&o)[NO][4],
                                        const float (&s)[NT][4],
                                        const __nv_bfloat16* sV, int lane) {
  const __nv_bfloat16* base = sV + (lane & 15) * STR + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    p_fragment<NT>(pa, s, kk);
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t vb[4];
      ldsm_x4_t(vb, base + kk * 16 * STR + dp * 16);
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// The ldmatrix row address of a lane in a Q tile of a warp's 16 rows
// at sQ (stride STR): row lane % 16, dimensions (lane / 16) * 8; Q's
// fragment of k-step ks is ldsm_x4 at q_lane + 16 ks
template <int STR>
__device__ __forceinline__ const __nv_bfloat16* q_lane(
    const __nv_bfloat16* sQ, int lane) {
  return sQ + (lane & 15) * STR + (lane >> 4) * 8;
}

}  // namespace attn
