// Decode attention over a contiguous KV ring, hand-written for Hopper.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_pallas (body _decode_kernel), the Pallas TPU kernel
//   behind every cached decode step and every chunked-prefill extend.
//
// What it computes (exactly decode_attention_reference): T query rows of
// each sequence attend, with an online softmax in f32, over its cache of
// S slots. Masks: slot valid (pos >= 0), causal (pos <= q_pos) and an
// optional sliding window (pos > q_pos - window). A masked score is the
// finite NEG_INF = -1e30, never -inf, so a row whose every slot is
// masked returns the mean of V over the S slots, as the reference does.
//
// Layout: K/V are read in the model's cache layout (B, S, Hkv, hd)
// through strides (the last dimension contiguous), so no transposed copy
// of the cache is ever made. q is (B, T, Hq, hd) with strides, q_pos
// (B, T) int32 contiguous, pos (B, S) int32 with a row stride, and the
// output (B, T, Hq, hd) contiguous in q's type.
//
// Design (simple and correct first): one thread block per (sequence, KV
// head, tile of 16 of the R = T*G rows); row r is query token r / G and
// query head kvh*G + r % G, the grouping of the Pallas kernel. The block
// walks S in tiles of BK slots staged in shared memory as f32 (rows
// padded by one word so the score loop is free of bank conflicts) and
// masks the ragged last tile itself, so any S works. K/V tiles are read
// with 16-byte loads, and the next tile is loaded into registers while
// the current one is consumed, so the block keeps its loads in flight
// instead of waiting on each. The 4 warps take the rows round-robin
// (warp w owns rows w, w+4, w+8, w+12 of the tile), so even a decode
// step's G = 4 rows keep all four busy: a lane scores BK/32 slots, the
// warp reduces max and sum with shuffles, and a lane accumulates hd/32
// output dimensions.
//
// What bounds it: the K/V bytes it must read, 2*B*S*Hkv*hd*elt (16.8 MB
// at B=8, S=1024, Hkv=8, hd=64 in bf16: >= 5.0 us at 3.35 TB/s). Each
// block reads its head's K/V once for all of its G*T rows; the grid has
// B*Hkv*ceil(R/16) blocks, which at decode (T=1, B=8) is only 64 blocks
// for 132 SMs: splitting S across blocks is the next thing a faster
// version changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int THREADS = WARPS * 32;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// 16 bytes of K/V as f32: 4 floats or 8 bf16 values
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* qpos;
  void* out;
  int B, T, Hq, Hkv, S, G, R, window;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long pos_sb;
  float scale;
};

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(Args a) {
  constexpr int NK = BK / 32;  // slots a lane scores per tile
  constexpr int ND = HD / 32;  // output dimensions a lane accumulates
  constexpr int KS = HD + 1;   // padded shared-memory row stride
  constexpr int VN = Pack<T>::N;             // values per 16-byte load
  constexpr int VPR = HD / VN;               // 16-byte loads per slot row
  constexpr int NV = BK * VPR / THREADS;     // loads per thread per tile
  static_assert(BK * VPR % THREADS == 0, "tile must split evenly");
  static_assert(BK <= THREADS, "one thread per slot position");
  __shared__ float sK[BK * KS];
  __shared__ float sV[BK * KS];
  __shared__ float sQ[ROWS * HD];
  __shared__ int sPos[BK];

  const int b = blockIdx.x / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv;
  const int r0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vc = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int* pos = a.pos + b * a.pos_sb;

  // sQ row i holds tile row i; warp w owns tile rows w, w + WARPS, ...
  for (int i = tid; i < ROWS * HD; i += THREADS) {
    const int r = r0 + i / HD, d = i % HD;
    float x = 0.f;
    if (r < a.R) {
      const int t = r / a.G, head = kvh * a.G + r % a.G;
      x = to_f(q[b * a.q_sb + t * a.q_st + head * a.q_sh + d]);
    }
    sQ[i] = x;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][ND];
  int qp[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = r0 + rr * WARPS + warp;
    live[rr] = r < a.R;
    qp[rr] = live[rr] ? a.qpos[b * a.T + r / a.G] : 0;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[rr][i] = 0.f;
  }

  // the next tile waits in registers while the current one is consumed
  uint4 kreg[NV], vreg[NV];
  int preg = -1;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * THREADS;
      const int s = k0 + i / VPR, c = (i % VPR) * VN;
      kreg[j] = vreg[j] = make_uint4(0u, 0u, 0u, 0u);
      if (s < a.S) {
        kreg[j] = *reinterpret_cast<const uint4*>(kc + s * a.k_ss + c);
        vreg[j] = *reinterpret_cast<const uint4*>(vc + s * a.v_ss + c);
      }
    }
    preg = tid < BK && k0 + tid < a.S ? pos[k0 + tid] : -1;
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * THREADS;
      const int kk = i / VPR, c = (i % VPR) * VN;
      float f[VN];
      Pack<T>::unpack(kreg[j], f);
#pragma unroll
      for (int e = 0; e < VN; ++e) sK[kk * KS + c + e] = f[e];
      Pack<T>::unpack(vreg[j], f);
#pragma unroll
      for (int e = 0; e < VN; ++e) sV[kk * KS + c + e] = f[e];
    }
    if (tid < BK) sPos[tid] = preg;
  };

  load(0);
  for (int k0 = 0; k0 < a.S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    stash();
    __syncthreads();
    if (k0 + BK < a.S) load(k0 + BK);
    const int nvalid = min(BK, a.S - k0);  // slots of this tile inside S

#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      if (!live[rr]) continue;  // uniform across the warp
      const float* qr = sQ + (rr * WARPS + warp) * HD;
      float s[NK], p[NK];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int kk = j * 32 + lane;
        const float* kr = sK + kk * KS;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // 4 independent chains
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          d0 += qr[d] * kr[d];
          d1 += qr[d + 1] * kr[d + 1];
          d2 += qr[d + 2] * kr[d + 2];
          d3 += qr[d + 3] * kr[d + 3];
        }
        const float dot = (d0 + d1) + (d2 + d3);
        const int ps = sPos[kk];
        const bool ok = kk < nvalid && ps >= 0 && ps <= qp[rr] &&
                        (a.window == 0 || ps > qp[rr] - a.window);
        s[j] = ok ? dot * a.scale : NEG_INF;
        if (kk < nvalid) mt = fmaxf(mt, s[j]);
      }
      mt = warp_max(mt);
      const float m_new = fmaxf(m[rr], mt);
      const float alpha = expf(m[rr] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        // slots past S (the ragged tail) take no part at all
        p[j] = j * 32 + lane < nvalid ? expf(s[j] - m_new) : 0.f;
        ls += p[j];
      }
      l[rr] = l[rr] * alpha + warp_sum(ls);
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[rr][i] *= alpha;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        for (int src = 0; src < 32; ++src) {
          const int kk = j * 32 + src;
          if (kk >= nvalid) break;  // uniform across the warp
          const float pk = __shfl_sync(FULL, p[j], src);
#pragma unroll
          for (int i = 0; i < ND; ++i)
            acc[rr][i] += pk * sV[kk * KS + lane + 32 * i];
        }
      }
      m[rr] = m_new;
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    if (!live[rr]) continue;
    const int r = r0 + rr * WARPS + warp;
    const int t = r / a.G, head = kvh * a.G + r % a.G;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    T* o = out + ((static_cast<long long>(b) * a.T + t) * a.Hq + head) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[lane + 32 * i] = from_f<T>(acc[rr][i] * inv);
  }
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BK = HD <= 64 ? 64 : 32;  // keeps shared memory < 48 KB
  const dim3 grid(a.B * a.Hkv, (a.R + ROWS - 1) / ROWS);
  decode_attention_kernel<T, HD, BK><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; K/V rows
// must start on 16-byte boundaries (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* qpos, void* out, int B, int T, int Hq, int Hkv, int S,
    int hd, long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long pos_sb, int window, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.qpos = static_cast<const int*>(qpos);
  a.out = out;
  a.B = B;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.G = Hq / Hkv;
  a.R = T * a.G;
  a.window = window;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.pos_sb = pos_sb;
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
