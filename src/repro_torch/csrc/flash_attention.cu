// Online-softmax (flash) attention with GQA, causal and sliding-window
// masks, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), reached from models/attention.py when impl == "flash"
// and there is no cache (the decoder LM's full-sequence forward).
// q [B, H, Tq, D] and k, v [B, Hkv, Tk, D] (bf16 or f32, contiguous) ->
// out [B, H, Tq, D] in q's type.  Query head h of batch b reads KV head
// b * Hkv + h / (H / Hkv): contiguous groups, as the Pallas index map and
// _sdpa_xla's [hkv, g] reshape.
//
// The arithmetic follows the Pallas kernel step for step:
//   * q is scaled before the dot: f32(q) * sm_scale, sm_scale = 1/sqrt(D)
//     rounded to f32 by the caller (the logits are not divided);
//   * masked logits take the finite sentinel -1e30, never -inf, so a fully
//     masked row of a live tile gives exp(0) that the mask then zeroes,
//     exp(m_prev - m_new) never sees inf - inf, and a row whose normalizer
//     stays 0 writes 0, not NaN;
//   * queries are aligned bottom-right: q_offset = Tk - Tq, so a
//     Tq = 1 decode-shaped call sees every key under the causal mask; keys
//     past Tk are masked by kpos < Tk (this kernel guards the ragged edge
//     in place of the TPU kernel's padding);
//   * the window keeps kpos > qpos - window; a tile that is wholly in the
//     future (causal) or wholly before the window is skipped, which
//     changes only which tiles enter the rescale, never which keys count;
//   * expf (no fast math) and round-to-nearest-even bf16 stores.
// Sums are taken in another order than the TPU's, so the result is held
// to its plain version with a tolerance, not bitwise.
//
// What bounds it on the H100: at the LM's shapes (D = 64, T = 2048) the
// work is 4 * Tq * Tk * D flops per head (halved by the causal mask), far
// above the bytes it must move, so it is bound by operations.  This first
// form runs them as f32 FFMA on the CUDA cores (67 TFLOP/s), not on the
// bf16 tensor cores (989 TFLOP/s): simple and right first; mma/wgmma with
// TMA-fed K/V tiles is later work.
//
// Design: one block of 256 threads per (batch * head, 64-query tile).
// The scaled q tile, each 64-key K and V tile, and the 64 x 64
// probability tile are staged in shared memory as f32 (rows padded by
// one word so the column reads hit distinct banks).  Thread (tr, tc) of a
// 16 x 16 grid owns query rows tr + 16 i (i < 4) and, for the logits, key
// columns tc + 16 j (j < 4), for the output, columns tc + 16 c
// (c < D / 16).  The 16 threads of a row group are one half-warp, so the
// row max and row sum are four xor shuffles; every thread of a group ends
// with the same running max and normalizer of its rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
          (size_t)BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int Hkv, int Tq, int Tk, int causal,
                           int window, float sm_scale) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDP = BKV + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LDQ], q * sm_scale
  float* Ks = Qs + BQ * LDQ;      // [BKV][LDK]
  float* Vs = Ks + BKV * LDK;     // [BKV][LDV]
  float* Ps = Vs + BKV * LDV;     // [BQ][LDP]

  const int bh = blockIdx.x;                         // b * H + head
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int q_lo = q0 + (Tk - Tq);                   // first query's position
  const T* qg = q + (size_t)bh * Tq * D;
  const T* kg = k + (size_t)kvh * Tk * D;
  const T* vg = v + (size_t)kvh * Tk * D;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int gq = q0 + r;
    Qs[r * LDQ + d] =
        gq < Tq ? __fmul_rn(to_f32(qg[(size_t)gq * D + d]), sm_scale) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (Tk + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * BKV;
    // The Pallas kernel's `live` test on this tile (uniform in the block).
    bool live = true;
    if (causal) live = live && (k_lo <= q_lo + BQ - 1);
    if (window > 0) live = live && (k_lo + BKV - 1 > q_lo - window);
    if (!live) continue;

    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int gk = k_lo + r;
      const bool in = gk < Tk;
      Ks[r * LDK + d] = in ? to_f32(kg[(size_t)gk * D + d]) : 0.f;
      Vs[r * LDV + d] = in ? to_f32(vg[(size_t)gk * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tc + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + tr + 16 * i;
      bool mask[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tc + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        mask[j] = ok;
        if (!ok) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mask[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr + 16 * i) * LDP + tc + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BKV; ++key) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[key * LDV + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(tr + 16 * i) * LDP + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Tq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tc + 16 * c, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Tq, int Tk, int causal, int window,
           float sm_scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Tq, Tk, causal,
      window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int Tq, int Tk, int D, int causal, int window,
             float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, window,
                           sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, window,
                           sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, window,
                            sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int Tq, int Tk, int D,
                                      int causal, int window, int is_bf16,
                                      float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                   window, sm_scale, s);
  return launch_d<float>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, window,
                         sm_scale, s);
}
