// W8A16 matrix product: int8 weights dequantized in-tile, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py, w8_matmul_pallas
// (_w8_kernel), reached through kernels/ops.py w8_matmul.  x [M, K] (bf16
// or f32) times w_q int8 [K, N]: each int8 weight is widened to x's type
// in the tile (exact: every int8 value is a bf16), the products are summed
// in f32, and the epilogue forms acc * w_scale[col] in f32 and rounds it
// to x's type (round to nearest even), as the Pallas kernel's
// `(acc * s).astype(o.dtype)` does.  No caller in the JAX package or in
// the port reaches it on a model path; it stands as an op, held against
// its plain version.
//
// What bounds it on the H100: at decode shapes (M of a few rows, K = 2048,
// N = 5632) it must stream the int8 weight once, so it is bound by bytes
// (1 byte a weight, where bf16 weights would take 2); at prefill shapes
// (M = 8192) by operations, which this first form runs as f32 FFMA (67
// TFLOP/s), not on the bf16 tensor cores (989 TFLOP/s).
//
// Design (modelled on int8_matmul.cu; simple and right first): 64 x 64
// output tiles, 256 threads, 4 x 4 outputs per thread, K in steps of 32
// staged in shared memory as f32.  Ragged M, N and K edges are zero-filled
// on load and masked on store, in place of the TPU kernel's padding.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int LDA = BK + 1;   // x tile [row][k], padded against conflicts

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    w8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale, T* __restrict__ out,
                     int M, int K, int N) {
  __shared__ float As[BM * LDA];   // [row][k]
  __shared__ float Bs[BK * BN];    // [k][col]
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[r * LDA + kk] =
          (gr < M && gk < K) ? to_f32(x[(size_t)gr * K + gk]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk * BN + c] =
          (gk < K && gc < N) ? (float)w[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(tr + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * BN + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc + 16 * j;
      if (c >= N) continue;
      store(out + (size_t)r * N + c, __fmul_rn(acc[i][j], w_scale[c]));
    }
  }
}

}  // namespace

extern "C" int w8_matmul_launch(const void* x, const void* w,
                                const void* w_scale, void* out, int M, int K,
                                int N, int is_bf16, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    w8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)w_scale,
        (__nv_bfloat16*)out, M, K, N);
  else
    w8_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)x, (const int8_t*)w, (const float*)w_scale, (float*)out,
        M, K, N);
  return (int)cudaGetLastError();
}
