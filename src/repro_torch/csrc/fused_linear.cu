// Fused linear + bias + activation in fp32, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_linear.py, fused_linear_pallas
// (_fused_kernel): y = act(x @ w + b) for x [M, K], w [K, N], b [N], with
// act relu, gelu (tanh form, jax.nn.gelu's default) or none, accumulated
// in fp32.  It runs every BN-folded fp32 CBR layer of the pipeline.
//
// What bounds it on the H100: full-precision fp32 (no TF32) runs on the
// CUDA cores at 67 TFLOP/s, and at the pipeline's shapes (K, N <= 512,
// M up to 131072 rows) the layers move about as many bytes as they do
// flops per byte allowed, so both limits are close; the wide early-stage
// layers lean to bytes, the 512-wide ones to flops.
//
// Design (simple first; tensor cores would need TF32 or a split-fp32
// scheme and are later work): 64x64 output tiles, 256 threads, 4x4
// outputs per thread, K in steps of 16 staged in shared memory (x tile
// transposed so a thread reads its four rows as one float4).  Each
// output is one fmaf chain over k = 0 .. K-1 in order, so its value does
// not depend on M, on its row's position, or on what else is in the
// batch.  Ragged edges are zero-filled on load and masked on store.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) {
    const float c = 0.7978845608028654f;          // sqrt(2 / pi)
    const float inner = c * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  return y;
}

__global__ void fused_linear_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int M, int K,
                                    int N, int act) {
  __shared__ __align__(16) float As[BK][BM];      // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;  // 16 x 16
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? x[(size_t)gr * K + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? w[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
    const int kend = min(BK, K - k0);   // zero-filled k adds nothing, but
                                        // stopping keeps the chain exact
    for (int kk = 0; kk < kend; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc * 4 + j;
      if (c >= N) continue;
      out[(size_t)r * N + c] = activate(acc[i][j] + b[c], act);
    }
  }
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh form).
extern "C" int fused_linear_launch(const void* x, const void* w,
                                   const void* b, void* out, int M, int K,
                                   int N, int act, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, M, K,
      N, act);
  return (int)cudaGetLastError();
}
