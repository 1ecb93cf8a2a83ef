// A8W8 int8 matrix product with a dequantizing epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul_pallas
// (_int8_kernel), reached through kernels/ops.py int8_matmul: int8 x int8
// into an int32 accumulator, then out = f32(acc) * scale.  Here the scale
// is s = a_scale[lane(row)] * w_scale[col], formed in f32 first (the same
// product, in the same order, as ops.py then the Pallas epilogue), with
// lane(row) = row / rows_per_lane: a batched serving dispatch keeps one
// activation scale per cloud, as the JAX walk does when it maps lanes.
//
// What bounds it on the H100: at the pipeline's shapes (K, N <= 512 and
// M up to 131072 rows) the product is narrow, and the f32 output it
// writes (4 bytes per element against 1 byte per input element) makes
// most layers memory-bound; the int8 tensor-core peak is far away.
//
// Design (simple and exact first; wgmma/TMA are later work): 64x64 output
// tiles, 256 threads, 4x4 outputs per thread, K in steps of 32 staged in
// shared memory with the B tile transposed so both operands read four
// consecutive k values as one 32-bit word for __dp4a.  Ragged M, N and K
// edges are zero-filled on load and masked on store (the embed layer has
// K = 3).  Integer accumulation is exact, so the result is bitwise equal
// to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int LDS = BK + 4;           // row stride in bytes, keeps 4-byte
                                      // alignment and staggers banks

__global__ void int8_matmul_kernel(const int8_t* __restrict__ x,
                                   const int8_t* __restrict__ w,
                                   const float* __restrict__ a_scale,
                                   const float* __restrict__ w_scale,
                                   float* __restrict__ out, int M, int K,
                                   int N, int rows_per_lane) {
  __shared__ __align__(16) int8_t As[BM * LDS];   // [row][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];   // [col][k] (transposed)
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;   // 16 x 16
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[r * LDS + kk] =
          (gr < M && gk < K) ? x[(size_t)gr * K + gk] : (int8_t)0;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[c * LDS + kk] =
          (gk < K && gc < N) ? w[(size_t)gk * N + gc] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[(tr + 16 * i) * LDS + k4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[(tc + 16 * j) * LDS + k4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr + 16 * i;
    if (r >= M) continue;
    const float as = a_scale[r / rows_per_lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc + 16 * j;
      if (c >= N) continue;
      const float s = __fmul_rn(as, w_scale[c]);
      out[(size_t)r * N + c] = __fmul_rn((float)acc[i][j], s);
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* a_scale, const void* w_scale,
                                  void* out, int M, int K, int N,
                                  int rows_per_lane, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)a_scale,
      (const float*)w_scale, (float*)out, M, K, N, rows_per_lane);
  return (int)cudaGetLastError();
}
