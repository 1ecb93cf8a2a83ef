// Fused group -> normalize -> transfer layer for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_transfer.py, grouped_transfer_pallas:
//   * with sigma = None, the stats variant (_grouped_transfer_stats_kernel,
//     its (2, s_tiles) grid): pass 0 sums the masked off^2, pass 1 forms
//     sigma and runs the epilogue below;
//   * with sigma given (_grouped_transfer_kernel), or with no normalization
//     at all (affine_mode "center"): the epilogue alone.
// For each sample s of a cloud and each of its k neighbours j, with
// off = feats[nidx[s, j]] - centers[s] (C values):
//   x = off / (sigma + eps), then x * alpha + beta under "affine";
//   row = [x, centers[s]] (2C values);
//   out[s, j] = relu(row @ w + b)           (C_out values).
// The [B, S, k, 2C] grouped tensor never exists in device memory.
//
// What bounds it on the H100: operations, on the CUDA cores (fp32 FFMA at
// 67 TFLOP/s, no TF32).  At the pipeline's shapes the output alone is
// 67 MB a dispatch (B32 S512 k16 C_out 64 at stage 1, S64 C_out 512 at
// stage 4), against 2.1 GFLOP at stage 1 (C = 32), where the two limits
// are close, and 17.2 GFLOP at stage 4 (C = 256).
//
// Design (simple first): no atomics anywhere, so results are the same run
// to run and a cloud's result does not depend on the rest of its dispatch.
//   * Stats launch: grid (ceil(S / 8), B).  A block gathers its 8 samples'
//     neighbour rows, forms off * off in float32 and sums it in float64 in
//     a fixed order (a strided loop, then a tree in shared memory); it
//     writes one partial per (cloud, tile).
//   * Compute launch: grid (C_out / 64, S*k / 64, B), 256 threads, the
//     tiling of fused_linear.cu.  Each block first forms its cloud's
//     sigma: the partials summed in a fixed order, mean =
//     f32(total / count), sigma = f32(sqrt(f64(mean + eps))), exactly as
//     repro_torch.core.knn.group_sigma does; or it takes the given sigma.
//     It then builds each K-slice of its [64, 2C] row tile in shared
//     memory straight from the gather (__fsub_rn, __fdiv_rn, __fmul_rn,
//     __fadd_rn: one rounding per op, in the unfused path's order), and
//     forms each output as one fmaf chain over k = 0 .. 2C-1 in order,
//     from 0, then + b, then ReLU: the order of fused_linear.cu.  So the
//     fused path equals the unfused one (torch gather and normalize ops,
//     then the fused_linear kernel) bit for bit on the same inputs.
// The file builds with --fmad=false; the explicit fmaf stays fused.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-5f;
constexpr int STATS_SAMPLES = 8, STATS_THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int MODE_CENTER = 0, MODE_GIVEN = 1, MODE_STATS = 2;

__global__ void grouped_transfer_stats_kernel(
    const float* __restrict__ feats, const int64_t* __restrict__ nidx,
    const float* __restrict__ centers, double* __restrict__ partials, int N,
    int S, int k, int C) {
  __shared__ double red[STATS_THREADS];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int s0 = tile * STATS_SAMPLES;
  const int s1 = min(S, s0 + STATS_SAMPLES);
  const int per_sample = k * C;
  const int count = (s1 - s0) * per_sample;
  double acc = 0.0;
  for (int e = threadIdx.x; e < count; e += STATS_THREADS) {
    const int s = s0 + e / per_sample, r = e % per_sample;
    const int j = r / C, c = r % C;
    const int64_t nb = nidx[((size_t)b * S + s) * k + j];
    const float off = __fsub_rn(feats[((size_t)b * N + nb) * C + c],
                                centers[((size_t)b * S + s) * C + c]);
    acc = __dadd_rn(acc, (double)__fmul_rn(off, off));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = STATS_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h)
      red[threadIdx.x] = __dadd_rn(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[(size_t)b * gridDim.x + tile] = red[0];
}

__global__ void grouped_transfer_kernel(
    const float* __restrict__ feats, const int64_t* __restrict__ nidx,
    const float* __restrict__ centers, const float* __restrict__ sigma,
    const double* __restrict__ partials, const float* __restrict__ alpha,
    const float* __restrict__ beta, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int N, int S,
    int k, int C, int C_out, int n_tiles, int mode, int affine, int act) {
  __shared__ __align__(16) float As[BK][BM];      // row tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int64_t nbr[BM];
  __shared__ float den_sh;
  const int b = blockIdx.z;
  const int M = S * k, K = 2 * C;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;  // 16 x 16

  if (threadIdx.x < 32 && mode != MODE_CENTER) {
    float sig = 0.0f;
    if (mode == MODE_STATS) {
      // lane l sums tiles l, l + 32, ... in order; the shuffle tree is
      // fixed, so lane 0's total is the same in every block
      double tot = 0.0;
      for (int t = threadIdx.x; t < n_tiles; t += 32)
        tot = __dadd_rn(tot, partials[(size_t)b * n_tiles + t]);
      for (int off = 16; off > 0; off >>= 1)
        tot = __dadd_rn(tot, __shfl_down_sync(0xffffffffu, tot, off));
      const double count = (double)S * k * C;
      const float mean = __double2float_rn(__ddiv_rn(tot, count));
      sig = __double2float_rn(__dsqrt_rn((double)__fadd_rn(mean, EPS)));
    } else if (mode == MODE_GIVEN) {
      sig = sigma[b];
    }
    if (threadIdx.x == 0) den_sh = __fadd_rn(sig, EPS);
  }
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const int r = row0 + i;
    nbr[i] = r < M ? nidx[(size_t)b * M + r] : 0;
  }
  __syncthreads();
  const float den = mode != MODE_CENTER ? den_sh : 1.0f;
  const float* cen = centers + (size_t)b * S * C;
  const float* fb = feats + (size_t)b * N * C;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < M && gk < K) {
        const int s = gr / k;
        if (gk < C) {
          v = __fsub_rn(fb[(size_t)nbr[r] * C + gk], cen[(size_t)s * C + gk]);
          if (mode != MODE_CENTER) v = __fdiv_rn(v, den);
          if (affine) v = __fadd_rn(__fmul_rn(v, alpha[gk]), beta[gk]);
        } else {
          v = cen[(size_t)s * C + gk - C];
        }
      }
      As[kk][r] = v;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < C_out) ? w[(size_t)gk * C_out + gc] : 0.0f;
    }
    __syncthreads();
    const int kend = min(BK, K - k0);
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

  float* ob = out + (size_t)b * M * C_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + tr * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tc * 4 + j;
      if (c >= C_out) continue;
      const float y = __fadd_rn(acc[i][j], bias[c]);
      ob[(size_t)r * C_out + c] = act ? fmaxf(y, 0.0f) : y;
    }
  }
}

}  // namespace

// feats f32 [B, N, C], nidx int64 [B, S, k], centers f32 [B, S, C],
// sigma f32 [B] (mode 1), alpha/beta f32 [C] (read under affine),
// w f32 [2C, C_out], b f32 [C_out] -> out f32 [B, S, k, C_out];
// partials f64 [B, ceil(S / 8)] is scratch for mode 2.
// mode: 0 no normalization ("center"), 1 sigma given, 2 sigma computed.
extern "C" int grouped_transfer_launch(
    const void* feats, const void* nidx, const void* centers,
    const void* sigma, const void* alpha, const void* beta, const void* w,
    const void* b, void* out, void* partials, int B, int N, int S, int k,
    int C, int C_out, int mode, int affine, int act, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (S + STATS_SAMPLES - 1) / STATS_SAMPLES;
  if (mode == MODE_STATS) {
    dim3 sgrid(n_tiles, B);
    grouped_transfer_stats_kernel<<<sgrid, STATS_THREADS, 0, st>>>(
        (const float*)feats, (const int64_t*)nidx, (const float*)centers,
        (double*)partials, N, S, k, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((C_out + BN - 1) / BN, (S * k + BM - 1) / BM, B);
  grouped_transfer_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)feats, (const int64_t*)nidx, (const float*)centers,
      (const float*)sigma, (const double*)partials, (const float*)alpha,
      (const float*)beta, (const float*)w, (const float*)b, (float*)out, N, S,
      k, C, C_out, n_tiles, mode, affine, act);
  return (int)cudaGetLastError();
}
