// Fused group -> normalize -> transfer layer for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/grouped_transfer.py, grouped_transfer_pallas:
//   * with sigma = None, the stats variant (_grouped_transfer_stats_kernel,
//     the pallas_call at :149, its (2, s_tiles) grid): pass 0 sums the
//     masked off^2, pass 1 forms sigma and runs the product below;
//   * with sigma given (_grouped_transfer_kernel, the pallas_call at :173),
//     or with no normalization at all (affine_mode "center"): the product
//     alone.
// For each sample s of a cloud and each of its k neighbours j, with
// off = feats[nidx[s, j]] - centers[s] (C values):
//   x = off / (sigma + eps), then x * alpha + beta under "affine";
//   row = [x, centers[s]] (2C values);
//   out[s, j] = relu(row @ w + b)           (C_out values).
// The [B, S, k, 2C] grouped tensor never exists in device memory.
//
// What bounds it on the H100: operations, on the CUDA cores (fp32 FFMA at
// 67 TFLOP/s, no TF32): 2 * 2C * C_out flops a row, 17.2 GFLOP at Elite's
// stage 4 (B32 S64 k16, C 256 -> 512; 0.256 ms).  At stage 1 (S512,
// C 32 -> 64) the 67 MB output (0.020 ms at 3.35 TB/s) is close to the
// 2.1 GFLOP (0.032 ms).  So the product has to run at the FFMA rate, which
// is what fused_linear.cu's wide tile does.
//
// Design: no atomics anywhere, so results are the same run to run and a
// cloud's result does not depend on the rest of its dispatch.
//   * Stats launch (stats variant only): grid (ceil(S / 8), B), 256
//     threads.  A block takes 8 samples' neighbour rows; each warp walks
//     whole rows (a group of lanes a row, sized to C), reading the row's
//     index once and the row as float4s, and sums off * off (formed in
//     float32) in float64 in a fixed order; a tree in shared memory gives
//     one partial per (cloud, tile).
//   * Compute launch: grid (C_out / BN, S*k / BM, B), the main loop of
//     fp32_wide_tile.cuh (fused_linear.cu's wide tile: the same w ring,
//     k-major A buffer, register tile and epilogue) fed by a
//     gather-normalize A loader.  Each block first forms its cloud's
//     divisor: the partials summed in a fixed order, mean =
//     f32(total / count), sigma = f32(sqrt(f64(mean + eps))), exactly as
//     repro_torch.core.knn.group_sigma does; or the given sigma; den =
//     sigma + eps (1 in "center" mode, where the division is exact).  A
//     thread's rows are fixed across the k steps, so it finds each row's
//     neighbour and centre offsets once, before the main loop.  A step
//     loads the neighbour's features a step ahead (16-byte loads); the
//     centre, alpha and beta are read when the values are formed, after
//     the step before it has been computed (L1 hits: a warp's rows share
//     one centre row, prefetched with the neighbour); forming the values
//     at the loads instead, or dropping the prefetch, measured 1-2%
//     slower over Elite's stages (PERF.md).  The values are
//     __fsub_rn, __fdiv_rn(., den) and, under affine,
//     __fadd_rn(__fmul_rn(., alpha), beta): one rounding per op, in the
//     unfused path's order; k >= C takes centers[s][k - C].  Each output
//     is then one fmaf chain over k = 0 .. 2C-1 in order, from 0, then
//     + b, then ReLU: fused_linear's order.  So the fused path equals the
//     unfused one (torch gather and normalize ops, then the fused_linear
//     kernel) bit for bit on the same inputs.
//   * Templates: the wrapper (kernels/grouped_transfer.py) picks the tile
//     with kernels/fused_linear.py::template for the same (S*k*B, 2C,
//     C_out).  Where that names fused_linear's small tile (small products,
//     in tests), this file runs the wide tile of the same BN.  The vector
//     route needs C % 4 == 0 (a float4 never straddles C), C_out % 4 == 0
//     and 16-byte aligned feats, centers, alpha, beta and w; otherwise the
//     scalar route forms each value from scalar loads, for any C.
// Row offsets are 32-bit, registers being the scarce resource (the
// wrapper checks B*N*C, B*S*C and S*k < 2^31).  The file builds with
// --fmad=false; the explicit fmaf and __f*_rn stay as written, so both flag
// sets give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "fp32_wide_tile.cuh"

namespace {

using namespace fp32_wide;

constexpr float EPS = 1e-5f;
constexpr int STATS_SAMPLES = 8, STATS_THREADS = 256;
constexpr int MODE_CENTER = 0, MODE_GIVEN = 1, MODE_STATS = 2;

__device__ __forceinline__ double sq(float f, float c) {
  const float off = __fsub_rn(f, c);
  return (double)__fmul_rn(off, off);
}

// One partial of sum(off^2) per (cloud, tile of STATS_SAMPLES samples).
// Lanes are grouped by lpr (a power of two covering the row's float4s,
// or scalars on the scalar route, at most 32); a group walks whole rows.
__global__ void __launch_bounds__(STATS_THREADS)
    grouped_transfer_stats_kernel(const float* __restrict__ feats,
                                  const int64_t* __restrict__ nidx,
                                  const float* __restrict__ centers,
                                  double* __restrict__ partials, int N,
                                  int S, int k, int C, int vec) {
  __shared__ double red[STATS_THREADS];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int s0 = tile * STATS_SAMPLES;
  const int s1 = min(S, s0 + STATS_SAMPLES);
  const float* fb = feats + (size_t)b * N * C;
  const float* cb = centers + (size_t)b * S * C;
  const int64_t* nb = nidx + (size_t)b * S * k;
  const int units = vec ? C / 4 : C;
  int lpr = 1;
  while (lpr < 32 && lpr < units) lpr <<= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows_per_pass = (STATS_THREADS / 32) * (32 / lpr);
  const int l = lane % lpr;
  double acc = 0.0;
  for (int r = s0 * k + warp * (32 / lpr) + lane / lpr; r < s1 * k;
       r += rows_per_pass) {
    const float* f = fb + (int)nb[r] * C;
    const float* c = cb + (r / k) * C;
    if (vec) {
      for (int q = l; q < units; q += lpr) {
        const float4 fv = __ldg(reinterpret_cast<const float4*>(f) + q);
        const float4 cv = __ldg(reinterpret_cast<const float4*>(c) + q);
        acc = __dadd_rn(acc, sq(fv.x, cv.x));
        acc = __dadd_rn(acc, sq(fv.y, cv.y));
        acc = __dadd_rn(acc, sq(fv.z, cv.z));
        acc = __dadd_rn(acc, sq(fv.w, cv.w));
      }
    } else {
      for (int q = l; q < C; q += lpr)
        acc = __dadd_rn(acc, sq(__ldg(f + q), __ldg(c + q)));
    }
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

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

struct Args {
  const float* feats;
  const int64_t* nidx;
  const float* centers;
  const float* sigma;
  const double* partials;
  const float* alpha;
  const float* beta;
  const float* w;
  const float* bias;
  float* out;
  int N, S, k, C, C_out, n_tiles, mode, affine, act;
};

// The block's divisor, sigma + eps (1 in "center" mode), formed by warp 0.
__shared__ float den_sh;

// The gather-normalize A loader of the wide tile: slot j is row
// row0 + tid / 4 + 64 j of cloud b's [S*k, 2C] rows, four k from
// kt * BK + (tid % 4) * 4.  It keeps only what changes with the thread
// (two row offsets a slot, the step's loads): the arguments are the
// kernel's (read from the constant bank, not held in registers) and the
// divisor is read from shared memory, so the tile keeps its registers.
template <int BN, bool VEC>
struct GatherLoader {
  static constexpr int A4 = Wide<BN>::A4;
  Args a;
  int nbr[A4], cen[A4];            // element offsets of the row's neighbour
                                   // in feats and its centre in centers;
                                   // cen -1 past M
  int gk;                          // this thread's first k of the step
  float4 v[A4];                    // the step's raw loads (VEC) or values

  __device__ __forceinline__ void init(int b, int M, int row0) {
#pragma unroll
    for (int j = 0; j < A4; ++j) {
      const int r = row0 + (int)threadIdx.x / (BK / 4) + j * (THREADS / 4);
      const int64_t n = r < M ? a.nidx[(size_t)b * M + r] : 0;
      nbr[j] = (b * a.N + (int)n) * a.C;
      cen[j] = r < M ? (b * a.S + r / a.k) * a.C : -1;
    }
  }

  __device__ __forceinline__ float norm(float f, float c, float al,
                                        float be) const {
    float x = __fdiv_rn(__fsub_rn(f, c), den_sh);
    if (a.affine) x = __fadd_rn(__fmul_rn(x, al), be);
    return x;
  }

  __device__ __forceinline__ void fetch(int kt) {
    gk = kt * BK + ((int)threadIdx.x % (BK / 4)) * 4;
    const int C = a.C;
#pragma unroll
    for (int j = 0; j < A4; ++j) {
      if (VEC) {
        // a float4 lies wholly below C or wholly past it (C % 4 == 0)
        if (cen[j] < 0 || gk >= 2 * C) {
          v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (gk < C) {
          v[j] = __ldg(reinterpret_cast<const float4*>(a.feats + nbr[j] +
                                                       gk));
          prefetch_l1(a.centers + cen[j] + gk);
        } else {
          v[j] = __ldg(reinterpret_cast<const float4*>(a.centers + cen[j] +
                                                       gk - C));
        }
      } else {
        float e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = gk + q;
          e[q] = 0.0f;
          if (cen[j] >= 0 && kk < C) {
            e[q] = norm(__ldg(a.feats + nbr[j] + kk),
                        __ldg(a.centers + cen[j] + kk),
                        a.affine ? __ldg(a.alpha + kk) : 1.0f,
                        a.affine ? __ldg(a.beta + kk) : 0.0f);
          } else if (cen[j] >= 0 && kk < 2 * C) {
            e[q] = __ldg(a.centers + cen[j] + kk - C);
          }
        }
        v[j] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  __device__ __forceinline__ float4 get(int j) const {
    if (!VEC || cen[j] < 0 || gk >= a.C) return v[j];
    const float4 c = *reinterpret_cast<const float4*>(a.centers + cen[j] +
                                                      gk);
    float4 al = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    float4 be = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a.affine) {
      al = *reinterpret_cast<const float4*>(a.alpha + gk);
      be = *reinterpret_cast<const float4*>(a.beta + gk);
    }
    return make_float4(norm(v[j].x, c.x, al.x, be.x),
                       norm(v[j].y, c.y, al.y, be.y),
                       norm(v[j].z, c.z, al.z, be.z),
                       norm(v[j].w, c.w, al.w, be.w));
  }
};

// Grid (column tiles, row tiles of a cloud, clouds).
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_transfer_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int M = a.S * a.k;
  if (threadIdx.x < 32) {
    float den = 1.0f;              // "center": x / 1 is x
    if (a.mode == MODE_STATS) {
      // lane l sums tiles l, l + 32, ... in order; the shuffle tree is
      // fixed, so lane 0's total is the same in every block
      double tot = 0.0;
      for (int t = threadIdx.x; t < a.n_tiles; t += 32)
        tot = __dadd_rn(tot, a.partials[(size_t)b * a.n_tiles + t]);
      for (int off = 16; off > 0; off >>= 1)
        tot = __dadd_rn(tot, __shfl_down_sync(0xffffffffu, tot, off));
      const double count = (double)a.S * a.k * a.C;
      const float mean = __double2float_rn(__ddiv_rn(tot, count));
      den = __fadd_rn(
          __double2float_rn(__dsqrt_rn((double)__fadd_rn(mean, EPS))), EPS);
    } else if (a.mode == MODE_GIVEN) {
      den = __fadd_rn(a.sigma[b], EPS);
    }
    if (threadIdx.x == 0) den_sh = den;
  }
  const int row0 = blockIdx.y * Wide<BN>::BM;
  GatherLoader<BN, VEC> ld;
  ld.a = a;
  ld.init(b, M, row0);
  __syncthreads();                 // den_sh is in place
  wide_tile<BN, VEC>(ld, a.w, a.bias, a.out + (size_t)b * M * a.C_out, M,
                     2 * a.C, a.C_out, a.act, row0, blockIdx.x * BN, smem);
}

template <int BN, bool VEC>
int launch(const Args& a, int B, cudaStream_t stream) {
  using T = Wide<BN>;
  auto kernel = grouped_transfer_wide_kernel<BN, VEC>;
  static bool sized = false;        // per template: the smem attribute set
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  if (a.mode == MODE_STATS) {
    dim3 sgrid(a.n_tiles, B);
    grouped_transfer_stats_kernel<<<sgrid, STATS_THREADS, 0, stream>>>(
        a.feats, a.nidx, a.centers, const_cast<double*>(a.partials), a.N,
        a.S, a.k, a.C, (int)VEC);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a.C_out + BN - 1) / BN, (a.S * a.k + T::BM - 1) / T::BM, B);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// feats f32 [B, N, C], nidx int64 [B, S, k], centers f32 [B, S, C],
// sigma f32 [B] (mode 1), alpha/beta f32 [C] (read under affine),
// w f32 [2C, C_out], b f32 [C_out] -> out f32 [B, S, k, C_out];
// partials f64 [B, ceil(S / 8)] is scratch for mode 2.
// mode: 0 no normalization ("center"), 1 sigma given, 2 sigma computed.
// tmpl = vec + 2 * log2(BN / 16) + 8 * small: fused_linear's template
// code for the product (kernels/fused_linear.py::template); the small
// codes run the wide tile of the same BN.  vec needs C % 4 == 0,
// C_out % 4 == 0 and 16-byte aligned feats, centers, alpha, beta and w.
extern "C" int grouped_transfer_launch(
    const void* feats, const void* nidx, const void* centers,
    const void* sigma, const void* alpha, const void* beta, const void* w,
    const void* b, void* out, void* partials, int B, int N, int S, int k,
    int C, int C_out, int mode, int affine, int act, int tmpl,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{(const float*)feats, (const int64_t*)nidx,
               (const float*)centers, (const float*)sigma,
               (const double*)partials, (const float*)alpha,
               (const float*)beta, (const float*)w, (const float*)b,
               (float*)out, N, S, k, C, C_out,
               (S + STATS_SAMPLES - 1) / STATS_SAMPLES, mode, affine, act};
  switch (tmpl) {
    case 0: return launch<16, false>(a, B, st);
    case 1: return launch<16, true>(a, B, st);
    case 2: return launch<32, false>(a, B, st);
    case 3: return launch<32, true>(a, B, st);
    case 4: return launch<64, false>(a, B, st);
    case 5: return launch<64, true>(a, B, st);
    case 6: return launch<128, false>(a, B, st);
    case 7: return launch<128, true>(a, B, st);
    case 8: return launch<16, false>(a, B, st);
    case 9: return launch<16, true>(a, B, st);
    case 10: return launch<32, false>(a, B, st);
    case 11: return launch<32, true>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
