// Fused linear + bias + activation in fp32, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_linear.py, fused_linear_pallas
// (_fused_kernel): y = act(x @ w + b) for x [M, K], w [K, N], b [N], with
// act relu, gelu (tanh form, jax.nn.gelu's default) or none, accumulated
// in fp32.  It runs every BN-folded fp32 CBR layer of the pipeline.
//
// The contract: each output is one fmaf chain over k = 0 .. K-1 in order,
// from 0.0f, then activate(acc + b[c], act).  So a value does not depend on
// M, on its row's position, on the tile, or on what else is in the batch,
// and it equals the product in grouped_transfer.cu bit for bit.  That rules
// out TF32 and split-fp32 tensor-core schemes, split-K and independent
// partial sums: the product runs on the CUDA cores.
//
// What bounds it on the H100: fp32 FFMA at 67 TFLOP/s against 3.35 TB/s.
// The 512-wide layers are bound by operations (M16384 K512 N512: 0.128 ms
// of FFMA, 0.050 ms of bytes), the 64-wide ones nearly equally by both
// (M131072 K64 N64: 0.016 ms of FFMA, 0.020 ms of bytes).  So the inner
// loop must keep the FMA pipes fed from shared memory, and the copies must
// overlap it.
//
// Design (two kernels; the wrapper, kernels/fused_linear.py, picks one):
//   * The wide kernel: the main loop of fp32_wide_tile.cuh (shared with
//     grouped_transfer.cu, which feeds it another A loader) under the
//     dense row loader below.  Block tiles of BM x BN, BN (16, 32, 64, 128)
//     following N, 256 threads, a thread holding 8 x 8 outputs at BN = 128
//     (8 x 4 at 64 and 32, 4 x 4 at 16).  x is fetched into registers one
//     16-k step ahead (16-byte loads) and stored transposed into a k-major
//     tile, so a thread reads its rows of a k as float4s; w comes through a
//     3-stage cp.async ring.  Per k a thread does 64 FMAs for 4 float4
//     reads from shared memory, on distinct banks or broadcast, with one
//     __syncthreads a step; output stores are float4s.  Measured on the
//     H100 against a persistent walk, a deeper cp.async ring for x, BK 8
//     and 32, and other BN = 64 tiles (PERF.md), this one was
//     fastest over a dispatch.
//   * The small kernel, for products that leave the card idle with the
//     wide tile (the head at M = 32, the late stages): BN 16 or 32, one row
//     and 4 columns a thread, x row-major and w through a 4-stage cp.async
//     ring of 32-k steps, so that more blocks and deeper copies hide the
//     latency a short step cannot.
//   * The scalar route of both (VEC = false) takes K % 4 != 0, N % 4 != 0
//     or unaligned bases (the embed layer has K = 3): scalar loads into the
//     same buffers, masked scalar stores.
#include <type_traits>

#include <cuda_runtime.h>

#include "fp32_wide_tile.cuh"

namespace {

using namespace fp32_wide;

// The small tile, for products too small to fill the card with the wide
// one: BN 16 or 32, one row and 4 columns a thread (BM 64 or 32), a deeper
// ring of longer steps, since a step holds little work to hide a copy.
constexpr int SBK = 32, SNSTAGE = 4;
constexpr int SLDA = SBK + 4;          // x row stride in the ring (floats)
template <int BN>
struct Small {
  static constexpr int TX = BN / 4, TY = THREADS / TX, BM = TY;
  static constexpr int STAGE = BM * SLDA + SBK * BN;   // floats a stage
  static constexpr int SMEM = SNSTAGE * STAGE * 4;
};

// The dense row loader of the wide tile: slot j of a thread is row
// row0 + tid / 4 + 64 j of x, four k from kt * BK + (tid % 4) * 4, loaded
// one step ahead into registers (16-byte loads on the vector route).
template <int BN, bool VEC>
struct RowLoader {
  const float* x;
  int M, K, row0;
  float4 xs[Wide<BN>::A4];                        // x of the next step

  __device__ __forceinline__ void fetch(int kt) {
#pragma unroll
    for (int j = 0; j < Wide<BN>::A4; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int gr = row0 + i / (BK / 4);
      const int gk = kt * BK + (i % (BK / 4)) * 4;
      const float* src = x + (size_t)gr * K + gk;
      if (VEC) {
        xs[j] = gr < M && gk < K ? __ldg(reinterpret_cast<const float4*>(src))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        xs[j].x = gr < M && gk < K ? __ldg(src) : 0.0f;
        xs[j].y = gr < M && gk + 1 < K ? __ldg(src + 1) : 0.0f;
        xs[j].z = gr < M && gk + 2 < K ? __ldg(src + 2) : 0.0f;
        xs[j].w = gr < M && gk + 3 < K ? __ldg(src + 3) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ float4 get(int j) const { return xs[j]; }
};

// The wide kernel: the shared wide tile (fp32_wide_tile.cuh) fed by the
// dense row loader.  Grid (column tiles, row tiles).
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    fused_linear_wide_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ b,
                             float* __restrict__ out, int M, int K, int N,
                             int act) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * Wide<BN>::BM;
  RowLoader<BN, VEC> ld{x, M, K, row0};
  wide_tile<BN, VEC>(ld, w, b, out, M, K, N, act, row0, blockIdx.x * BN,
                     smem);
}

// The small kernel: x [BM][SLDA] row-major and w [SBK][BN] through a
// SNSTAGE-stage cp.async ring; a thread reads four k of its row as one
// float4.  Grid (column tiles, row tiles).
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
    fused_linear_small_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              float* __restrict__ out, int M, int K, int N,
                              int act) {
  using T = Small<BN>;
  extern __shared__ __align__(16) float smem[];   // SNSTAGE x [As | Bs]
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * T::BM;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int KT = K > 0 ? (K + SBK - 1) / SBK : 1;

  auto load = [&](int kt) {
    float* as = smem + (kt % SNSTAGE) * T::STAGE;
    float* bs = as + T::BM * SLDA;
    const int k0 = kt * SBK;
    if (VEC) {
      for (int i = threadIdx.x; i < T::BM * (SBK / 4); i += THREADS) {
        const int r = i / (SBK / 4), q = i % (SBK / 4);
        const int gr = row0 + r, gk = k0 + q * 4;
        const bool ok = gr < M && gk < K;
        cp_async16(as + r * SLDA + q * 4, ok ? x + (size_t)gr * K + gk : x,
                   ok);
      }
      for (int i = threadIdx.x; i < SBK * (BN / 4); i += THREADS) {
        const int kk = i / (BN / 4), q = i % (BN / 4);
        const int gk = k0 + kk, gc = col0 + q * 4;
        const bool ok = gk < K && gc < N;
        cp_async16(bs + kk * BN + q * 4, ok ? w + (size_t)gk * N + gc : w,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < T::BM * SBK; i += THREADS) {
        const int r = i / SBK, kk = i % SBK;
        const int gr = row0 + r, gk = k0 + kk;
        as[r * SLDA + kk] = gr < M && gk < K ? x[(size_t)gr * K + gk] : 0.0f;
      }
      for (int i = threadIdx.x; i < SBK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN;
        const int gk = k0 + kk, gc = col0 + c;
        bs[kk * BN + c] = gk < K && gc < N ? w[(size_t)gk * N + gc] : 0.0f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < SNSTAGE - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  float acc[4] = {};
  const float* arow = smem + ty * SLDA;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<SNSTAGE - 2>();
    __syncthreads();               // step kt landed; step kt - 1 is read
    if (kt + SNSTAGE - 1 < KT) load(kt + SNSTAGE - 1);
    cp_async_commit();
    const float* as = arow + (kt % SNSTAGE) * T::STAGE;
    const float* bs = smem + (kt % SNSTAGE) * T::STAGE + T::BM * SLDA +
                      tx * 4;
    auto step = [&](float a, int kk) {
      const float4 v = *reinterpret_cast<const float4*>(bs + kk * BN);
      acc[0] = fmaf(a, v.x, acc[0]);
      acc[1] = fmaf(a, v.y, acc[1]);
      acc[2] = fmaf(a, v.z, acc[2]);
      acc[3] = fmaf(a, v.w, acc[3]);
    };
    const int kend = min(SBK, K - kt * SBK);   // the chain stops at K
    if (VEC && kend == SBK) {
#pragma unroll
      for (int kq = 0; kq < SBK; kq += 4) {
        const float4 a = *reinterpret_cast<const float4*>(as + kq);
        step(a.x, kq);
        step(a.y, kq + 1);
        step(a.z, kq + 2);
        step(a.w, kq + 3);
      }
    } else {
      for (int kk = 0; kk < kend; ++kk) step(as[kk], kk);
    }
  }
  cp_async_wait<0>();

  const int r = row0 + ty, c = col0 + tx * 4;
  float bias[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bias[e] = c + e < N ? b[c + e] : 0.0f;
  if (r < M) store4<VEC>(out + (size_t)r * N + c, c, N, acc, bias, act);
}

template <int BN, bool SMALL, bool VEC>
int launch(const void* x, const void* w, const void* b, void* out, int M,
           int K, int N, int act, cudaStream_t stream) {
  using T = std::conditional_t<SMALL, Small<BN>, Wide<BN>>;
  auto kernel = fused_linear_wide_kernel<BN, VEC>;
  if constexpr (SMALL) kernel = fused_linear_small_kernel<BN, VEC>;
  static bool sized = false;        // per template: the smem attribute set
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, M, K,
      N, act);
  return (int)cudaGetLastError();
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh form).  tmpl = vec + 2 * log2(BN / 16)
// + 8 * small, BN in {16, 32, 64, 128} (16 or 32 when small): the
// wrapper's choice (kernels/fused_linear.py::template).  vec needs 16-byte
// aligned x and w, K % 4 == 0 and N % 4 == 0.
extern "C" int fused_linear_launch(const void* x, const void* w,
                                   const void* b, void* out, int M, int K,
                                   int N, int act, int tmpl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tmpl) {
    case 0: return launch<16, false, false>(x, w, b, out, M, K, N, act, st);
    case 1: return launch<16, false, true>(x, w, b, out, M, K, N, act, st);
    case 2: return launch<32, false, false>(x, w, b, out, M, K, N, act, st);
    case 3: return launch<32, false, true>(x, w, b, out, M, K, N, act, st);
    case 4: return launch<64, false, false>(x, w, b, out, M, K, N, act, st);
    case 5: return launch<64, false, true>(x, w, b, out, M, K, N, act, st);
    case 6: return launch<128, false, false>(x, w, b, out, M, K, N, act, st);
    case 7: return launch<128, false, true>(x, w, b, out, M, K, N, act, st);
    case 8: return launch<16, true, false>(x, w, b, out, M, K, N, act, st);
    case 9: return launch<16, true, true>(x, w, b, out, M, K, N, act, st);
    case 10: return launch<32, true, false>(x, w, b, out, M, K, N, act, st);
    case 11: return launch<32, true, true>(x, w, b, out, M, K, N, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
