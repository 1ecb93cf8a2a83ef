// The wide fp32 tile of fused_linear.cu, shared with grouped_transfer.cu.
//
// wide_tile<BN, VEC>(loader, ...) computes one BM x BN block of
// out = act(A @ w + b) on the CUDA cores, A [M, K] (produced by the A-tile
// loader), w [K, N] row-major, b [N].  Each output is one fmaf chain over
// k = 0 .. K-1 in order, from 0.0f, then activate(acc + b[c], act); so a
// value depends neither on the tile nor on the loader, and two kernels
// built on this loop give the same bits for the same A.
//
// The tile: 256 threads, BN (16, 32, 64, 128) following N, a thread
// holding TM x TN outputs (8 x 8 at BN = 128, 8 x 4 at 64 and 32, 4 x 4 at
// 16; BM 128, or 256 at BN <= 32).  A comes through registers into a
// 2-stage k-major copy As [BK][BMP] one 16-k step ahead, so a thread reads
// its rows of a k as float4s; w through a 3-stage cp.async ring Bs
// [BK][BN].  One __syncthreads a step; output stores are float4s.
//
// The A-tile loader is a class with two members, called by every thread:
//   void fetch(int kt): load step kt's A values of this thread's slots into
//     registers.  Slot j is row row0 + tid / 4 + 64 * j and the four k
//     from kt * BK + (tid % 4) * 4, j < Wide<BN>::A4: a thread's rows are
//     fixed across the steps, and so is its k offset within a step.  Values
//     past M or K are 0.
//   float4 get(int j): slot j's four values of the step last fetched.  It
//     is called after the step before it has been computed, so arithmetic
//     placed here does not wait on the loads before the FMAs.
// The scalar route (VEC = false) loads w by scalars and stores masked
// scalars: it takes N % 4 != 0 or unaligned w and out.
#pragma once

#include <cuda_runtime.h>

namespace fp32_wide {

constexpr int THREADS = 256;
constexpr int BK = 16;                 // k a step

// A thread's rows are (i / 4) * (BM / MH) + ty * 4 + i % 4, its columns
// (j / 4) * (BN / NH) + tx * 4 + j % 4: reads of both operands are float4s
// on distinct banks or broadcasts, and stores float4s, TX of them
// contiguous.
template <int BN>
struct Wide {
  static constexpr int TN = BN == 128 ? 8 : 4;
  static constexpr int TM = BN == 16 ? 4 : 8;
  static constexpr int TX = BN / TN, TY = THREADS / TX;
  static constexpr int BM = TY * TM;
  static constexpr int MH = TM / 4, NH = TN / 4;
  static constexpr int BMP = BM + 4;   // As row stride (floats)
  static constexpr int A4 = BM * BK / 4 / THREADS;   // A float4s a thread
  static constexpr int SMEM = (2 * BK * BMP + 3 * BK * BN) * 4;
};

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) {
    const float c = 0.7978845608028654f;          // sqrt(2 / pi)
    const float inner = c * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.0f + tanhf(inner));
  }
  return y;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bias, activation and the store of a thread's 4 consecutive columns.
template <bool VEC>
__device__ __forceinline__ void store4(float* o, int c, int N,
                                       const float (&acc)[4],
                                       const float (&bias)[4], int act) {
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) y[e] = activate(acc[e] + bias[e], act);
  if (VEC) {
    if (c < N) *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < N) o[e] = y[e];
  }
}

// The block at rows [row0, row0 + BM) and columns [col0, col0 + BN) of
// out [M, N]; smem holds Wide<BN>::SMEM bytes.
template <int BN, bool VEC, class Loader>
__device__ __forceinline__ void wide_tile(Loader& ld,
                                          const float* __restrict__ w,
                                          const float* __restrict__ b,
                                          float* __restrict__ out, int M,
                                          int K, int N, int act, int row0,
                                          int col0, float* smem) {
  using T = Wide<BN>;
  float* As = smem;                               // [2][BK][BMP]
  float* Bs = smem + 2 * BK * T::BMP;             // [3][BK][BN]
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int KT = K > 0 ? (K + BK - 1) / BK : 1;

  auto store_x = [&](int kt) {
    float* a = As + (kt & 1) * BK * T::BMP;
#pragma unroll
    for (int j = 0; j < T::A4; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / (BK / 4), k4 = (i % (BK / 4)) * 4;
      const float4 v = ld.get(j);
      a[(k4 + 0) * T::BMP + r] = v.x;
      a[(k4 + 1) * T::BMP + r] = v.y;
      a[(k4 + 2) * T::BMP + r] = v.z;
      a[(k4 + 3) * T::BMP + r] = v.w;
    }
  };
  auto load_w = [&](int kt) {
    float* bs = Bs + (kt % 3) * BK * BN;
    const int k0 = kt * BK;
    if (VEC) {
      for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
        const int kk = i / (BN / 4), gc = col0 + (i % (BN / 4)) * 4;
        const bool ok = k0 + kk < K && gc < N;
        cp_async16(bs + kk * BN + gc - col0,
                   ok ? w + (size_t)(k0 + kk) * N + gc : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
        const int kk = i / BN, gc = col0 + i % BN;
        bs[i] = k0 + kk < K && gc < N ? w[(size_t)(k0 + kk) * N + gc] : 0.0f;
      }
    }
  };

  ld.fetch(0);
  store_x(0);
  load_w(0);
  cp_async_commit();
  float acc[T::TM][T::TN] = {};
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      ld.fetch(kt + 1);
      load_w(kt + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();               // step kt's x and w are in place
    const float* a = As + (kt & 1) * BK * T::BMP;
    const float* bs = Bs + (kt % 3) * BK * BN;
    auto step = [&](int kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int h = 0; h < T::MH; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            a + kk * T::BMP + h * (T::BM / T::MH) + ty * 4);
        av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z,
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < T::NH; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + kk * BN + h * (BN / T::NH) + tx * 4);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z,
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    };
    const int kend = min(BK, K - kt * BK);   // the chain ends at K
    if (kend == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kend; ++kk) step(kk);
    }
    if (kt + 1 < KT) store_x(kt + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < T::NH; ++h) {
    const int c = col0 + h * (BN / T::NH) + tx * 4;
    float bias[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bias[e] = c + e < N ? b[c + e] : 0.0f;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = row0 + (i / 4) * (T::BM / T::MH) + ty * 4 + i % 4;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (r < M) store4<VEC>(out + (size_t)r * N + c, c, N, v, bias, act);
    }
  }
}

}  // namespace fp32_wide
