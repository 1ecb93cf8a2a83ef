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
// What bounds it on the H100: bytes.  At the pipeline's shapes (K, N <= 512,
// M up to 131072 rows) the f32 output (4 bytes an element, against 1 byte
// an input element) dominates the traffic: M16384 K512 N512 moves 42 MB
// (12.6 us at 3.35 TB/s) for 8.6 GOP (4.3 us at the int8 tensor-core peak).
// So the work is in the memory pipeline, not in the math.
//
// Design:
//   * Main loop on the int8 tensor cores: mma.sync m16n8k32 s8.s8.s32.
//     Eight warps; a warp holds 32 rows x (BN or BN / 2) columns of int32
//     accumulators.  The column tile BN (16, 32, 64, 128) follows N, so the
//     narrow layers compute no padding columns; BM is 128 at BN = 128 and
//     256 below (half that on the scalar route).
//   * B (w_q [K, N], N-contiguous) is loaded once per block where K <= 1024:
//     the block's whole [K, BN] slice (at most 64 KB at K = 512) goes to
//     shared memory transposed to [BN][K] (k-contiguous, the .col operand),
//     each 4x4 byte block turned around with __byte_perm on the way.  The
//     block then walks several M tiles with it: no launch, and no
//     shared-memory traffic, is spent on the transpose in the main loop.
//     Past K = 1024 a second instantiation (SLICED) walks K in slices of
//     512 through the same buffer (64 KB at BN = 128, so two blocks still
//     fit an SM), loading and transposing each slice of each M tile it
//     walks when the ring reaches it; the int32 accumulators carry across
//     slices, so the sums stay exact.  The launch picks it by K, so the
//     whole-K kernel is the same code as before the slices existed.  The
//     sliced kernel reads w_scale again at each epilogue, to leave its
//     registers to the slice loads beside the live accumulators; at BN 64
//     and 128 on the vector route it still spills 24 bytes (-Xptxas -v).
//   * A (x_q [M, K], K-contiguous) streams through a 3-stage ring of
//     64-byte k chunks with 16-byte cp.async (zero-filled past M and K),
//     one __syncthreads a chunk, the chunks of consecutive M tiles in one
//     sequence so the next tile's loads overlap this tile's epilogue.  Rows
//     are padded to 80 bytes and fragments read with ldmatrix, conflict-free.
//   * Epilogue straight from the accumulator fragments: the two __fmul_rn of
//     the contract, in its order, stored as float2 (32 contiguous bytes a
//     row for each n8 tile).
//   * The scalar route (VEC = false) takes rows of x_q that are not 16-byte
//     aligned (the embed layer has K = 3) or N % 4 != 0: byte loads, zero-
//     filled, into the same ring and slice, masked scalar stores, and half
//     the rows a block.  The wrapper (kernels/int8_matmul.py) picks the
//     template.
// Integer accumulation is exact whatever the order, and the epilogue is the
// contract's, so the result is bitwise equal to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, NSTAGE = 3;
constexpr int BK = 64;                // bytes of k in one ring stage
constexpr int LDA = BK + 16;          // ring row stride: 16-byte aligned,
                                      // ldmatrix rows on distinct banks
// w's shared-memory slice: all of K up to MAX_WHOLE_K bytes; past it (the
// SLICED kernels) slices of SLICE_CHUNKS ring chunks.
constexpr int MAX_WHOLE_K = 1024, SLICE_CHUNKS = 512 / BK;

// The scalar route takes half the rows a block, for more blocks on its
// small products.
template <int BN, bool VEC>
struct Tile {
  static constexpr int WARPS_N = BN == 128 ? 2 : 1;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WN = BN / WARPS_N;       // a warp's columns
  static constexpr int NT = WN / 8;             // its n8 tiles (even)
  static constexpr int MT = VEC ? 2 : 1;        // its m16 tiles
  static constexpr int BM = WARPS_M * 16 * MT;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t load_or_zero(const int8_t* p, bool ok) {
  return ok ? *p : (int8_t)0;
}

// Four rows k..k+3 of 4 columns (one 32-bit word each, byte j = column j)
// -> four columns of 4 k values (byte i = row i).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Grid: (column tiles, M-tile walkers).  Block (x, y) takes columns
// [x * BN, x * BN + BN) and the M tiles y, y + gridDim.y, ...  SLICED
// walks w in slices (K > MAX_WHOLE_K); otherwise the whole [K, BN] slice
// is loaded once, before the first M tile.
template <int BN, bool VEC, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ a_scale,
                       const float* __restrict__ w_scale,
                       float* __restrict__ out, int M, int K, int N,
                       int rows_per_lane) {
  using T = Tile<BN, VEC>;
  extern __shared__ __align__(16) int8_t smem[];
  const int KC = K > 0 ? (K + BK - 1) / BK : 1;   // ring chunks an M tile
  const int SC = SLICED ? SLICE_CHUNKS : KC;      // ring chunks a w slice
  const int KP = SC * BK + 16;                    // slice row stride
  int8_t* Bs = smem;                              // [BN][KP], k-contiguous
  int8_t* As = smem + BN * KP;                    // [NSTAGE][BM][LDA]
  const int col0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int g = lane >> 2, tig = lane & 3;

  // The block's [SC * BK, BN] slice of w from row k0, transposed, zero
  // past K and N: 16 columns a task where N % 16 == 0, else 4.
  auto load_w = [&](int k0) {
    if (VEC && N % 16 != 0) {
      const int K4 = SC * BK / 4, tasks = K4 * (BN / 4);
      for (int t = threadIdx.x; t < tasks; t += THREADS) {
        const int k = (t % K4) * 4, n = (t / K4) * 4, gc = col0 + n;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = (k0 + k + i < K && gc < N)
                     ? *reinterpret_cast<const uint32_t*>(
                           w + (size_t)(k0 + k + i) * N + gc)
                     : 0u;
        uint32_t tw[4];
        transpose4x4(r[0], r[1], r[2], r[3], tw);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(Bs + (n + j) * KP + k) = tw[j];
      }
    } else if (VEC) {
      const int K4 = SC * BK / 4, tasks = K4 * (BN / 16);
      for (int t = threadIdx.x; t < tasks; t += THREADS) {
        const int k = (t % K4) * 4, n = (t / K4) * 16, gc = col0 + n;
        uint4 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = (k0 + k + i < K && gc < N)
                     ? *reinterpret_cast<const uint4*>(
                           w + (size_t)(k0 + k + i) * N + gc)
                     : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t q[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                                  {r[0].y, r[1].y, r[2].y, r[3].y},
                                  {r[0].z, r[1].z, r[2].z, r[3].z},
                                  {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          uint32_t tw[4];
          transpose4x4(q[c4][0], q[c4][1], q[c4][2], q[c4][3], tw);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<uint32_t*>(Bs + (n + 4 * c4 + j) * KP + k) = tw[j];
        }
      }
    } else {
      const int kw = SC * BK;
      for (int t = threadIdx.x; t < BN * kw; t += THREADS) {
        const int n = t / kw, k = t % kw, gc = col0 + n;
        Bs[n * KP + k] = load_or_zero(w + (size_t)(k0 + k) * N + gc,
                                      k0 + k < K && gc < N);
      }
    }
  };
  load_w(0);

  const int m_tiles = (M + T::BM - 1) / T::BM;
  const int my_tiles =
      (int)blockIdx.y < m_tiles
          ? (m_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y
          : 0;
  const int total = my_tiles * KC;

  // Chunk c of this block: M tile c / KC, k bytes [(c % KC) * BK, + BK).
  auto load_chunk = [&](int c) {
    const int row0 = ((int)blockIdx.y + (c / KC) * (int)gridDim.y) * T::BM;
    const int k0 = (c % KC) * BK;
    int8_t* dst = As + (c % NSTAGE) * T::BM * LDA;
    if (VEC) {
      for (int i = threadIdx.x; i < T::BM * (BK / 16); i += THREADS) {
        const int r = i / (BK / 16), q = i % (BK / 16);
        const int gr = row0 + r, gk = k0 + q * 16;
        const bool ok = gr < M && gk < K;
        cp_async16(dst + r * LDA + q * 16,
                   ok ? x + (size_t)gr * K + gk : x, ok);
      }
    } else {                       // words past K stay zero from the start
      const int words = min(BK / 4, (K - k0 + 3) / 4);
      for (int i = threadIdx.x; i < T::BM * words; i += THREADS) {
        const int r = i / words, q = i % words;
        const int gr = row0 + r, gk = k0 + q * 4;
        const int8_t* src = x + (size_t)gr * K + gk;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (uint32_t)(uint8_t)load_or_zero(src + j,
                                                  gr < M && gk + j < K)
                  << (8 * j);
        *reinterpret_cast<uint32_t*>(dst + r * LDA + q * 4) = word;
      }
    }
  };

  // This thread's columns: wn * WN + nt * 8 + tig * 2 + {0, 1}.  Their
  // scales stay in registers, or in the sliced kernel (whose slice loads
  // need those registers) are read again at each epilogue.
  auto wscale = [&](int nt, int e) {
    const int c = col0 + wn * T::WN + nt * 8 + tig * 2 + e;
    return c < N ? w_scale[c] : 0.0f;
  };
  float ws[T::NT][2];
  if (!SLICED) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) ws[nt][e] = wscale(nt, e);
  }

  if (!VEC) {
    for (int i = threadIdx.x; i < NSTAGE * T::BM * LDA / 4; i += THREADS)
      reinterpret_cast<uint32_t*>(As)[i] = 0u;
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < total) load_chunk(s);
    cp_async_commit();
  }

  int acc[T::MT][T::NT][4] = {};
  for (int c = 0; c < total; ++c) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();               // chunk c landed; chunk c - 1 is read
    if (c + NSTAGE - 1 < total) load_chunk(c + NSTAGE - 1);
    cp_async_commit();

    const int kc = c % KC;
    const int kw0 = SLICED ? (kc - kc % SC) * BK : 0;   // k of Bs's slice
    if (SLICED && kc % SC == 0 && c > 0) {    // the next slice of w
      load_w(kw0);
      __syncthreads();
    }
    const int8_t* At = As + (c % NSTAGE) * T::BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = kc * BK + ks * 32;
      if (kb >= K) break;          // uniform: the rest of the chunk is pad
      uint32_t a[T::MT][4], b[T::NT][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                    At + (wm * 16 * T::MT + mt * 16 + (lane & 7) +
                          ((lane >> 3) & 1) * 8) * LDA +
                        ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int nt = 0; nt < T::NT; nt += 2)
        ldmatrix_x4(b[nt][0], b[nt][1], b[nt + 1][0], b[nt + 1][1],
                    Bs + (wn * T::WN + nt * 8 + (lane & 7) +
                          (lane >> 4) * 8) * KP +
                        kb - kw0 + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }

    if (kc == KC - 1) {            // the M tile is summed: dequantize
      const int row0 =
          ((int)blockIdx.y + (c / KC) * (int)gridDim.y) * T::BM;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wm * 16 * T::MT + mt * 16 + h * 8 + g;
          if (r >= M) continue;
          const float as = a_scale[r / rows_per_lane];
          float* orow = out + (size_t)r * N;
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            const int cc = col0 + wn * T::WN + nt * 8 + tig * 2;
            const float s0 = SLICED ? wscale(nt, 0) : ws[nt][0];
            const float s1 = SLICED ? wscale(nt, 1) : ws[nt][1];
            const float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h]),
                                       __fmul_rn(as, s0));
            const float v1 =
                __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]),
                          __fmul_rn(as, s1));
            if (VEC) {
              if (cc < N)
                *reinterpret_cast<float2*>(orow + cc) = make_float2(v0, v1);
            } else {
              if (cc < N) orow[cc] = v0;
              if (cc + 1 < N) orow[cc + 1] = v1;
            }
          }
        }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
  }
  cp_async_wait<0>();
}

template <int BN, bool VEC, bool SLICED>
int launch_kernel(const void* x, const void* w, const void* a_scale,
                  const void* w_scale, void* out, int M, int K, int N,
                  int rows_per_lane, cudaStream_t stream) {
  using T = Tile<BN, VEC>;
  auto kernel = int8_matmul_kernel<BN, VEC, SLICED>;
  const int KC = K > 0 ? (K + BK - 1) / BK : 1;
  const int smem = BN * ((SLICED ? SLICE_CHUNKS : KC) * BK + 16) +
                   NSTAGE * T::BM * LDA;
  // Per template: the largest dynamic shared memory granted so far, and
  // the resident blocks an SM takes at the last size asked.
  static int granted = 48 * 1024, sized = -1, per_sm = 1, sms = 0;
  cudaError_t err;
  if (smem > granted) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem != sized) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
    sized = smem;
  }
  // Spread the M tiles evenly over the blocks the card holds at once.
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + T::BM - 1) / T::BM;
  const int slots = sms * per_sm / n_tiles > 0 ? sms * per_sm / n_tiles : 1;
  const int per_block = (m_tiles + slots - 1) / slots;
  dim3 grid(n_tiles, (m_tiles + per_block - 1) / per_block);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)a_scale,
      (const float*)w_scale, (float*)out, M, K, N, rows_per_lane);
  return (int)cudaGetLastError();
}

template <int BN, bool VEC>
int launch(const void* x, const void* w, const void* a_scale,
           const void* w_scale, void* out, int M, int K, int N,
           int rows_per_lane, cudaStream_t stream) {
  if (K > MAX_WHOLE_K)
    return launch_kernel<BN, VEC, true>(x, w, a_scale, w_scale, out, M, K,
                                        N, rows_per_lane, stream);
  return launch_kernel<BN, VEC, false>(x, w, a_scale, w_scale, out, M, K, N,
                                       rows_per_lane, stream);
}

}  // namespace

// tmpl = vec + 2 * log2(BN / 16), BN in {16, 32, 64, 128}: the wrapper's
// choice (kernels/int8_matmul.py::template).  vec needs 16-byte aligned
// x and w, K % 16 == 0 and N % 4 == 0.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* a_scale, const void* w_scale,
                                  void* out, int M, int K, int N,
                                  int rows_per_lane, int tmpl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tmpl) {
    case 0: return launch<16, false>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 1: return launch<16, true>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 2: return launch<32, false>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 3: return launch<32, true>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 4: return launch<64, false>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 5: return launch<64, true>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 6: return launch<128, false>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    case 7: return launch<128, true>(x, w, a_scale, w_scale, out, M, K, N, rows_per_lane, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
