// W8A16 matrix product: int8 weights widened in the kernel, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul.py, w8_matmul_pallas
// (_w8_kernel), reached through kernels/ops.py w8_matmul.  x [M, K] (bf16
// or f32) times w_q int8 [K, N]: each int8 weight is widened exactly
// (every int8 value is a bf16), the products are summed in f32, and the
// epilogue forms acc * w_scale[col] in f32 and rounds it to x's type
// (round to nearest even), as the Pallas kernel's `(acc * s).astype(
// o.dtype)` does.  No caller in the JAX package or in the port reaches it
// on a model path; it stands as an op, held against its plain version.
//
// Three routes, picked in Python by kernels/int8_matmul.py::w8_route from
// the shape alone (never a retry) and switched on here by their code.
//
// stream (code 1): up to 64 rows (decode; tinyllama's MLP at M = 4).
// Bound by bytes: the int8 weight is read once (11.5 MB at K2048 N5632,
// 3.4 us at 3.35 TB/s).  The grid cuts the work into 128-column strips x
// K splits of a multiple of 16 rows (x chunks of rows), sized in Python so
// that every SM gets at least two blocks.  Each thread reads w with
// 16-byte loads (16 neighbouring columns of one row), the next rows in
// flight while it computes, and the first ones in flight while the
// block stages its x slice in shared memory.  The int8 values widen in
// registers without the conversion unit: the bytes, offset by 128, go
// into the mantissa of 2^23 by a byte permute and one subtraction gives
// the value, exactly.  bf16 x (w8_stream_mma_kernel): the products run on
// the tensor cores, mma.sync m16n8k16 with f32 sums, 16 rows of x a block
// (zero past M): lane (g, q) loads rows 2q, 2q+1, 2q+8, 2q+9 of a 16-row
// step at its 16 columns and makes each column one n8 tile's column g, so
// it widens its own bytes straight into B fragments.  Widening costs
// about 3 instructions a weight whatever M is, where FFMA at M = 4 costs
// 6 and grows with M.  f32 x (w8_stream_kernel; it must not round x to
// bf16): 8 column groups of 16 x 32 row lanes, MR x 16 f32 FMA sums a
// thread.
// Either way a block sums its warps in shared memory in fixed order and
// writes its strip's partial sums to a scratch [splits, M, N] f32 that
// the wrapper allocates; a second launch, programmatic-dependent so that
// its launch overlaps the first, adds the splits in order, scales and
// rounds.  No atomics: results are the same run to run.
//
// wgmma (code 2): bf16 x at more rows (prefill; M = 8192).  Bound by
// operations (2MKN at the bf16 tensor cores' 989 TFLOP/s).  "Swap AB":
// the block computes outT = wT xT for 128 columns of w by 256 rows of x,
// so the widened w is wgmma's register A operand and never goes back to
// shared memory.  A producer warp issues TMA copies (x as 128-byte-
// swizzled bf16, the wgmma B operand, K-major; w as 128-byte-swizzled
// int8) through a four-stage ring of mbarriers; two consumer warpgroups,
// 64 columns of w each, widen each stage's int8 into A fragments while
// the stage before runs on the tensor cores (m64n256k16, f32 sums in
// registers), then hand that stage back.  A lane's two A rows are two
// neighbouring columns of w (one 16-bit load a row of the swizzled tile,
// bank-conflict free), so its D rows are neighbouring outputs of one
// 32-bit store.  The epilogue scales in f32, rounds to bf16 and stores
// with masks on the M and N edges; TMA zero-fills rows and columns past
// M, K and N.  TMA needs 16-byte row strides: K % 8 == 0 and N % 16 ==
// 0.
//
// tiled (code 0): every other shape (ragged N, unaligned data, bf16 x
// with K % 8 != 0 at more rows, f32 x at more rows, which must not move
// to TF32).  64 x 64 output tiles, 256 threads, 4 x 4 outputs a thread, K
// in steps of 32 staged in shared memory as f32; ragged edges zero-filled
// on load and masked on store.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The four int8 values of a word as f32, exactly: byte b + 128 is put
// into the mantissa of 2^23 (0x4B0000bb is 8388608 + b + 128), then
// 8388608 + 128 is taken off.
__device__ __forceinline__ void widen4(uint32_t word, float (&f)[4]) {
  const uint32_t u = word ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// ------------------------------------------------------- tiled route ---

namespace tiled {
constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int LDA = BK + 1;   // x tile [row][k], padded against conflicts
}  // namespace tiled

template <typename T>
__global__ void __launch_bounds__(tiled::THREADS)
    w8_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale, T* __restrict__ out,
                    int M, int K, int N) {
  using namespace tiled;
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

template <typename T>
int launch_tiled(const void* x, const void* w, const void* w_scale,
                 void* out, int M, int K, int N, cudaStream_t s) {
  dim3 grid((N + tiled::BN - 1) / tiled::BN,
            (M + tiled::BM - 1) / tiled::BM);
  w8_tiled_kernel<T><<<grid, tiled::THREADS, 0, s>>>(
      (const T*)x, (const int8_t*)w, (const float*)w_scale, (T*)out, M, K,
      N);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ stream route ---

namespace stream {
// Mirrored in kernels/int8_matmul.py (_STREAM_COLS, _STREAM_ROWS,
// _STREAM_KS_MAX).
constexpr int THREADS = 256;
constexpr int COLS = 128;     // columns of a strip: 8 groups of 16
constexpr int TX = 8, TY = 32;
constexpr int MR_MAX = 8;     // rows of x a block takes
constexpr int KS_MAX = 512;   // rows of w a K split takes, at most
constexpr int UNROLL = 4;     // 16-byte loads in flight a thread
constexpr int MMA_ROWS = 16;  // rows of bf16 x a block takes (mma's M)
constexpr int XS_LD = KS_MAX + 8;   // its x slice's row stride, in bf16
constexpr int RED_LD = COLS + 8;    // its warps' sums' row stride, in f32
}  // namespace stream

// acc[m][j] += x[m] * w[j] for one row of 16 int8 weights.
template <int MR>
__device__ __forceinline__ void fma_row(float (&acc)[MR][16], uint4 v,
                                        const float* __restrict__ xr) {
  float xv[MR];
  if constexpr (MR >= 4) {
#pragma unroll
    for (int m = 0; m < MR; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(xr + m);
      xv[m] = q.x;
      xv[m + 1] = q.y;
      xv[m + 2] = q.z;
      xv[m + 3] = q.w;
    }
  } else if constexpr (MR == 2) {
    const float2 q = *reinterpret_cast<const float2*>(xr);
    xv[0] = q.x;
    xv[1] = q.y;
  } else {
    xv[0] = xr[0];
  }
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float f[4];
    widen4(words[q], f);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int m = 0; m < MR; ++m)
        acc[m][4 * q + e] = fmaf(xv[m], f[e], acc[m][4 * q + e]);
  }
}

// Rows k, k + TY, ... (UNROLL of them) of this thread's 16 columns; rows
// at or past kend read 0.
__device__ __forceinline__ void load_rows(uint4 (&v)[stream::UNROLL],
                                          const int8_t* __restrict__ wp,
                                          int k, int kend, int N) {
#pragma unroll
  for (int u = 0; u < stream::UNROLL; ++u) {
    const int kk = k + u * stream::TY;
    v[u] = kk < kend ? __ldg(reinterpret_cast<const uint4*>(
                           wp + (size_t)kk * N))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

// f32 x.  Grid (strips, splits, chunks of MR rows): partial[split][row]
// [col] = the sum over the split's rows of w of x[row][k] * w[k][col].
template <int MR>
__global__ void __launch_bounds__(stream::THREADS)
    w8_stream_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ w,
                     float* __restrict__ partial, int M, int K, int N,
                     int ks) {
  using namespace stream;
  // x slice [ks][MR] during the loop, then the warps' sums [8][MR][COLS].
  __shared__ __align__(16) float smem[(THREADS / 32) * MR * COLS];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int col0 = blockIdx.x * COLS + tx * 16;
  const int kbeg = blockIdx.y * ks, kend = min(K, kbeg + ks);
  const int len = kend - kbeg;
  const int row0 = blockIdx.z * MR;
  const bool live = col0 < N;
  const int8_t* wp = w + col0;

  // The thread's first rows of w are in flight while x is staged.
  uint4 cur[UNROLL];
  load_rows(cur, wp, kbeg + ty, live ? kend : 0, N);
  // x[row0 + m][kbeg + kk] as smem[kk][m] (rows past M 0), eight loads a
  // thread in flight.
  for (int i0 = threadIdx.x; i0 < MR * len; i0 += THREADS * 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS, m = i / len;
      v[u] = i < MR * len && row0 + m < M
                 ? x[(size_t)(row0 + m) * K + kbeg + i - m * len]
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * THREADS, m = i / len;
      if (i < MR * len) smem[(i - m * len) * MR + m] = v[u];
    }
  }
  // Let the reduction launch: it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (live) {
    // Each step computes UNROLL rows while the next UNROLL are loaded.
    for (int k = kbeg + ty; k < kend; k += UNROLL * TY) {
      uint4 nxt[UNROLL];
      load_rows(nxt, wp, k + UNROLL * TY, kend, N);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (k + u * TY < kend)
          fma_row<MR>(acc, cur[u], smem + (k + u * TY - kbeg) * MR);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
    }
  }

  // The warp's four row lanes (lane / 8) hold the same columns.
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 8);
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
  __syncthreads();   // the x slice is no longer read
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < TX) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(smem + (warp * MR + m) * COLS + tx * 16 +
                                   j) =
            make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2],
                        acc[m][j + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    const int r = row0 + m, col = blockIdx.x * COLS + c;
    float s = smem[m * COLS + c];
#pragma unroll
    for (int wi = 1; wi < THREADS / 32; ++wi)
      s += smem[(wi * MR + m) * COLS + c];
    if (r < M && col < N)
      partial[((size_t)blockIdx.y * M + r) * N + col] = s;
  }
}

// out[row][col..col+3] = (the splits' sums, added in split order) *
// w_scale[col..col+3]; N % 4 == 0.  Launched as a programmatic dependent
// of the stream kernel: it starts early and waits here for that grid to
// finish and its writes to be visible.
template <typename T>
__global__ void __launch_bounds__(256)
    w8_reduce_kernel(const float* __restrict__ partial,
                     const float* __restrict__ w_scale, T* __restrict__ out,
                     int M, int N, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t mn = (size_t)M * N;
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  // Sixteen splits' loads in flight at a time, added in split order.
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < splits; p0 += 16) {
    float4 q[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      q[u] = p0 + u < splits ? *reinterpret_cast<const float4*>(
                                   partial + (p0 + u) * mn + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (p0 + u >= splits) break;
      s.x += q[u].x;
      s.y += q[u].y;
      s.z += q[u].z;
      s.w += q[u].w;
    }
  }
  const float4 sc = *reinterpret_cast<const float4*>(w_scale + i % N);
  store(out + i, __fmul_rn(s.x, sc.x));
  store(out + i + 1, __fmul_rn(s.y, sc.y));
  store(out + i + 2, __fmul_rn(s.z, sc.z));
  store(out + i + 3, __fmul_rn(s.w, sc.w));
}

// ---- the stream route for bf16 x: the same strips and splits, the
// products on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums) ----

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The high halves of two f32 words as one bf16x2 word (exact where the
// low halves are 0, as for every widened int8).
__device__ __forceinline__ uint32_t high_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Rows k + 2q, k + 2q + 1, k + 2q + 8 and k + 2q + 9 of this thread's 16
// columns: the k-pairs of its B fragments; rows at or past kend read 0.
__device__ __forceinline__ void load_quad(uint4 (&v)[4],
                                          const int8_t* __restrict__ wp,
                                          int k, int kend, int N) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int kk = k + (u & 1) + 8 * (u >> 1);
    v[u] = kk < kend ? __ldg(reinterpret_cast<const uint4*>(
                           wp + (size_t)kk * N))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Grid (strips, splits, chunks of 16 rows of x), as w8_stream_kernel; the
// 8 warps take the split's 16-row steps of w in turn.  Lane (g, q) loads
// rows 2q, 2q+1, 2q+8, 2q+9 of a step at its strip's columns 16 g .. 16 g
// + 15, and column 16 g + j is column g of the step's j-th n8 tile, so
// each lane widens its own bytes straight into B fragments: no exchange
// between lanes.  A (x, 16 rows, zero past M) comes from shared memory.
__global__ void __launch_bounds__(stream::THREADS, 2)
    w8_stream_mma_kernel(const uint16_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         float* __restrict__ partial, int M, int K, int N,
                         int ks) {
  using namespace stream;
  // x slice [16][XS_LD] bf16 during the loop, then the warps' sums
  // [8][mr][COLS] f32.
  extern __shared__ __align__(16) uint8_t dsmem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(dsmem);
  float* red = reinterpret_cast<float*>(dsmem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int kbeg = blockIdx.y * ks, kend = min(K, kbeg + ks);
  const int len = kend - kbeg, steps = (len + 15) / 16;
  const int row0 = blockIdx.z * MMA_ROWS, mr = min(MMA_ROWS, M - row0);
  const int col0 = blockIdx.x * COLS + 16 * g;
  // Lanes past N load zeros but still take part in every mma.
  const int kend_w = col0 < N ? kend : kbeg;
  const int8_t* wp = w + (col0 < N ? col0 : 0);

  uint4 cur[4];
  load_quad(cur, wp, kbeg + 16 * warp + 2 * q, kend_w, N);
  // x[row0 + m][kbeg + kk] as xs[m][kk], 0 past M and past the split, all
  // of a thread's loads in flight together: 8 bf16 a load where rows and
  // splits start on 16-byte boundaries, else one.
  const int cols = 16 * steps;
  if ((K % 8) == 0 && (ks % 8) == 0) {
    const int vecs = MMA_ROWS * cols / 8;
    for (int i0 = threadIdx.x; i0 < vecs; i0 += THREADS * 4) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS, m = i / (cols / 8);
        const int kk = 8 * (i - m * (cols / 8));
        v[u] = i < vecs && m < mr && kk < len
                   ? __ldg(reinterpret_cast<const uint4*>(
                         x + (size_t)(row0 + m) * K + kbeg + kk))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS, m = i / (cols / 8);
        if (i < vecs)
          *reinterpret_cast<uint4*>(xs + m * XS_LD +
                                    8 * (i - m * (cols / 8))) = v[u];
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < MMA_ROWS * cols; i0 += THREADS * 8) {
      uint16_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * THREADS, m = i / cols, kk = i - m * cols;
        v[u] = i < MMA_ROWS * cols && m < mr && kk < len
                   ? x[(size_t)(row0 + m) * K + kbeg + kk]
                   : (uint16_t)0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * THREADS, m = i / cols;
        if (i < MMA_ROWS * cols) xs[m * XS_LD + i - m * cols] = v[u];
      }
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int c = warp; c < steps; c += THREADS / 32) {
    uint4 nxt[4];
    load_quad(nxt, wp, kbeg + 16 * (c + THREADS / 32) + 2 * q, kend_w, N);
    const uint16_t* xr = xs + g * XS_LD + 16 * c + 2 * q;
    const uint32_t a[4] = {
        *reinterpret_cast<const uint32_t*>(xr),
        *reinterpret_cast<const uint32_t*>(xr + 8 * XS_LD),
        *reinterpret_cast<const uint32_t*>(xr + 8),
        *reinterpret_cast<const uint32_t*>(xr + 8 * XS_LD + 8)};
    const uint32_t rows[4][4] = {{cur[0].x, cur[0].y, cur[0].z, cur[0].w},
                                 {cur[1].x, cur[1].y, cur[1].z, cur[1].w},
                                 {cur[2].x, cur[2].y, cur[2].z, cur[2].w},
                                 {cur[3].x, cur[3].y, cur[3].z, cur[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float f[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) widen4(rows[u][e], f[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_bf16(acc[4 * e + i], a, high_halves(f[0][i], f[1][i]),
                 high_halves(f[2][i], f[3][i]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
  }

  // acc[j] holds rows g and g + 8, columns n = 2q, 2q + 1 of tile j: strip
  // column 16 n + j, kept at 8 j + n of a row of RED_LD floats (a store
  // then meets each bank at most twice).
  __syncthreads();   // the x slice is no longer read
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= mr) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(warp * mr + r) * RED_LD + 8 * j + 2 * q + e] = acc[j][2 * h + e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < mr * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    const int col = blockIdx.x * COLS + c, at = 8 * (c % 16) + c / 16;
    float s = red[m * RED_LD + at];
#pragma unroll
    for (int wi = 1; wi < THREADS / 32; ++wi)
      s += red[(wi * mr + m) * RED_LD + at];
    if (col < N) partial[((size_t)blockIdx.y * M + row0 + m) * N + col] = s;
  }
}

// The reduction of the stream route's splits, as a programmatic dependent
// launch of the kernel just launched.
template <typename T>
int launch_reduce(const void* scratch, const void* w_scale, void* out, int M,
                  int N, int splits, cudaStream_t s) {
  const size_t quads = (size_t)M * N / 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((quads + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, w8_reduce_kernel<T>, (const float*)scratch,
      (const float*)w_scale, (T*)out, M, N, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MR>
int launch_stream_mr(const void* x, const void* w, void* scratch, int M,
                     int K, int N, int ks, int splits, cudaStream_t s) {
  dim3 grid((N + stream::COLS - 1) / stream::COLS, splits,
            (M + MR - 1) / MR);
  w8_stream_kernel<MR><<<grid, stream::THREADS, 0, s>>>(
      (const float*)x, (const int8_t*)w, (float*)scratch, M, K, N, ks);
  return (int)cudaGetLastError();
}

// bf16 x takes the tensor-core kernel; f32 x the FFMA kernel at the
// smallest of 1, 2, 4, 8 rows a block that covers M (8 past).
template <typename T>
int launch_stream(const void* x, const void* w, const void* w_scale,
                  void* out, void* scratch, int M, int K, int N, int ks,
                  cudaStream_t s) {
  if (ks < 1 || ks > stream::KS_MAX || (N % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (K + ks - 1) / ks;
  int err;
  if constexpr (sizeof(T) == 2) {
    const int mr = M < stream::MMA_ROWS ? M : stream::MMA_ROWS;
    const int bytes = max(stream::MMA_ROWS * stream::XS_LD * 2,
                          (stream::THREADS / 32) * mr * stream::RED_LD * 4);
    cudaError_t e = cudaFuncSetAttribute(
        w8_stream_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + stream::COLS - 1) / stream::COLS, splits,
              (M + stream::MMA_ROWS - 1) / stream::MMA_ROWS);
    w8_stream_mma_kernel<<<grid, stream::THREADS, bytes, s>>>(
        (const uint16_t*)x, (const int8_t*)w, (float*)scratch, M, K, N, ks);
    err = (int)cudaGetLastError();
  } else if (M <= 1) {
    err = launch_stream_mr<1>(x, w, scratch, M, K, N, ks, splits, s);
  } else if (M <= 2) {
    err = launch_stream_mr<2>(x, w, scratch, M, K, N, ks, splits, s);
  } else if (M <= 4) {
    err = launch_stream_mr<4>(x, w, scratch, M, K, N, ks, splits, s);
  } else {
    err = launch_stream_mr<stream::MR_MAX>(x, w, scratch, M, K, N, ks,
                                           splits, s);
  }
  if (err) return err;
  return launch_reduce<T>(scratch, w_scale, out, M, N, splits, s);
}

// ------------------------------------------------------- wgmma route ---

namespace wg {
// A block computes outT [BN w columns][BM x rows] = wT xT: each of the two
// consumer warpgroups owns 64 columns of w (wgmma's M) against all BM rows
// of x (wgmma's N = 256), K in steps of BK through a STAGES-deep ring.
constexpr int BM = 256, BN = 128, BK = 64, STAGES = 4;
// Warpgroups 0 and 1 consume; warp 8 issues the copies.
constexpr int THREADS = 2 * 128 + 32, PRODUCER = 256;
constexpr uint32_t SW_ATOM = 1024;               // 8 rows of 128 bytes
constexpr uint32_t X_BYTES = BM * BK * 2;        // bf16 box {64, BM}
constexpr uint32_t W8_BYTES = BK * BN;           // int8 box {BN, BK}
constexpr uint32_t STAGE = X_BYTES + W8_BYTES;
constexpr uint32_t BARS = STAGES * STAGE;
// The ring, two barriers a stage (full, empty), and the slack to align the
// base to a swizzle atom.
constexpr size_t SMEM = BARS + 8 * 2 * STAGES + SW_ATOM;
static_assert(STAGE % SW_ATOM == 0, "stages keep the swizzle alignment");
static_assert(BN == 128, "one 128-byte swizzled row of int8 a k");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it (and from reusing an A register the
// wgmma still reads).
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define W8_R(a, b, c, d, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define W8_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define W8_F16(d, i) \
  W8_F4(d, i), W8_F4(d, i + 4), W8_F4(d, i + 8), W8_F4(d, i + 12)
#define W8_F32(d, i) W8_F16(d, i), W8_F16(d, i + 16)

// D[64 x 256] += A[64 x 16] B[16 x 256]: A (wT) from registers, B (xT)
// K-major in shared memory (x's own rows).
__device__ __forceinline__ void wgmma_wx(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      W8_R(0, 1, 2, 3, 4, 5, 6, 7) ", " W8_R(8, 9, 10, 11, 12, 13, 14, 15) ", "
      W8_R(16, 17, 18, 19, 20, 21, 22, 23) ", "
      W8_R(24, 25, 26, 27, 28, 29, 30, 31) ", "
      W8_R(32, 33, 34, 35, 36, 37, 38, 39) ", "
      W8_R(40, 41, 42, 43, 44, 45, 46, 47) ", "
      W8_R(48, 49, 50, 51, 52, 53, 54, 55) ", "
      W8_R(56, 57, 58, 59, 60, 61, 62, 63) ", "
      W8_R(64, 65, 66, 67, 68, 69, 70, 71) ", "
      W8_R(72, 73, 74, 75, 76, 77, 78, 79) ", "
      W8_R(80, 81, 82, 83, 84, 85, 86, 87) ", "
      W8_R(88, 89, 90, 91, 92, 93, 94, 95) ", "
      W8_R(96, 97, 98, 99, 100, 101, 102, 103) ", "
      W8_R(104, 105, 106, 107, 108, 109, 110, 111) ", "
      W8_R(112, 113, 114, 115, 116, 117, 118, 119) ", "
      W8_R(120, 121, 122, 123, 124, 125, 126, 127)
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : W8_F32(d, 0), W8_F32(d, 32), W8_F32(d, 64), W8_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef W8_R
#undef W8_F4
#undef W8_F16
#undef W8_F32

}  // namespace wg

__global__ void __launch_bounds__(wg::THREADS, 1)
    w8_wgmma_kernel(__grid_constant__ const CUtensorMap x_map,
                    __grid_constant__ const CUtensorMap w_map,
                    const float* __restrict__ w_scale,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((SW_ATOM - (raw & (SW_ATOM - 1))) &
                              (SW_ATOM - 1));
  const uint32_t base = smem_u32(smem);
  auto full = [&](int s) { return base + BARS + 8u * s; };
  auto empty = [&](int s) { return base + BARS + 8u * (STAGES + s); };
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == PRODUCER) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t st = base + s * STAGE;
        tma_load(st, &x_map, full(s), it * BK, m0);
        tma_load(st + X_BYTES, &w_map, full(s), n0, it * BK);
      }
    }
    return;
  }

  // ---- consumers ----
  // Row r of warp `warp`'s 16 rows of wT is column 2 (r % 8) + r / 8 of its
  // 16-column chunk of the int8 tile: lane (g, q) holds rows g and g + 8,
  // so its two columns are neighbours (one 16-bit load a row of w), and
  // its D rows are the neighbouring outputs of one 32-bit store.
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  const int chunk = wgi * 4 + warp;   // 16-byte chunk of an int8 row

  // The A fragments of one stage: for each k16 step, rows g and g + 8 at
  // k = 2q, 2q + 1 and at k = 2q + 8, 2q + 9, widened to bf16 pairs.  The
  // int8 tile is 128-byte swizzled: chunk c of row k sits at c ^ (k % 8).
  auto widen_stage = [&](int s, uint32_t(&a)[BK / 16][4]) {
    const uint8_t* w8 = smem + s * STAGE + X_BYTES + 2 * g;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * kk + 8 * h + 2 * q;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(
            w8 + k * 128 + ((chunk ^ (k & 7)) << 4));
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(
            w8 + (k + 1) * 128 + ((chunk ^ ((k + 1) & 7)) << 4));
        // (k, n), (k + 1, n), (k, n + 1), (k + 1, n + 1)
        float f[4];
        widen4(__byte_perm(lo, hi, 0x5140), f);
        a[kk][2 * h] = high_halves(f[0], f[1]);
        a[kk][2 * h + 1] = high_halves(f[2], f[3]);
      }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  // One step: widen stage it's w (while step it - 1's products run), issue
  // its products, wait for step it - 1's and hand that stage back.
  auto step = [&](int it, uint32_t(&a)[BK / 16][4],
                  uint32_t(&a_prev)[BK / 16][4]) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    widen_stage(s, a);
    const uint32_t sx = base + s * STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_wx(acc, a[kk], desc_sw128(sx + kk * 32, 16, SW_ATOM));
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a_prev[kk][i]);
    if (it > 0) mbar_arrive(empty((it - 1) % STAGES));
  };
  for (int it = 0; it < n_k; it += 2) {
    step(it, a0, a1);
    if (it + 1 < n_k) step(it + 1, a1, a0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_reg(acc[i]);

  // Epilogue: acc[4 j + e] is D row g (w column n), acc[4 j + 2 + e] row
  // g + 8 (column n + 1), both at D column 8 j + 2 q + e (x row m).
  const int n = n0 + 16 * chunk + 2 * g;
  if (n >= N) return;
  const float2 sc = *reinterpret_cast<const float2*>(w_scale + n);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * q + e;
      if (m >= M) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
          __floats2bfloat162_rn(__fmul_rn(acc[4 * j + e], sc.x),
                                __fmul_rn(acc[4 * j + 2 + e], sc.y));
    }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = (EncodeTiled)p;
  }
  *fn = cached;
  return 0;
}

// A 2-D map over a row-major [rows, cols] tensor, boxes of box_cols x
// box_rows, out-of-range elements read 0.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
             CUtensorMapDataType type, int elem_bytes, int rows, int cols,
             int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)r;
}

int launch_wgmma(const void* x, const void* w, const void* w_scale,
                 void* out, int M, int K, int N, cudaStream_t s) {
  if (K % 8 != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  EncodeTiled enc;
  int err = encoder(&enc);
  if (err) return err;
  CUtensorMap x_map, w_map;
  if ((err = make_map(enc, &x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M,
                      K, 64, wg::BM, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if ((err = make_map(enc, &w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N,
                      wg::BN, wg::BK, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  cudaError_t e = cudaFuncSetAttribute(
      w8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wg::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + wg::BN - 1) / wg::BN, (M + wg::BM - 1) / wg::BM);
  w8_wgmma_kernel<<<grid, wg::THREADS, wg::SMEM, s>>>(
      x_map, w_map, (const float*)w_scale, (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// route: 0 tiled, 1 stream (K splits of ks rows of w; scratch holds
// ceil(K / ks) x M x N floats), 2 wgmma
// (bf16 x only); kernels/int8_matmul.py::w8_route picks it.
extern "C" int w8_matmul_launch(const void* x, const void* w,
                                const void* w_scale, void* out,
                                void* scratch, int M, int K, int N,
                                int is_bf16, int route, int ks,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case 0:
      return is_bf16 ? launch_tiled<__nv_bfloat16>(x, w, w_scale, out, M, K,
                                                   N, s)
                     : launch_tiled<float>(x, w, w_scale, out, M, K, N, s);
    case 1:
      return is_bf16 ? launch_stream<__nv_bfloat16>(x, w, w_scale, out,
                                                    scratch, M, K, N, ks,
                                                    s)
                     : launch_stream<float>(x, w, w_scale, out, scratch, M,
                                            K, N, ks, s);
    case 2:
      return is_bf16 ? launch_wgmma(x, w, w_scale, out, M, K, N, s)
                     : (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}
