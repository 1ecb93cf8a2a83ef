// k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn.py, knn_pallas (_knn_kernel): for each
// query sample, d = |s|^2 - 2 s.p + |p|^2 against every point, then k
// rounds of row argmin, each pick overwritten with the float maximum.
// Output int64 [B, S, k] in ascending distance order, ties to the lowest
// index (jnp.argmin's and torch.argmin's rule).  Any N, any 1 <= k <= N,
// C <= 8 (the wrapper checks).  With a radius (r2 = radius^2, +inf for
// plain kNN) it is also src/repro/core/knn.py's ball_query: a pick whose
// distance exceeds r2 is replaced by pick 0 (PointNet++'s fill).
//
// What bounds it on the H100: operations, not bytes.  A dispatch reads
// B*(S+N)*C floats and writes B*S*k indices, but does B*S*N*(2C+3)
// distance flops and, per (query, point) pair, at least one compare of a
// selection (Elite's stage 1, B32 S512 N1024, needs 2.3 us of it).  The k
// rounds of argmin that the TPU kernel runs cost k scans of the row; here
// a query costs one pass over the points and a selection among a few.
//
// For finite distances, k rounds of (argmin, overwrite with FLT_MAX) give
// the first k of a stable sort by (distance, index).  So:
//
// - Keys.  A distance maps to an order-preserving unsigned key (the bits of
//   a negative flipped, the sign bit of a non-negative set; -0 taken as +0
//   first so that equal floats give equal keys: s2 - 2*cross + p2 can be
//   slightly negative at s = p).  A candidate is (key << 32) | index, one
//   64-bit integer, so (distance, index) order is integer order.
// - knn_kernel (k <= 32, N <= 1024: every Lite, M-2 and Elite launch).
//   One warp a query; lane l computes the candidates of the points
//   j = l (mod 32), keeps them in registers and takes their minimum.  The
//   k-th smallest of the 32 lane minima, T, bounds the k-th smallest
//   candidate from above (k candidates are <= T), so the k nearest are
//   among the candidates <= T: typically a few more than k.  They are
//   gathered in shared memory (a prefix sum of the lanes' counts) and
//   sorted by a bitonic network across the lanes, and lane r writes pick
//   r, coalesced.  Where more than 32 pass (many near-ties), the warp takes
//   k rounds of "the smallest candidate above the last pick" over its
//   registers instead.  No distance row is written anywhere.  The block's
//   8 warps serve 8 * qpw queries of one cloud, qpw chosen for about
//   TARGET_BLOCKS blocks over the dispatch, and the block stages the
//   cloud in shared memory once for all of them, one plane a channel plus
//   |p|^2.
// - The float maximum.  Once the next candidate is not below FLT_MAX (fewer
//   than k distances below FLT_MAX in the row, as when coordinates near
//   +-1e19 overflow the squares to inf), the k rounds stop following the
//   sort: the overwritten picks (now FLT_MAX) tie with or undercut what is
//   left.  Every remaining round then picks j*, the lowest index among the
//   picks so far and the first candidate left if it is exactly FLT_MAX (or
//   if there are no picks yet), and overwrites it with itself, so the
//   kernel writes j* to the rest of the row, as knn_select does.
// - The radius fill.  As each kernel writes out, it holds the distance of
//   every pick as the key it selected on (a re-pick j* takes the key of
//   the pick that first chose it), compares that key with key(r2), and
//   writes pick 0's index where it is larger.  d <= r2 and key(d) <=
//   key(r2) agree for every non-NaN d, so no distance is recomputed, and
//   at r2 = +inf nothing is filled: plain kNN, bit for bit.
// - Any other shape (N > 1024 or k > 32; no model's launch has one):
//   knn_rounds_kernel runs the TPU kernel's algorithm, k rounds of argmin
//   with each pick overwritten by FLT_MAX, one warp a query, its distance
//   row in shared memory, or in a device scratch buffer [rows, N] that the
//   wrapper allocates when 4 rows do not fit; the warps walk the queries
//   with a grid stride.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, and the
// file builds with --fmad=false), in the order of the plain version
// (repro_torch.core.knn.pairwise_sqdist), so kernel and plain version agree
// bit for bit.
#include <algorithm>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr int WARPS = 8;                 // knn_kernel: warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int TARGET_BLOCKS = 1056;      // its blocks a dispatch, 8 an SM
constexpr int SELECT_K = 32;             // the k and N it takes
constexpr int SELECT_POINTS = 1024;
constexpr int ROUND_WARPS = 4;           // k-round path: warps a block
constexpr int ROUND_MAX_BLOCKS = 264;    // its grid (a scratch row a warp)
constexpr int SMEM_BYTES = 232448;       // dynamic shared memory a block
constexpr unsigned KEY_FLT_MAX = 0xff7fffffu;   // key(FLT_MAX)
constexpr u64 NONE = ~0ull;                     // no candidate

__host__ __device__ __forceinline__ unsigned key_of_bits(unsigned u) {
  if (u == 0x80000000u) u = 0u;          // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned order_key(float d) {
  return key_of_bits(__float_as_uint(d));
}

// sum_c a[c] * b[c], added left to right, each step rounded on its own.
template <int C>
__device__ __forceinline__ float dot_in_order(const float* a,
                                              const float* b) {
  float acc = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) acc = __fadd_rn(acc, __fmul_rn(a[c], b[c]));
  return acc;
}

// Shuffles of a 64-bit candidate.
__device__ __forceinline__ u64 shfl(u64 v, int src) {
  return ((u64)__shfl_sync(0xffffffffu, (unsigned)(v >> 32), src) << 32) |
         __shfl_sync(0xffffffffu, (unsigned)v, src);
}

__device__ __forceinline__ u64 shfl_xor(u64 v, int mask) {
  return ((u64)__shfl_xor_sync(0xffffffffu, (unsigned)(v >> 32), mask)
          << 32) |
         __shfl_xor_sync(0xffffffffu, (unsigned)v, mask);
}

// The warp's smallest candidate, in every lane.
__device__ __forceinline__ u64 warp_min(u64 v) {
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : UINT_MAX);
  return ((u64)hi << 32) | lo;
}

// k <= SELECT_K, N <= SELECT_POINTS: the threshold selection of the
// header.
template <int C>
__global__ void __launch_bounds__(THREADS)
    knn_kernel(const float* __restrict__ samples,
               const float* __restrict__ points, int64_t* __restrict__ out,
               int S, int N, int k, int qpw, int tcap, unsigned kr2) {
  constexpr int M = SELECT_POINTS / 32;           // candidates a lane
  extern __shared__ __align__(16) unsigned char smem[];
  u64* gather = reinterpret_cast<u64*>(smem);              // [WARPS][32]
  float* xs = reinterpret_cast<float*>(gather + WARPS * 32);  // [C][tcap]
  float* p2s = xs + C * tcap;                                 // [tcap]
  const int lane_b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* cloud = points + (size_t)lane_b * N * C;
  u64* buf = gather + warp * 32;

  for (int i = threadIdx.x; i < N; i += THREADS) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = cloud[(size_t)i * C + c];
      xs[c * tcap + i] = v[c];
    }
    p2s[i] = dot_in_order<C>(v, v);
  }
  __syncthreads();

  for (int qi = 0; qi < qpw; ++qi) {
    const int q = (blockIdx.x * qpw + qi) * WARPS + warp;
    if (q >= S) break;                          // warp-uniform, no barrier
    float sv[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      sv[c] = samples[((size_t)lane_b * S + q) * C + c];
    const float s2 = dot_in_order<C>(sv, sv);
    u64 cand[M];
    u64 lmin = NONE;
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const int i = u * 32 + lane;
      cand[u] = NONE;
      if (i < N) {
        float pv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) pv[c] = xs[c * tcap + i];
        const float cross = dot_in_order<C>(sv, pv);
        const float d =
            __fadd_rn(__fsub_rn(s2, __fmul_rn(2.0f, cross)), p2s[i]);
        cand[u] = ((u64)order_key(d) << 32) | (unsigned)i;
      }
      lmin = min(lmin, cand[u]);
    }
    // T: the lane minimum of rank k - 1.  Real minima are distinct, a lane
    // with no point ranks after all of them, and N >= k points fill at
    // least k lanes, so one lane holds rank k - 1.
    int rank = 0;
#pragma unroll
    for (int l2 = 0; l2 < 32; ++l2) rank += shfl(lmin, l2) < lmin;
    const u64 T = shfl(lmin, __ffs(__ballot_sync(0xffffffffu,
                                                 rank == k - 1)) - 1);
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < M; ++u) cnt += cand[u] <= T;
    int incl = cnt;                             // inclusive prefix over lanes
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    u64 v;
    if (total <= 32) {
      int pos = incl - cnt;
#pragma unroll
      for (int u = 0; u < M; ++u)
        if (cand[u] <= T) buf[pos++] = cand[u];
      __syncwarp();
      v = lane < total ? buf[lane] : NONE;
      __syncwarp();                             // buf is rewritten next query
#pragma unroll
      for (int size = 2; size <= 32; size *= 2)
#pragma unroll
        for (int stride = size / 2; stride > 0; stride /= 2) {
          const u64 o = shfl_xor(v, stride);
          const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
          v = keep_min ? min(v, o) : max(v, o);
        }
    } else {
      u64 last = 0;
      v = NONE;
      for (int r = 0; r < k; ++r) {
        u64 best = NONE;
#pragma unroll
        for (int u = 0; u < M; ++u)
          if (cand[u] > last && cand[u] < best) best = cand[u];
        last = warp_min(best);
        if (lane == r) v = last;
      }
    }
    // Lane r holds pick r.  From the first pick not below FLT_MAX on, every
    // pick is the lowest index among the earlier picks and that one (if it
    // is exactly FLT_MAX, or it is the first), with that pick's key.
    unsigned idx = (unsigned)v, key = (unsigned)(v >> 32);
    const unsigned big =
        __ballot_sync(0xffffffffu, lane < k && key >= KEY_FLT_MAX);
    if (big != 0u) {
      const int r0 = __ffs(big) - 1;
      const unsigned lowest =
          __reduce_min_sync(0xffffffffu, lane < r0 ? idx : UINT_MAX);
      const u64 first = shfl(v, r0);
      const unsigned js = ((unsigned)(first >> 32) == KEY_FLT_MAX || r0 == 0)
                              ? min(lowest, (unsigned)first) : lowest;
      const unsigned holder = __ballot_sync(0xffffffffu,
                                            lane < r0 && idx == js);
      const unsigned held_key =
          __shfl_sync(0xffffffffu, key, holder ? __ffs(holder) - 1 : 0);
      if (lane >= r0) {
        idx = js;
        key = holder ? held_key : (unsigned)(first >> 32);
      }
    }
    const unsigned idx0 = __shfl_sync(0xffffffffu, idx, 0);
    if (key > kr2) idx = idx0;                  // outside the ball
    if (lane < k) out[((size_t)lane_b * S + q) * k + lane] = idx;
  }
}

// N > SELECT_POINTS or k > SELECT_K: the k-round selection, one warp a
// query, grid-strided.  Each round writes (key << 32) | index to out: the
// key of the pick's own distance, which a re-pick (selected at FLT_MAX,
// its slot overwritten) finds at the round that first chose it; a last
// pass over the row applies the radius fill and keeps the indices.
template <int C>
__global__ void __launch_bounds__(32 * ROUND_WARPS)
    knn_rounds_kernel(const float* __restrict__ samples,
                      const float* __restrict__ points,
                      int64_t* __restrict__ out, float* __restrict__ scratch,
                      int B, int S, int N, int k, int row_in_smem,
                      unsigned kr2) {
  extern __shared__ float rows_sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gw = blockIdx.x * ROUND_WARPS + warp;
  const long long n_warps = (long long)gridDim.x * ROUND_WARPS;
  float* row = row_in_smem ? rows_sm + (size_t)warp * N
                           : scratch + (size_t)gw * N;
  for (long long qq = gw; qq < (long long)B * S; qq += n_warps) {
    const int lane_b = (int)(qq / S);
    const float* cloud = points + (size_t)lane_b * N * C;
    float sv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) sv[c] = samples[qq * C + c];
    const float s2 = dot_in_order<C>(sv, sv);
    for (int j = lane; j < N; j += 32) {
      float pv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) pv[c] = cloud[(size_t)j * C + c];
      const float cross = dot_in_order<C>(sv, pv);
      row[j] = __fadd_rn(__fsub_rn(s2, __fmul_rn(2.0f, cross)),
                         dot_in_order<C>(pv, pv));
    }
    __syncwarp();
    int64_t* o = out + qq * k;
    for (int r = 0; r < k; ++r) {
      // +inf start: a pick overwritten with FLT_MAX can still win a later
      // round over an inf distance, exactly as argmin over the row would.
      float best = INFINITY;
      int best_j = N;                 // sentinel above every real index
      for (int j = lane; j < N; j += 32) {
        const float v = row[j];
        if (v < best || (v == best && j < best_j)) {
          best = v;
          best_j = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
        if (ov < best || (ov == best && oj < best_j)) {
          best = ov;
          best_j = oj;
        }
      }
      if (lane == 0) {
        unsigned key = order_key(best);
        if (key >= KEY_FLT_MAX)                 // a re-pick keeps its key
          for (int r1 = 0; r1 < r; ++r1)
            if ((unsigned)o[r1] == (unsigned)best_j) {
              key = (unsigned)((u64)o[r1] >> 32);
              break;
            }
        o[r] = (int64_t)(((u64)key << 32) | (unsigned)best_j);
      }
      if (best_j < N && (best_j % 32) == lane) row[best_j] = FLT_MAX;
      __syncwarp();
    }
    const unsigned idx0 = (unsigned)o[0];
    __syncwarp();                               // o[0] is rewritten below
    for (int r = lane; r < k; r += 32) {
      const u64 p = (u64)o[r];
      o[r] = (unsigned)(p >> 32) > kr2 ? idx0 : (unsigned)p;
    }
    __syncwarp();
  }
}

// Queries a warp, for about TARGET_BLOCKS blocks over the dispatch.
inline int queries_per_warp(int B, int S) {
  const int blocks_per_cloud =
      max(1, min((S + WARPS - 1) / WARPS, (TARGET_BLOCKS + B - 1) / B));
  return (S + WARPS * blocks_per_cloud - 1) / (WARPS * blocks_per_cloud);
}

// qpw: queries a warp, or 0 for queries_per_warp's choice.
template <int C>
int launch_select(const float* samples, const float* points, int64_t* out,
                  int B, int S, int N, int k, unsigned kr2, int qpw,
                  cudaStream_t stream) {
  const int tcap = (N + 31) / 32 * 32;
  const size_t smem = WARPS * 32 * sizeof(u64) +
                      (size_t)(C + 1) * tcap * sizeof(float);
  if (qpw == 0) qpw = queries_per_warp(B, S);
  const dim3 grid((S + WARPS * qpw - 1) / (WARPS * qpw), B);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<C><<<grid, THREADS, smem, stream>>>(samples, points, out, S, N,
                                                 k, qpw, tcap, kr2);
  return (int)cudaGetLastError();
}

template <int C>
int launch_rounds(const float* samples, const float* points, int64_t* out,
                  float* scratch, long long scratch_floats, int B, int S,
                  int N, int k, unsigned kr2, cudaStream_t stream) {
  const long long queries = (long long)B * S;
  const int blocks = (int)std::min<long long>(
      (queries + ROUND_WARPS - 1) / ROUND_WARPS, ROUND_MAX_BLOCKS);
  const size_t row_bytes = (size_t)ROUND_WARPS * N * sizeof(float);
  const bool in_smem = row_bytes <= SMEM_BYTES;
  if (!in_smem && (scratch == nullptr ||
                   scratch_floats < (long long)blocks * ROUND_WARPS * N))
    return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? row_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      knn_rounds_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_rounds_kernel<C><<<blocks, 32 * ROUND_WARPS, smem, stream>>>(
      samples, points, out, scratch, B, S, N, k, in_smem, kr2);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const float* samples, const float* points, int64_t* out,
             float* scratch, long long scratch_floats, int B, int S, int N,
             int k, unsigned kr2, int qpw, cudaStream_t stream) {
  if (k <= SELECT_K && N <= SELECT_POINTS)
    return launch_select<C>(samples, points, out, B, S, N, k, kr2, qpw,
                            stream);
  if (qpw != 0) return (int)cudaErrorInvalidValue;   // no query tile here
  return launch_rounds<C>(samples, points, out, scratch, scratch_floats, B,
                          S, N, k, kr2, stream);
}

}  // namespace

// samples f32 [B, S, C], points f32 [B, N, C] contiguous -> out int64
// [B, S, k].  scratch: f32, at least 1056 * N floats when 4 * N floats
// exceed a block's shared memory (N > 14528), else unused.  r2: the ball's
// radius squared (> 0, or +inf for plain kNN; not NaN).  qpw: knn_kernel's
// queries a warp (a block serves 8 * qpw), or 0 for queries_per_warp's
// choice; the rounds kernel (N > 1024 or k > 32) takes 0 only.
extern "C" int knn_launch(const void* samples, const void* points, void* out,
                          void* scratch, long long scratch_floats, int B,
                          int S, int N, int C, int k, float r2, int qpw,
                          void* stream) {
  const float* s = (const float*)samples;
  const float* p = (const float*)points;
  int64_t* o = (int64_t*)out;
  float* sc = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > N || !(r2 >= 0.0f) || qpw < 0)
    return (int)cudaErrorInvalidValue;
  unsigned r2_bits;
  std::memcpy(&r2_bits, &r2, sizeof r2_bits);
  const unsigned kr2 = key_of_bits(r2_bits);
  switch (C) {
    case 1:
      return launch_c<1>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 2:
      return launch_c<2>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 3:
      return launch_c<3>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 4:
      return launch_c<4>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 5:
      return launch_c<5>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 6:
      return launch_c<6>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 7:
      return launch_c<7>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    case 8:
      return launch_c<8>(s, p, o, sc, scratch_floats, B, S, N, k, kr2,
                           qpw, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
