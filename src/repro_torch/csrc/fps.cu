// Farthest Point Sampling for Hopper (sm_90a): the whole sampler, one launch.
//
// Replaces: src/repro/kernels/fps.py, fps_update_pallas (_fps_update_kernel)
// and the loop around it, fps_pallas.  The TPU kernel folds the squared
// distance to the last centroid into the running minimum over all N points;
// the argmax and the loop over the S samples stay outside it, one launch
// per step.
// Here one block per cloud runs every step: the update, the argmax and the
// next centroid, so a stage costs one launch and not S.
//
// Output int64 [B, S]: idx[0] = 0, then at each step the index of the
// largest running minimum, ties to the lowest index (jnp.argmax's and
// torch.argmax's first-index rule).  An all-zero (padded) cloud gives all
// zeros: every distance ties at 0.  Any N >= 1; C = 3 (the wrapper checks).
//
// What bounds it on the H100: neither bytes nor operations (Elite's stage
// 1, B32 N1024 S512, needs 2.5 us of fp32 work).  The S steps are
// sequential and each ends in a block-wide argmax whose result the next
// step needs, so the time is S times the latency of one step: the
// distance update, a warp reduction, one barrier with a slot write and
// read, and a shared-memory read of the winner.  The design keeps that
// chain short:
//
// - Packed keys.  A running minimum is a sum of squares, so it is +0 or
//   positive (a square is never -0, and +0 + +0 = +0): its float bits
//   order as unsigned integers, and a warp's largest is one `redux.sync`.
//   The lowest index among the lanes that hold it is a second one (one
//   lane holds it but where distances tie; the multi-warp path checks with
//   a ballot and skips the second `redux.sync` then).
// - One barrier a step.  A warp's (key, ~index) goes as one 64-bit integer
//   to its slot [s & 1][warp]; after the one __syncthreads every thread
//   reduces the slots itself (a tree of 64-bit maxima: the larger key, then
//   the lower index), so no second barrier or broadcast is needed.  The
//   slots alternate between steps, so a warp that runs ahead into step
//   s + 1 cannot overwrite what a slower warp still reads of step s (it
//   would have to pass step s + 1's barrier first to reach step s + 2's
//   write).  The winner's coordinates come from the block's float4 copy of
//   the cloud in shared memory.
// - Few warps a cloud.  A thread keeps PT = 8 points (coordinates and
//   running minima) in registers and takes their argmax as a tree; the
//   block is the smallest power of two of threads (32 to 1024) that covers
//   N: 4 warps at N = 1024.  At N <= 256 it is one warp, with no barrier:
//   the winner's lane shuffles out its coordinates, loaded meanwhile.
//   Points past N hold a running minimum of +0, which never beats a real
//   point (a tie goes to the lower index), so the step has no branch.
// - Any N.  Past the register tile (8192 points) the block keeps 1024
//   threads, each walking its tail points j = 8192 + tid + i * 1024 with
//   their running minima in a device scratch buffer [B, N - 8192] that the
//   wrapper allocates; the cloud is then read from device memory.
//
// A cluster of 2 or 4 blocks a cloud, its step's reduction through
// distributed shared memory, was 2.7-2.8x slower at Elite's stage 1: one
// cluster barrier costs more than a whole step here (PERF.md).
//
// d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its
// own (__fmul_rn/__fadd_rn; the file builds with --fmad=false), in the
// order of the plain version (repro_torch.kernels.ref.fps_ref), so kernel
// and plain version pick the same indices.
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr int PT = 8;                           // points a thread
constexpr int MAX_THREADS = 1024;
constexpr int REG_POINTS = MAX_THREADS * PT;    // the largest register tile

__device__ __forceinline__ float sqdist(float x, float y, float z,
                                        float4 l) {
  const float dx = __fsub_rn(x, l.x), dy = __fsub_rn(y, l.y),
              dz = __fsub_rn(z, l.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A candidate (key, index) as one integer: the larger is the larger key
// at the lower index.
__device__ __forceinline__ u64 pack(unsigned key, unsigned idx) {
  return ((u64)key << 32) | (unsigned)~idx;
}

// One block per cloud.  TAIL: N > THREADS * PT (then THREADS = 1024): the
// cloud stays in device memory and the tail's minima in scratch.
template <int THREADS, bool TAIL>
__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ points, int64_t* __restrict__ out,
               float* __restrict__ scratch, int N, int S) {
  constexpr int WARPS = THREADS / 32;
  constexpr int REG = THREADS * PT;
  extern __shared__ float4 cloud[];                 // [N] unless TAIL
  __shared__ u64 slot[2][WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* p = points + (size_t)blockIdx.x * N * 3;
  int64_t* o = out + (size_t)blockIdx.x * S;
  float* tail = TAIL ? scratch + (size_t)blockIdx.x * (N - REG) : nullptr;
  auto point = [&](int j) {
    return TAIL ? make_float4(__ldg(p + 3 * j), __ldg(p + 3 * j + 1),
                              __ldg(p + 3 * j + 2), 0.0f)
                : cloud[j];
  };

  if (!TAIL)
    for (int j = tid; j < N; j += THREADS)
      cloud[j] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], 0.0f);
  if (TAIL)
    for (int j = REG + tid; j < N; j += THREADS) tail[j - REG] = INFINITY;
  __syncthreads();
  // A point beyond N keeps a running minimum of +0: it ties at best, and
  // a tie goes to the lower index, which is always a real point.
  float px[PT], py[PT], pz[PT], m[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = i * THREADS + tid;
    const float4 v = j < N ? point(j) : make_float4(0.f, 0.f, 0.f, 0.f);
    px[i] = v.x;
    py[i] = v.y;
    pz[i] = v.z;
    m[i] = j < N ? INFINITY : 0.0f;
  }
  if (tid == 0) o[0] = 0;

  float4 l = point(0);
  for (int s = 1; s < S; ++s) {
    // The thread's argmax: a tree over its PT points, the lower index
    // (the left one) kept on ties.
    float bv[PT];
    int bi[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      m[i] = fminf(m[i], sqdist(px[i], py[i], pz[i], l));
      bv[i] = m[i];
      bi[i] = i;
    }
#pragma unroll
    for (int stride = 1; stride < PT; stride *= 2)
#pragma unroll
      for (int i = 0; i + stride < PT; i += 2 * stride)
        if (bv[i + stride] > bv[i]) {
          bv[i] = bv[i + stride];
          bi[i] = bi[i + stride];
        }
    int bj = bi[0] * THREADS + tid;
    if (TAIL) {
      for (int j = REG + tid; j < N; j += THREADS) {
        const float4 v = point(j);
        const float d = fminf(tail[j - REG], sqdist(v.x, v.y, v.z, l));
        tail[j - REG] = d;
        if (d > bv[0]) {
          bv[0] = d;
          bj = j;
        }
      }
    }
    // Minima are >= +0, so their bits order as unsigned integers.
    const unsigned key = __float_as_uint(bv[0]);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    int next;
    if (WARPS == 1) {
      // The lowest index that holds the largest key; its coordinates come
      // from its lane (index j sits in lane j % 32), fetched meanwhile.
      const float4 mine = point(bj < N ? bj : 0);
      next = (int)__reduce_min_sync(0xffffffffu,
                                    key == top ? (unsigned)bj : UINT_MAX);
      const int src = next % 32;
      l = make_float4(__shfl_sync(0xffffffffu, mine.x, src),
                      __shfl_sync(0xffffffffu, mine.y, src),
                      __shfl_sync(0xffffffffu, mine.z, src), 0.0f);
    } else {
      // One lane holds the warp's largest key (ties are rare) and posts
      // it; else the lowest index among the holders is posted.
      const int buf = s & 1;
      const unsigned holders = __ballot_sync(0xffffffffu, key == top);
      if (__popc(holders) == 1) {
        if (key == top) slot[buf][warp] = pack(top, bj);
      } else {
        const unsigned wi = __reduce_min_sync(
            0xffffffffu, key == top ? (unsigned)bj : UINT_MAX);
        if (lane == 0) slot[buf][warp] = pack(top, wi);
      }
      __syncthreads();
      // Every warp reduces the slots itself: up to 8 as a tree in each
      // thread, more one a lane.  The slots alternate between steps: a
      // warp that runs ahead into step s + 1 writes the other buffer, and
      // reaches this one again only past step s + 1's barrier, when every
      // warp has read it.
      if (WARPS <= 8) {
        u64 c[WARPS];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) c[w] = slot[buf][w];
#pragma unroll
        for (int stride = 1; stride < WARPS; stride *= 2)
#pragma unroll
          for (int w = 0; w + stride < WARPS; w += 2 * stride)
            c[w] = max(c[w], c[w + stride]);
        next = (int)~(unsigned)c[0];
      } else {
        const u64 c = lane < WARPS ? slot[buf][lane] : 0ull;
        const unsigned hi = __reduce_max_sync(0xffffffffu,
                                              (unsigned)(c >> 32));
        next = (int)~__reduce_max_sync(
            0xffffffffu, (unsigned)(c >> 32) == hi ? (unsigned)c : 0u);
      }
      l = point(next);
    }
    if (tid == 0) o[s] = next;
  }
}

template <int THREADS, bool TAIL>
int launch(const float* points, int64_t* out, float* scratch,
           long long scratch_floats, int B, int N, int S,
           cudaStream_t stream) {
  if (TAIL && (scratch == nullptr ||
               scratch_floats < (long long)B * (N - THREADS * PT)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = TAIL ? 0 : (size_t)N * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<THREADS, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<THREADS, TAIL><<<B, THREADS, smem, stream>>>(points, out,
                                                          scratch, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// points f32 [B, N, 3] contiguous -> out int64 [B, S].  scratch: f32, at
// least B * (N - 8192) floats past the register tile (B * N is always
// enough), else unused.
extern "C" int fps_launch(const void* points, void* out, void* scratch,
                          long long scratch_floats, int B, int N, int S,
                          void* stream) {
  const float* p = (const float*)points;
  int64_t* o = (int64_t*)out;
  float* sc = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (N <= 32 * PT)
    return launch<32, false>(p, o, sc, scratch_floats, B, N, S, st);
  if (N <= 64 * PT)
    return launch<64, false>(p, o, sc, scratch_floats, B, N, S, st);
  if (N <= 128 * PT)
    return launch<128, false>(p, o, sc, scratch_floats, B, N, S, st);
  if (N <= 256 * PT)
    return launch<256, false>(p, o, sc, scratch_floats, B, N, S, st);
  if (N <= 512 * PT)
    return launch<512, false>(p, o, sc, scratch_floats, B, N, S, st);
  if (N <= REG_POINTS)
    return launch<1024, false>(p, o, sc, scratch_floats, B, N, S, st);
  return launch<1024, true>(p, o, sc, scratch_floats, B, N, S, st);
}
