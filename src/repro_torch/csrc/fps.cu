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
// zeros: every distance ties at 0.
//
// What bounds it on the H100: neither bytes nor operations.  A cloud is
// read once (12 KB at N = 1024) and a step does 3C+1 flops a point, but
// the S steps are sequential, and each ends in a block-wide argmax: two
// barriers and two five-step shuffle reductions.  So the time is S times
// the latency of one step, and a dispatch of B clouds fills only B SMs.
//
// Design: 512 threads; a thread keeps the coordinates and running minima
// of its PT points (j = i * 512 + tid) in registers, and the cloud sits in
// shared memory so the winner's coordinates are one broadcast read away.
// d = (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its
// own (__fmul_rn/__fadd_rn; the file builds with --fmad=false), in the
// order of the plain version (repro_torch.kernels.ref.fps_ref), so kernel
// and plain version pick the same indices.
#include <cmath>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void take_max(float& bv, int& bj, float ov,
                                         int oj) {
  if (ov > bv || (ov == bv && oj < bj)) {
    bv = ov;
    bj = oj;
  }
}

template <int PT>
__global__ void fps_kernel(const float* __restrict__ points,
                           int64_t* __restrict__ out, int N, int S) {
  extern __shared__ float pts[];                    // [N, 3]
  __shared__ float warp_v[WARPS];
  __shared__ int warp_j[WARPS];
  __shared__ int last_sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* p = points + (size_t)blockIdx.x * N * 3;
  int64_t* o = out + (size_t)blockIdx.x * S;

  for (int i = tid; i < N * 3; i += THREADS) pts[i] = p[i];
  __syncthreads();
  float px[PT], py[PT], pz[PT], m[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int j = i * THREADS + tid;
    const bool in = j < N;
    px[i] = in ? pts[3 * j] : 0.0f;
    py[i] = in ? pts[3 * j + 1] : 0.0f;
    pz[i] = in ? pts[3 * j + 2] : 0.0f;
    m[i] = INFINITY;
  }
  if (tid == 0) o[0] = 0;

  int last = 0;
  for (int s = 1; s < S; ++s) {
    const float lx = pts[3 * last], ly = pts[3 * last + 1],
                lz = pts[3 * last + 2];
    float bv = -INFINITY;
    int bj = INT_MAX;
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int j = i * THREADS + tid;
      if (j < N) {
        const float dx = __fsub_rn(px[i], lx), dy = __fsub_rn(py[i], ly),
                    dz = __fsub_rn(pz[i], lz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        m[i] = fminf(m[i], d);
        if (m[i] > bv) {                // j grows with i: keeps the first
          bv = m[i];
          bj = j;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      take_max(bv, bj, __shfl_xor_sync(0xffffffffu, bv, off),
               __shfl_xor_sync(0xffffffffu, bj, off));
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_j[warp] = bj;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? warp_v[lane] : -INFINITY;
      bj = lane < WARPS ? warp_j[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1)
        take_max(bv, bj, __shfl_xor_sync(0xffffffffu, bv, off),
                 __shfl_xor_sync(0xffffffffu, bj, off));
      if (lane == 0) {
        last_sh = bj;
        o[s] = bj;
      }
    }
    __syncthreads();
    last = last_sh;
  }
}

template <int PT>
int launch(const float* points, int64_t* out, int B, int N, int S,
           cudaStream_t stream) {
  const size_t smem = (size_t)N * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PT><<<B, THREADS, smem, stream>>>(points, out, N, S);
  return (int)cudaGetLastError();
}

}  // namespace

// points f32 [B, N, 3] contiguous -> out int64 [B, S]; N <= 16 * 512.
extern "C" int fps_launch(const void* points, void* out, int B, int N, int S,
                          void* stream) {
  const float* p = (const float*)points;
  int64_t* o = (int64_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_thread = (N + THREADS - 1) / THREADS;
  if (per_thread <= 1) return launch<1>(p, o, B, N, S, st);
  if (per_thread <= 2) return launch<2>(p, o, B, N, S, st);
  if (per_thread <= 4) return launch<4>(p, o, B, N, S, st);
  if (per_thread <= 8) return launch<8>(p, o, B, N, S, st);
  if (per_thread <= 16) return launch<16>(p, o, B, N, S, st);
  return (int)cudaErrorInvalidValue;
}
