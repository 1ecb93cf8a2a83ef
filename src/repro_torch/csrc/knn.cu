// k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn.py, knn_pallas (_knn_kernel): for each
// query sample, d = |s|^2 - 2 s.p + |p|^2 against every point, then k
// rounds of row argmin, each pick overwritten with the float maximum.
// Output int64 [B, S, k] in ascending distance order, ties to the lowest
// index (jnp.argmin's and torch.argmin's rule).
//
// What bounds it on the H100: operations, not bytes.  A dispatch reads
// B*(S+N)*C floats and writes B*S*k indices, but does B*S*N*(2C+3)
// distance flops and B*S*N*k compare-selects; at the pipeline's shapes
// (N <= 512, k = 16) the k selection rounds dominate.
//
// Design: one block per (lane, tile of QUERIES_PER_BLOCK queries); one
// warp per query.  The lane's points are staged once per block in shared
// memory, and each warp writes its query's distance row (N floats) to
// shared memory too, so the k rounds never touch device memory.  A round
// is a strided scan (each thread keeps its first minimum) followed by a
// five-step shuffle reduction over (value, index) pairs that prefers the
// lower index on equal values.  Only j < N is ever scanned, so no padding
// column can be picked.  Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, and the file builds with --fmad=false), in the
// order of the plain version (repro_torch.core.knn.pairwise_sqdist), so
// kernel and plain version agree bit for bit.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QUERIES_PER_BLOCK = 8;
constexpr int THREADS = 32 * QUERIES_PER_BLOCK;

__device__ __forceinline__ float dot_in_order(const float* a, const float* b,
                                              int c) {
  float acc = __fmul_rn(a[0], b[0]);
  for (int i = 1; i < c; ++i) acc = __fadd_rn(acc, __fmul_rn(a[i], b[i]));
  return acc;
}

__global__ void knn_kernel(const float* __restrict__ samples,
                           const float* __restrict__ points,
                           int64_t* __restrict__ out, int S, int N, int C,
                           int k) {
  extern __shared__ float smem[];
  float* pts = smem;                                  // [N, C]
  float* p2 = pts + (size_t)N * C;                    // [N]
  float* rows = p2 + N;                               // [QPB, N]
  const int lane_b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int tid = threadIdx.x % 32;
  const float* lane_pts = points + (size_t)lane_b * N * C;

  for (int i = threadIdx.x; i < N * C; i += THREADS) pts[i] = lane_pts[i];
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += THREADS)
    p2[j] = dot_in_order(pts + (size_t)j * C, pts + (size_t)j * C, C);
  __syncthreads();

  const int q = blockIdx.x * QUERIES_PER_BLOCK + warp;
  if (q >= S) return;                 // no block-wide sync follows
  const float* s = samples + ((size_t)lane_b * S + q) * C;
  float sv[8];                        // C <= 8, checked by the host
  for (int c = 0; c < C; ++c) sv[c] = s[c];
  const float s2 = dot_in_order(sv, sv, C);
  float* row = rows + (size_t)warp * N;
  for (int j = tid; j < N; j += 32) {
    const float cross = dot_in_order(sv, pts + (size_t)j * C, C);
    row[j] = __fadd_rn(__fsub_rn(s2, __fmul_rn(2.0f, cross)), p2[j]);
  }
  __syncwarp();

  int64_t* o = out + ((size_t)lane_b * S + q) * k;
  for (int r = 0; r < k; ++r) {
    // +inf start: a pick overwritten with FLT_MAX can still win a later
    // round over an inf distance, exactly as argmin over the row would.
    float best = INFINITY;
    int best_j = N;                   // sentinel above every real index
    for (int j = tid; j < N; j += 32) {
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
    if (tid == 0) o[r] = best_j;
    if (best_j < N && (best_j % 32) == tid) row[best_j] = FLT_MAX;
    __syncwarp();
  }
}

}  // namespace

extern "C" int knn_launch(const void* samples, const void* points, void* out,
                          int B, int S, int N, int C, int k, void* stream) {
  const size_t smem = ((size_t)N * C + N + (size_t)QUERIES_PER_BLOCK * N) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK, B);
  knn_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)samples, (const float*)points, (int64_t*)out, S, N, C, k);
  return (int)cudaGetLastError();
}
