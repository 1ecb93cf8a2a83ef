// Online-softmax (flash) attention with GQA, causal and sliding-window
// masks, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_flash_kernel), reached from models/attention.py when impl == "flash"
// and there is no cache (the decoder LM's full-sequence forward).
// q [B, H, Tq, D] and k, v [B, Hkv, Tk, D] (bf16 or f32, contiguous) ->
// out [B, H, Tq, D] in q's type.  Query head h of batch b reads KV head
// b * Hkv + h / (H / Hkv): contiguous groups, as the Pallas index map and
// _sdpa_xla's [hkv, g] reshape; K and V are never repeated.
//
// What both routes keep from the Pallas kernel:
//   * masked logits take the finite sentinel -1e30, never -inf, so a fully
//     masked row of a live tile gives exp(0) that the mask then zeroes,
//     exp(m_prev - m_new) never sees inf - inf, and a row whose normalizer
//     stays 0 writes 0, not NaN;
//   * queries are aligned bottom-right: q_offset = Tk - Tq, so a
//     Tq = 1 decode-shaped call sees every key under the causal mask; keys
//     past Tk are masked by kpos < Tk (in place of the TPU kernel's
//     padding);
//   * the window keeps kpos > qpos - window; a tile that is wholly in the
//     future (causal) or wholly before the window is skipped, which
//     changes only which tiles enter the rescale, never which keys count;
//   * round-to-nearest-even stores.
// Sums are taken in another order than the TPU's, so the result is held
// to its plain version with a tolerance, not bitwise.
//
// What bounds it on the H100: 4 * D flops per unmasked (query, key) pair
// against 2 * D bytes per row read or written.  At the LM's shape (B4 H32
// Hkv4 T2048 D64, causal) that is 68.7 GFLOP against 75.5 MB: 0.069 ms
// at the bf16 tensor cores' 989 TFLOP/s, 0.023 ms at 3.35 TB/s, so it is
// bound by operations, and only the tensor cores come near the bound.
//
// Two routes, fixed by dtype and head dim (never a retry):
//
// bf16, D = 64 and 128: the tensor-core kernel (flash_attention_wgmma_
// kernel).  One block of three warpgroups per (batch * head, 128-query
// tile); tiles with more live keys launch first (reverse tile order under
// the causal mask), so the causal triangle's short tiles fill the last
// wave.  Warpgroup 2 is the producer: it gives up registers (setmaxnreg
// 40) and one thread issues TMA copies (cp.async.bulk.tensor, 3-D maps
// over [B*H, Tq, D] and [B*Hkv, Tk, D], so rows past Tq or Tk are zero-
// filled per head and never read from the next one): Q once, then K and V
// through a two-stage ring of 128-key tiles, each stage guarded by a full
// and an empty mbarrier.  Rows are 128-byte swizzled (a D = 128 row is two
// 64-column boxes).  Warpgroups 0 and 1 (setmaxnreg 232) own 64 query
// rows each and, per live tile:
//   * S = Q K^T by wgmma m64n128k16 (both operands in shared memory,
//     K-major), D / 16 steps, f32 accumulators in registers; the raw bf16
//     q and k are multiplied and the f32 logits scaled afterwards by
//     sm_scale * log2(e), so exp2 (ex2.approx.ftz, exp2f's fast form)
//     gives the softmax's exp within an ulp or two of expf;
//   * the masks only on tiles that straddle the causal diagonal, the Tk
//     edge or the window edge; interior tiles skip them, take the row max
//     on the raw logits and fold the scale into one FFMA per exponent
//     (about four instructions an element); a row's max is its thread's
//     32 values and two xor shuffles across the quad that shares the row
//     in the wgmma layout; O is rescaled by alpha in registers, and the
//     normalizer kept per thread until the end;
//   * P rounded to bf16 in registers (the f32 accumulator layout packs
//     straight into the register A operand) and O += P V by wgmma
//     m64nDk16, V from shared memory MN-major (transposed), 8 steps; then
//     the stage goes back to the producer.
// The two warpgroups run the same loop on the same stages without taking
// turns: ping-pong turns at the tensor cores, issuing Q K^T of one tile
// with P V of the one before, P staged in shared memory, tree reductions
// and a third stage each measured no faster on an H100 (PERF.md).
// The epilogue divides by the normalizer (l == 0 writes 0), rounds to
// bf16, stages the warpgroup's rows in its own part of the Q tile and
// stores them with 16-byte writes, rows past Tq left out.  This rounds P
// to bf16 before P V where the Pallas kernel keeps it f32 (as
// FlashAttention and SDPA do): at most 2^-9 relative per term, averaged
// over the keys.
//
// f32 (any of D = 16, 32, 64, 128) and bf16 D = 16 and 32: the CUDA-core
// kernel (flash_attention_ffma_kernel), which follows the Pallas arithmetic
// step for step (q scaled before the dot, f32(q) * sm_scale; expf; P in
// f32), as the f32 contract of 1e-5 needs.  One block of 256 threads per
// (batch * head, 64-query tile); q, each 64-key K and V tile and the
// 64 x 64 probability tile are staged in shared memory as f32 (rows padded
// by one word); thread (tr, tc) of a 16 x 16 grid owns query rows tr + 16 i
// and key or output columns tc + 16 j, so a row's 16 threads are one
// half-warp and its max and sum are four xor shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

// ------------------------------------------------- CUDA-core route ---

namespace ffma {

constexpr int BQ = 64, BKV = 64, THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) + (size_t)BKV * D +
          (size_t)BQ * (BKV + 1));
}

}  // namespace ffma

template <typename T, int D>
__global__ void __launch_bounds__(ffma::THREADS)
    flash_attention_ffma_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                int H, int Hkv, int Tq, int Tk, int causal,
                                int window, float sm_scale) {
  using namespace ffma;
  constexpr int LDQ = D + 1, LDK = D + 1, LDV = D, LDP = BKV + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LDQ], q * sm_scale
  float* Ks = Qs + BQ * LDQ;      // [BKV][LDK]
  float* Vs = Ks + BKV * LDK;     // [BKV][LDV]
  float* Ps = Vs + BKV * LDV;     // [BQ][LDP]

  const int bh = blockIdx.x;                         // b * H + head
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int q_lo = q0 + (Tk - Tq);                   // first query's position
  const T* qg = q + (size_t)bh * Tq * D;
  const T* kg = k + (size_t)kvh * Tk * D;
  const T* vg = v + (size_t)kvh * Tk * D;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int gq = q0 + r;
    Qs[r * LDQ + d] =
        gq < Tq ? __fmul_rn(to_f32(qg[(size_t)gq * D + d]), sm_scale) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (Tk + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * BKV;
    // The Pallas kernel's `live` test on this tile (uniform in the block).
    bool live = true;
    if (causal) live = live && (k_lo <= q_lo + BQ - 1);
    if (window > 0) live = live && (k_lo + BKV - 1 > q_lo - window);
    if (!live) continue;

    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int gk = k_lo + r;
      const bool in = gk < Tk;
      Ks[r * LDK + d] = in ? to_f32(kg[(size_t)gk * D + d]) : 0.f;
      Vs[r * LDV + d] = in ? to_f32(vg[(size_t)gk * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tc + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + tr + 16 * i;
      bool mask[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_lo + tc + 16 * j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        mask[j] = ok;
        if (!ok) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mask[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr + 16 * i) * LDP + tc + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BKV; ++key) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[key * LDV + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(tr + 16 * i) * LDP + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Tq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* o = out + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tc + 16 * c, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Hkv, int Tq, int Tk, int causal, int window,
                float sm_scale, cudaStream_t stream) {
  constexpr size_t bytes = ffma::smem_bytes<D>();
  auto kernel = flash_attention_ffma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + ffma::BQ - 1) / ffma::BQ);
  kernel<<<grid, ffma::THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Tq, Tk, causal,
      window, sm_scale);
  return (int)cudaGetLastError();
}

// The f32 route at every head dim.
int launch_ffma_d(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int Hkv, int Tq, int Tk, int D, int causal,
                  int window, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_ffma<float, 16>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                    window, sm_scale, stream);
    case 32:
      return launch_ffma<float, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                    window, sm_scale, stream);
    case 64:
      return launch_ffma<float, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                    window, sm_scale, stream);
    case 128:
      return launch_ffma<float, 128>(q, k, v, out, B, H, Hkv, Tq, Tk,
                                     causal, window, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------- tensor-core route ---

namespace wg {

constexpr int BQ = 128, BKV = 128, STAGES = 2, THREADS = 384;
constexpr int BOX = 64;          // bf16 columns of a TMA box: one 128-byte row
constexpr uint32_t SW_ATOM = 1024;   // 8 rows of 128 bytes, one swizzle atom

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

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define FA_R0_31                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define FA_R32_63                                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
#define FA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_F16(d, i) \
  FA_F4(d, i), FA_F4(d, i + 4), FA_F4(d, i + 8), FA_F4(d, i + 12)
#define FA_F32(d, i) FA_F16(d, i), FA_F16(d, i + 16)

// S[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" FA_R0_31 ", " FA_R32_63 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F32(d, 0), FA_F32(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64]: P from registers, V MN-major in
// shared memory (transposed).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" FA_R0_31 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] V[16 x 128], as above.
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" FA_R0_31 ", " FA_R32_63 "}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : FA_F32(d, 0), FA_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_R0_31
#undef FA_R32_63
#undef FA_F4
#undef FA_F16
#undef FA_F32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the MUFU unit (exp2f's fast form; results below 2^-126 flush
// to 0, far below a bf16 step of the row's largest probability).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on this thread's two rows (the wgmma
// layout: element i is in row (i >> 1) & 1, column 8 (i >> 2) + 2 (lane %
// 4) + (i & 1)).  s holds the raw logits on entry and the probabilities on
// exit; m is the running max in the log2 domain, l the thread's part of
// the normalizer; alpha gets the factors that rescale O.  MASKED applies
// the masks (-1e30 for masked logits, their probabilities zeroed after
// the exp); an interior tile skips them, takes the max on the raw logits
// (scaling by a positive factor keeps the order) and forms the exponent
// with one FFMA.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int k_lo,
                                             int qpos0, int lane, int Tk,
                                             int causal, int window) {
  float mx[2] = {NEG, NEG};
  uint64_t keep = ~0ull;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (MASKED) {
      const int kpos = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int qpos = qpos0 + 8 * r;
      bool ok = kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) keep &= ~(1ull << i);
      s[i] = ok ? s[i] * scale_log2 : NEG;
    }
    mx[r] = fmaxf(mx[r], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], MASKED ? mx[r] : mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    float e;
    if (MASKED) {
      e = ex2(s[i] - m[r]);
      if (!((keep >> i) & 1)) e = 0.f;
    } else {
      e = ex2(fmaf(s[i], scale_log2, -m[r]));
    }
    l[r] += e;
    s[i] = e;
  }
}

template <int D>
struct Layout {
  static constexpr int NBOX = D / BOX;
  static constexpr uint32_t BOX_Q = BQ * BOX * 2;     // bytes of a Q box
  static constexpr uint32_t BOX_KV = BKV * BOX * 2;   // bytes of a K or V box
  static constexpr uint32_t Q_BYTES = NBOX * BOX_Q;
  static constexpr uint32_t KV_BYTES = NBOX * BOX_KV;  // K or V of a stage
  static constexpr uint32_t BARS = Q_BYTES + STAGES * 2 * KV_BYTES;
  // Q, the ring, the barriers (Q, then full and empty of each stage) and
  // the slack to align the base to a swizzle atom.
  static constexpr size_t SMEM = BARS + 8 * (1 + 2 * STAGES) + SW_ATOM;
};

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_attention_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                                 __grid_constant__ const CUtensorMap k_map,
                                 __grid_constant__ const CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ out, int H,
                                 int Hkv, int Tq, int Tk, int causal,
                                 int window, float scale_log2) {
  using namespace wg;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((SW_ATOM - (raw & (SW_ATOM - 1))) &
                              (SW_ATOM - 1));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t bar_q = sQ + L::BARS;
  auto full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto k_stage = [&](int s) { return sQ + L::Q_BYTES + s * 2 * L::KV_BYTES; };

  const int bh = blockIdx.x;                         // b * H + head
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  // Under the causal mask, later q-tiles have more live keys: launch them
  // first.
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int q_lo = q0 + (Tk - Tq);                   // first query's position
  // The Pallas kernel's `live` test, as a range of KV tiles.
  int kt_begin = 0, kt_end = (Tk + BKV - 1) / BKV;
  if (causal) {
    const int last = q_lo + BQ - 1;
    kt_end = last < 0 ? 0 : min(kt_end, last / BKV + 1);
  }
  if (window > 0) {
    const int first = q_lo - window + 1;             // earliest key seen
    if (first > 0) kt_begin = first / BKV;
  }
  const int n_iter = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256 && n_iter > 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int b = 0; b < L::NBOX; ++b)
        tma_load(sQ + b * L::BOX_Q, &q_map, bar_q, b * BOX, q0, bh);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::KV_BYTES);
        const int k_lo = (kt_begin + it) * BKV;
        const uint32_t sK = k_stage(s), sV = sK + L::KV_BYTES;
        for (int b = 0; b < L::NBOX; ++b) {
          tma_load(sK + b * L::BOX_KV, &k_map, full(s), b * BOX, k_lo, kvh);
          tma_load(sV + b * L::BOX_KV, &v_map, full(s), b * BOX, k_lo, kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // This thread's rows within the warpgroup: r0 and r0 + 8 (the wgmma
    // accumulator layout); its columns 8 j + 2 (lane % 4) + {0, 1}.
    const int r0 = warp * 16 + lane / 4;
    const int wq_lo = q_lo + wgi * 64;               // warpgroup's first qpos
    const int qpos0 = wq_lo + r0;
    const uint32_t q_wg = sQ + wgi * 64 * 128;       // its rows of each Q box

    float o[D / 2], s[64];
    uint32_t p[32];
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    if (n_iter > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      mbar_wait(full(st), (it / STAGES) & 1);
      const uint32_t sK = k_stage(st), sV = sK + L::KV_BYTES;

      // S = Q K^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::BOX_Q + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * L::BOX_KV + (kk % 4) * 32;
        wgmma_qk(s, desc_sw128(q_wg + off, 16, SW_ATOM),
                 desc_sw128(sK + koff, 16, SW_ATOM), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(s[i]);

      // Online softmax, in the log2 domain.
      const int k_lo = (kt_begin + it) * BKV;
      const bool need_mask = k_lo + BKV > Tk ||
                             (causal && k_lo + BKV - 1 > wq_lo) ||
                             (window > 0 && k_lo <= wq_lo + 63 - window);
      float alpha[2];
      if (need_mask)
        softmax_tile<true>(s, m, l, alpha, scale_log2, k_lo, qpos0, lane, Tk,
                           causal, window);
      else
        softmax_tile<false>(s, m, l, alpha, scale_log2, k_lo, qpos0, lane,
                            Tk, causal, window);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      // O += P V
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_pv(o, p + 4 * kk,
                 desc_sw128(sV + kk * 2 * SW_ATOM, L::BOX_KV, SW_ATOM));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(p[i]);
      mbar_arrive(empty(st));
    }

    // Epilogue: O / l, bf16, staged in this warpgroup's rows of the Q tile
    // (swizzled as TMA wrote Q), then 16-byte stores of the rows < Tq.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.f) l[r] = 1.f;
    }
    uint8_t* rows = smem + wgi * 64 * 128;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = r0 + 8 * r;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      const int cc = col % BOX;
      const uint32_t off = (col / BOX) * L::BOX_Q + row * 128 +
                           (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(rows + off) =
          pack_bf16(o[i] / l[r], o[i + 1] / l[r]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    constexpr int CHUNKS = D / 8;                    // 16-byte chunks a row
    for (int c = t; c < 64 * CHUNKS; c += 128) {
      const int row = c / CHUNKS, ch = c % CHUNKS;
      const int grow = q0 + wgi * 64 + row;
      if (grow >= Tq) continue;
      const uint32_t off = (ch / 8) * L::BOX_Q + row * 128 +
                           (((ch % 8) ^ (row % 8)) * 16);
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Tq + grow) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(rows + off);
    }
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

// A 3-D map over a bf16 [heads, rows, D] tensor, boxes of 64 columns by
// `box_rows` rows of one head, 128-byte swizzle, out-of-range rows read 0.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int heads,
             int rows, int D, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)wg::BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)r;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int Hkv, int Tq, int Tk, int causal,
                 int window, float sm_scale, cudaStream_t stream) {
  EncodeTiled enc;
  int err = encoder(&enc);
  if (err) return err;
  CUtensorMap q_map, k_map, v_map;
  if ((err = make_map(enc, &q_map, q, B * H, Tq, D, wg::BQ))) return err;
  if ((err = make_map(enc, &k_map, k, B * Hkv, Tk, D, wg::BKV))) return err;
  if ((err = make_map(enc, &v_map, v, B * Hkv, Tk, D, wg::BKV))) return err;
  constexpr size_t bytes = wg::Layout<D>::SMEM;
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Tq + wg::BQ - 1) / wg::BQ);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  kernel<<<grid, wg::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, H, Hkv, Tq, Tk, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// The route is fixed by dtype and head dim: bf16 at D = 64 or 128 takes the
// tensor-core kernel, everything else the CUDA-core kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int Tq, int Tk, int D,
                                      int causal, int window, int is_bf16,
                                      float sm_scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16)
    return launch_ffma_d(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal, window,
                         sm_scale, s);
  switch (D) {
    case 16:
      return launch_ffma<__nv_bfloat16, 16>(q, k, v, out, B, H, Hkv, Tq, Tk,
                                            causal, window, sm_scale, s);
    case 32:
      return launch_ffma<__nv_bfloat16, 32>(q, k, v, out, B, H, Hkv, Tq, Tk,
                                            causal, window, sm_scale, s);
    case 64:
      return launch_wgmma<64>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                              window, sm_scale, s);
    case 128:
      return launch_wgmma<128>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                               window, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
