// ACAM similarity kernels for Hopper (sm_90a): paper Eq. 9-11 window
// scores, the Eq. 12 per-class max over K templates and the winner-take-
// all, with the windowed winner-vs-runner-up margin and the cascade's
// escalation bit.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/acam_similarity/acam_similarity.py:
//   acam_similarity           (_kernel)          raw (B, M) scores     B7b
//   acam_similarity_classify  (_classify_kernel) binarise -> WTA       B5
//   acam_similarity_serve     (_serve_kernel)    the serving tick      B6
//
//   tiled_kernel  B5 and B6, one launch each: the tiled design of
//                 acam_tiled.cuh with its similarity scorer (kSimilarity).
//                 The queries binarise (f > thr for B5, (f - thr_table[slot])
//                 > 0 for B6), so a feature hits iff the window's plane of
//                 the query's bit holds it: H is two popc per 32 features
//                 on the bit planes h0 = (lo <= 0 <= hi) and h1 = (lo <= 1
//                 <= hi), exact for any window, and on a binary window
//                 (lo, hi in {0, 1}, as generate_templates builds them)
//                 D = N - H exactly. A row that is not binary (real
//                 windows) sums D in float over its raw windows, the warp
//                 on one row at a time with coalesced loads, in
//                 score_row's order. B5 takes the local
//                 design at predict's 10 classes, B6 the cooperative one
//                 (the tick's 128 classes, the 1,100-class big bank, whose
//                 35 tiles merge through arrival counters).
//   score_kernel  B7b: raw (unbinarised) queries, one block per query row.
//                 Its threads stage the row in shared memory and its warps
//                 split the template rows; for each row the lanes stride N
//                 with coalesced lower/upper loads, each accumulating D
//                 (f32) and the hit count H (int32), and shuffles reduce
//                 both.
//
// Arithmetic equal to the JAX package's, as XLA compiles its kernels: the
// division by the constant N becomes a multiplication by the f32
// reciprocal, and 1 + alpha * D is contracted into one fused multiply-add.
// So S = __fdiv_rn(__fmul_rn(H, inv_n), __fmaf_rn(alpha, D, 1)), with
// inv_n = 1.f / N from the host (the plain version's value) and the
// quotient IEEE-rounded. Every other product and sum is written with
// __fmul_rn / __fadd_rn, which nvcc never contracts. D summed in another
// order than the JAX package's is exact on binary and dyadic windows; on
// other real windows it agrees to rounding.
//
// Semantics kept exactly: invalid rows and padded classes score -inf; an
// empty or all-invalid window gives pred 0 and margin 0 (capped at 1.0);
// ties go to the lowest class index (acam_epilogue.cuh). `chunk` (B6) is
// accepted for signature parity with the TPU kernel, whose VMEM budget
// walked the bank in class chunks; outputs never depend on it.
//
// Bounds on this card. On binary windows B5 and B6 are bound by bytes: the
// windows of the valid rows read once, both planes derived from them, and
// their two popc per 32 cells (132 SMs x 16 a clock) far cheaper: the tick
// (64 x 128 x 2, 8 tenants) about 1.5 MB, 0.45 us; the big bank (64 x
// 1,100 x 2) about 11.7 MB, 3.5 us; predict's B5 about 0.8 MB, 0.25 us. As
// with the feature count (acam_match.cu) a launch costs more than that, so
// the design is one launch with each round's loads issued together. B7b
// scores raw queries, about ten FP32 / int instructions per (query, row,
// feature) cell, so it is bound by operations; its one-block-per-row
// design is latency bound instead (25 strided loads per lane and two
// shuffle reductions per row).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero (the serve tick's (f - thr) > 0 must keep a subnormal difference),
// and it would allow contracted and approximate arithmetic.

#include "acam_tiled.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// S of the staged query row q against template row r (lane 0's value).
__device__ __forceinline__ float score_row(const float* q,
                                           const float* __restrict__ lower,
                                           const float* __restrict__ upper,
                                           int64_t r, int N, float alpha,
                                           float inv_n, int lane) {
  const float* lo = lower + r * N;
  const float* hi = upper + r * N;
  float d = 0.0f;
  int h = 0;
  for (int i = lane; i < N; i += 32) {
    const float x = q[i];
    const float l = lo[i];
    const float u = hi[i];
    const float above = fmaxf(__fsub_rn(x, u), 0.0f);
    const float below = fmaxf(__fsub_rn(l, x), 0.0f);
    d = __fadd_rn(d, __fadd_rn(__fmul_rn(above, above),
                               __fmul_rn(below, below)));
    h += (x >= l) & (x <= u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
    h += __shfl_xor_sync(0xffffffffu, h, off);
  }
  return __fdiv_rn(__fmul_rn((float)h, inv_n), __fmaf_rn(alpha, d, 1.0f));
}

// B7b: the (B, M) scores of raw queries, one block per query row.
__global__ void score_kernel(const float* __restrict__ f,
                             const float* __restrict__ lower,
                             const float* __restrict__ upper, int N, int M,
                             float alpha, float inv_n,
                             float* __restrict__ scores) {
  extern __shared__ float q[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = f + (int64_t)b * N;
  for (int i = threadIdx.x; i < N; i += kThreads) q[i] = row[i];
  __syncthreads();
  for (int r = warp; r < M; r += kWarps) {
    const float s = score_row(q, lower, upper, r, N, alpha, inv_n, lane);
    if (lane == 0) scores[(int64_t)b * M + r] = s;
  }
}

}  // namespace

// The C interface, one entry per TPU kernel face. Pointers are device
// pointers; `stream` is a cudaStream_t; alpha and inv_n = 1.f / N are f32
// (bind them as ctypes.c_float). Each returns cudaGetLastError() (or the
// launch's own error). `scratch` (B5, B6) is laid out as the header's
// launch_cooperative says, with B arrival counters; null picks the tiled
// kernel's local design.

extern "C" int acam_similarity(const float* q, const float* lower,
                               const float* upper, int B, int M, int N,
                               float alpha, float inv_n, float* scores,
                               void* stream) {
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  score_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      q, lower, upper, N, M, alpha, inv_n, scores);
  return (int)cudaGetLastError();
}

extern "C" int acam_similarity_classify(
    const float* f, const float* thr, const float* lower, const float* upper,
    const float* valid, int B, int N, int K, int Cp, int C, float alpha,
    float inv_n, uint32_t* scratch, int* pred, float* per_class,
    void* stream) {
  TileArgs a{};
  a.f = f, a.thr = thr, a.t = lower, a.t2 = upper, a.valid = valid;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.alpha = alpha, a.inv_n = inv_n;
  a.pred = pred, a.per_class = per_class;
  return launch_tiled<kSimilarity, false>(a, scratch, (cudaStream_t)stream);
}

extern "C" int acam_similarity_serve(
    const float* f, const float* thr_table, int thr_rows, const int* slot,
    const float* lower, const float* upper, const float* valid,
    const int* lo, const int* hi, const float* tau, int B, int N, int K,
    int Cp, int C, int chunk, float alpha, float inv_n, uint32_t* scratch,
    int* pred, float* per_class, float* margin, unsigned char* esc,
    void* stream) {
  (void)chunk;
  TileArgs a{};
  a.f = f, a.thr = thr_table, a.slot = slot, a.thr_rows = thr_rows;
  a.t = lower, a.t2 = upper, a.valid = valid, a.lo = lo, a.hi = hi;
  a.tau = tau;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.alpha = alpha, a.inv_n = inv_n;
  a.pred = pred, a.per_class = per_class, a.margin = margin, a.esc = esc;
  return launch_tiled<kSimilarity, true>(a, scratch, (cudaStream_t)stream);
}
