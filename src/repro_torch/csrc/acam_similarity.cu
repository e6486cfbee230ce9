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
// as one design with three faces (one C entry each):
//
//   score_kernel  one block per query row. Its threads stage the row in
//                 shared memory: raw (B7b), binarised f > thr (B5), or
//                 binarised (f - thr_table[slot]) > 0 (B6). Its warps
//                 split the template rows (B7b) or the classes (B5, B6).
//                 For each valid row the lanes stride N with coalesced
//                 lower/upper loads, each accumulating D (f32) and the hit
//                 count H (int32); shuffles reduce both, and lane 0 forms
//                 S = (H * inv_n) / (1 + alpha * D), the max over K, the
//                 per-class score and the warp's windowed (top1, argmax,
//                 runner-up) summary (acam_epilogue.cuh). Thread 0 merges
//                 the warps' summaries and writes pred, the margin clamped
//                 at 1.0 and escalate = margin < tau.
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
// empty or all-invalid window gives pred 0 and margin 0; ties go to the
// lowest class index (acam_epilogue.cuh). `chunk` (B6) is accepted for
// signature parity with the TPU kernel, whose VMEM budget walked the bank
// in class chunks; no block here holds the bank, so outputs never depend
// on it.
//
// Bound on this card. Each (query, valid template row, feature) cell costs
// about ten FP32 / int instructions (two subtractions, two maxima, two
// multiplies, two adds, two compares, an integer add) and moves no bytes of
// its own once the windows sit in L2, so the kernels are bound by
// operations, not bytes: the serving tick (64 slots x 80 valid rows x 784)
// needs about 1.2 us at 132 SMs x 128 lanes x 1.98 GHz, its bytes about
// 0.6 us at 3.35 TB/s. This simple design is latency bound instead: one
// warp walks its classes one row at a time, and a row's 784 features are
// 25 strided loads per lane plus two 5-step shuffle reductions. A
// bit-packed path for binary windows is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero (the serve tick's (f - thr) > 0 must keep a subnormal difference),
// and it would allow contracted and approximate arithmetic.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "acam_epilogue.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum Mode { kRaw = 0, kClassify = 1, kServe = 2 };

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

template <int kMode>
__global__ void score_kernel(const float* __restrict__ f,
                             const float* __restrict__ thr, int thr_rows,
                             const int* __restrict__ slot,
                             const float* __restrict__ lower,
                             const float* __restrict__ upper,
                             const float* __restrict__ valid,
                             const int* __restrict__ lo,
                             const int* __restrict__ hi,
                             const float* __restrict__ tau, int N, int M,
                             int K, int Cp, int C, float alpha, float inv_n,
                             float* __restrict__ scores,
                             int* __restrict__ pred,
                             float* __restrict__ per_class,
                             float* __restrict__ margin,
                             unsigned char* __restrict__ esc) {
  extern __shared__ float q[];
  __shared__ acam::Top tops[kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = f + (int64_t)b * N;

  const float* th = thr;
  bool zero_thr = false;
  if (kMode == kServe) {
    const int s = slot[b];
    // a slot outside the table reads zero thresholds, as the TPU kernel's
    // one-hot select does
    zero_thr = s < 0 || s >= thr_rows;
    th = thr + (int64_t)(zero_thr ? 0 : s) * N;
  }
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float x = row[i];
    if (kMode == kClassify) x = x > th[i] ? 1.0f : 0.0f;
    if (kMode == kServe)
      x = __fsub_rn(x, zero_thr ? 0.0f : th[i]) > 0.0f ? 1.0f : 0.0f;
    q[i] = x;
  }
  __syncthreads();

  if (kMode == kRaw) {
    for (int r = warp; r < M; r += kWarps) {
      const float s = score_row(q, lower, upper, r, N, alpha, inv_n, lane);
      if (lane == 0) scores[(int64_t)b * M + r] = s;
    }
    return;
  }

  const int wlo = kMode == kServe ? max(lo[b], 0) : 0;
  const int whi = kMode == kServe ? min(hi[b], C) : C;
  acam::Top top = acam::top_empty();
  for (int c = warp; c < C; c += kWarps) {
    float best = -CUDART_INF_F;
    for (int kk = 0; kk < K; ++kk) {
      const int64_t r = (int64_t)kk * Cp + c;
      if (valid[r] > 0.0f)
        best = fmaxf(best,
                     score_row(q, lower, upper, r, N, alpha, inv_n, lane));
    }
    if (lane == 0) {
      per_class[(int64_t)b * C + c] = best;
      // a warp's classes arrive in increasing order (top_push's
      // precondition)
      if (c >= wlo && c < whi) acam::top_push(top, best, c);
    }
  }
  if (lane == 0) tops[warp] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) top = acam::top_merge(top, tops[w]);
    acam::top_finish(top, kMode == kServe ? 1.0f : CUDART_INF_F, tau, b,
                     pred, kMode == kServe ? margin : nullptr,
                     kMode == kServe ? esc : nullptr);
  }
}

template <int kMode>
int launch(const float* f, const float* thr, int thr_rows, const int* slot,
           const float* lower, const float* upper, const float* valid,
           const int* lo, const int* hi, const float* tau, int B, int N,
           int M, int K, int Cp, int C, float alpha, float inv_n,
           float* scores, int* pred, float* per_class, float* margin,
           unsigned char* esc, cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  score_kernel<kMode><<<B, kThreads, smem, stream>>>(
      f, thr, thr_rows, slot, lower, upper, valid, lo, hi, tau, N, M, K, Cp,
      C, alpha, inv_n, scores, pred, per_class, margin, esc);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, one entry per TPU kernel face. Pointers are device
// pointers; `stream` is a cudaStream_t; alpha and inv_n = 1.f / N are f32
// (bind them as ctypes.c_float). Each returns cudaGetLastError().

extern "C" int acam_similarity(const float* q, const float* lower,
                               const float* upper, int B, int M, int N,
                               float alpha, float inv_n, float* scores,
                               void* stream) {
  return launch<kRaw>(q, nullptr, 0, nullptr, lower, upper, nullptr, nullptr,
                      nullptr, nullptr, B, N, M, 1, M, M, alpha, inv_n,
                      scores, nullptr, nullptr, nullptr, nullptr,
                      (cudaStream_t)stream);
}

extern "C" int acam_similarity_classify(
    const float* f, const float* thr, const float* lower, const float* upper,
    const float* valid, int B, int N, int K, int Cp, int C, float alpha,
    float inv_n, int* pred, float* per_class, void* stream) {
  return launch<kClassify>(f, thr, 0, nullptr, lower, upper, valid, nullptr,
                           nullptr, nullptr, B, N, K * Cp, K, Cp, C, alpha,
                           inv_n, nullptr, pred, per_class, nullptr, nullptr,
                           (cudaStream_t)stream);
}

extern "C" int acam_similarity_serve(
    const float* f, const float* thr_table, int thr_rows, const int* slot,
    const float* lower, const float* upper, const float* valid,
    const int* lo, const int* hi, const float* tau, int B, int N, int K,
    int Cp, int C, int chunk, float alpha, float inv_n, int* pred,
    float* per_class, float* margin, unsigned char* esc, void* stream) {
  (void)chunk;
  return launch<kServe>(f, thr_table, thr_rows, slot, lower, upper, valid,
                        lo, hi, tau, B, N, K * Cp, K, Cp, C, alpha, inv_n,
                        nullptr, pred, per_class, margin, esc,
                        (cudaStream_t)stream);
}
