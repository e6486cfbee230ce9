// ACAM feature-count classify kernels for Hopper (sm_90a): paper Eq. 8
// match counts, the Eq. 12 per-class max over K templates and the
// winner-take-all, with the windowed winner-vs-runner-up margin and the
// cascade's escalation bit.
//
// Replaces the four Pallas TPU kernels of
// src/repro/kernels/acam_match/acam_match.py:
//   acam_match_classify                  (_classify_kernel)                 B1
//   acam_match_classify_margins          (_classify_margins_kernel)         B4
//   acam_match_classify_margins_chunked  (_classify_margins_chunked_kernel) B2
//   acam_match_serve                     (_serve_kernel)                    B3
// They share one design with four faces (one C entry each):
//
//   pack_kernel    binarise every query row (f > thr, or for the serve tick
//                  (f - thr_table[slot]) > 0 with a direct indexed load of
//                  the slot's threshold row) and every template row
//                  (t != 0) into 32-bit words, one thread per word.
//                  Queries land row-major (B, W), templates word-major
//                  (W, K * Cp) so a warp's lanes read neighbouring rows.
//   select_kernel  one warp per query row, lanes over classes: match count
//                  N - sum_w popc(q_w ^ t_w) (exact in int32), invalid rows
//                  -inf, max over K, per-class scores written out, then the
//                  windowed (top1, argmax, runner-up) merged across lanes
//                  with shuffles; lane 0 writes pred, margin = min(top1 -
//                  top2, cap) and escalate = margin < tau.
//
// Precondition: templates are {0, 1}. Every producer binarises them; the
// TPU kernels' bipolar bf16 product equals the count only under it, and
// here any non-zero entry reads as bit 1.
//
// Semantics kept exactly (src/repro/kernels/layout.py, wta_epilogue and
// windowed_margin): the lowest class index wins ties; the runner-up
// excludes only the winner's position; the margin is clamped at cap = N;
// an empty or all-invalid window gives pred 0 and margin 0.
//
// `chunk` (B2, B3) is accepted for signature parity with the TPU kernels,
// whose VMEM budget walked the bank in class chunks. A block here holds no
// bank in shared memory, so there is nothing to chunk: outputs never depend
// on it.
//
// Bound on this card. At the serving tick (64 slots, N = 784, 128 classes,
// K = 2) the call must move about 1.06 MB (f32 features, f32 {0,1}
// templates, the thresholds table, per-class scores out): about 0.32 us at
// 3.35 TB/s, far below the fixed cost of a launch. This simple design makes
// two launches and reads the f32 templates once (pack) and their 32x
// smaller bits once per query row (select, from L2). It does nothing yet
// about launch overhead; packing templates once per bank generation is the
// next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero, and the serve tick's (f - thr) > 0 must keep a subnormal difference.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kSelectWarps = 4;

// One thread per 32-bit word. Words [0, B * W) are query words (row-major),
// words [B * W, (B + R) * W) template words (word-major: w * R + r).
template <bool kServe>
__global__ void pack_kernel(const float* __restrict__ f,
                            const float* __restrict__ thr,
                            const int* __restrict__ slot, int thr_rows,
                            const float* __restrict__ t, int B, int N, int R,
                            int Cp, int C, int W, uint32_t* __restrict__ qbits,
                            uint32_t* __restrict__ tbits) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t q_words = (int64_t)B * W;
  if (idx >= q_words + (int64_t)R * W) return;
  uint32_t word = 0;
  if (idx < q_words) {
    const int b = (int)(idx / W), w = (int)(idx % W);
    const float* row = f + (int64_t)b * N;
    const float* th = thr;
    bool zero_thr = false;
    if (kServe) {
      const int s = slot[b];
      // a slot outside the table reads zero thresholds, as the TPU
      // kernel's one-hot select does
      zero_thr = s < 0 || s >= thr_rows;
      th = thr + (int64_t)(zero_thr ? 0 : s) * N;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = w * 32 + j;
      if (i < N) {
        bool bit;
        if (kServe) {
          const float x = row[i] - (zero_thr ? 0.0f : th[i]);
          bit = x > 0.0f;
        } else {
          bit = row[i] > th[i];
        }
        word |= (uint32_t)bit << j;
      }
    }
    qbits[idx] = word;
  } else {
    const int64_t k = idx - q_words;
    const int w = (int)(k / R), r = (int)(k % R);
    // padded class columns hold zeros and are invalid: skip their reads
    if (r % Cp < C) {
      const float* row = t + (int64_t)r * N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = w * 32 + j;
        if (i < N) word |= (uint32_t)(row[i] != 0.0f) << j;
      }
    }
    tbits[k] = word;
  }
}

struct Top {
  float t1;  // best score in the window
  int i1;    // its class index (lowest among ties)
  float t2;  // best score at any other position
};

// Merge two summaries over disjoint class sets: the winner is the
// lexicographic max on (score desc, index asc); the runner-up is the
// losing side's top1 or the winning side's own runner-up.
__device__ __forceinline__ Top merge(Top a, Top b) {
  const bool take = b.t1 > a.t1 || (b.t1 == a.t1 && b.i1 < a.i1);
  Top out;
  out.t1 = take ? b.t1 : a.t1;
  out.i1 = take ? b.i1 : a.i1;
  out.t2 = take ? fmaxf(b.t2, a.t1) : fmaxf(a.t2, b.t1);
  return out;
}

__global__ void select_kernel(const uint32_t* __restrict__ qbits,
                              const uint32_t* __restrict__ tbits,
                              const float* __restrict__ valid,
                              const int* __restrict__ lo,
                              const int* __restrict__ hi,
                              const float* __restrict__ tau, int B, int N,
                              int K, int Cp, int C, int W,
                              int* __restrict__ pred,
                              float* __restrict__ per_class,
                              float* __restrict__ margin,
                              unsigned char* __restrict__ esc) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSelectWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int R = K * Cp;
  const int wlo = lo ? max(lo[b], 0) : 0;
  const int whi = hi ? min(hi[b], C) : C;
  const uint32_t* q = qbits + (int64_t)b * W;

  Top top{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
  for (int c = lane; c < C; c += 32) {
    float best = -CUDART_INF_F;
    for (int kk = 0; kk < K; ++kk) {
      const int r = kk * Cp + c;
      if (valid[r] > 0.0f) {
        int diff = 0;
        for (int w = 0; w < W; ++w) diff += __popc(q[w] ^ tbits[(int64_t)w * R + r]);
        best = fmaxf(best, (float)(N - diff));
      }
    }
    per_class[(int64_t)b * C + c] = best;
    if (c >= wlo && c < whi) {
      // classes arrive in increasing order: strict > keeps the lowest index
      if (best > top.t1) {
        top.t2 = top.t1;
        top.t1 = best;
        top.i1 = c;
      } else {
        top.t2 = fmaxf(top.t2, best);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top other;
    other.t1 = __shfl_xor_sync(0xffffffffu, top.t1, off);
    other.i1 = __shfl_xor_sync(0xffffffffu, top.i1, off);
    other.t2 = __shfl_xor_sync(0xffffffffu, top.t2, off);
    top = merge(top, other);
  }
  if (lane == 0) {
    const bool finite = top.t1 > -CUDART_INF_F;
    const float cap = (float)N;
    const float m = finite ? top.t1 - fmaxf(top.t2, top.t1 - cap) : 0.0f;
    pred[b] = finite ? top.i1 : 0;
    if (margin) margin[b] = m;
    if (esc) esc[b] = m < tau[b];
  }
}

int launch(const float* f, const float* thr, const int* slot, int thr_rows,
           const float* t, const float* valid, const int* lo, const int* hi,
           const float* tau, int B, int N, int K, int Cp, int C,
           uint32_t* qbits, uint32_t* tbits, int* pred, float* per_class,
           float* margin, unsigned char* esc, cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const int R = K * Cp;
  const int64_t words = (int64_t)(B + R) * W;
  const int pack_blocks = (int)((words + kPackThreads - 1) / kPackThreads);
  if (slot) {
    pack_kernel<true><<<pack_blocks, kPackThreads, 0, stream>>>(
        f, thr, slot, thr_rows, t, B, N, R, Cp, C, W, qbits, tbits);
  } else {
    pack_kernel<false><<<pack_blocks, kPackThreads, 0, stream>>>(
        f, thr, nullptr, 0, t, B, N, R, Cp, C, W, qbits, tbits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int select_blocks = (B + kSelectWarps - 1) / kSelectWarps;
  select_kernel<<<select_blocks, kSelectWarps * 32, 0, stream>>>(
      qbits, tbits, valid, lo, hi, tau, B, N, K, Cp, C, W, pred, per_class,
      margin, esc);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, one entry per TPU kernel face. Pointers are device
// pointers; `stream` is a cudaStream_t. Each returns cudaGetLastError().
// qbits holds B * ceil(N/32) words, tbits K * Cp * ceil(N/32) words.

extern "C" int acam_match_classify(const float* f, const float* thr,
                                   const float* t, const float* valid, int B,
                                   int N, int K, int Cp, int C,
                                   uint32_t* qbits, uint32_t* tbits,
                                   int* pred, float* per_class,
                                   void* stream) {
  return launch(f, thr, nullptr, 0, t, valid, nullptr, nullptr, nullptr, B,
                N, K, Cp, C, qbits, tbits, pred, per_class, nullptr, nullptr,
                (cudaStream_t)stream);
}

extern "C" int acam_match_classify_margins(
    const float* f, const float* thr, const float* t, const float* valid,
    const int* lo, const int* hi, int B, int N, int K, int Cp, int C,
    uint32_t* qbits, uint32_t* tbits, int* pred, float* per_class,
    float* margin, void* stream) {
  return launch(f, thr, nullptr, 0, t, valid, lo, hi, nullptr, B, N, K, Cp,
                C, qbits, tbits, pred, per_class, margin, nullptr,
                (cudaStream_t)stream);
}

extern "C" int acam_match_classify_margins_chunked(
    const float* f, const float* thr, const float* t, const float* valid,
    const int* lo, const int* hi, int B, int N, int K, int Cp, int C,
    int chunk, uint32_t* qbits, uint32_t* tbits, int* pred,
    float* per_class, float* margin, void* stream) {
  (void)chunk;
  return launch(f, thr, nullptr, 0, t, valid, lo, hi, nullptr, B, N, K, Cp,
                C, qbits, tbits, pred, per_class, margin, nullptr,
                (cudaStream_t)stream);
}

extern "C" int acam_match_serve(const float* f, const float* thr_table,
                                int thr_rows, const int* slot, const float* t,
                                const float* valid, const int* lo,
                                const int* hi, const float* tau, int B, int N,
                                int K, int Cp, int C, int chunk,
                                uint32_t* qbits, uint32_t* tbits, int* pred,
                                float* per_class, float* margin,
                                unsigned char* esc, void* stream) {
  (void)chunk;
  return launch(f, thr_table, slot, thr_rows, t, valid, lo, hi, tau, B, N, K,
                Cp, C, qbits, tbits, pred, per_class, margin, esc,
                (cudaStream_t)stream);
}
