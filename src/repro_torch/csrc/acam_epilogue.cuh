// The windowed winner-take-all epilogue shared by the ACAM classify kernels
// (acam_match.cu: B1-B4, acam_similarity.cu: B5-B6).
//
// A `Top` summarises the per-class scores of a set of classes inside a
// request's window [lo, hi): the best score, its class index and the best
// score at any other position. Summaries of disjoint class sets merge
// exactly and in any order, so a warp's lanes, or a block's warps, can each
// walk their own classes and combine at the end.
//
// Semantics kept exactly (src/repro/kernels/layout.py, wta_epilogue and
// windowed_margin): the lowest class index wins ties; the runner-up
// excludes only the winner's position, so a tie elsewhere gives margin 0;
// the margin is clamped at `cap` (N for feature counts, 1 for similarity);
// an empty or all -inf window gives pred 0 and margin 0.
//
// kNaN (the similarity, whose scores can be NaN when a window bound or a
// query is NaN) follows the plain epilogues' max and argmax, which
// propagate a NaN: a NaN outranks every score, the lowest NaN class wins,
// and a window whose best score is not finite (NaN, +inf) gets margin 0.
// The feature count (integer scores) takes the default, kNaN = false.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace acam {

struct Top {
  float t1;  // best score in the window
  int i1;    // its class index (lowest among ties)
  float t2;  // best score at any other position
};

__device__ __forceinline__ Top top_empty() {
  return Top{-CUDART_INF_F, INT_MAX, -CUDART_INF_F};
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// Add class `c`'s score to a summary. Classes must arrive in increasing
// index order: the strict > keeps the lowest index among ties.
template <bool kNaN = false>
__device__ __forceinline__ void top_push(Top& top, float score, int c) {
  if (score > top.t1 || (kNaN && is_nan(score) && !is_nan(top.t1))) {
    top.t2 = top.t1;
    top.t1 = score;
    top.i1 = c;
  } else {
    top.t2 = fmaxf(top.t2, score);
  }
}

// Merge two summaries over disjoint class sets: the winner is the
// lexicographic max on (score desc, index asc); the runner-up is the
// losing side's top1 or the winning side's own runner-up.
template <bool kNaN = false>
__device__ __forceinline__ Top top_merge(Top a, Top b) {
  bool take = b.t1 > a.t1 || (b.t1 == a.t1 && b.i1 < a.i1);
  if (kNaN && (is_nan(a.t1) || is_nan(b.t1)))
    take = is_nan(b.t1) && (!is_nan(a.t1) || b.i1 < a.i1);
  Top out;
  out.t1 = take ? b.t1 : a.t1;
  out.i1 = take ? b.i1 : a.i1;
  out.t2 = take ? fmaxf(b.t2, a.t1) : fmaxf(a.t2, b.t1);
  return out;
}

// Merge the summaries of a warp's 32 lanes; every lane ends with the total.
template <bool kNaN = false>
__device__ __forceinline__ Top top_warp_merge(Top top) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top other;
    other.t1 = __shfl_xor_sync(0xffffffffu, top.t1, off);
    other.i1 = __shfl_xor_sync(0xffffffffu, top.i1, off);
    other.t2 = __shfl_xor_sync(0xffffffffu, top.t2, off);
    top = top_merge<kNaN>(top, other);
  }
  return top;
}

// Write one row's decision: pred, the margin min(top1 - top2, cap) and the
// cascade's escalation bit margin < tau (margin and esc may be null).
template <bool kNaN = false>
__device__ __forceinline__ void top_finish(const Top& top, float cap,
                                           float tau_b, int b, int* pred,
                                           float* margin,
                                           unsigned char* esc) {
  const bool finite = kNaN ? isfinite(top.t1) : top.t1 > -CUDART_INF_F;
  const float m = finite ? top.t1 - fmaxf(top.t2, top.t1 - cap) : 0.0f;
  pred[b] = top.t1 > -CUDART_INF_F || (kNaN && is_nan(top.t1)) ? top.i1 : 0;
  if (margin) margin[b] = m;
  if (esc) esc[b] = m < tau_b;
}

// The same with row b's tau read here (tau may be null when esc is).
template <bool kNaN = false>
__device__ __forceinline__ void top_finish(const Top& top, float cap,
                                           const float* tau, int b,
                                           int* pred, float* margin,
                                           unsigned char* esc) {
  top_finish<kNaN>(top, cap, esc ? tau[b] : 0.0f, b, pred, margin, esc);
}

}  // namespace acam
