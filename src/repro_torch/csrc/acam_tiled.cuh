// The tiled design of the ACAM classify kernels for Hopper (sm_90a),
// shared by acam_match.cu (the feature count, paper Eq. 8: B1, B3, B4,
// B7a, and B2's pack) and acam_similarity.cu (the similarity, Eq. 9-11 on
// binarised queries: B5, B6). Each source instantiates its own faces.
//
// A warp scores one query row against a tile of kCT = 32 classes, one lane
// per class, over bits staged in shared memory; takes the max over K
// (invalid rows -inf) and writes per_class; and reduces its window's
// classes to one acam::Top (best, its class, runner-up), which merges
// exactly in any order, so ties go to the lowest class across tiles too
// (acam_epilogue.cuh). Queries binarise as f > thr or, for the serve tick,
// (f - thr_table[slot]) > 0, a slot outside the table reading zero
// thresholds. One warp binarises a row: lane j reads feature 32 w + j, one
// coalesced 128-byte load per word, and __ballot_sync forms word w.
//
// The scorer is a compile-time parameter:
//   kCount       one plane, t != 0; a row scores N - sum_w popc(q_w ^ t_w)
//                in int32.
//   kSimilarity  two planes of a window row [lo, hi]: h0 = (lo <= 0 <= hi)
//                and h1 = (lo <= 1 <= hi), bits past N 0 in both. A binary
//                query hits feature i iff its bit's plane holds bit i, so
//                H = sum_w popc(~q_w & h0_w) + popc(q_w & h1_w) is exact
//                for any real window. On a binary window (every lo and hi
//                exactly 0 or 1; -0 counts as 0, a NaN does not) each miss
//                adds exactly 1 to Eq. 9's D, so D = N - H, summed per
//                round as an exact integer. Another row (real windows:
//                generate_templates(binary_windows=False), or any bank sent
//                in) sums D in float over its raw windows and the query
//                bits, lane j over features 32 w + j and a shuffle tree
//                over the lanes, each feature's two cells
//                (x = 0, 1) computed once for all the queries it meets:
//                the cooperative design in a distance phase of its own,
//                the local one as it packs the row. A row scores
//                S = (H * inv_n) / fma(alpha, D, 1), rounded as XLA compiles
//                the JAX kernels (acam_similarity.cu), and the max over K
//                is taken on S, never on H (a negative alpha reverses H's
//                order). Two planes of 4 slabs a round (against the count's
//                one plane of 8) keep the staging in the same 33.8 KB of
//                static shared memory; items then span at most 4 tiles. A
//                NaN bound makes its row not binary, and its NaN reaches S
//                as the plain version's does: Eq. 9's max(x, 0) keeps it
//                (relu_nan), and so do the max over K and the epilogue
//                (acam_epilogue.cuh, kNaN). These are the similarity's
//                branches only; the count compiles as before.
//
// tiled_kernel: an item is gq query rows x gc class tiles (gc the power of
// two up to kSlabs, 8 for the count and 4 for the similarity, that covers
// the bank, gq the warps left): a block merges its gc tiles' summaries
// itself, so no counter is needed up to kSlabs tiles (256 or 128
// classes). Staging loads of a round are all in flight before the first
// store; pred, margin and escalate = margin < tau are written by the block.
// kRaw (feature count, B7a) counts every row of an unpadded (M, N) bank as
// a K = 1, C = M bank with no valid mask and writes the (B, M) counts as
// per_class: no summary, no decision, so no merge at any M. Two designs,
// picked by the wrapper (LOCAL_ROWS):
//   cooperative  pack the query rows and the valid template rows once into
//                row-major bit scratch (a similarity row also its binary
//                flag); grid sync; if a row is not binary, a distance phase
//                (one warp per such row and 16 queries, all SMs) and a
//                second grid sync; the items stage bits through L2
//                (__ldcg: other SMs wrote them); past one item's kSlabs
//                tiles the last group to arrive merges (arrival counters).
//   local        a plain launch, no scratch: one block per 4 query rows
//                binarises its queries and the bank's rows straight into
//                shared memory (bank rows on the warps that stage no query;
//                a similarity row's round keeps its binary flag in the pad
//                word of its plane-0 slab row, and a row that is not binary
//                its round's D for each query in `dpart`, summed by the
//                warp that packs it from the windows it holds). It reads
//                the bank once per block, so it suits small banks
//                (predict's 10 classes), and it needs neither a grid sync
//                nor a counter.
//
// Each source is its own library, so the header keeps everything in an
// unnamed namespace: every translation unit gets its own instances.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "acam_epilogue.cuh"

namespace {

constexpr int kTileWarps = 8;  // warps per block
constexpr int kCT = 32;        // classes per tile (one per lane)
// tiled_kernel: items of gq queries x gc class tiles (gq gc = 8 warps),
// staged kSlabs (class tile, K slice) slabs of kSW words a round
constexpr int kSW = 32;  // 1,024 features
constexpr int kSlabRows = kCT / kTileWarps;  // rows of a slab per warp

enum Score { kCount, kSimilarity };
// bit planes of a template row, and the slabs staged a round: the
// similarity's two planes take the room of the count's one (33.8 KB)
template <Score kScore>
constexpr int kPlanes = kScore == kSimilarity ? 2 : 1;
template <Score kScore>
constexpr int kSlabs = kScore == kSimilarity ? 4 : 8;

// Words [w0, w0 + kU) of one row, one warp: lane j reads feature
// 32 w + j, so each word is one coalesced 128-byte warp load, and the
// ballot is the word; lane u keeps word w0 + u. Bits past N stay 0. A
// query binarises as x > thr, or with kServe as (x - thr) > 0, a null
// `thr` reading zeros; a template as x != 0.
template <int kU, bool kQuery, bool kServe>
__device__ __forceinline__ uint32_t pack_words(const float* __restrict__ src,
                                               const float* __restrict__ thr,
                                               int w0, int N, int lane) {
  float x[kU], th[kQuery ? kU : 1];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = (w0 + u) * 32 + lane;
    x[u] = i < N ? src[i] : 0.0f;
    if (kQuery) th[u] = i < N && (!kServe || thr) ? thr[i] : 0.0f;
  }
  uint32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = (w0 + u) * 32 + lane;
    const float h = th[kQuery ? u : 0];
    const bool bit =
        i < N && (kQuery ? (kServe ? x[u] - h > 0.0f : x[u] > h)
                         : x[u] != 0.0f);
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    if (lane == u) mine = word;
  }
  return mine;
}

__device__ __forceinline__ bool is_bit(float x) {
  return x == 0.0f || x == 1.0f;  // -0 == 0; a NaN is neither
}

// Eq. 9's max(x, 0), NaN kept as torch.clamp and jnp.maximum keep it
// (fmaxf would drop it): one max.NaN instruction.
__device__ __forceinline__ float relu_nan(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(0.0f));
  return r;
}

// Eq. 9's two cells of one feature, for x = 0 and x = 1, each in the plain
// version's order of operations: cell[x] = max(x - hi, 0)^2 +
// max(lo - x, 0)^2 (NaN if a bound is NaN).
__device__ __forceinline__ void window_cells(float l, float h, float* cell) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float above = relu_nan(__fsub_rn((float)x, h));
    const float below = relu_nan(__fsub_rn(l, (float)x));
    cell[x] = __fadd_rn(__fmul_rn(above, above), __fmul_rn(below, below));
  }
}

// The lanes' sums of d[0, nq) added up by a shuffle tree (every lane gets
// each total); lane 0 writes them to out[0, nq).
template <int kQ>
__device__ __forceinline__ void warp_sums(float* d, int nq, int lane,
                                          float* out) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (j < nq) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        d[j] = __fadd_rn(d[j], __shfl_xor_sync(0xffffffffu, d[j], o));
      if (lane == 0) out[j] = d[j];
    }
  }
}

// Words [w0, w0 + 32) of a window row's two planes, one warp, as
// pack_words does: lane u keeps word w0 + u of h0 = (lo <= 0 <= hi) and of
// h1 = (lo <= 1 <= hi), bits past N 0. Returns, on every lane, whether
// every lo and hi of these words is exactly 0 or 1.
__device__ __forceinline__ bool pack_window_words(
    const float* __restrict__ lo, const float* __restrict__ hi, int w0,
    int N, int lane, uint32_t* h0, uint32_t* h1) {
  float l[32], h[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const int i = (w0 + u) * 32 + lane;
    l[u] = i < N ? lo[i] : 0.0f;
    h[u] = i < N ? hi[i] : 0.0f;
  }
  bool binary = true;
  uint32_t m0 = 0, m1 = 0;
#pragma unroll
  for (int u = 0; u < 32; ++u) {
    const bool in = (w0 + u) * 32 + lane < N;
    binary &= is_bit(l[u]) && is_bit(h[u]);
    const uint32_t b0 =
        __ballot_sync(0xffffffffu, in && l[u] <= 0.0f && 0.0f <= h[u]);
    const uint32_t b1 =
        __ballot_sync(0xffffffffu, in && l[u] <= 1.0f && 1.0f <= h[u]);
    if (lane == u) m0 = b0, m1 = b1;
  }
  *h0 = m0;
  *h1 = m1;
  return __all_sync(0xffffffffu, binary);
}

// Eq. 9's D of one window row [lo, hi] against nq query rows, features of
// words [w0, w0 + wn): query j's bit of word w0 + u is bit `lane` of
// q[j * stride + u]. Lane j sums features 32 w + j in w's order into
// acc[j] (the caller's shuffle tree sums the lanes),
// each feature's two cells computed once for every query. The loop stays
// rolled: unrolled or batched, the H100 ran it slower.
template <int kQ>
__device__ __forceinline__ void row_distances(
    const float* __restrict__ lo, const float* __restrict__ hi, int N,
    int w0, int wn, const uint32_t* q, int stride, int nq, int lane,
    float* acc) {
#pragma unroll 1
  for (int u = 0; u < wn; ++u) {
    const int i = (w0 + u) * 32 + lane;
    if (i < N) {
      float cell[2];
      window_cells(lo[i], hi[i], cell);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (j < nq)
          acc[j] = __fadd_rn(acc[j], (q[j * stride + u] >> lane) & 1u
                                         ? cell[1] : cell[0]);
    }
  }
}

// A summary another block wrote, read past L1 (it holds no stale copy).
__device__ __forceinline__ acam::Top load_top(const acam::Top* p) {
  const float* w = reinterpret_cast<const float*>(p);
  return acam::Top{__ldcg(w), __ldcg(reinterpret_cast<const int*>(w) + 1),
                   __ldcg(w + 2)};
}

// One call's operands. Null `lo`/`hi` mean the window [0, C); null
// `margin`, `tau`/`esc` are not written; `valid` and `pred` are null in
// raw mode. `slot` (the serve tick) picks each row's threshold row of
// `thr` (thr_rows rows); otherwise `thr` is one row. `t` is the template
// bank, or the window bank's lower bounds with `t2` its upper ones (the
// similarity, scored with alpha and inv_n = 1.f / N). The scratch pointers
// are used by the cooperative designs only (`flags` and `dist` by the
// similarity).
struct TileArgs {
  const float* f;
  const float* thr;
  const int* slot;
  int thr_rows;
  const float* t;
  const float* valid;
  const int* lo;
  const int* hi;
  const float* tau;
  int B, N, K, Cp, C;
  uint32_t* qbits;
  uint32_t* tbits;
  acam::Top* tops;
  unsigned* arrivals;
  int* pred;
  float* per_class;
  float* margin;
  unsigned char* esc;
  const float* t2;
  float alpha, inv_n;
  uint32_t* flags;
  float* dist;
};

// Row b's threshold row: the one row, or its slot's (null for a slot
// outside the table: zeros, as the TPU kernel's one-hot select reads).
template <bool kServe>
__device__ __forceinline__ const float* thr_row(const TileArgs& a, int b) {
  if (!kServe) return a.thr;
  const int s = a.slot[b];
  return s >= 0 && s < a.thr_rows ? a.thr + (int64_t)s * a.N : nullptr;
}

// The cooperative pack phase: one warp per row, grid-stride, binarises the
// B query rows (kQU words a round) and the valid template rows (kRaw:
// every row) into row-major bit words: the count's one plane, or the
// similarity's h0 plane, then its h1 plane, and each row's binary flag.
// Padded class rows and invalid rows are never scored, so never packed
// (the similarity flags them binary: no distance is summed for them).
// Block 0 zeroes `counters` arrival counters.
template <Score kScore, int kQU, bool kServe, bool kRaw = false>
__device__ __forceinline__ void pack_rows(const TileArgs& a, int counters) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = a.N, W = (N + 31) / 32, R = a.K * a.Cp;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < counters; i += blockDim.x) a.arrivals[i] = 0;
  for (int row = blockIdx.x * kTileWarps + warp; row < a.B + R;
       row += gridDim.x * kTileWarps) {
    if (row < a.B) {
      const float* src = a.f + (int64_t)row * N;
      const float* th = thr_row<kServe>(a, row);
      for (int w0 = 0; w0 < W; w0 += kQU) {
        const uint32_t mine = pack_words<kQU, true, kServe>(src, th, w0, N,
                                                            lane);
        if (lane < kQU && w0 + lane < W)
          a.qbits[(int64_t)row * W + w0 + lane] = mine;
      }
    } else {
      const int r = row - a.B;
      if (r % a.Cp >= a.C || (!kRaw && !(a.valid[r] > 0.0f))) {
        if (kScore == kSimilarity && lane == 0) a.flags[r] = 1;
        continue;
      }
      if constexpr (kScore == kSimilarity) {
        const float* lo = a.t + (int64_t)r * N;
        const float* hi = a.t2 + (int64_t)r * N;
        bool binary = true;
        for (int w0 = 0; w0 < W; w0 += 32) {
          uint32_t h0, h1;
          binary &= pack_window_words(lo, hi, w0, N, lane, &h0, &h1);
          if (w0 + lane < W) {
            a.tbits[(int64_t)r * W + w0 + lane] = h0;
            a.tbits[(int64_t)(R + r) * W + w0 + lane] = h1;
          }
        }
        if (lane == 0) a.flags[r] = binary;
      } else {
        const float* src = a.t + (int64_t)r * N;
        for (int w0 = 0; w0 < W; w0 += 32) {
          const uint32_t mine =
              pack_words<32, false, false>(src, nullptr, w0, N, lane);
          if (w0 + lane < W) a.tbits[(int64_t)r * W + w0 + lane] = mine;
        }
      }
    }
  }
}

// The cooperative decide phase: the last of `parts` items of query group
// `qg` to arrive (an atomic counter) merges the `parts` summaries of each
// of its rows (exact in any order) and writes the decision, the margin
// clamped at `cap`; the warps with `decides` set each decide their row b.
// Every thread of the block calls. kNaN: the similarity's epilogue
// (acam_epilogue.cuh).
template <bool kNaN = false>
__device__ __forceinline__ void decide_last(const TileArgs& a, int qg,
                                            int parts, int b, bool decides,
                                            float cap, bool* last) {
  const int lane = threadIdx.x & 31;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(&a.arrivals[qg], 1u) == (unsigned)parts - 1;
  __syncthreads();
  if (*last && decides && b < a.B) {
    __threadfence();
    acam::Top top = acam::top_empty();
    for (int i = lane; i < parts; i += 32)
      top = acam::top_merge<kNaN>(top,
                                  load_top(a.tops + (int64_t)b * parts + i));
    top = acam::top_warp_merge<kNaN>(top);
    if (lane == 0) acam::top_finish<kNaN>(top, cap, a.tau, b, a.pred,
                                          a.margin, a.esc);
  }
}

// The cooperative similarity's distance phase, after the pack: Eq. 9's D
// of every (query, valid row that is not binary) pair into a.dist (B rows
// of K * Cp), so that the items take it whole. A unit is one such row
// against kDQ queries, one warp, grid-stride: each round of 32 words
// stages the queries' bits in `stage` (kDQ x 32 words per warp) for
// row_distances, and a shuffle tree sums the lanes.
constexpr int kDQ = 16;
__device__ __forceinline__ void distance_phase(const TileArgs& a,
                                               uint32_t* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = a.N, W = (N + 31) / 32, R = a.K * a.Cp;
  const int qc = (a.B + kDQ - 1) / kDQ;
  uint32_t* qst = stage + warp * kDQ * 32;
  for (int64_t unit = (int64_t)blockIdx.x * kTileWarps + warp;
       unit < (int64_t)R * qc; unit += (int64_t)gridDim.x * kTileWarps) {
    const int r = (int)(unit / qc), b0 = (int)(unit % qc) * kDQ;
    if (__ldcg(a.flags + r)) continue;  // binary, invalid or padded
    const int nq = min(kDQ, a.B - b0);
    const float* lo = a.t + (int64_t)r * N;
    const float* hi = a.t2 + (int64_t)r * N;
    float acc[kDQ];
#pragma unroll
    for (int j = 0; j < kDQ; ++j) acc[j] = 0.0f;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int wn = min(32, W - w0);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kDQ; ++j)
        qst[j * 32 + lane] =
            j < nq && lane < wn
                ? __ldcg(a.qbits + (int64_t)(b0 + j) * W + w0 + lane) : 0u;
      __syncwarp();
      row_distances<kDQ>(lo, hi, N, w0, wn, qst, 32, nq, lane, acc);
    }
    float sums[kDQ];
    warp_sums<kDQ>(acc, nq, lane, sums);
    if (lane == 0)
      for (int j = 0; j < nq; ++j) a.dist[(int64_t)(b0 + j) * R + r] = sums[j];
  }
}

// Class tiles per item of tiled_kernel: the power of two (1, 2, 4, 8) that
// covers the bank's tiles, at most kSlabs; and its query rows per item: the
// warps left, but at most 4 in the local design, whose warps beyond them
// binarise bank rows meanwhile.
template <Score kScore>
__host__ __device__ __forceinline__ int group_tiles(int tiles) {
  const int gc = tiles > 4 ? 8 : tiles > 2 ? 4 : tiles;
  return gc < kSlabs<kScore> ? gc : kSlabs<kScore>;
}
__host__ __device__ __forceinline__ int group_rows(int gc, bool local) {
  const int gq = kTileWarps / gc;
  return local && gq > 4 ? 4 : gq;
}

// The tiled faces in one launch (see the head of this file); kLocal picks
// the design. Warp (qi, gt) of an item scores query qi against the 32
// classes of tile gt, one per lane, and a block merge of the gc warps'
// summaries decides each row unless the bank has more than 8 tiles (the
// cooperative decide then merges the groups). One block per SM is enough
// (the grid is small): the full register file keeps the unrolled staging
// and count out of local memory.
template <Score kScore, bool kServe, bool kLocal, bool kRaw>
__global__ void __launch_bounds__(kTileWarps * 32, 1)
    tiled_kernel(const TileArgs a) {
  constexpr bool kSim = kScore == kSimilarity;
  constexpr int kP = kPlanes<kScore>, kS = kSlabs<kScore>;
  constexpr int kS_log = kS == 8 ? 3 : 2;
  // slab rows padded to kSW + 1 words: lane c reads ts[.][.][c][w],
  // conflict-free; the count reads all kSW words, zeros past N. The local
  // similarity keeps a row's round binary flag in its plane-0 pad word.
  __shared__ uint32_t ts[kP][kS][kCT][kSW + 1];
  __shared__ uint32_t qs[kTileWarps][kSW + 1];
  __shared__ acam::Top warp_top[kTileWarps];
  __shared__ bool last;
  // the local similarity's rows that are not binary: D's part of the
  // round for each (slab, class, query)
  __shared__ float dpart[kSim ? kS : 1][kCT][kSim ? kTileWarps : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, N = a.N, K = a.K, Cp = a.Cp, C = a.C;
  const int W = (N + 31) / 32;
  const int tiles = (C + kCT - 1) / kCT;
  const int gc = group_tiles<kScore>(tiles), gq = group_rows(gc, kLocal);
  const int kr = kS / gc, kr_log = kS_log - (__ffs(gc) - 1);  // K slices
  const int groups = (tiles + gc - 1) / gc, q_groups = (B + gq - 1) / gq;
  const int qi = warp / gc, gt = warp % gc;
  const float cap = kSim ? 1.0f : (float)N;  // of the margin

  if (!kLocal) {
    pack_rows<kScore, 32, kServe, kRaw>(a, kRaw ? 0 : q_groups);
    cooperative_groups::this_grid().sync();
    if constexpr (kSim) {
      // every block sees the same flags, so all or none sync again
      bool any_real = false;
#pragma unroll 8
      for (int r = threadIdx.x; r < K * Cp; r += blockDim.x)
        any_real |= !__ldcg(a.flags + r);
      if (__syncthreads_or(any_real)) {
        distance_phase(a, &ts[0][0][0][0]);
        cooperative_groups::this_grid().sync();
      }
    }
  }

  const int items = kLocal ? q_groups : groups * q_groups;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int qg = kLocal ? item : item / groups;
    const int g0 = kLocal ? 0 : item % groups, g1 = kLocal ? groups : g0 + 1;
    const int b = qi < gq ? qg * gq + qi : B;  // this warp's row, if any
    const int bs = qg * gq + warp;  // the row this warp stages (warp < gq)
    const float* th =
        kLocal && warp < gq && bs < B ? thr_row<kServe>(a, bs) : nullptr;
    // the row's window and tau, read before the count needs them
    const int wlo = b < B && a.lo ? max(a.lo[b], 0) : 0;
    const int whi = b < B && a.hi ? min(a.hi[b], C) : C;
    const float tau_b = b < B && a.esc ? a.tau[b] : 0.0f;
    acam::Top top = acam::top_empty();
    for (int g = g0; g < g1; ++g) {
      const int c = (g * gc + gt) * kCT + lane;
      float best = -CUDART_INF_F;
      for (int k0 = 0; k0 < K; k0 += kr) {
        float vf[kS];  // this warp's slices, loaded before the staging
        int diff[kS];  // count: mismatches; similarity: hits H
        float dist[kSim ? kS : 1];  // similarity: Eq. 9's D
        unsigned real = 0;  // cooperative similarity: rows not binary
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          vf[u] = b < B && u < kr && k0 + u < K && c < C
                      ? (kRaw ? 1.0f : a.valid[(k0 + u) * Cp + c]) : 0.0f;
          diff[u] = 0;
          if constexpr (kSim) {
            dist[u] = 0.0f;
            if (!kLocal && vf[u] > 0.0f &&
                !__ldcg(a.flags + (k0 + u) * Cp + c)) {
              real |= 1u << u;
              dist[u] = __ldcg(a.dist + (int64_t)b * K * Cp + (k0 + u) * Cp +
                               c);
            }
          }
        }
        for (int w0 = 0; w0 < W; w0 += kSW) {
          const int wn = min(kSW, W - w0);
          __syncthreads();  // the previous round (or item) is consumed
          // slab s holds K slice k0 + (s % kr) of the group's tile s / kr;
          // each warp stages every 8th row of each slab
          unsigned packed_real = 0;  // local similarity: (s, j) not binary
          if (kLocal) {
            // binarise straight from the bank (padded classes and slices
            // past K skipped: never scored)
            for (int s = 0; s < kS; ++s) {
              const int u = s & (kr - 1);
              const int c0 = (g * gc + (s >> kr_log)) * kCT;
              if (k0 + u >= K) continue;
              for (int j = 0; j < kSlabRows; ++j) {
                // rows start on the warps that stage no query
                const int rr = (warp + kTileWarps - gq) % kTileWarps +
                               j * kTileWarps;
                if (c0 + rr >= C) break;
                const int64_t row = (int64_t)((k0 + u) * Cp + c0 + rr) * N;
                if constexpr (kSim) {
                  uint32_t h0, h1;
                  const bool binary = pack_window_words(
                      a.t + row, a.t2 + row, w0, N, lane, &h0, &h1);
                  ts[0][s][rr][lane] = h0;
                  ts[1][s][rr][lane] = h1;
                  if (lane == 0) ts[0][s][rr][kSW] = binary;
                  if (!binary) packed_real |= 1u << (s * kSlabRows + j);
                } else {
                  ts[0][s][rr][lane] = pack_words<32, false, false>(
                      a.t + row, nullptr, w0, N, lane);
                }
              }
            }
            // with one round of words qs keeps its rows across the groups
            // and K rounds
            if (warp < gq && (W > kSW || (g == g0 && k0 == 0)))
              qs[warp][lane] = bs < B ? pack_words<32, true, kServe>(
                                            a.f + (int64_t)bs * N, th, w0,
                                            N, lane)
                                      : 0u;
          } else {
            // every load of the round in flight before the first store
            uint32_t v[kP][kS][kSlabRows];
            const bool in_words = lane < wn;
#pragma unroll
            for (int p = 0; p < kP; ++p)
#pragma unroll
              for (int s = 0; s < kS; ++s) {
                const int u = s & (kr - 1);
                const int c0 = (g * gc + (s >> kr_log)) * kCT;
#pragma unroll
                for (int j = 0; j < kSlabRows; ++j) {
                  const int rr = warp + j * kTileWarps;
                  // plane p of row r starts at word (p K Cp + r) W
                  v[p][s][j] =
                      in_words && k0 + u < K && c0 + rr < C
                          ? __ldcg(a.tbits +
                                   (int64_t)(p * K * Cp + (k0 + u) * Cp +
                                             c0 + rr) * W + w0 + lane)
                          : 0u;
                }
              }
            const uint32_t qv =
                warp < gq && bs < B && in_words
                    ? __ldcg(a.qbits + (int64_t)bs * W + w0 + lane) : 0u;
#pragma unroll
            for (int p = 0; p < kP; ++p)
#pragma unroll
              for (int s = 0; s < kS; ++s)
#pragma unroll
                for (int j = 0; j < kSlabRows; ++j)
                  ts[p][s][warp + j * kTileWarps][lane] = v[p][s][j];
            if (warp < gq) qs[warp][lane] = qv;
          }
          if constexpr (!kSim) {
            __syncthreads();
          } else if (__syncthreads_or(packed_real != 0)) {
            // local similarity: the warp that packed a row that is not
            // binary sums its round's D for each query (its windows are
            // still in L1) into dpart
            for (unsigned todo = packed_real; todo; todo &= todo - 1) {
              const int bit = __ffs(todo) - 1;
              const int s = bit / kSlabRows, j = bit % kSlabRows;
              const int rr = (warp + kTileWarps - gq) % kTileWarps +
                             j * kTileWarps;
              const int64_t row =
                  (int64_t)((k0 + (s & (kr - 1))) * Cp +
                            (g * gc + (s >> kr_log)) * kCT + rr) * N;
              float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // gq <= 4 here
              row_distances<4>(a.t + row, a.t2 + row, N, w0, wn, &qs[0][0],
                               kSW + 1, gq, lane, acc);
              warp_sums<4>(acc, gq, lane, dpart[s][rr]);
            }
            __syncthreads();
          }
#pragma unroll
          for (int u = 0; u < kS; ++u) {
            if (vf[u] > 0.0f) {
              const int slab = gt * kr + u;
              if constexpr (kSim) {
                const uint32_t* h0 = ts[0][slab][lane];
                const uint32_t* h1 = ts[1][slab][lane];
                int h = 0;
#pragma unroll
                for (int w = 0; w < kSW; ++w) {
                  const uint32_t q = qs[qi][w];
                  h += __popc(~q & h0[w]) + __popc(q & h1[w]);
                }
                diff[u] += h;
                // a binary row's misses in this round are its features
                // less h; another row's D is the pack's (local) or the
                // distance phase's, taken whole at k0 (cooperative)
                if (kLocal && h0[kSW] == 0u)
                  dist[u] = __fadd_rn(dist[u], dpart[slab][lane][qi]);
                else if (kLocal || !(real >> u & 1u))
                  dist[u] = __fadd_rn(
                      dist[u], (float)(min(N - 32 * w0, 32 * kSW) - h));
              } else {
                const uint32_t* t_row = ts[0][slab][lane];
                int d = 0;
#pragma unroll
                for (int w = 0; w < kSW; ++w) d += __popc(qs[qi][w] ^ t_row[w]);
                diff[u] += d;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          if (vf[u] > 0.0f) {
            if constexpr (kSim) {
              // the max over K keeps a NaN, as the plain amax does
              const float s = __fdiv_rn(__fmul_rn((float)diff[u], a.inv_n),
                                        __fmaf_rn(a.alpha, dist[u], 1.0f));
              best = s > best || acam::is_nan(s) ? s : best;
            } else
              best = fmaxf(best, (float)(N - diff[u]));
          }
        }
      }
      if (b < B) {
        if (c < C) a.per_class[(int64_t)b * C + c] = best;
        // a lane's classes arrive in increasing order (top_push's
        // precondition), also across the local design's groups
        if (!kRaw && c >= wlo && c < whi) acam::top_push<kSim>(top, best, c);
      }
    }
    if (kRaw) continue;  // the counts are the output: no decision
    top = acam::top_warp_merge<kSim>(top);  // exact in any lane order
    if (gc > 1) {  // merge the item's gc class tiles of each row
      if (lane == 0) warp_top[warp] = top;
      __syncthreads();
      if (gt == 0)
        for (int j = 1; j < gc; ++j)
          top = acam::top_merge<kSim>(top, warp_top[warp + j]);
    }
    if (kLocal || groups == 1) {  // the item held every class of its rows
      if (gt == 0 && lane == 0 && b < B)
        acam::top_finish<kSim>(top, cap, tau_b, b, a.pred, a.margin, a.esc);
      continue;
    }
    if (gt == 0 && lane == 0 && b < B) a.tops[(int64_t)b * groups + g0] = top;
    decide_last<kSim>(a, qg, groups, b, gt == 0, cap, &last);
  }
}

// Blocks of `kernel` (kTileWarps warps, static shared memory only) that fit
// on device `dev` at once, cached per device in `cache`: the cap of a
// cooperative grid.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int dev, int* cache,
                            int* resident) {
  *resident = dev < 64 ? cache[dev] : 0;
  if (*resident) return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kTileWarps * 32, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *resident = per_sm * sms;
  if (dev < 64) cache[dev] = *resident;
  return cudaSuccess;
}

// One cooperative launch of `kernel` on min(want, co-resident) blocks,
// `scratch` holding B * W query words, kPlanes * K * Cp * W template words
// (plane by plane), K * Cp binary flags and B * K * Cp distances (the
// similarity only), B * ceil(C / 32) acam::Top summaries (3 words each)
// and the arrival counters, in that order (raw mode: the bits alone; it
// never reaches the summaries or the counters).
template <Score kScore, typename Kernel>
int launch_cooperative(Kernel kernel, int* cache, TileArgs a,
                       uint32_t* scratch, int64_t want, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(kernel, dev, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  const int W = (a.N + 31) / 32, tiles = (a.C + kCT - 1) / kCT;
  const int64_t rows = (int64_t)a.K * a.Cp;
  a.qbits = scratch;
  a.tbits = a.qbits + (int64_t)a.B * W;
  a.flags = a.tbits + kPlanes<kScore> * rows * W;
  a.dist = reinterpret_cast<float*>(a.flags +
                                    (kScore == kSimilarity ? rows : 0));
  a.tops = reinterpret_cast<acam::Top*>(
      a.dist + (kScore == kSimilarity ? (int64_t)a.B * rows : 0));
  a.arrivals = reinterpret_cast<unsigned*>(a.tops + (int64_t)a.B * tiles);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    (int)min(want, (int64_t)resident),
                                    kTileWarps * 32, args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A tiled face in one launch: the local design when `scratch` is null
// (one block per query group), else the cooperative one (B arrival
// counters).
template <Score kScore, bool kServe, bool kRaw = false>
int launch_tiled(TileArgs a, uint32_t* scratch, cudaStream_t stream) {
  static int resident_of[64] = {};  // co-resident blocks per device
  if (a.Cp % kCT != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (a.C + kCT - 1) / kCT;
  const int gc = group_tiles<kScore>(tiles), gq = group_rows(gc, !scratch);
  const int64_t q_groups = (a.B + gq - 1) / gq;
  if (!scratch) {
    tiled_kernel<kScore, kServe, true, kRaw>
        <<<(int)q_groups, kTileWarps * 32, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int64_t want =
      max((int64_t)(a.B + a.K * a.Cp + kTileWarps - 1) / kTileWarps,
          (tiles + gc - 1) / gc * q_groups);
  return launch_cooperative<kScore>(
      tiled_kernel<kScore, kServe, false, kRaw>, resident_of, a, scratch,
      want, stream);
}

}  // namespace
