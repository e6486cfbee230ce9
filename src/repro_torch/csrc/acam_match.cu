// ACAM feature-count classify kernels for Hopper (sm_90a): paper Eq. 8
// match counts, the Eq. 12 per-class max over K templates and the
// winner-take-all, with the windowed winner-vs-runner-up margin and the
// cascade's escalation bit.
//
// Replaces the five Pallas TPU kernels of
// src/repro/kernels/acam_match/acam_match.py:
//   acam_match_classify                  (_classify_kernel)                 B1
//   acam_match_classify_margins          (_classify_margins_kernel)         B4
//   acam_match_classify_margins_chunked  (_classify_margins_chunked_kernel) B2
//   acam_match_serve                     (_serve_kernel)                    B3
//   acam_match                           (_kernel)                          B7a
//
// Every face is one launch of the tiled design. A warp counts one query
// row against a tile of kCT = 32 classes, one lane per class:
// N - sum_w popc(q_w ^ t_w) in int32 over bits staged in shared memory,
// the max over K (invalid rows -inf), per_class written; the warp reduces
// its window's classes to one acam::Top (best, its class, runner-up),
// which merges exactly in any order, so ties go to the lowest class across
// tiles too. Queries binarise as f > thr (B1, B2, B4, B7a) or, for the
// serve tick, (f - thr_table[slot]) > 0, a slot outside the table reading
// zero thresholds; templates as t != 0. One warp binarises a row: lane j
// reads feature 32 w + j, one coalesced 128-byte load per word, and
// __ballot_sync forms word w.
//
//   big_bank_kernel  B2: one cooperative launch. Pack the
//                    query rows and the valid template rows once into
//                    row-major bit scratch (block 0 zeroes the arrival
//                    counters); grid sync; blocks walk (class tile, 8-query
//                    tile) items; the last class tile of a query tile to
//                    arrive (an atomic counter) merges its rows' summaries
//                    and writes pred and margin = min(top1 - top2, N).
//   tiled_kernel     B1, B3, B4 and B7a. An item is gq query rows x gc
//                    class tiles (gc the power of two up to 8 that covers
//                    the bank, gq the warps left): a block merges its gc
//                    tiles' summaries itself, so no counter is needed up to
//                    8 tiles (256 classes). Staging loads of a round are
//                    all in flight before the first store; pred, margin
//                    (B3, B4) and escalate = margin < tau (B3) are written
//                    by the block. kRaw (B7a) counts every row of an
//                    unpadded (M, N) bank as a K = 1, C = M bank with no
//                    valid mask and writes the (B, M) counts as per_class:
//                    no summary, no decision, so no merge at any M.
//                    Two designs, picked by the wrapper (LOCAL_ROWS):
//     cooperative    B2's pack and grid sync, then the items stage bits
//                    through L2 (__ldcg: other SMs wrote them); past 8
//                    tiles the last group to arrive merges (B2's counters).
//     local          a plain launch, no scratch: one block per 4 query rows
//                    binarises its queries and the bank's rows straight
//                    into shared memory (bank rows on the warps that stage
//                    no query). It reads the bank once per block, so it
//                    suits small banks (predict's 10 classes), and it needs
//                    neither a grid sync nor a counter.
//
// Precondition: templates are {0, 1}. Every producer binarises them; the
// TPU kernels' bipolar bf16 product equals the count only under it, and
// here any non-zero entry reads as bit 1.
//
// The windowed (top1, argmax, runner-up) epilogue is shared with the
// similarity kernels (acam_epilogue.cuh, which states the semantics kept
// exactly: ties to the lowest class across tiles too, invalid and padded
// rows -inf, an empty or all-invalid window pred 0 and margin 0); here the
// margin is clamped at cap = N.
//
// `chunk` (B2, B3) is accepted for signature parity with the TPU kernels,
// whose VMEM budget walked the bank in class chunks. Outputs never depend
// on it: the class tiles here are the kernel's own (kCT), merged exactly.
//
// Bounds on this card (bytes: each input read once, each output written
// once, at 3.35 TB/s; the 2 B K C N bit operations at 1,979 TOP/s are far
// smaller):
//   B1 at predict and B7a at ACAMHead.scores (B 256, C 10, K 1, N 784):
//      0.85 MB, 0.25 us.
//   B3 at the serve tick (B 64, C 128, K 2, N 784, 8 tenants): 1.06 MB,
//      0.32 us; B4 at the compose tick (the same bank, one threshold row):
//      1.04 MB, 0.31 us.
//   B2 on the big bank (B 64, C 1,100, K 2, N 784): 7.4 MB, 2.2 us.
// The tiled faces' bounds lie below the fixed cost of a launch (about 1 us
// of device time for an empty one), so their design is about launches and
// dependent round trips: one launch per call (the first design made two,
// with a pack of 32 cache lines per warp load and one warp walking every
// class of a row), every load coalesced, each round's loads issued
// together, and no cross-block merge at these banks. What is left is the
// cooperative design's pack (two dependent rounds for the serve tick:
// slot, then its threshold row), grid sync, L2 staging and a count bound
// by popc (16 per clock per SM) on the serve and compose ticks' 32 blocks;
// the local design's binarising rounds on B1 and B7a. B2 is bound by
// bytes: it reads its bank once, coalesced, with every SM busy in each
// phase. At these sizes a call is bound by its host cost: a second launch
// costs more host time than a grid sync costs device time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero, and the serve tick's (f - thr) > 0 must keep a subnormal difference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "acam_epilogue.cuh"

namespace {

// ---- the tiled designs ---------------------------------------------------

constexpr int kTileWarps = 8;  // warps per block
constexpr int kCT = 32;        // classes per tile (one per lane)
// B2 (big_bank_kernel): items of kQT queries x one class tile, staged kKS
// K slices of kWC words a round
constexpr int kQT = kTileWarps;
constexpr int kKS = 4;
constexpr int kWC = 64;  // 2,048 features
// B1, B3 (tiled_kernel): items of gq queries x gc class tiles (gq gc = 8
// warps), staged kSlabs (class tile, K slice) slabs of kSW words a round
constexpr int kSlabs = 8;
constexpr int kSW = 32;  // 1,024 features
constexpr int kSlabRows = kCT / kTileWarps;  // rows of a slab per warp

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

// A summary another block wrote, read past L1 (it holds no stale copy).
__device__ __forceinline__ acam::Top load_top(const acam::Top* p) {
  const float* w = reinterpret_cast<const float*>(p);
  return acam::Top{__ldcg(w), __ldcg(reinterpret_cast<const int*>(w) + 1),
                   __ldcg(w + 2)};
}

// One call's operands. Null `lo`/`hi` mean the window [0, C); null
// `margin`, `tau`/`esc` are not written; `valid` and `pred` are null in
// raw mode. `slot` (the serve tick) picks each row's threshold row of
// `thr` (thr_rows rows); otherwise `thr` is one row. The scratch pointers
// are used by the cooperative designs only.
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
// every row) into row-major bit words; padded class rows and invalid rows
// are never counted, so never packed. Block 0 zeroes `counters` arrival
// counters.
template <int kQU, bool kServe, bool kRaw = false>
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
      if (r % a.Cp >= a.C || (!kRaw && !(a.valid[r] > 0.0f))) continue;
      const float* src = a.t + (int64_t)r * N;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const uint32_t mine =
            pack_words<32, false, false>(src, nullptr, w0, N, lane);
        if (w0 + lane < W) a.tbits[(int64_t)r * W + w0 + lane] = mine;
      }
    }
  }
}

// The cooperative decide phase: the last of `parts` items of query group
// `qg` to arrive (an atomic counter) merges the `parts` summaries of each
// of its rows (exact in any order) and writes the decision; the warps with
// `decides` set each decide their row b. Every thread of the block calls.
__device__ __forceinline__ void decide_last(const TileArgs& a, int qg,
                                            int parts, int b, bool decides,
                                            bool* last) {
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
      top = acam::top_merge(top, load_top(a.tops + (int64_t)b * parts + i));
    top = acam::top_warp_merge(top);
    if (lane == 0)
      acam::top_finish(top, (float)a.N, a.tau, b, a.pred, a.margin, a.esc);
  }
}

// B2 in one cooperative launch (its count loop kept as its device time was
// measured, one L2 round trip per staged row): pack; grid sync; blocks walk the (class tile of kCT, query
// tile of kQT) items, stage the tile's bits (up to kKS K slices of kWC
// words a round) in shared memory, one thread per (query, class) counts
// N - sum popc(q ^ t), takes the max over K (invalid rows -inf) and writes
// per_class, and each warp reduces its window's classes to one acam::Top
// in `tops`; the last tile of a query tile to arrive decides its rows.
// The bit words are read through L2 (__ldcg): other SMs wrote them.
__global__ void __launch_bounds__(kTileWarps * 32)
    big_bank_kernel(const TileArgs a) {
  // rows padded to kWC + 1 words: lane c reads ts[.][c][w], conflict-free
  __shared__ uint32_t ts[kKS][kCT][kWC + 1];
  __shared__ uint32_t qs[kQT][kWC + 1];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, N = a.N, K = a.K, Cp = a.Cp, C = a.C;
  const int W = (N + 31) / 32;
  const int tiles = (C + kCT - 1) / kCT, q_tiles = (B + kQT - 1) / kQT;

  pack_rows<16, false>(a, q_tiles);
  cooperative_groups::this_grid().sync();

  for (int item = blockIdx.x; item < tiles * q_tiles; item += gridDim.x) {
    const int c0 = (item % tiles) * kCT, qt = item / tiles;
    const int c = c0 + lane, b = qt * kQT + warp;
    float best = -CUDART_INF_F;
    for (int k0 = 0; k0 < K; k0 += kKS) {
      const int kn = min(kKS, K - k0);
      float vf[kKS];  // loaded now, read after the staging loads are issued
      int diff[kKS];
#pragma unroll
      for (int u = 0; u < kKS; ++u) {
        // Cp is a multiple of kCT: row (k0 + u) Cp + c stays in its slice
        vf[u] = u < kn && c < C ? a.valid[(k0 + u) * Cp + c] : 0.0f;
        diff[u] = 0;
      }
      for (int w0 = 0; w0 < W; w0 += kWC) {
        const int wn = min(kWC, W - w0);
        __syncthreads();  // the previous round (or item) is consumed
        // warp q stages rows q, q + kQT, ... of each slice and query q;
        // rows of padded or invalid classes hold stale words, never used
        for (int u = 0; u < kn; ++u)
          for (int rr = warp; rr < kCT; rr += kQT)
            for (int w = lane; w < wn; w += 32)
              ts[u][rr][w] = __ldcg(
                  a.tbits + (int64_t)((k0 + u) * Cp + c0 + rr) * W + w0 + w);
        for (int w = lane; w < wn; w += 32)
          qs[warp][w] = b < B ? __ldcg(a.qbits + (int64_t)b * W + w0 + w)
                              : 0u;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kKS; ++u) {
          if (vf[u] > 0.0f) {
            int d = 0;
            for (int w = 0; w < wn; ++w)
              d += __popc(qs[warp][w] ^ ts[u][lane][w]);
            diff[u] += d;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kKS; ++u)
        if (vf[u] > 0.0f) best = fmaxf(best, (float)(N - diff[u]));
    }

    acam::Top top = acam::top_empty();
    if (b < B) {
      if (c < C) a.per_class[(int64_t)b * C + c] = best;
      const int wlo = max(a.lo[b], 0), whi = min(a.hi[b], C);
      if (c >= wlo && c < whi) acam::top_push(top, best, c);
    }
    top = acam::top_warp_merge(top);  // exact in any lane order
    if (lane == 0 && b < B) a.tops[(int64_t)b * tiles + item % tiles] = top;
    decide_last(a, qt, tiles, b, true, &last);
  }
}

// Class tiles per item of tiled_kernel: the power of two (1, 2, 4, 8) that
// covers the bank's tiles, at most 8; and its query rows per item: the
// warps left, but at most 4 in the local design, whose warps beyond them
// binarise bank rows meanwhile.
__host__ __device__ __forceinline__ int group_tiles(int tiles) {
  return tiles > 4 ? 8 : tiles > 2 ? 4 : tiles;
}
__host__ __device__ __forceinline__ int group_rows(int gc, bool local) {
  const int gq = kTileWarps / gc;
  return local && gq > 4 ? 4 : gq;
}

// B1, B3, B4 and B7a (kRaw) in one launch (see the head of this file);
// kLocal picks the design. An item is gq query rows x gc class tiles
// (group_rows, group_tiles): warp (qi, gt) counts query qi of the item
// against the 32 classes of tile gt, one per lane, and a block merge of
// the gc warps' summaries decides each row unless the bank has more than 8
// tiles (the cooperative decide then merges the groups). One block per SM
// is enough (the grid is small): the full register file keeps the
// unrolled staging and count out of local memory.
template <bool kServe, bool kLocal, bool kRaw>
__global__ void __launch_bounds__(kTileWarps * 32, 1)
    tiled_kernel(const TileArgs a) {
  // slab rows padded to kSW + 1 words: lane c reads ts[.][c][w],
  // conflict-free; the count reads all kSW words, zeros past N
  __shared__ uint32_t ts[kSlabs][kCT][kSW + 1];
  __shared__ uint32_t qs[kTileWarps][kSW + 1];
  __shared__ acam::Top warp_top[kTileWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, N = a.N, K = a.K, Cp = a.Cp, C = a.C;
  const int W = (N + 31) / 32;
  const int tiles = (C + kCT - 1) / kCT;
  const int gc = group_tiles(tiles), gq = group_rows(gc, kLocal);
  const int kr = kSlabs / gc, kr_log = 3 - (__ffs(gc) - 1);  // K slices
  const int groups = (tiles + gc - 1) / gc, q_groups = (B + gq - 1) / gq;
  const int qi = warp / gc, gt = warp % gc;

  if (!kLocal) {
    pack_rows<32, kServe, kRaw>(a, kRaw ? 0 : q_groups);
    cooperative_groups::this_grid().sync();
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
        float vf[kSlabs];  // this warp's slices, loaded before the staging
        int diff[kSlabs];
#pragma unroll
        for (int u = 0; u < kSlabs; ++u) {
          vf[u] = b < B && u < kr && k0 + u < K && c < C
                      ? (kRaw ? 1.0f : a.valid[(k0 + u) * Cp + c]) : 0.0f;
          diff[u] = 0;
        }
        for (int w0 = 0; w0 < W; w0 += kSW) {
          const int wn = min(kSW, W - w0);
          __syncthreads();  // the previous round (or item) is consumed
          // slab s holds K slice k0 + (s % kr) of the group's tile s / kr;
          // each warp stages every 8th row of each slab
          if (kLocal) {
            // binarise straight from the bank (padded classes and slices
            // past K skipped: never counted)
            for (int s = 0; s < kSlabs; ++s) {
              const int u = s & (kr - 1);
              const int c0 = (g * gc + (s >> kr_log)) * kCT;
              if (k0 + u >= K) continue;
              for (int j = 0; j < kSlabRows; ++j) {
                // rows start on the warps that stage no query
                const int rr = (warp + kTileWarps - gq) % kTileWarps +
                               j * kTileWarps;
                if (c0 + rr >= C) break;
                ts[s][rr][lane] = pack_words<32, false, false>(
                    a.t + (int64_t)((k0 + u) * Cp + c0 + rr) * N, nullptr,
                    w0, N, lane);
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
            uint32_t v[kSlabs][kSlabRows];
            const bool in_words = lane < wn;
#pragma unroll
            for (int s = 0; s < kSlabs; ++s) {
              const int u = s & (kr - 1);
              const int c0 = (g * gc + (s >> kr_log)) * kCT;
#pragma unroll
              for (int j = 0; j < kSlabRows; ++j) {
                const int rr = warp + j * kTileWarps;
                v[s][j] = in_words && k0 + u < K && c0 + rr < C
                              ? __ldcg(a.tbits +
                                       (int64_t)((k0 + u) * Cp + c0 + rr) *
                                           W + w0 + lane)
                              : 0u;
              }
            }
            const uint32_t qv =
                warp < gq && bs < B && in_words
                    ? __ldcg(a.qbits + (int64_t)bs * W + w0 + lane) : 0u;
#pragma unroll
            for (int s = 0; s < kSlabs; ++s)
#pragma unroll
              for (int j = 0; j < kSlabRows; ++j)
                ts[s][warp + j * kTileWarps][lane] = v[s][j];
            if (warp < gq) qs[warp][lane] = qv;
          }
          __syncthreads();
#pragma unroll
          for (int u = 0; u < kSlabs; ++u) {
            if (vf[u] > 0.0f) {
              const uint32_t* t_row = ts[gt * kr + u][lane];
              int d = 0;
#pragma unroll
              for (int w = 0; w < kSW; ++w) d += __popc(qs[qi][w] ^ t_row[w]);
              diff[u] += d;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kSlabs; ++u)
          if (vf[u] > 0.0f) best = fmaxf(best, (float)(N - diff[u]));
      }
      if (b < B) {
        if (c < C) a.per_class[(int64_t)b * C + c] = best;
        // a lane's classes arrive in increasing order (top_push's
        // precondition), also across the local design's groups
        if (!kRaw && c >= wlo && c < whi) acam::top_push(top, best, c);
      }
    }
    if (kRaw) continue;  // the counts are the output: no decision
    top = acam::top_warp_merge(top);  // exact in any lane order
    if (gc > 1) {  // merge the item's gc class tiles of each row
      if (lane == 0) warp_top[warp] = top;
      __syncthreads();
      if (gt == 0)
        for (int j = 1; j < gc; ++j)
          top = acam::top_merge(top, warp_top[warp + j]);
    }
    if (kLocal || groups == 1) {  // the item held every class of its rows
      if (gt == 0 && lane == 0 && b < B)
        acam::top_finish(top, (float)N, tau_b, b, a.pred, a.margin, a.esc);
      continue;
    }
    if (gt == 0 && lane == 0 && b < B) a.tops[(int64_t)b * groups + g0] = top;
    decide_last(a, qg, groups, b, gt == 0, &last);
  }
}

// Blocks of `kernel` (kTileWarps warps) that fit on device `dev` at once,
// cached per device in `cache`: the cap of a cooperative grid.
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
// `scratch` holding B * W query words, K * Cp * W template words,
// B * ceil(C / 32) acam::Top summaries (3 words each) and the arrival
// counters, in that order (raw mode: the bits alone; it never reaches the
// summaries or the counters).
template <typename Kernel>
int launch_cooperative(Kernel kernel, int* cache, TileArgs a,
                       uint32_t* scratch, int64_t want, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(kernel, dev, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  const int W = (a.N + 31) / 32, tiles = (a.C + kCT - 1) / kCT;
  a.qbits = scratch;
  a.tbits = a.qbits + (int64_t)a.B * W;
  a.tops = reinterpret_cast<acam::Top*>(a.tbits + (int64_t)a.K * a.Cp * W);
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
template <bool kServe, bool kRaw = false>
int launch_tiled(TileArgs a, uint32_t* scratch, cudaStream_t stream) {
  static int resident_of[64] = {};  // co-resident blocks per device
  if (a.Cp % kCT != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (a.C + kCT - 1) / kCT;
  const int gc = group_tiles(tiles), gq = group_rows(gc, !scratch);
  const int64_t q_groups = (a.B + gq - 1) / gq;
  if (!scratch) {
    tiled_kernel<kServe, true, kRaw><<<(int)q_groups, kTileWarps * 32, 0,
                                       stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int64_t want =
      max((int64_t)(a.B + a.K * a.Cp + kTileWarps - 1) / kTileWarps,
          (tiles + gc - 1) / gc * q_groups);
  return launch_cooperative(tiled_kernel<kServe, false, kRaw>, resident_of,
                            a, scratch, want, stream);
}

}  // namespace

// The C interface, one entry per TPU kernel face. Pointers are device
// pointers; `stream` is a cudaStream_t. Each returns cudaGetLastError() (or
// the launch's own error). `scratch` is laid out as launch_cooperative
// says, with ceil(B / 8) arrival counters for B2 and B for the other
// faces (none for acam_match); null picks the tiled kernel's local design.

extern "C" int acam_match(const float* f, const float* thr, const float* t,
                          int B, int N, int M, uint32_t* scratch, float* out,
                          void* stream) {
  TileArgs a{};
  a.f = f, a.thr = thr, a.t = t;
  a.B = B, a.N = N, a.K = 1, a.Cp = (M + kCT - 1) / kCT * kCT, a.C = M;
  a.per_class = out;
  return launch_tiled<false, true>(a, scratch, (cudaStream_t)stream);
}

extern "C" int acam_match_classify(const float* f, const float* thr,
                                   const float* t, const float* valid, int B,
                                   int N, int K, int Cp, int C,
                                   uint32_t* scratch, int* pred,
                                   float* per_class, void* stream) {
  TileArgs a{};
  a.f = f, a.thr = thr, a.t = t, a.valid = valid;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.pred = pred, a.per_class = per_class;
  return launch_tiled<false>(a, scratch, (cudaStream_t)stream);
}

extern "C" int acam_match_classify_margins(
    const float* f, const float* thr, const float* t, const float* valid,
    const int* lo, const int* hi, int B, int N, int K, int Cp, int C,
    uint32_t* scratch, int* pred, float* per_class, float* margin,
    void* stream) {
  TileArgs a{};
  a.f = f, a.thr = thr, a.t = t, a.valid = valid, a.lo = lo, a.hi = hi;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.pred = pred, a.per_class = per_class, a.margin = margin;
  return launch_tiled<false>(a, scratch, (cudaStream_t)stream);
}

extern "C" int acam_match_classify_margins_chunked(
    const float* f, const float* thr, const float* t, const float* valid,
    const int* lo, const int* hi, int B, int N, int K, int Cp, int C,
    int chunk, uint32_t* scratch, int* pred, float* per_class, float* margin,
    void* stream) {
  (void)chunk;
  static int resident_of[64] = {};  // co-resident blocks per device
  if (!scratch || Cp % kCT != 0) return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.f = f, a.thr = thr, a.t = t, a.valid = valid, a.lo = lo, a.hi = hi;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.pred = pred, a.per_class = per_class, a.margin = margin;
  const int tiles = (C + kCT - 1) / kCT, q_tiles = (B + kQT - 1) / kQT;
  const int64_t want = max((int64_t)(B + K * Cp + kTileWarps - 1) / kTileWarps,
                           (int64_t)tiles * q_tiles);
  return launch_cooperative(big_bank_kernel, resident_of, a, scratch, want,
                            (cudaStream_t)stream);
}

extern "C" int acam_match_serve(const float* f, const float* thr_table,
                                int thr_rows, const int* slot, const float* t,
                                const float* valid, const int* lo,
                                const int* hi, const float* tau, int B, int N,
                                int K, int Cp, int C, int chunk,
                                uint32_t* scratch, int* pred,
                                float* per_class, float* margin,
                                unsigned char* esc, void* stream) {
  (void)chunk;
  TileArgs a{};
  a.f = f, a.thr = thr_table, a.slot = slot, a.thr_rows = thr_rows;
  a.t = t, a.valid = valid, a.lo = lo, a.hi = hi, a.tau = tau;
  a.B = B, a.N = N, a.K = K, a.Cp = Cp, a.C = C;
  a.pred = pred, a.per_class = per_class, a.margin = margin, a.esc = esc;
  return launch_tiled<true>(a, scratch, (cudaStream_t)stream);
}
