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
// Every face is one launch. A warp counts one query row against a tile of
// 32 classes, one lane per class, N - sum_w popc(q_w ^ t_w) in int32 over
// bits staged in shared memory (acam_tiled.cuh's feature-count scorer,
// kCount). Templates binarise as t != 0.
//
//   big_bank_kernel  B2: one cooperative launch. The header's pack of the
//                    query rows and the valid template rows into row-major
//                    bit scratch (block 0 zeroes the arrival counters);
//                    grid sync; blocks walk (class tile, 8-query tile)
//                    items; the last class tile of a query tile to arrive
//                    (an atomic counter) merges its rows' summaries and
//                    writes pred and margin = min(top1 - top2, N).
//   tiled_kernel     B1, B3, B4 and B7a (acam_tiled.cuh): the local design
//                    for predict's small bank, the cooperative one for the
//                    ticks; kRaw (B7a) writes the raw (B, M) counts.
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
// dependent round trips: one launch per call, every load coalesced, each
// round's loads issued together, and no cross-block merge at these banks.
// What is left is the cooperative design's pack (two dependent rounds for
// the serve tick: slot, then its threshold row), grid sync, L2 staging and
// a count bound by popc (16 per clock per SM) on the serve and compose
// ticks' 32 blocks; the local design's binarising rounds on B1 and B7a. B2
// is bound by bytes: it reads its bank once, coalesced, with every SM busy
// in each phase. At these sizes a call is bound by its host cost: a second
// launch costs more host time than a grid sync costs device time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero, and the serve tick's (f - thr) > 0 must keep a subnormal difference.

#include "acam_tiled.cuh"

namespace {

// B2 (big_bank_kernel): items of kQT queries x one class tile, staged kKS
// K slices of kWC words a round
constexpr int kQT = kTileWarps;
constexpr int kKS = 4;
constexpr int kWC = 64;  // 2,048 features

// B2 in one cooperative launch (its count loop kept as its device time was
// measured, one L2 round trip per staged row): pack; grid sync; blocks walk
// the (class tile of kCT, query tile of kQT) items, stage the tile's bits (up to kKS K slices of kWC
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

  pack_rows<kCount, 16, false>(a, q_tiles);
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
    decide_last(a, qt, tiles, b, true, (float)N, &last);
  }
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
  return launch_tiled<kCount, false, true>(a, scratch, (cudaStream_t)stream);
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
  return launch_tiled<kCount, false>(a, scratch, (cudaStream_t)stream);
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
  return launch_tiled<kCount, false>(a, scratch, (cudaStream_t)stream);
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
  return launch_cooperative<kCount>(big_bank_kernel, resident_of, a, scratch,
                                    want, (cudaStream_t)stream);
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
  return launch_tiled<kCount, true>(a, scratch, (cudaStream_t)stream);
}
