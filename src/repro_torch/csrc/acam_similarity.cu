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
//                 on one row at a time with coalesced loads, lane j over
//                 features 32 w + j and a shuffle tree over the lanes.
//                 B5 takes the local
//                 design at predict's 10 classes, B6 the cooperative one
//                 (the tick's 128 classes, the 1,100-class big bank, whose
//                 35 tiles merge through arrival counters).
//   sim_tile_kernel  B7b: raw (unbinarised) queries, register-tiled FP32.
//                 A block owns a tile of query rows x template rows and
//                 walks N in slices of kCW features: each slice's query,
//                 lower and upper rows are staged in shared memory by
//                 cp.async (16-byte copies where N % 4 == 0 and the bases
//                 are aligned, else 4-byte ones; rows past B or M not
//                 copied) in a ring of kStages slices, so the next slices
//                 load while one computes. The block's warps split each
//                 slice's features into groups, each skipping the quads
//                 past N; a thread keeps a kTQ x kTR micro-tile of (query,
//                 row) accumulators, D in f32 and H in int32, and reads its
//                 operands from shared memory as float4 (rows tx + kTX k
//                 and queries ty + kTY i: each 8-thread phase of a 128-bit
//                 load reads distinct bank quads or broadcasts). At
//                 the end the groups' partial D and H fold in group order
//                 (deterministic), H loses the zeros that fill the last
//                 quad past N (each a hit), and Eq. 11 is applied once per
//                 cell.
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
// feature) cell, so it is bound by operations: its micro-tiles keep those
// instructions fed from registers (a 4 x 2 tile reads 8 float4 per 4
// features for 32 cells), and its tiles are sized so that the main shapes
// fill the card: 8 queries x 16 rows where that gives two blocks an SM
// (1,104 blocks on the 64 x 2,200 big bank), else 2 x 12 (128 blocks at
// ACAMHead.scores' 256 x 10).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. No --use_fast_math: it flushes subnormals to
// zero (the serve tick's (f - thr) > 0 must keep a subnormal difference),
// and it would allow contracted and approximate arithmetic. Eq. 9's max(x,
// 0) keeps a NaN (relu_nan, acam_tiled.cuh), as torch.clamp and jnp.maximum
// do: a NaN bound or query gives a NaN score in every kernel here.

#include "acam_tiled.cuh"
#include "cp_async.cuh"

namespace {

// h += (x >= l) & (x <= u): two compares and one predicated add (false for
// a NaN), where the C form compiles to a select and an add.
__device__ __forceinline__ void count_hit(int& h, float x, float l, float u) {
  asm("{\n .reg .pred p;\n"
      " setp.le.f32 p, %1, %3;\n"
      " setp.ge.and.f32 p, %1, %2, p;\n"
      " @p add.s32 %0, %0, 1;\n}"
      : "+r"(h)
      : "f"(x), "f"(l), "f"(u));
}

// A tiling of B7b: kTQ x kTR (query, row) cells a thread, kTX x kTY
// threads a group (rows tx + kTX k, queries ty + kTY i), the block's
// kThreads in kGroups groups that split each slice of kCW features; kStages
// slices in flight. An 8-thread phase of a 128-bit shared load lies in one
// group (kTX kTY a multiple of 8) and reads distinct bank quads or one
// address per row: the row stride kS / 4 quads is odd.
template <int TQ, int TR, int TX, int TY, int CW, int STAGES,
          int MIN_BLOCKS>
struct SimTile {
  static constexpr int kTQ = TQ, kTR = TR, kTX = TX, kTY = TY, kCW = CW;
  static constexpr int kStages = STAGES, kMinBlocks = MIN_BLOCKS;
  static constexpr int kThreads = 256;
  static constexpr int kGroup = kTX * kTY;
  static constexpr int kGroups = kThreads / kGroup;
  static constexpr int kBQ = kTY * kTQ, kBR = kTX * kTR;  // block tile
  static constexpr int kRows = kBQ + 2 * kBR;  // staged: q, lower, upper
  static constexpr int kS = kCW + 4;  // row stride in floats
  static constexpr int kGW = kCW / kGroups;  // a group's features a slice
  static_assert(kGW % 4 == 0 && (kS / 4) % 2 == 1 && kGroup % 8 == 0,
                "conflict-free float4 reads");
  static_assert(kGroups * kBQ * kBR * 2 <= kStages * kRows * kS,
                "the fold fits the staging");
};
// 2 x 12 tiles, 1 x 3 cells a thread (4 row threads x 2 query threads a
// group), 32 groups over a 3-slice ring of 128 features: small banks
// (ACAMHead.scores' 10 classes: 2 of the 12 rows idle, against 6 of 16 for
// 8 row threads), where blocks are few and each slice's work small
using NarrowTile = SimTile<1, 3, 4, 2, 128, 3, 2>;
// 8 x 16 tiles, 4 x 2 cells a thread, three blocks an SM: grids of at
// least two blocks an SM (the big bank's 64 x 2,200: 1,104 blocks). On the
// H100 these ran fastest of the tilings tried (PERF.md §6).
using WideTile = SimTile<4, 2, 8, 2, 64, 2, 3>;

// The staging of a block's slices: thread t copies the quads t, t + 256,
// ... of the kRows x kCW / 4 quads of a slice, the same (row, quad) in every
// slice, so each keeps its row's base pointer and whether the row exists
// (queries b0.., then lower and upper rows r0..). Rows past B or M and
// quads past N are not copied: their cells are never written, and the
// compute skips quads past N. A quad that straddles N (4-byte copies) is
// zero-filled past it.
template <class T>
struct Stager {
  static constexpr int kQuads = T::kCW / 4;
  static constexpr int kItems =
      (T::kRows * kQuads + T::kThreads - 1) / T::kThreads;
  const float* src[kItems];  // the row's first feature
  int dst[kItems];           // row * kS + 4 quad, or -1 (no such item)
  int col[kItems];           // 4 quad
  bool live[kItems];         // the row exists

  __device__ __forceinline__ Stager(const float* __restrict__ q,
                                    const float* __restrict__ lower,
                                    const float* __restrict__ upper, int B,
                                    int M, int N, int b0, int r0) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * T::kThreads;
      const int row = i / kQuads;
      col[k] = (i % kQuads) * 4;
      dst[k] = i < T::kRows * kQuads ? row * T::kS + col[k] : -1;
      if (row < T::kBQ) {
        live[k] = b0 + row < B;
        src[k] = q + (int64_t)(live[k] ? b0 + row : 0) * N;
      } else {
        const int r = r0 + (row - T::kBQ) % T::kBR;
        live[k] = r < M;
        src[k] = (row < T::kBQ + T::kBR ? lower : upper) +
                 (int64_t)(live[k] ? r : 0) * N;
      }
    }
  }

  // Slice `sl` (features [sl kCW, sl kCW + kCW)) into stage `buf`, one
  // commit group.
  __device__ __forceinline__ void issue(float* buf, int sl, int N,
                                        bool vec) const {
    const int c0 = sl * T::kCW;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = c0 + col[k];
      if (dst[k] < 0 || !live[k] || c >= N) continue;
      if (vec) {
        cp_async16(buf + dst[k], src[k] + c, true);  // whole: N % 4 == 0
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = c + e < N;
          cp_async4(buf + dst[k] + e, in ? src[k] + c + e : src[k], in);
        }
      }
    }
    cp_async_commit();
  }
};

// B7b: the (B, M) Eq. 9-11 scores of raw queries (see the head of this
// file). Block i owns query tile i / row_tiles and row tile i % row_tiles.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    sim_tile_kernel(const float* __restrict__ q,
                    const float* __restrict__ lower,
                    const float* __restrict__ upper, int B, int M, int N,
                    float alpha, float inv_n, float* __restrict__ scores) {
  __shared__ __align__(16) float st[T::kStages][T::kRows][T::kS];
  const int tid = threadIdx.x;
  const int g = tid / T::kGroup, tx = tid % T::kTX,
            ty = tid % T::kGroup / T::kTX;
  const int row_tiles = (M + T::kBR - 1) / T::kBR;
  const int b0 = blockIdx.x / row_tiles * T::kBQ;
  const int r0 = blockIdx.x % row_tiles * T::kBR;
  const int slices = (N + T::kCW - 1) / T::kCW;
  const bool vec =
      (N & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(lower) |
        reinterpret_cast<uintptr_t>(upper)) & 15) == 0;

  const Stager<T> stager(q, lower, upper, B, M, N, b0, r0);
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < slices)
      stager.issue(&st[s][0][0], s, N, vec);
    else
      cp_async_commit();
  }
  float d[T::kTQ][T::kTR];
  int h[T::kTQ][T::kTR];
#pragma unroll
  for (int i = 0; i < T::kTQ; ++i)
#pragma unroll
    for (int k = 0; k < T::kTR; ++k) d[i][k] = 0.0f, h[i][k] = 0;

  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // slice sl landed; slice sl - 1 is consumed
    const int next = sl + T::kStages - 1;
    if (next < slices)
      stager.issue(&st[next % T::kStages][0][0], next, N, vec);
    else
      cp_async_commit();
    const float(*buf)[T::kS] = st[sl % T::kStages];
#pragma unroll
    for (int jj = 0; jj < T::kGW; jj += 4) {
      const int j = g * T::kGW + jj;
      if (sl * T::kCW + j >= N) break;  // past N: the group skips the quad
      float4 x[T::kTQ], l[T::kTR], u[T::kTR];
#pragma unroll
      for (int i = 0; i < T::kTQ; ++i)
        x[i] = *reinterpret_cast<const float4*>(&buf[ty + i * T::kTY][j]);
#pragma unroll
      for (int k = 0; k < T::kTR; ++k) {
        const int rr = tx + k * T::kTX;
        l[k] = *reinterpret_cast<const float4*>(&buf[T::kBQ + rr][j]);
        u[k] = *reinterpret_cast<const float4*>(
            &buf[T::kBQ + T::kBR + rr][j]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < T::kTQ; ++i)
#pragma unroll
          for (int k = 0; k < T::kTR; ++k) {
            const float xv = (&x[i].x)[e], lv = (&l[k].x)[e],
                        uv = (&u[k].x)[e];
            const float above = relu_nan(__fsub_rn(xv, uv));
            const float below = relu_nan(__fsub_rn(lv, xv));
            d[i][k] = __fadd_rn(d[i][k], __fadd_rn(__fmul_rn(above, above),
                                                   __fmul_rn(below, below)));
            count_hit(h[i][k], xv, lv, uv);
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every slice consumed: the staging becomes the fold

  constexpr int kCells = T::kBQ * T::kBR;
  float* fold_d = &st[0][0][0];
  int* fold_h = reinterpret_cast<int*>(fold_d + T::kGroups * kCells);
#pragma unroll
  for (int i = 0; i < T::kTQ; ++i)
#pragma unroll
    for (int k = 0; k < T::kTR; ++k) {
      const int cell = (ty + i * T::kTY) * T::kBR + tx + k * T::kTX;
      fold_d[g * kCells + cell] = d[i][k];
      fold_h[g * kCells + cell] = h[i][k];
    }
  __syncthreads();
  const int pad = (4 - N % 4) % 4;  // zeros in the last quad: hits
  for (int cell = tid; cell < kCells; cell += T::kThreads) {
    const int b = b0 + cell / T::kBR, r = r0 + cell % T::kBR;
    if (b >= B || r >= M) continue;
    float dist = fold_d[cell];
    int hits = fold_h[cell] - pad;
    for (int gg = 1; gg < T::kGroups; ++gg) {
      dist = __fadd_rn(dist, fold_d[gg * kCells + cell]);
      hits += fold_h[gg * kCells + cell];
    }
    scores[(int64_t)b * M + r] = __fdiv_rn(__fmul_rn((float)hits, inv_n),
                                           __fmaf_rn(alpha, dist, 1.0f));
  }
}

template <class T>
int launch_sim_tiles(const float* q, const float* lower, const float* upper,
                     int B, int M, int N, float alpha, float inv_n,
                     float* scores, cudaStream_t stream) {
  const int64_t blocks = (int64_t)((B + T::kBQ - 1) / T::kBQ) *
                         ((M + T::kBR - 1) / T::kBR);
  sim_tile_kernel<T><<<(unsigned)blocks, T::kThreads, 0, stream>>>(
      q, lower, upper, B, M, N, alpha, inv_n, scores);
  return (int)cudaGetLastError();
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
  static int sms_of[64] = {};  // SMs per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !sms_of[dev])) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms_of[dev] = sms;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t wide = (int64_t)((B + WideTile::kBQ - 1) / WideTile::kBQ) *
                       ((M + WideTile::kBR - 1) / WideTile::kBR);
  const cudaStream_t s = (cudaStream_t)stream;
  return wide >= 2 * (dev < 64 ? sms_of[dev] : 132)
             ? launch_sim_tiles<WideTile>(q, lower, upper, B, M, N, alpha,
                                          inv_n, scores, s)
             : launch_sim_tiles<NarrowTile>(q, lower, upper, B, M, N, alpha,
                                            inv_n, scores, s);
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
