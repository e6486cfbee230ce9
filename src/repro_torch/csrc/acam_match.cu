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
// B1, B3, B4 and B7a share one design (one C entry each):
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
//   counts_kernel  the raw (B, M) counts of B7a: one warp per query row,
//                  lanes over template rows, N - sum_w popc(q_w ^ t_w)
//                  written as f32. No mask, no max, no WTA.
//
// B2, the big-bank face, is one cooperative launch of its own kernel
// (big_bank_kernel, the tiled design), on a grid of co-resident blocks:
//
//   pack           one warp per row: lane j reads feature 32 w + j, a
//                  coalesced 128-byte load per word (32 words in flight per
//                  lane), and __ballot_sync forms word w. Queries and
//                  templates land row-major ((B, W) and (K * Cp, W));
//                  padded class rows and invalid rows are neither read nor
//                  written. Then the grid synchronises.
//   count          blocks walk (class tile of kCT = 32) x (query tile of
//                  kQT = 8) items: an item stages its tile's bits (up to 4
//                  K slices at once) in shared memory, one thread per
//                  (query, class) counts N - sum popc(q ^ t), takes the max
//                  over K (invalid rows -inf) and writes per_class, and each
//                  warp (one query, the tile's 32 classes) reduces its
//                  window's classes to one acam::Top in scratch.
//   decide         the last item of a query tile to arrive (an atomic
//                  counter, zeroed in the pack phase) merges each row's
//                  tile summaries (top_merge is exact in any order) and
//                  writes pred and margin = min(top1 - top2, N).
//
// Precondition: templates are {0, 1}. Every producer binarises them; the
// TPU kernels' bipolar bf16 product equals the count only under it, and
// here any non-zero entry reads as bit 1.
//
// The windowed (top1, argmax, runner-up) epilogue is shared with the
// similarity kernels (acam_epilogue.cuh, which states the semantics kept
// exactly); here the margin is clamped at cap = N.
//
// `chunk` (B2, B3) is accepted for signature parity with the TPU kernels,
// whose VMEM budget walked the bank in class chunks. Outputs never depend
// on it: B3 holds no bank in shared memory, and B2's class tiles are its
// own (kCT), merged exactly.
//
// Bound on this card. At the serving tick (64 slots, N = 784, 128 classes,
// K = 2) the call must move about 1.06 MB (f32 features, f32 {0,1}
// templates, the thresholds table, per-class scores out): about 0.32 us at
// 3.35 TB/s, far below the fixed cost of a launch. B1/B3/B4 make two
// launches and read the f32 templates once (pack) and their 32x smaller
// bits once per query row (select, from L2). B7a at B = 256, M = 10,
// N = 784 moves about 0.84 MB: about 0.25 us, again far below a launch.
//
// B2 at B = 64, C = 1,100, K = 2, N = 784 must move 7.4 MB, almost all of
// it the f32 bank: 2.2 us at 3.35 TB/s, while its 2 B K C N bit operations
// take 0.11 us at 1,979 TOP/s, so it is bound by bytes. B1-B4's design
// (one warp walking every class of a row: 16 blocks for 132 SMs and
// ~1,750 dependent loads per lane; a pack with 32 cache lines per warp
// load) is latency bound there, two orders above the bound. The tiled
// design reads the bank once,
// coalesced, with every SM busy in each phase (296 blocks, 280 count
// items), and its count is a few hundred shared-memory popcounts per
// thread. It is one launch because at this size the call is bound by its
// host cost: a second launch costs more host time than the grid sync
// costs device time.
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

  acam::Top top = acam::top_empty();
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
    // a lane's classes arrive in increasing order (top_push's precondition)
    if (c >= wlo && c < whi) acam::top_push(top, best, c);
  }
  top = acam::top_warp_merge(top);
  if (lane == 0) acam::top_finish(top, (float)N, tau, b, pred, margin, esc);
}

__global__ void counts_kernel(const uint32_t* __restrict__ qbits,
                              const uint32_t* __restrict__ tbits, int B,
                              int N, int M, int W, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSelectWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const uint32_t* q = qbits + (int64_t)b * W;
  for (int r = lane; r < M; r += 32) {
    int diff = 0;
    for (int w = 0; w < W; ++w) diff += __popc(q[w] ^ tbits[(int64_t)w * M + r]);
    out[(int64_t)b * M + r] = (float)(N - diff);
  }
}

// ---- B2: the tiled big-bank design ---------------------------------------

constexpr int kB2Warps = 8;  // warps per block; a tile's query rows
constexpr int kQT = kB2Warps;
constexpr int kCT = 32;  // classes per tile (one per lane)
constexpr int kKS = 4;   // K slices staged per round
constexpr int kWC = 64;  // words staged per round (2,048 features)

// Words [w0, w0 + kU) of one row, one warp: lane j reads feature
// 32 w + j, so each word is one coalesced 128-byte warp load, and the
// ballot is the word; lane u keeps word w0 + u. Bits past N stay 0.
template <int kU, bool kQuery>
__device__ __forceinline__ uint32_t pack_words(const float* __restrict__ src,
                                               const float* __restrict__ thr,
                                               int w0, int N, int lane) {
  float x[kU], th[kQuery ? kU : 1];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = (w0 + u) * 32 + lane;
    x[u] = i < N ? src[i] : 0.0f;
    if (kQuery) th[u] = i < N ? thr[i] : 0.0f;
  }
  uint32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = (w0 + u) * 32 + lane;
    const bool bit = i < N && (kQuery ? x[u] > th[kQuery ? u : 0]
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

// B2 in one cooperative launch, a grid of co-resident blocks in three
// phases:
//  1. pack: one warp per row (grid-stride) binarises the B query rows
//     (f > thr) and the valid template rows (t != 0) into row-major bit
//     words; padded class rows and invalid rows are skipped. Block 0 zeroes
//     the arrival counters. Then the grid synchronises.
//  2. count: blocks walk the (class tile of kCT, query tile of kQT) items;
//     an item stages its tile's bits in shared memory (up to kKS K slices
//     of kWC words a round), one thread per (query, class) counts
//     N - sum popc(q ^ t), takes the max over K (invalid rows -inf) and
//     writes per_class, and each warp reduces its window's classes to one
//     acam::Top in `tops`.
//  3. decide: the last item of a query tile to arrive (an atomic counter)
//     merges each of its rows' tile summaries (exact in any order) and
//     writes pred and margin = min(top1 - top2, N).
// The bit words are read through L2 (__ldcg): other SMs wrote them.
__global__ void __launch_bounds__(kB2Warps * 32)
    big_bank_kernel(const float* __restrict__ f,
                    const float* __restrict__ thr,
                    const float* __restrict__ t,
                    const float* __restrict__ valid,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    int B, int N, int K, int Cp, int C, uint32_t* qbits,
                    uint32_t* tbits, acam::Top* tops, unsigned* arrivals,
                    int* __restrict__ pred, float* __restrict__ per_class,
                    float* __restrict__ margin) {
  // rows padded to kWC + 1 words: lane c reads ts[.][c][w], conflict-free
  __shared__ uint32_t ts[kKS][kCT][kWC + 1];
  __shared__ uint32_t qs[kQT][kWC + 1];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = (N + 31) / 32, R = K * Cp;
  const int tiles = (C + kCT - 1) / kCT, q_tiles = (B + kQT - 1) / kQT;

  // 1. pack
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < q_tiles; i += blockDim.x) arrivals[i] = 0;
  for (int row = blockIdx.x * kB2Warps + warp; row < B + R;
       row += gridDim.x * kB2Warps) {
    if (row < B) {
      const float* src = f + (int64_t)row * N;
      for (int w0 = 0; w0 < W; w0 += 16) {
        const uint32_t mine = pack_words<16, true>(src, thr, w0, N, lane);
        if (lane < 16 && w0 + lane < W) qbits[(int64_t)row * W + w0 + lane] = mine;
      }
    } else {
      const int r = row - B;
      if (r % Cp >= C || !(valid[r] > 0.0f)) continue;  // never counted
      const float* src = t + (int64_t)r * N;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const uint32_t mine = pack_words<32, false>(src, nullptr, w0, N, lane);
        if (w0 + lane < W) tbits[(int64_t)r * W + w0 + lane] = mine;
      }
    }
  }
  cooperative_groups::this_grid().sync();

  // 2. count, and 3. decide
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
        vf[u] = u < kn && c < C ? valid[(k0 + u) * Cp + c] : 0.0f;
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
                  tbits + (int64_t)((k0 + u) * Cp + c0 + rr) * W + w0 + w);
        for (int w = lane; w < wn; w += 32)
          qs[warp][w] = b < B ? __ldcg(qbits + (int64_t)b * W + w0 + w) : 0u;
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
      if (c < C) per_class[(int64_t)b * C + c] = best;
      const int wlo = max(lo[b], 0), whi = min(hi[b], C);
      if (c >= wlo && c < whi) acam::top_push(top, best, c);
    }
    top = acam::top_warp_merge(top);  // exact in any lane order
    if (lane == 0 && b < B) tops[(int64_t)b * tiles + item % tiles] = top;

    // the last class tile of this query tile to arrive decides its rows
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&arrivals[qt], 1u) == (unsigned)tiles - 1;
    __syncthreads();
    if (last && b < B) {
      __threadfence();
      top = acam::top_empty();
      for (int i = lane; i < tiles; i += 32)
        top = acam::top_merge(top, load_top(tops + (int64_t)b * tiles + i));
      top = acam::top_warp_merge(top);
      if (lane == 0) acam::top_finish(top, (float)N, nullptr, b, pred,
                                      margin, nullptr);
    }
  }
}

// Pack B query rows and R template rows (padded classes: r % Cp >= C).
int pack(const float* f, const float* thr, const int* slot, int thr_rows,
         const float* t, int B, int N, int R, int Cp, int C, uint32_t* qbits,
         uint32_t* tbits, cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const int64_t words = (int64_t)(B + R) * W;
  const int pack_blocks = (int)((words + kPackThreads - 1) / kPackThreads);
  if (slot) {
    pack_kernel<true><<<pack_blocks, kPackThreads, 0, stream>>>(
        f, thr, slot, thr_rows, t, B, N, R, Cp, C, W, qbits, tbits);
  } else {
    pack_kernel<false><<<pack_blocks, kPackThreads, 0, stream>>>(
        f, thr, nullptr, 0, t, B, N, R, Cp, C, W, qbits, tbits);
  }
  return (int)cudaGetLastError();
}

int launch(const float* f, const float* thr, const int* slot, int thr_rows,
           const float* t, const float* valid, const int* lo, const int* hi,
           const float* tau, int B, int N, int K, int Cp, int C,
           uint32_t* qbits, uint32_t* tbits, int* pred, float* per_class,
           float* margin, unsigned char* esc, cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const int err = pack(f, thr, slot, thr_rows, t, B, N, K * Cp, Cp, C, qbits,
                       tbits, stream);
  if (err != 0) return err;
  const int select_blocks = (B + kSelectWarps - 1) / kSelectWarps;
  select_kernel<<<select_blocks, kSelectWarps * 32, 0, stream>>>(
      qbits, tbits, valid, lo, hi, tau, B, N, K, Cp, C, W, pred, per_class,
      margin, esc);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, one entry per TPU kernel face. Pointers are device
// pointers; `stream` is a cudaStream_t. Each returns cudaGetLastError().
// qbits holds B * ceil(N/32) words, tbits K * Cp * ceil(N/32) words (M *
// ceil(N/32) for acam_match).

extern "C" int acam_match(const float* f, const float* thr, const float* t,
                          int B, int N, int M, uint32_t* qbits,
                          uint32_t* tbits, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = pack(f, thr, nullptr, 0, t, B, N, M, M, M, qbits, tbits, s);
  if (err != 0) return err;
  const int blocks = (B + kSelectWarps - 1) / kSelectWarps;
  counts_kernel<<<blocks, kSelectWarps * 32, 0, s>>>(qbits, tbits, B, N, M,
                                                     (N + 31) / 32, out);
  return (int)cudaGetLastError();
}

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

// B2: `scratch` holds B * W query words, K * Cp * W template words,
// B * ceil(C / 32) acam::Top summaries (3 words each) and ceil(B / 8)
// arrival counters, in that order. One cooperative launch of at most the
// blocks that fit on the card at once.
extern "C" int acam_match_classify_margins_chunked(
    const float* f, const float* thr, const float* t, const float* valid,
    const int* lo, const int* hi, int B, int N, int K, int Cp, int C,
    int chunk, uint32_t* scratch, int* pred, float* per_class, float* margin,
    void* stream) {
  (void)chunk;
  static int resident_of[64] = {};  // co-resident blocks per device
  if (Cp % kCT != 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < 64 ? resident_of[dev] : 0;
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, big_bank_kernel, kB2Warps * 32, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    resident = per_sm * sms;
    if (dev < 64) resident_of[dev] = resident;
  }
  const int W = (N + 31) / 32, R = K * Cp;
  const int tiles = (C + kCT - 1) / kCT, q_tiles = (B + kQT - 1) / kQT;
  uint32_t* qbits = scratch;
  uint32_t* tbits = qbits + (int64_t)B * W;
  acam::Top* tops = reinterpret_cast<acam::Top*>(tbits + (int64_t)R * W);
  unsigned* arrivals =
      reinterpret_cast<unsigned*>(tops + (int64_t)B * tiles);
  const int64_t want =
      max((int64_t)(B + R + kB2Warps - 1) / kB2Warps,
          (int64_t)tiles * q_tiles);
  const int grid = (int)min(want, (int64_t)resident);
  void* args[] = {&f,  &thr,   &t,     &valid, &lo,   &hi,       &B,
                  &N,  &K,     &Cp,    &C,     &qbits, &tbits,   &tops,
                  &arrivals,   &pred,  &per_class,     &margin};
  err = cudaLaunchCooperativeKernel((const void*)big_bank_kernel, grid,
                                    kB2Warps * 32, args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
