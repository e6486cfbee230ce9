// Flash attention forward for Hopper (sm_90a): softmax(q k^T * d^-0.5) v
// with an online softmax, an optional causal mask and grouped-query heads.
// Replaces the Pallas TPU kernel `flash_attention` (_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py (B9).
//
// Layouts: q and o (B, Sq, H, D), k and v (B, Sk, KV, D), contiguous, one
// dtype (f32, bf16 or f16). Query head h reads kv head h / (H / KV), so
// grouped-query attention needs no repeated copy of k and v. The TPU
// kernel's (BH, S, D) face is the same call with H = KV = 1.
//
// Bound on this card: operations. QK^T and P.V take 4 * D flops per live
// (query, key) pair: at (1, 1024, 8 heads, 2 kv heads, 64) bf16 causal
// about 1.07 GFLOP, 1.1 us at the 989 TFLOP/s bf16 tensor rate, against
// about 2.5 MB of bytes (0.75 us at 3.35 TB/s); at (1, 4096, 16, 8, 128)
// 68.7 GFLOP, 69.5 us. Only the tensor cores come near that rate.
//
// bf16 and f16: flash_mma_kernel, on the tensor cores. One block per
// (batch * head, tile of 64 query rows), four row warps of 16 query rows.
// Q, K and V stay in their own dtype in shared memory (rows padded by 16
// bytes, so the eight rows an ldmatrix reads fall in distinct banks). K/V
// tiles of 64 keys sit in a 2-stage ring filled by cp.async: tile j + 1
// loads while tile j computes. S = Q K^T and O += P V run as
// mma.sync.m16n8k16 with f32 accumulation, fragments loaded by ldmatrix
// (.trans for V). S stays in registers; each row's max and sum reduce over
// the four lanes of its quad, not the whole warp. p is rounded to the input
// dtype in registers and becomes the A operand of P V: that is the TPU
// kernel's p.astype(v.dtype); l sums the f32 p. p = 2^((s - m) log2 e) on
// the SFU (a few ulps of f32 from expf). Causal key tiles wholly above the
// diagonal are skipped, a warp skips the keys wholly above its own rows,
// the mask is applied only where the keys cross the diagonal or the end of
// the keys, and the grid launches the heaviest (last) query tiles first to
// even out the causal wave. A grid of fewer than two blocks per SM (the
// bench shape: 128 blocks) gives each row warp a twin that takes the other
// half of every tile's keys; the two merge (m, l, O) once at the end, so
// each SM runs 8 warps instead of 4.
// Why mma.sync and not wgmma: the FA2-style fragment layout needs no
// shared-memory descriptors or swizzle modes, which could only be
// debugged on the card; it reaches the targets (bench shape under 30 us,
// (1, 4096, 16, 8, 128) under 0.35 ms). wgmma with TMA-fed K/V, which
// reads B from shared memory without the ldmatrix traffic, is the next
// step toward the bound.
//
// f32: flash_fwd_f32_kernel, FP32 FMAs from shared memory (tensor cores
// would compute f32 in TF32, outside the 2e-3 tolerance the JAX package
// holds f32 to). One block per (query tile of
// kBQ = 64 rows, batch * head), eight warps; Q, K (row stride D + 1) and V
// staged as f32; a lane scores keys `lane` and `lane + 32` for four rows at
// a time, and the warp updates each row's m and l with shuffles.
//
// Numerics kept from the TPU kernel on both routes: the scale d^-0.5 is
// applied to the f32 dot product; padded and causally hidden keys get the
// finite mask -1e30 (with -inf, a tile row with no live key would give
// exp(-inf + inf) = NaN); m starts at -1e30 and l at 0; p feeds l in f32
// and P.V rounded to v's dtype; l is clamped at 1e-30; the output is in
// q's dtype.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf stays accurate).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16 / f16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kKeyTile = 64;  // keys per K/V tile

// D += A B for one m16n8k16 tile (A 16x16 row-major, B 16x8 col-major, f32
// accumulators), and two f32 values rounded into one register of T pairs
// (the lower column in the low half, as the fragments hold them).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// Four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i holds each lane's pair of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way (V as the col-major B).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Rows [row0, row0 + ROWS) of a (S, stride) operand into a tile of row
// stride D + 8; rows past S are zero-filled (a NaN in a stale row would
// survive p = 0 in P V).
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int S, int64_t stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    const bool in = row < S;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (int64_t)(in ? row : 0) * stride + c * 8, in);
  }
}

template <typename T, int D, int ROWW>
constexpr size_t mma_smem_bytes() {
  return (size_t)(16 * ROWW + 4 * kKeyTile) * (D + 8) * sizeof(T);
}

// p = exp(x - m) as 2^((x - m) log2 e): one rounding more than expf, a
// few ulps of f32, far inside the tolerance of a 16-bit output.
__device__ __forceinline__ float exp_(float x) {
  return exp2f(__fmul_rn(x, 1.4426950408889634f));
}

// ROWW warps of 16 query rows each, times KSPLIT warps that split every
// K/V tile's 64 keys between them (KSPLIT 2 gives a small grid twice the
// warps per SM; the halves merge their (m, l, O) once at the end).
template <typename T, int D, int ROWW, int KSPLIT>
__global__ void __launch_bounds__(ROWW * KSPLIT * 32)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int causal, float scale) {
  constexpr int BQ = 16 * ROWW, BK = kKeyTile, LD = D + 8;
  constexpr int THREADS = ROWW * KSPLIT * 32;
  constexpr int KW = BK / KSPLIT;  // keys a warp takes of each tile
  constexpr int KT = D / 16;       // k-steps of Q K^T
  constexpr int NS = KW / 8;       // n-tiles of S (8 keys each)
  constexpr int ND = D / 8;        // n-tiles of O (8 columns each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // BQ x LD
  T* Ks = Qs + BQ * LD;                    // 2 stages x BK x LD
  T* Vs = Ks + 2 * BK * LD;                // 2 stages x BK x LD

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % ROWW, koff = (warp / ROWW) * KW;
  const int g = lane >> 2, tig = lane & 3;  // fragment row, column pair
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const T* qg = q + (int64_t)b * Sq * q_stride + (int64_t)h * D;
  const T* kg = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  const T* vg = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;

  const int tiles = (Sk + BK - 1) / BK;
  const int n_tiles = causal ? min(tiles, (q0 + BQ - 1) / BK + 1) : tiles;
  const int wrow = q0 + rw * 16;               // this warp's first row
  const int row0 = wrow + g, row1 = row0 + 8;  // this lane's two rows

  load_tile<T, D, BQ, THREADS>(Qs, qg, q0, Sq, q_stride);
  load_tile<T, D, BK, THREADS>(Ks, kg, 0, Sk, kv_stride);
  load_tile<T, D, BK, THREADS>(Vs, vg, 0, Sk, kv_stride);
  cp_async_commit();

  uint32_t qa[KT][4];
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // tile j + 1 loads while tile j computes
      load_tile<T, D, BK, THREADS>(Ks + (st ^ 1) * BK * LD, kg, (j + 1) * BK,
                                   Sk, kv_stride);
      load_tile<T, D, BK, THREADS>(Vs + (st ^ 1) * BK * LD, vg, (j + 1) * BK,
                                   Sk, kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldsm_x4(qa[kt], Qs + (rw * 16 + (lane & 15)) * LD + kt * 16 +
                            (lane >> 4) * 8);
    }
    // this warp's keys [kb, kb + KW) of the tile; none live: nothing to do
    const int kb = j * BK + koff;
    if (kb < Sk && !(causal && kb > wrow + 15)) {
      const T* Kt = Ks + (st * BK + koff) * LD;
      const T* Vt = Vs + (st * BK + koff) * LD;

      // S = Q K^T: lanes 8i .. 8i + 7 address matrix i = (keys +8 (i / 2),
      // d +8 (i % 2)), giving b0/b1 of two neighbouring 8-key tiles
      float s[NS][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                         kt * 16 + ((lane >> 3) & 1) * 8);
          Mma<T>::run(s[2 * np], qa[kt], r[0], r[1]);
          Mma<T>::run(s[2 * np + 1], qa[kt], r[2], r[3]);
        }
      }

      // scale, mask (only where the keys cross this warp's diagonal or the
      // end of the keys), and the online softmax over each row's quad
      const bool edge = kb + KW > Sk || (causal && kb + KW - 1 > wrow);
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[nt][e] * scale, x1 = s[nt][2 + e] * scale;
          if (edge) {
            const int key = kb + nt * 8 + 2 * tig + e;
            if (key >= Sk || (causal && key > row0)) x0 = kNeg;
            if (key >= Sk || (causal && key > row1)) x1 = kNeg;
          }
          s[nt][e] = x0;
          s[nt][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kAll, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kAll, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kAll, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kAll, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp_(m0 - mn0), c1 = exp_(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p: f32 into l, rounded to T as the A operand of P V (A's k16 chunk
      // kk is S's 8-key tiles 2 kk and 2 kk + 1)
      uint32_t pa[NS / 2][4];
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float p00 = exp_(s[nt][0] - mn0), p01 = exp_(s[nt][1] - mn0);
        const float p10 = exp_(s[nt][2] - mn1), p11 = exp_(s[nt][3] - mn1);
        ps0 += p00 + p01;
        ps1 += p10 + p11;
        pa[nt >> 1][(nt & 1) * 2] = Mma<T>::pack(p00, p01);
        pa[nt >> 1][(nt & 1) * 2 + 1] = Mma<T>::pack(p10, p11);
      }
      l0 = l0 * c0 + ps0;  // this lane's columns; the quad sums at the end
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= c0;
        acc[i][1] *= c0;
        acc[i][2] *= c1;
        acc[i][3] *= c1;
      }

      // O += P V: matrix i = (keys +8 (i % 2), d +8 (i / 2)), transposed
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                LD +
                           dp * 16 + (lane >> 4) * 8);
          Mma<T>::run(acc[2 * dp], pa[kk], r[0], r[1]);
          Mma<T>::run(acc[2 * dp + 1], pa[kk], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before tile j + 2 refills it
  }

  if (KSPLIT == 2) {
    // the second key half hands (m, l, O) to the first through the K/V
    // ring (free now), value-major so the 32 lanes hit 32 banks
    constexpr int NV = ND * 4 + 4;
    float* red = reinterpret_cast<float*>(Ks) + rw * NV * 32 + lane;
    if (koff) {
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(i * 4 + e) * 32] = acc[i][e];
      red[(NV - 4) * 32] = m0;
      red[(NV - 3) * 32] = m1;
      red[(NV - 2) * 32] = l0;
      red[(NV - 1) * 32] = l1;
    }
    __syncthreads();
    if (koff) return;
    const float mb0 = red[(NV - 4) * 32], mb1 = red[(NV - 3) * 32];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float ca0 = exp_(m0 - mn0), cb0 = exp_(mb0 - mn0);
    const float ca1 = exp_(m1 - mn1), cb1 = exp_(mb1 - mn1);
    l0 = l0 * ca0 + red[(NV - 2) * 32] * cb0;
    l1 = l1 * ca1 + red[(NV - 1) * 32] * cb1;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] = acc[i][0] * ca0 + red[(i * 4 + 0) * 32] * cb0;
      acc[i][1] = acc[i][1] * ca0 + red[(i * 4 + 1) * 32] * cb0;
      acc[i][2] = acc[i][2] * ca1 + red[(i * 4 + 2) * 32] * cb1;
      acc[i][3] = acc[i][3] * ca1 + red[(i * 4 + 3) * 32] * cb1;
    }
  }

  l0 += __shfl_xor_sync(kAll, l0, 1);
  l0 += __shfl_xor_sync(kAll, l0, 2);
  l1 += __shfl_xor_sync(kAll, l1, 1);
  l1 += __shfl_xor_sync(kAll, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  T* o0 = o + ((int64_t)b * Sq + row0) * q_stride + (int64_t)h * D;
  T* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int col = i * 8 + 2 * tig;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + col) =
          Mma<T>::pack(acc[i][0] / lc0, acc[i][1] / lc0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + col) =
          Mma<T>::pack(acc[i][2] / lc1, acc[i][3] / lc1);
  }
}

template <typename T, int D, int KSPLIT>
int launch_mma_split(dim3 grid, const void* q, const void* k, const void* v,
                     void* o, int Sq, int Sk, int H, int KV, int causal,
                     float scale, cudaStream_t stream) {
  constexpr int kRowWarps = 4;
  constexpr size_t smem = mma_smem_bytes<T, D, kRowWarps>();
  static_assert(kRowWarps * 32 * (D / 2 + 4) * sizeof(float) <=
                    4 * kKeyTile * (D + 8) * sizeof(T),
                "the key halves merge inside the K/V ring");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T, D, kRowWarps, KSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_mma_kernel<T, D, kRowWarps, KSPLIT>
      <<<grid, kRowWarps * KSPLIT * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
          scale);
  return (int)cudaGetLastError();
}

// A grid of fewer than two blocks per SM splits every tile's keys between
// two warps per row group (8 warps a block); a larger one keeps 4 warps.
template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, float scale,
               cudaStream_t stream) {
  const int q_tiles = (Sq + 63) / 64;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  static int sm_count[64] = {};  // per device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = dev < 64 ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sm_count[dev] = sms;
  }
  const dim3 grid(B * H, q_tiles);
  if ((int64_t)B * H * q_tiles < 2 * sms)
    return launch_mma_split<T, D, 2>(grid, q, k, v, o, Sq, Sk, H, KV, causal,
                                     scale, stream);
  return launch_mma_split<T, D, 1>(grid, q, k, v, o, Sq, Sk, H, KV, causal,
                                   scale, stream);
}

// ---------------------------------------------------------------------------
// f32: FP32 FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 8
constexpr int kR = 4;                       // rows scored together

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBQ * D + kBK * (D + 1) + kBK * D + kWarps * kR * kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int Sq, int Sk, int H, int KV, int causal,
                         float scale) {
  constexpr int kDL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                // kBQ x D
  float* Ks = Qs + kBQ * D;        // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);  // kBK x D
  float* Ps = Vs + kBK * D;        // kWarps x kR x kBK

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = q0 + r;
    Qs[idx] = i < Sq ? q[((int64_t)b * Sq + i) * H * D + h * D + c] : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) acc[r][i] = 0.0f;
  }

  const int tiles = (Sk + kBK - 1) / kBK;
  const int n_tiles = causal ? min(tiles, (q0 + kBQ - 1) / kBK + 1) : tiles;
  float* Pw = Ps + warp * kR * kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (Qs staged, 1st pass)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D, key = k0 + j;
      const int64_t g = ((int64_t)b * Sk + key) * KV * D + kvh * D + c;
      Ks[j * (D + 1) + c] = key < Sk ? k[g] : 0.0f;
      Vs[idx] = key < Sk ? v[g] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int grp = 0; grp < kRowsPerWarp / kR; ++grp) {
      const int rbase = warp * kRowsPerWarp + grp * kR;  // row in the tile
      float s[kR][2];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float k_a = Ks[lane * (D + 1) + c];
        const float k_b = Ks[(lane + 32) * (D + 1) + c];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float qv = Qs[(rbase + r) * D + c];
          s[r][0] = fmaf(qv, k_a, s[r][0]);
          s[r][1] = fmaf(qv, k_b, s[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int rr = grp * kR + r;  // this warp's row index
        const int qi = q0 + rbase + r;
        float sc[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int key = k0 + lane + 32 * t;
          const bool live = key < Sk && (!causal || key <= qi);
          sc[t] = live ? s[r][t] * scale : kNeg;
        }
        float mt = fmaxf(sc[0], sc[1]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(kAll, mt, off));
        const float mn = fmaxf(m[rr], mt);
        const float p0 = expf(sc[0] - mn), p1 = expf(sc[1] - mn);
        const float corr = expf(m[rr] - mn);
        float ps = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(kAll, ps, off);
        l[rr] = l[rr] * corr + ps;
        m[rr] = mn;
        Pw[r * kBK + lane] = p0;
        Pw[r * kBK + lane + 32] = p1;
#pragma unroll
        for (int i = 0; i < kDL; ++i) acc[rr][i] *= corr;
      }
      __syncwarp();
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float vv[kDL];
#pragma unroll
        for (int i = 0; i < kDL; ++i) vv[i] = Vs[j * D + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = Pw[r * kBK + j];
#pragma unroll
          for (int i = 0; i < kDL; ++i)
            acc[grp * kR + r][i] = fmaf(p, vv[i], acc[grp * kR + r][i]);
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
    float* orow = o + ((int64_t)b * Sq + qi) * H * D + h * D;
#pragma unroll
    for (int i = 0; i < kDL; ++i) orow[lane + 32 * i] = acc[rr][i] / lc;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, scale);
  return (int)cudaGetLastError();
}

// Route (dtype, D) to its kernel: f32 to the FP32 path, bf16 and f16 to the
// tensor cores.
template <template <int> class L>
int by_head_dim(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int KV, int causal, float scale,
                cudaStream_t stream) {
  switch (D) {
    case 32:
      return L<32>::run(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 64:
      return L<64>::run(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 96:
      return L<96>::run(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    case 128:
      return L<128>::run(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
struct F32 {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int causal, float scale,
                 cudaStream_t s) {
    return launch_f32<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, s);
  }
};

template <int D>
struct Bf16 {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int causal, float scale,
                 cudaStream_t s) {
    return launch_mma<__nv_bfloat16, D>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                        scale, s);
  }
};

template <int D>
struct F16 {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int causal, float scale,
                 cudaStream_t s) {
    return launch_mma<__half, D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                                 s);
  }
};

}  // namespace

// The C interface. Pointers are device pointers (16-byte aligned for bf16
// and f16: the tensor-core route copies 16-byte chunks); `stream` is a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and
// o alike); D in {32, 64, 96, 128}; H a multiple of KV; scale is f32 (bind
// it as ctypes.c_float). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype, D or grid it does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int D, int dtype, int causal, float scale,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return by_head_dim<F32>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                              s);
    case 1:
      return by_head_dim<Bf16>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                               s);
    case 2:
      return by_head_dim<F16>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
