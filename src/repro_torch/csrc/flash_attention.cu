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
// Design. One block per (batch * head, tile of kBQ = 64 query rows), eight
// warps. The block stages its query tile in shared memory (f32), then walks
// the key/value tiles of kBK = 64 rows: all threads stage K (row stride
// D + 1 floats, so the score loop is free of bank conflicts) and V in f32,
// then each warp takes eight query rows, four at a time. A lane computes
// the scores of keys `lane` and `lane + 32` for the four rows (f32 FMAs over
// D), applies the scale and the mask, and the warp updates each row's
// running max m and sum l with shuffles. The probabilities p go to shared
// memory rounded to v's dtype (as the TPU kernel casts p before P.V), and
// each lane accumulates D / 32 output columns of acc = acc * corr + p . V
// in f32. The block ends with out = acc / max(l, 1e-30) in q's dtype.
//
// Numerics kept from the TPU kernel: the scale d^-0.5 is applied to the
// f32 dot product; padded and causally hidden keys get the finite mask
// -1e30 (with -inf, a tile row with no live key would give
// exp(-inf + inf) = NaN); m starts at -1e30 and l at 0; p feeds l in f32
// and P.V rounded to v's dtype; l is clamped at 1e-30. Causal: key tiles
// that lie wholly above the query tile's diagonal are skipped.
//
// Bound on this card: operations. QK^T and P.V take 4 * D flops per live
// (query, key) pair: at (1, 1024, 8 heads, 2 kv heads, 64) bf16 causal
// about 1.07 GFLOP, 1.1 us at the 989 TFLOP/s bf16 tensor rate, against
// about 2.5 MB of bytes (0.75 us at 3.35 TB/s). This first version computes
// on FP32 FMAs from shared memory, not tensor cores, so it stays far above
// that bound; wgmma tiles are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf stays accurate).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 8
constexpr int kR = 4;                       // rows scored together
constexpr float kNeg = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// p rounded to T and back: the TPU kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * D + kBK * (D + 1) + kBK * D + kWarps * kR * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int causal, float scale) {
  constexpr int kDL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;               // kBQ x D
  float* Ks = Qs + kBQ * D;       // kBK x (D + 1)
  float* Vs = Ks + kBK * (D + 1);  // kBK x D
  float* Ps = Vs + kBK * D;       // kWarps x kR x kBK

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = q0 + r;
    Qs[idx] = i < Sq ? to_f32(q[((int64_t)b * Sq + i) * H * D + h * D + c])
                     : 0.0f;
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
      Ks[j * (D + 1) + c] = key < Sk ? to_f32(k[g]) : 0.0f;
      Vs[idx] = key < Sk ? to_f32(v[g]) : 0.0f;
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
        Pw[r * kBK + lane] = round_to<T>(p0);
        Pw[r * kBK + lane + 32] = round_to<T>(p1);
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
    T* orow = o + ((int64_t)b * Sq + qi) * H * D + h * D;
#pragma unroll
    for (int i = 0; i < kDL; ++i)
      orow[lane + 32 * i] = from_f32<T>(acc[rr][i] / lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int D, int causal, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                           stream);
    case 96:
      return launch<T, 96>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface. Pointers are device pointers; `stream` is a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and
// o alike); D in {32, 64, 96, 128}; H a multiple of KV; scale is f32 (bind
// it as ctypes.c_float). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype or D it does not take.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int H, int KV,
                               int D, int dtype, int causal, float scale,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, scale,
                             s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                     scale, s);
    case 2:
      return launch_d<__half>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, scale,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
