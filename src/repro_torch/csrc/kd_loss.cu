// Fused knowledge-distillation loss for Hopper (sm_90a), paper Eq. 1-3:
//
//   L_i = alpha * T^2 * KL(sigma(z_t/T) || sigma(z_s/T))
//       + (1 - alpha) * CE(z_s, y_i)
//
// per row i of (B, V) student and teacher logits. Replaces the Pallas TPU
// kernel `kd_loss` (_kernel) of src/repro/kernels/kd_loss/kd_loss.py (B8).
//
// The state of a run of columns is the TPU kernel's eight accumulators, a
// `Partial` in f32:
//   m_u, l_u, a   max / rescaled expsum of u = z_t/T, and a = sum
//                 e^{u - m_u} (u - v), rescaled with l_u    (teacher lse, KL)
//   m_v, l_v      the same for v = z_s/T                    (student lse)
//   m_w, l_w      the same for z_s at T = 1                 (CE lse)
//   pick          z_s[label] if the label lies in the run, else 0
// Partials of disjoint runs merge by the rescale rule in any grouping; a run
// with no column is the identity (m = -1e30, l = a = 0). The epilogue:
//   KL = a / l_u - (m_u + log l_u) + (m_v + log l_v)  (in natural units)
//   CE = (m_w + log l_w) - pick
//   L  = coef_kl * KL + coef_ce * CE,  coef_kl = alpha T^2, coef_ce = 1 - alpha
// so a label outside [0, V) picks 0, as on the TPU (whose one-hot pick
// finds no column).
//
// Design, one launch per call (`splits` and `split_cols` from the wrapper,
// kernels/kd_loss/kd_loss.py: `split_plan`):
//   rows_kernel    short rows (splits == 0; the trainer's V = 10): a warp
//                  per row, eight rows a block.
//   split_kernel   longer rows: each row split into `splits` runs of
//                  `split_cols` columns (a multiple of 8), one 256-thread
//                  block a run, so B x splits blocks cover the 132 SMs,
//                  two blocks an SM at most (64 x 32000: 4 splits, 256
//                  blocks; 8 x 152064: 33 splits, 264 blocks). With one
//                  split the block writes the loss; else it writes its
//                  Partial to `work` and the last block of the row to
//                  arrive (a counter per row in `counters`, zero before
//                  the launch and reset by that block) merges the row's
//                  partials in a fixed order, so the result does not
//                  depend on the order the blocks ran in.
// A thread reads its columns as 16-byte vectors (4 f32 or 8 bf16/f16)
// where both rows are equally aligned: a scalar head up to the first
// 16-byte boundary, the vectors two a round (both loaded before either is
// used), a scalar tail. Each chunk of columns folds into the
// thread's Partial with its maximum first: one rescale per stream per
// chunk, then one exponential per element per stream, and no branch per
// column. The streams are kept in base 2 (u, v and z_s prescaled by log2 e,
// dividing by T a multiplication by log2 e / T; the maxima and a in those
// units, converted in the epilogue), so each exponential is one exp2f:
// accurate, never __expf or fast math. The threads' partials merge by a
// shuffle tree in each warp, then the warps' by one in warp 0; the last
// block's warp 0 merges the splits, lane j splits j, j + 32, ... in order,
// then a shuffle tree: a fixed order whatever order the blocks ran in.
//
// Bound on this card: bytes. Each logit is read once (64 x 32000 f32 rows
// of both models: 16.4 MB, 4.9 us at 3.35 TB/s; 8 x 152064 bf16: 4.9 MB,
// 1.5 us); the three exponentials per column take about 1.5 us of the
// special-function units at the first shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: exp2f/logf stay accurate).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block of either kernel
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Partial {
  float mu, lu, a, mv, lv, mw, lw, pick;
};

__device__ __forceinline__ Partial identity() {
  return Partial{kNeg, 0.0f, 0.0f, kNeg, 0.0f, kNeg, 0.0f, 0.0f};
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// One 16-byte vector as f32: 4 floats or 8 16-bit values.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void widen_vec(const uint4& v, float* out);
template <>
__device__ __forceinline__ void widen_vec<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x), out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z), out[3] = __uint_as_float(v.w);
}
// 16-bit values from their bits, two a word (the low half first): bf16 is
// the high half of an f32; f16 converts exactly
__device__ __forceinline__ void widen(__nv_bfloat16, uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(__half, uint32_t w, float* out) {
  out[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  out[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
template <typename T>
__device__ __forceinline__ void widen_vec(const uint4& v, float* out) {
  widen(T{}, v.x, out);
  widen(T{}, v.y, out + 2);
  widen(T{}, v.z, out + 4);
  widen(T{}, v.w, out + 6);
}

// Fold a chunk of kN columns (student s, teacher t) into p: the chunk's
// maxima first, one rescale per stream, then one exponential per element
// per stream. u = t c, v = s c with c = log2 e / T, w = s log2 e.
template <int kN>
__device__ __forceinline__ void fold(Partial& p, const float* s,
                                     const float* t, float c) {
  float u[kN], v[kN], w[kN];
  float mu = p.mu, mv = p.mv, mw = p.mw;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    u[i] = t[i] * c;
    v[i] = s[i] * c;
    w[i] = s[i] * kLog2e;
    mu = fmaxf(mu, u[i]);
    mv = fmaxf(mv, v[i]);
    mw = fmaxf(mw, w[i]);
  }
  const float su = exp2f(p.mu - mu), sv = exp2f(p.mv - mv),
              sw = exp2f(p.mw - mw);
  float lu = p.lu * su, a = p.a * su, lv = p.lv * sv, lw = p.lw * sw;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float eu = exp2f(u[i] - mu);
    lu += eu;
    a += eu * (u[i] - v[i]);
    lv += exp2f(v[i] - mv);
    lw += exp2f(w[i] - mw);
  }
  p.mu = mu, p.lu = lu, p.a = a;
  p.mv = mv, p.lv = lv;
  p.mw = mw, p.lw = lw;
}

template <typename T>
__device__ __forceinline__ void fold_one(Partial& p, const T* s_row,
                                         const T* t_row, int col, float c) {
  const float s = to_f32(s_row[col]), t = to_f32(t_row[col]);
  fold<1>(p, &s, &t, c);
}

// Columns [c0, c1) of one row into this participant's p (`tid` of
// kParts): the scalar head and tail a column each, the vectors two a round,
// the four loads of a round issued before either vector is used. (Rounds
// of 4 or 8 vectors ran slower on the H100: their registers halve the
// blocks an SM holds.)
template <typename T, int kParts>
__device__ __forceinline__ void fold_run(Partial& p, const T* s_row,
                                         const T* t_row, int c0, int c1,
                                         int tid, float c) {
  constexpr int kV = kVec<T>;
  const uintptr_t as = reinterpret_cast<uintptr_t>(s_row + c0);
  const uintptr_t at = reinterpret_cast<uintptr_t>(t_row + c0);
  // equally aligned rows: scalar up to the 16-byte boundary; else scalar
  const int head =
      ((as ^ at) & 15) ? c1 - c0
                       : min(c1 - c0, (int)(((16 - (as & 15)) & 15) /
                                            sizeof(T)));
  const int v0 = c0 + head, nvec = (c1 - v0) / kV, t0 = v0 + nvec * kV;
  for (int col = c0 + tid; col < v0; col += kParts)
    fold_one(p, s_row, t_row, col, c);
  for (int col = t0 + tid; col < c1; col += kParts)
    fold_one(p, s_row, t_row, col, c);
  const uint4* sv = reinterpret_cast<const uint4*>(s_row + v0);
  const uint4* tv = reinterpret_cast<const uint4*>(t_row + v0);
  for (int v = tid; v < nvec; v += 2 * kParts) {
    const bool pair = v + kParts < nvec;
    const uint4 s0 = sv[v], t0 = tv[v];
    const uint4 s1 = pair ? sv[v + kParts] : s0;
    const uint4 t1 = pair ? tv[v + kParts] : t0;
    float s[2 * kV], t[2 * kV];
    widen_vec<T>(s0, s);
    widen_vec<T>(t0, t);
    if (pair) {
      widen_vec<T>(s1, s + kV);
      widen_vec<T>(t1, t + kV);
      fold<2 * kV>(p, s, t, c);
    } else {
      fold<kV>(p, s, t, c);
    }
  }
}

// Merge (m2, l2[, a2]) into (m, l[, a]) by the rescale rule (base 2).
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * exp2f(m - mn) + l2 * exp2f(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void merge_a(float& m, float& l, float& a,
                                        float m2, float l2, float a2) {
  const float mn = fmaxf(m, m2);
  const float s1 = exp2f(m - mn), s2 = exp2f(m2 - mn);
  l = l * s1 + l2 * s2;
  a = a * s1 + a2 * s2;
  m = mn;
}

__device__ __forceinline__ void merge_partial(Partial& p, const Partial& q) {
  merge_a(p.mu, p.lu, p.a, q.mu, q.lu, q.a);
  merge(p.mv, p.lv, q.mv, q.lv);
  merge(p.mw, p.lw, q.mw, q.lw);
  p.pick += q.pick;
}

__device__ __forceinline__ Partial shfl_down(const Partial& p, int off) {
  constexpr unsigned kAll = 0xffffffffu;
  return {__shfl_down_sync(kAll, p.mu, off), __shfl_down_sync(kAll, p.lu, off),
          __shfl_down_sync(kAll, p.a, off), __shfl_down_sync(kAll, p.mv, off),
          __shfl_down_sync(kAll, p.lv, off), __shfl_down_sync(kAll, p.mw, off),
          __shfl_down_sync(kAll, p.lw, off),
          __shfl_down_sync(kAll, p.pick, off)};
}

// Lanes [0, kWidth)'s partials merged into lane 0's by a shuffle tree.
template <int kWidth = 32>
__device__ __forceinline__ void warp_merge(Partial& p) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
    merge_partial(p, shfl_down(p, off));
}

__device__ __forceinline__ float loss(const Partial& p, float coef_kl,
                                      float coef_ce) {
  const float lse_u = p.mu * kLn2 + logf(p.lu);
  const float lse_v = p.mv * kLn2 + logf(p.lv);
  const float lse_w = p.mw * kLn2 + logf(p.lw);
  const float kl = p.a * kLn2 / p.lu - lse_u + lse_v;
  const float ce = lse_w - p.pick;
  return coef_kl * kl + coef_ce * ce;
}

// A Partial another block wrote, read past L1.
__device__ __forceinline__ Partial load_partial(const float* w) {
  return Partial{__ldcg(w), __ldcg(w + 1), __ldcg(w + 2), __ldcg(w + 3),
                 __ldcg(w + 4), __ldcg(w + 5), __ldcg(w + 6), __ldcg(w + 7)};
}

struct Args {
  const int* labels;
  int B, V, splits, split_cols;
  float c, coef_kl, coef_ce;  // c = log2 e / T
  float* work;
  unsigned* counters;
  float* out;
};

// Short rows: warp w of block i takes row 8 i + w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const T* __restrict__ zs, const T* __restrict__ zt,
                const Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.B) return;
  const T* s_row = zs + row * a.V;
  const T* t_row = zt + row * a.V;
  Partial p = identity();
  fold_run<T, 32>(p, s_row, t_row, 0, a.V, lane, a.c);
  const int label = a.labels[row];
  if (lane == 0 && label >= 0 && label < a.V) p.pick = to_f32(s_row[label]);
  warp_merge(p);
  if (lane == 0) a.out[row] = loss(p, a.coef_kl, a.coef_ce);
}

// Longer rows: block i takes split i % splits of row i / splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ zs, const T* __restrict__ zt,
                 const Args a) {
  __shared__ Partial warp_part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / a.splits;
  const int split = blockIdx.x % a.splits;
  const int c0 = min((int64_t)split * a.split_cols, (int64_t)a.V);
  const int c1 = min(c0 + a.split_cols, a.V);
  const T* s_row = zs + row * a.V;
  const T* t_row = zt + row * a.V;
  Partial p = identity();
  fold_run<T, kThreads>(p, s_row, t_row, c0, c1, threadIdx.x, a.c);
  const int label = a.labels[row];
  if (threadIdx.x == 0 && label >= c0 && label < c1)
    p.pick = to_f32(s_row[label]);
  warp_merge(p);
  if (lane == 0) warp_part[warp] = p;
  __syncthreads();
  if (warp != 0) return;
  p = lane < kWarps ? warp_part[lane] : identity();
  warp_merge<kWarps>(p);
  if (a.splits == 1) {
    if (lane == 0) a.out[row] = loss(p, a.coef_kl, a.coef_ce);
    return;
  }
  bool last = false;
  if (lane == 0) {
    float* mine = a.work + (row * a.splits + split) * 8;
    mine[0] = p.mu, mine[1] = p.lu, mine[2] = p.a, mine[3] = p.mv;
    mine[4] = p.lv, mine[5] = p.mw, mine[6] = p.lw, mine[7] = p.pick;
    __threadfence();
    last = atomicAdd(a.counters + row, 1u) == (unsigned)a.splits - 1;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  const float* parts = a.work + row * a.splits * 8;
  Partial q = identity();
#pragma unroll 4
  for (int s = lane; s < a.splits; s += 32)
    merge_partial(q, load_partial(parts + 8 * s));
  warp_merge(q);
  if (lane == 0) {
    a.counters[row] = 0;  // for the next launch on this workspace
    a.out[row] = loss(q, a.coef_kl, a.coef_ce);
  }
}

template <typename T>
int launch(const void* zs, const void* zt, const Args& a,
           cudaStream_t stream) {
  const T* s = static_cast<const T*>(zs);
  const T* t = static_cast<const T*>(zt);
  if (a.splits == 0)
    rows_kernel<T><<<(a.B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        s, t, a);
  else
    split_kernel<T><<<(unsigned)((int64_t)a.B * a.splits), kThreads, 0,
                      stream>>>(s, t, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. Pointers are device pointers; `stream` is a
// cudaStream_t; dtype 0 = float32, 1 = bfloat16, 2 = float16 (both logits);
// splits 0 = a warp per row, else splits x split_cols columns a row;
// temperature, coef_kl = alpha T^2 and coef_ce = 1 - alpha are f32 (bind
// them as ctypes.c_float). `work` holds B x splits Partials (8 floats) and
// `counters` B zeros (left zero) when splits > 1. Returns
// cudaGetLastError().
extern "C" int kd_loss(const void* zs, const void* zt, const int* labels,
                       int B, int V, int dtype, int splits, int split_cols,
                       float temperature, float coef_kl, float coef_ce,
                       float* work, unsigned* counters, float* out,
                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Args a{labels, B, V, splits, split_cols, kLog2e / temperature,
               coef_kl, coef_ce, work, counters, out};
  switch (dtype) {
    case 0:
      return launch<float>(zs, zt, a, s);
    case 1:
      return launch<__nv_bfloat16>(zs, zt, a, s);
    case 2:
      return launch<__half>(zs, zt, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
