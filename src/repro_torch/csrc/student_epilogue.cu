// The Fig. 5 student's convolution epilogues for Hopper (sm_90a), eval
// forward only (`models/cnn.py`, `Student.features` on the card with
// autograd off):
//
//   pool mode  (conv1, conv2)  y = maxpool2x2(bn(relu(conv + bias)))
//              bn(v) = (v - mu) * inv * scale + shift,  inv = rsqrt(var + eps)
//              the 2x2 window at stride 2 with the floor (30 -> 15, 15 -> 7)
//   relu mode  (conv3, conv4)  y = relu(conv + bias)
//
// on the raw cuDNN output (the convolution run without its bias). Replaces
// no Pallas kernel: the JAX package left these elementwise tails and the
// pool to XLA, which fuses them into its convolutions' epilogues. Added
// because PyTorch runs each step as its own pass over device memory: the
// bias add, ReLU, BatchNorm's four broadcast ops and the pool made six
// passes and a pool over each of the conv1 and conv2 outputs (472 MB each
// at a batch of 4,096) and two over conv3's and conv4's.
//
// Same arithmetic as that chain, bit for bit: each step rounded in float32
// in the chain's order (__fadd_rn / __fsub_rn / __fmul_rn, so nvcc cannot
// contract `* scale + shift` into an FMA; never --use_fast_math); ReLU as
// ATen's clamp_min (`v != v ? v : fmaxf(v, 0)`, NaN kept); BatchNorm
// applied to all four values of a window before the max (a negative scale
// does not commute with the max); the max as ATen's max_pool2d takes it,
// from -inf over the window in row order, a value replacing the running
// one where it is greater or NaN (NaN propagates, the first of equal
// values stays).
//
// Bound on this card: bytes. One pass reads each conv output once and
// writes only the result: 1,601,175,552 B for the four launches of a batch
// of 4,096 (conv1 471.9 MB in, 118.0 MB out; conv2 471.9 / 102.8; conv3
// 205.5 / 205.5; conv4 12.8 / 12.8), 0.478 ms at 3.35 TB/s.
//
// Design: the tensors are NHWC in memory (channels-last, the format cuDNN
// gives the student's convolutions, whose first input is a permuted NHWC
// batch); the wrapper checks the strides. A thread takes VEC = 4
// consecutive channels of one output pixel (16-byte loads and stores where
// C % 4 == 0 and both buffers are 16-byte aligned, else VEC = 1), so the
// threads of a warp read neighbouring 16-byte vectors along C and then
// along W. A block has a multiple of G = C / VEC threads and the grid
// strides by a multiple of G, so a thread's channels never change: it loads
// its per-channel parameters into registers once. The grid is capped at a
// full SM's residency over the 132 SMs (2,048 threads an SM), each block
// striding over its share; a launch allocates nothing, runs on the given
// stream and does not synchronise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block, rounded down to a multiple of G
constexpr int kThreadsPerSM = 2048;
constexpr int kMaxGroups = 1024;  // G = C / VEC: one group a thread at most

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __ldg(p + j);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r.v[j];
  }
}

// ATen's clamp_min(v, 0): NaN kept (a bare fmaxf would drop it); v != v
// is the NaN test (no fast math here)
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// one value through bias, ReLU and eval BatchNorm, each step rounded
__device__ __forceinline__ float bias_relu_bn(float v, float bias, float mu,
                                              float inv, float scale,
                                              float shift) {
  const float r = relu(__fadd_rn(v, bias));
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(r, mu), inv), scale),
                   shift);
}

// max_pool2d's update: greater, or NaN
__device__ __forceinline__ float pool_max(float running, float v) {
  return (v > running || v != v) ? v : running;
}

struct Shape {
  int64_t items;  // output pixels (pool) or vectors (relu)
  int H, W, C, Ho, Wo, G;
};

// pool mode: item = one output pixel's VEC channels of group g
template <int VEC>
__global__ void __launch_bounds__(1024)
    student_epilogue_pool_kernel(const float* __restrict__ in,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ inv,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 float* __restrict__ out, const Shape s) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (int)(tid % s.G) * VEC;
  const int64_t step = (int64_t)gridDim.x * blockDim.x / s.G;
  float b[VEC], m[VEC], iv[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    b[j] = bias[c0 + j], m[j] = mu[c0 + j], iv[j] = inv[c0 + j];
    sc[j] = scale[c0 + j], sh[j] = shift[c0 + j];
  }
  const int64_t row = (int64_t)s.W * s.C;
  for (int64_t p = tid / s.G; p < s.items; p += step) {
    const int64_t wo = p % s.Wo, t = p / s.Wo;
    const int64_t ho = t % s.Ho, n = t / s.Ho;
    const float* src = in + ((n * s.H + 2 * ho) * s.W + 2 * wo) * s.C + c0;
    const Vec<VEC> v00 = load<VEC>(src), v01 = load<VEC>(src + s.C);
    const Vec<VEC> v10 = load<VEC>(src + row);
    const Vec<VEC> v11 = load<VEC>(src + row + s.C);
    Vec<VEC> r;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = __int_as_float(0xff800000);  // -inf, max_pool2d's start
      x = pool_max(x, bias_relu_bn(v00.v[j], b[j], m[j], iv[j], sc[j], sh[j]));
      x = pool_max(x, bias_relu_bn(v01.v[j], b[j], m[j], iv[j], sc[j], sh[j]));
      x = pool_max(x, bias_relu_bn(v10.v[j], b[j], m[j], iv[j], sc[j], sh[j]));
      x = pool_max(x, bias_relu_bn(v11.v[j], b[j], m[j], iv[j], sc[j], sh[j]));
      r.v[j] = x;
    }
    store<VEC>(out + p * s.C + c0, r);
  }
}

// relu mode: item = VEC consecutive values of group g
template <int VEC>
__global__ void __launch_bounds__(1024)
    student_epilogue_relu_kernel(const float* __restrict__ in,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, const Shape s) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (int)(tid % s.G) * VEC;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  float b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) b[j] = bias[c0 + j];
  for (int64_t i = tid; i < s.items; i += step) {
    Vec<VEC> r = load<VEC>(in + i * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = relu(__fadd_rn(r.v[j], b[j]));
    store<VEC>(out + i * VEC, r);
  }
}

template <int VEC>
int launch(const float* in, const float* bias, const float* mu,
           const float* inv, const float* scale, const float* shift,
           float* out, int B, int H, int W, int C, int pool, int sms,
           cudaStream_t stream) {
  Shape s;
  s.H = H, s.W = W, s.C = C, s.Ho = H / 2, s.Wo = W / 2, s.G = C / VEC;
  if (s.G > kMaxGroups) return (int)cudaErrorInvalidValue;
  const int threads = s.G <= kThreads ? kThreads / s.G * s.G : s.G;
  // pool: an output pixel a group of G threads; relu: a vector a thread
  s.items = pool ? (int64_t)B * s.Ho * s.Wo : (int64_t)B * H * W * s.G;
  const int64_t work = pool ? s.items * s.G : s.items;
  if (work == 0) return (int)cudaSuccess;
  const int64_t cap = (int64_t)sms * (kThreadsPerSM / threads > 0
                                          ? kThreadsPerSM / threads : 1);
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (pool)
    student_epilogue_pool_kernel<VEC><<<(unsigned)blocks, threads, 0,
                                        stream>>>(in, bias, mu, inv, scale,
                                                  shift, out, s);
  else
    student_epilogue_relu_kernel<VEC><<<(unsigned)blocks, threads, 0,
                                        stream>>>(in, bias, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface. Pointers are device pointers to float32; `in` is the
// (B, H, W, C) NHWC conv output without its bias, `bias` (C,); pool != 0:
// `mu`, `inv`, `scale`, `shift` (C,) and `out` (B, H / 2, W / 2, C); pool
// == 0: those four unread (may be null) and `out` (B, H, W, C). `stream`
// is a cudaStream_t of the current device. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for more than 1,024 channel groups a pixel or a
// negative size.
extern "C" int student_epilogue(const float* in, const float* bias,
                                const float* mu, const float* inv,
                                const float* scale, const float* shift,
                                float* out, int B, int H, int W, int C,
                                int pool, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (C % 4 == 0 && aligned)
    return launch<4>(in, bias, mu, inv, scale, shift, out, B, H, W, C, pool,
                     sms, st);
  return launch<1>(in, bias, mu, inv, scale, shift, out, B, H, W, C, pool,
                   sms, st);
}
