// MLA prefill attention for Hopper (sm_90a): causal softmax(q k^T * scale) v
// with DeepSeek-V2/V3's multi-head latent attention widths, read where the
// projections leave them:
//
//   q_nope (B, S, H, 128)  a strided view of q_b's (B, S, H, 192) output
//   q_rope (B, S, H, 64)   the rotated query part
//   k_nope (B, S, H, 128)  kv_b's (B, S, H, 256) output, columns 0-127
//   k_rope (B, S, 64)      the rotated key part, shared by every head
//   v      (B, S, H, 128)  kv_b's output, columns 128-255
//   out    (B, S, H, 128)  bf16, contiguous
//
// S = Q_nope K_nope^T + Q_rope K_rope^T runs as two wgmma chains into the
// same f32 accumulators, so no concatenated q or k and no expanded k_rope
// is ever written. Sq == Sk (prefill from position 0).
//
// Replaces no Pallas kernel: the JAX package's MLA path (models/lm.py,
// `_mla_train_attention`) calls plain `chunked_attention`, which XLA
// compiles. The port's `chunked_attention` in f32 with TF32 off (the
// configuration's precision) took 2.17 s of a 2.44 s DeepSeek-V3 batch
// (4 x 4,096 tokens, 7 layers): f32 FFMA GEMMs and about ten passes over a
// 4.3 GB f32 score tensor per 512-row chunk.
//
// Bound on this card: operations. 2 * (192 + 128) flops per live (query,
// key) pair and head: at (4, 4096, 128 heads) causal 2.75 TFLOP, 2.78 ms at
// the 989 TFLOP/s bf16 tensor rate, against 2.4 GB of inputs and output
// (0.72 ms at 3.35 TB/s). On an H100 80GB HBM3 at 700 W it takes 5.25
// ms of device time there (the profiler's, chip_smoke.py `mla_phase`),
// 53% of the bf16 rate; SDPA on copies laid out for it takes 4.74 ms of
// device time, but the copies cost more than that lead in the model.
//
// Numerics (the configuration's: bf16 operands, f32 scores, softmax and
// accumulation, no TF32): q and k are bf16 operands of wgmma with f32
// accumulation, so each score is the f32 dot product up to the order of
// its sums; the scale multiplies the f32 score; the running row max, exp
// and row sum are f32 (online softmax, exp as 2^((s - m) log2 e)); p is
// rounded to bf16 as the A operand of P.V (the plain path's
// `att.to(v.dtype)`; here before the division by the row sum, which stays
// f32), P.V accumulates in f32 and the output is rounded to bf16 once.
// Keys above the diagonal get -inf; a row with no live key writes 0.
//
// Design: one block per (tile of 128 query rows, batch * head), 384
// threads in three warpgroups. Warpgroup 0 is the producer: one thread
// loads Q once and keeps a 2-stage ring of K (nope + rope, 48 KB) and V
// (32 KB) tiles of 128 keys in flight by TMA, each stage's K and V on
// their own mbarrier, and waits on the stage's empty barrier before
// refilling it. Warpgroups 1 and 2 each own 64 query rows: S (64 x 128
// f32) stays in registers, p becomes the register A operand of P.V, and O
// accumulates as 64 x 128 f32 per warpgroup. Every operand tile is a
// 64-column slab of 128-byte rows in TMA's 128-byte swizzle, read by wgmma
// descriptors: Q and K K-major, V MN-major (trans-b). Shared memory: Q 48
// KB + 2 x (48 + 32) KB = 208 KB. setmaxnreg gives the consumers 232
// registers and the producer 40. Causal: key tiles wholly above the
// diagonal are never loaded; only the diagonal tile is masked; the grid
// is flat, ceil(S / 128) x B x H blocks on grid.x (no cap on B x H short
// of 2^31 blocks), and runs the heaviest (last) query tiles of a head
// first, so neighbouring blocks share a head's K/V in L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. cuTensorMapEncodeTiled comes from libcuda
//        through dlopen (no link against libcuda; dlopen itself resolves
//        in the Python process that loads the library).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;   // query rows a block
constexpr int kKeys = 128;   // keys a K/V tile
constexpr int kStages = 2;
constexpr int kSlab = 128 * 128;  // bytes of a 64-column bf16 slab, 128 rows
constexpr int kQBytes = 3 * kSlab;  // nope 0-63, nope 64-127, rope
constexpr int kKBytes = 3 * kSlab;
constexpr int kVBytes = 2 * kSlab;
constexpr int kStageBytes = kKBytes + kVBytes;
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + 64 + 1024;  // barriers, alignment
constexpr int kThreads = 384;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInit = -1e30f;  // the running max before any live key
constexpr long long kHangCycles = 20000000000ll;  // ~10 s at 1.98 GHz

static_assert(kRows == kKeys, "Q and K/V slabs share one size");

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
// A phase that never completes (a lost copy) traps after about 10 s of
// waiting, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > kHangCycles)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile in TMA's 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define MLA_ACC8(b)                                                   \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define MLA_ACC64                                                     \
  MLA_ACC8(0), MLA_ACC8(8), MLA_ACC8(16), MLA_ACC8(24), MLA_ACC8(32), \
      MLA_ACC8(40), MLA_ACC8(48), MLA_ACC8(56)
#define MLA_REGS64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared,
// K-major); ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MLA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MLA_ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16 bf16 in registers, the accumulator's
// row layout) B (16 x 128, shared, MN-major: trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MLA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MLA_ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    mla_prefill_kernel(const __grid_constant__ CUtensorMap q_nope,
                       const __grid_constant__ CUtensorMap q_rope,
                       const __grid_constant__ CUtensorMap k_nope,
                       const __grid_constant__ CUtensorMap k_rope,
                       const __grid_constant__ CUtensorMap v,
                       __nv_bfloat16* __restrict__ out, int S, int H,
                       float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + kBarOffset;
  const uint32_t barQ = bars;
  // per stage: full K, full V, empty
  auto full_k = [&](int st) { return bars + 8u * (1 + st); };
  auto full_v = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto sK = [&](int st) { return base + kQBytes + st * kStageBytes; };
  auto sV = [&](int st) { return sK(st) + kKBytes; };

  // one block per (query tile, batch * head), flat on grid.x (whose limit
  // is 2^31 - 1, where grid.y's 65,535 would cap B * H): a head's tiles
  // are neighbours, the heaviest (last) first
  const int n_qt = (S + kRows - 1) / kRows;
  const int qt = n_qt - 1 - (int)(blockIdx.x % (unsigned)n_qt);
  const int bh = (int)(blockIdx.x / (unsigned)n_qt);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kRows;
  const int n_tiles = qt + 1;  // key tiles 0 .. qt: the rest are hidden

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, kQBytes);
      tma_load_4d(sQ, &q_nope, barQ, 0, h, q0, b);
      tma_load_4d(sQ + kSlab, &q_nope, barQ, 64, h, q0, b);
      tma_load_4d(sQ + 2 * kSlab, &q_rope, barQ, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t lap = (uint32_t)(j / kStages);
        mbar_wait(empty(st), (lap & 1u) ^ 1u);
        const int k0 = j * kKeys;
        mbar_expect_tx(full_k(st), kKBytes);
        tma_load_4d(sK(st), &k_nope, full_k(st), 0, h, k0, b);
        tma_load_4d(sK(st) + kSlab, &k_nope, full_k(st), 64, h, k0, b);
        tma_load_3d(sK(st) + 2 * kSlab, &k_rope, full_k(st), 0, k0, b);
        mbar_expect_tx(full_v(st), kVBytes);
        tma_load_4d(sV(st), &v, full_v(st), 0, h, k0, b);
        tma_load_4d(sV(st) + kSlab, &v, full_v(st), 64, h, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * c + 16 * warp + lane / 4;  // and row0 + 8
    const int col = 2 * (lane % 4);

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = kNegInit, m1 = kNegInit, l0 = 0.f, l1 = 0.f;
    float s[64];

    mbar_wait(barQ, 0);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t phase = (uint32_t)(j / kStages) & 1u;
      mbar_wait(full_k(st), phase);
      __syncwarp();

      // S = Q_nope K_nope^T + Q_rope K_rope^T: 12 steps of 16 dims
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int slab = 0; slab < 3; ++slab) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              sw128_desc(sQ + slab * kSlab + c * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db =
              sw128_desc(sK(st) + slab * kSlab + kk * 32, 16, 1024);
          wgmma_ss(s, da, db, slab | kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale, mask the diagonal tile, online softmax (log2 domain)
      const bool diag = j == n_tiles - 1;
      const int key0 = j * kKeys + col;
      float mx0 = kNegInit, mx1 = kNegInit;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * i + e;
          float x0 = s[4 * i + e] * scale;
          float x1 = s[4 * i + 2 + e] * scale;
          if (diag && key > row0) x0 = -INFINITY;
          if (diag && key > row0 + 8) x1 = -INFINITY;
          s[4 * i + e] = x0;
          s[4 * i + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float corr0 = exp2f((m0 - n0) * kLog2e);
      const float corr1 = exp2f((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;
      const float nl0 = n0 * kLog2e, nl1 = n1 * kLog2e;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2f(fmaf(s[4 * i + e], kLog2e, -nl0));
          const float p1 = exp2f(fmaf(s[4 * i + 2 + e], kLog2e, -nl1));
          s[4 * i + e] = p0;
          s[4 * i + 2 + e] = p1;
          sum0 += p0;
          sum1 += p1;
        }
      }
      l0 = l0 * corr0 + sum0;  // this thread's share of the row sum
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= corr0;
        o[4 * i + 1] *= corr0;
        o[4 * i + 2] *= corr1;
        o[4 * i + 3] *= corr1;
      }

      // O += P V: 8 steps of 16 keys, p rounded to bf16 in registers (the
      // accumulator's layout is the A operand's); the A registers stay
      // untouched until the wgmmas that read them have completed
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      mbar_wait(full_v(st), phase);
      __syncwarp();
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        const uint64_t db = sw128_desc(sV(st) + kt * 16 * 128, kSlab, 1024);
        wgmma_rs(o, pa[4 * kt], pa[4 * kt + 1], pa[4 * kt + 2],
                 pa[4 * kt + 3], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // the row sums over the quad, then O / l in bf16
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const size_t head = (size_t)h * 128 + col;
    if (row0 < S) {
      __nv_bfloat16* dst = out + ((size_t)b * S + row0) * H * 128 + head;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    }
    if (row0 + 8 < S) {
      __nv_bfloat16* dst = out + ((size_t)b * S + row0 + 8) * H * 128 + head;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i) =
            pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map over ``rank`` dims (innermost first, element strides
// of the outer ones), boxes of 64 columns x ``rows`` along dim ``row_dim``
// (1 elsewhere), in the 128-byte swizzle; rows past the end read as 0.
CUresult make_map(CUtensorMap* map, const void* ptr, int rank,
                  const uint64_t* dims, const int64_t* strides, int row_dim) {
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    box[i] = i == 0 ? 64 : (i == row_dim ? kRows : 1);
    elem[i] = 1;
    if (i > 0) gstride[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                   const_cast<void*>(ptr), gdim, gstride, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Element strides: (head, row, batch) for q_nope, q_rope, k_nope and v;
// (row, batch) for k_rope; the last dim of each is contiguous. Returns a
// CUDA error code, or 1000 + libcuda's CUresult when a tensor map is
// refused (cudaErrorSharedObjectInitFailed without libcuda's encoder).
extern "C" int mla_prefill(const void* q_nope, const void* q_rope,
                           const void* k_nope, const void* k_rope,
                           const void* v, void* out, int B, int S, int H,
                           long long qn_h, long long qn_s, long long qn_b,
                           long long qr_h, long long qr_s, long long qr_b,
                           long long kn_h, long long kn_s, long long kn_b,
                           long long kr_s, long long kr_b, long long v_h,
                           long long v_s, long long v_b, float scale,
                           void* stream) {
  if (encoder() == nullptr) return (int)cudaErrorSharedObjectInitFailed;
  const uint64_t B64 = B, S64 = S, H64 = H;
  CUtensorMap maps[5];
  const uint64_t d_nope[4] = {128, H64, S64, B64};
  const uint64_t d_rope[4] = {64, H64, S64, B64};
  const uint64_t d_krope[3] = {64, S64, B64};
  const int64_t s_qn[3] = {qn_h, qn_s, qn_b}, s_qr[3] = {qr_h, qr_s, qr_b};
  const int64_t s_kn[3] = {kn_h, kn_s, kn_b}, s_kr[2] = {kr_s, kr_b};
  const int64_t s_v[3] = {v_h, v_s, v_b};
  const CUresult rc[5] = {
      make_map(&maps[0], q_nope, 4, d_nope, s_qn, 2),
      make_map(&maps[1], q_rope, 4, d_rope, s_qr, 2),
      make_map(&maps[2], k_nope, 4, d_nope, s_kn, 2),
      make_map(&maps[3], k_rope, 3, d_krope, s_kr, 1),
      make_map(&maps[4], v, 4, d_nope, s_v, 2)};
  for (CUresult r : rc)
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const uint64_t blocks = (S64 + kRows - 1) / kRows * B64 * H64;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidConfiguration;
  mla_prefill_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                       (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      reinterpret_cast<__nv_bfloat16*>(out), S, H, scale);
  return (int)cudaGetLastError();
}
