// Head-major softmax attention for Hopper (sm_90a) on wgmma and TMA: the bf16
// path of fused_attention_bh_prescaled, replacing the Pallas TPU kernel
// _kernel (unirestore_tpu/nn/pallas_attention.py:32, pallas_call :179,
// wrapper _fused_raw_bh :166), which serves the UNet's level-2
// self-attention (d = 64, T = 256 at 512 px) and the Controller's stage 2
// (d = 128).
//
//   ur_attention_bh_sm90: q, k, v, o (BH, T, D) bf16, contiguous, D in
//   {64, 128}, any T >= 64; q prescaled by D^-1/2 * log2(e);
//     o = softmax_2(q k^T) v
//   with fp32 logits, an online base-2 softmax with fp32 running max and row
//   sum, the probabilities rounded to bf16 before the PV product, fp32
//   accumulation, and one division by the row sum and rounding at the end:
//   the function of attention_bh_plain (nn/attention_kernels.py) and of
//   csrc/attention.cu:ur_attention_bh, which keeps serving fp32.
//
// What bounds it on the H100: 4*BH*T^2*D operations against 8*BH*T*D bytes
// of q, k, v and o, T/2 = 128 operations per byte at T = 256, under the
// card's ~295: the bytes bound it. At the restore's two shapes:
//   (160, 256, 64):  21.0 MB, 6.26 us at 3.35 TB/s; 2.68 GFLOP, 2.71 us;
//   (32, 256, 128):   8.4 MB, 2.50 us;             1.07 GFLOP, 1.09 us.
// A block walks only T/64 = 4 key tiles, so its prologue (Q and the first K
// tile) and epilogue are a large part of its life: the design keeps the
// loads in flight from the block's first cycle, and several blocks on an SM
// hide each other's latency. Measured on an H100 (PERF.md): 13.1 us at
// (160, 256, 64) and 7.2 at (32, 256, 128), of which the loop's skeleton
// alone (loads, waits, stores; no products, no softmax) takes 10.4 and 4.9,
// whatever the bytes from L2.
//
// Design (M1):
// - A block owns (bh, 64 queries): grid (ceil(T/64), BH); one consumer
//   warpgroup (warps 0-3, wgmma has M = 64) and one producer warp, 160
//   threads. At D = 64 three blocks share an SM (74,856 B of shared memory
//   each; 106 registers a thread), at D = 128 one (148,584 B; 138).
// - TMA brings every load in 64-column boxes with 128-byte swizzle (one
//   64-wide bf16 row is one swizzle span): one 3-D tensor map per operand
//   over (D, T, BH), box (64, 64, 1), 8 KB; D = 128 is two boxes. Q arrives
//   once. K and V of key tile j land in stage j % kStages of a four-stage
//   ring, K and V each behind its own "full" mbarrier (expect_tx bytes), so
//   Q K_j^T starts before V_j has landed. At T <= 256 every tile has its own
//   stage: the producer issues every load at block start and never waits.
//   Longer rows reuse a stage once the four consumer warps have arrived on
//   its "empty" barrier (after P_j V_j).
// - S = Q K^T (64 x 64 per key tile): wgmma m64n64k16, both operands from
//   shared memory, K-major, 128-byte-swizzle descriptors; four k-steps per
//   64-column chunk, the start address advancing 32 bytes inside the swizzle
//   atom.
// - The softmax stays in registers on the accumulator layout (rows g and
//   g + 8 of each warp's 16, columns 8n + 2*t4 + {0, 1}).
// - O += P V: wgmma m64n64k16 per 64-column chunk of O (two at D = 128: 64
//   fp32 registers) with A from registers (P packed to bf16) and B a V chunk
//   from shared memory, MN-major (the transpose-B immediate set), the
//   descriptor advancing 16 rows * 128 B = 2048 B per k-step.
// - Softmax under the products: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are
//   issued together; the consumer waits for S_j alone and runs its softmax
//   while the tensor cores finish P_{j-1} V_{j-1}.
// - exp2 is one ex2.approx.ftz instruction: a probability below 2^-126 of its
//   row's maximum becomes 0, far under the bf16 rounding of P.
// - Masked tails: TMA zero-fills rows past T. Keys at or past T get the
//   logit kNegBig on the last tile before the row max; query rows at or past
//   T are computed (from zeros) and not stored.
// - Epilogue: divide by l, round once to bf16, store straight to global
//   memory as bf16x2.
// - The shared-memory size and carveout are set once per device and width,
//   not on every launch.
// Tried and left out (PERF.md): two warpgroups (128 queries sharing each K/V
// tile) per block at D = 64, with the producer warp (ptxas held a thread to
// 96 registers at two blocks an SM and spilled) or without it, thread 0
// issuing the loads (M2: 19 % slower at (160, 256, 64), and twice as slow on
// long rows, where thread 0 waits for both warpgroups before each refill);
// one block an SM with two or four warpgroups.
//
// The entry encodes the tensor maps from the pointers and dims it is given,
// with cuTensorMapEncodeTiled from cudaGetDriverEntryPoint (no -lcuda), and
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;           // queries per block
constexpr int kBN = 64;           // keys per tile
constexpr int kChunk = 64;        // columns per TMA box: one 128-byte swizzle span
constexpr int kStages = 4;        // K/V ring stages: every tile of T = 256 has its own
constexpr int kThreads = 160;     // one consumer warpgroup (warps 0-3), a producer warp (4)
constexpr int kConsumerWarps = 4;
constexpr uint32_t kChunkBytes = kBN * kChunk * 2;    // one 64 x 64 bf16 chunk: 8 KB
constexpr size_t kSmemPerSm = 233472;                 // the H100's shared memory per SM
constexpr size_t kSmemReserved = 1024;                // the runtime's share per block
constexpr float kNegBig = -1e30f;

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q and kStages K and V tiles (D/64 chunks each), barriers (Q, then full K,
  // full V and empty per stage), 1024 bytes of slack to align the swizzled
  // chunks
  return size_t(kChunkBytes) * (D / kChunk) * (1 + 2 * kStages) + 8 * (1 + 3 * kStages) + 1024;
}

// blocks that share an SM: its shared memory bounds them
template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return int(kSmemPerSm / (smem_bytes<D>() + kSmemReserved));
}

static_assert(blocks_per_sm<64>() == 3 && blocks_per_sm<128>() == 1,
              "three blocks an SM at D = 64, one at D = 128");

// 2^x in one special-function instruction; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the barrier's phase of this parity has completed; traps (a
// launch error, not a hung card) if it has not after about 2^26 polls
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (64, 64, 1) at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing its bytes of the barrier's expected transaction count (rows
// past the tensor's end arrive as zeros and count all the same)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle. For the K-major chunks
// (Q, K) SBO is the 1024-byte stride between 8-row groups and LBO is unused;
// for the MN-major V chunk with N = 64 (one swizzle span) SBO is the stride
// between 8-key groups and LBO, the stride between 64-column spans, is
// unused. Both take 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (kStride << 16) | (kStride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

#define UR_F8(c, a, i)                                                                    \
  c(a[i]), c(a[i + 1]), c(a[i + 2]), c(a[i + 3]), c(a[i + 4]), c(a[i + 5]), c(a[i + 6]), \
      c(a[i + 7])
#define UR_F32(c, a) UR_F8(c, a, 0), UR_F8(c, a, 8), UR_F8(c, a, 16), UR_F8(c, a, 24)
#define UR_SS_M64N64K16                                                                    \
  "{\n"                                                                                    \
  ".reg .pred p;\n"                                                                        \
  "setp.ne.b32 p, %34, 0;\n"                                                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "      \
  "%32, %33, p, 1, 1, 0, 0;\n"                                                             \
  "}\n"

// d (64 x 64, fp32) = A (64 x 16) B (16 x 64)^T (kAccumulate: d += ...), A
// and B K-major in shared memory. The first k-step overwrites d, so d is not
// live before it.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (kAccumulate)
    asm volatile(UR_SS_M64N64K16 : UR_F32("+f", d) : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(UR_SS_M64N64K16 : UR_F32("=f", d) : "l"(da), "l"(db), "r"(0));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64), B in shared
// memory MN-major (d contiguous: the transpose-B immediate is 1)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : UR_F32("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef UR_SS_M64N64K16
#undef UR_F32
#undef UR_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

// keys k0 + (column) at or past seq, zero rows that TMA filled in, get the
// logit kNegBig (the accumulator layout: s[4n + e] at column 8n + 2 t4 + (e & 1))
__device__ __forceinline__ void mask_tail(float (&s)[32], int k0, int seq, int t4) {
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * n + 2 * t4 + (e & 1) >= seq) s[4 * n + e] = kNegBig;
}

// online-softmax statistics of one 64-key tile of S (rows g and g + 8 of the
// warp's 16, s[4n + {0, 1}] and s[4n + {2, 3}] at columns 8n + 2 t4 + {0, 1}):
// s becomes exp2(s - m_new), m and l move on, and corr is the factor O must
// be rescaled by. The four threads of a row are lanes 4g .. 4g + 3.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegBig;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = exp2_ftz(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * n + e] = exp2_ftz(s[4 * n + e] - m_new);
        sum += s[4 * n + e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

// P in bf16 as the register A operand of O += P V: keys 16 kk .. 16 kk + 15
// are the accumulator's column blocks 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<D>())
attention_bh_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int seq) {
  constexpr int NC = D / kChunk;  // 64-column chunks of a row: 1 or 2
  constexpr uint32_t kTileBytes = kChunkBytes * NC;  // 64 rows of Q, K or V
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled chunks start on 1024-byte boundaries
  const uint32_t q_base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = q_base + kTileBytes * (1 + 2 * kStages);
  auto k_stage = [&](int st) { return q_base + kTileBytes * (1 + 2 * st); };
  auto v_stage = [&](int st) { return q_base + kTileBytes * (2 + 2 * st); };
  const uint32_t q_bar = bars;
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int n_tiles = (seq + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread loads Q, then K and V of tile j into stage
    // j % kStages, waiting only where the stage held tile j - kStages
    if (lane == 0) {
      mbar_expect_tx(q_bar, kTileBytes);
      for (int c = 0; c < NC; ++c)
        tma_load_3d(q_base + kChunkBytes * c, &tq, q_bar, c * kChunk, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty(st), ((j / kStages) - 1) & 1);
        mbar_expect_tx(full_k(st), kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(k_stage(st) + kChunkBytes * c, &tk, full_k(st), c * kChunk, j * kBN, bh);
        mbar_expect_tx(full_v(st), kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(v_stage(st) + kChunkBytes * c, &tv, full_v(st), c * kChunk, j * kBN, bh);
      }
    }
  } else {
    const int g = lane >> 2;
    const int t4 = lane & 3;

    auto qk = [&](float (&s)[32], int j) {  // S = Q K_j^T: four k-steps per chunk of d
      const int st = j % kStages;
      mbar_wait(full_k(st), (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t qa = q_base + kChunkBytes * c;
        const uint32_t ka = k_stage(st) + kChunkBytes * c;
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          if (c == 0 && kk == 0)
            wgmma_m64n64k16_ss<false>(s, desc_sw128(qa), desc_sw128(ka));
          else
            wgmma_m64n64k16_ss<true>(s, desc_sw128(qa + 32 * kk), desc_sw128(ka + 32 * kk));
        }
      }
      wgmma_commit();
    };
    auto pv = [&](float (&oacc)[NC][32], const uint32_t (&p)[kBN / 16][4], int j) {
      // O += P V_j per 64-column chunk of O: four k-steps of 16 keys
      const int st = j % kStages;
      mbar_wait(full_v(st), (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_m64n64k16_rs(oacc[c], p[kk],
                             desc_sw128(v_stage(st) + kChunkBytes * c + 2048 * kk));
      }
      wgmma_commit();
    };
    auto release = [&](int j) {  // this warp is done with tile j's stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % kStages));
    };

    float s[32], oacc[NC][32], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;

    // tile 0 (whole: seq >= 64): S alone, its softmax, P
    mbar_wait(q_bar, 0);
    qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, corr);
    pack_p(s, p);

    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together; the
    // softmax of S_j runs while the tensor cores finish P_{j-1} V_{j-1}
    for (int j = 1; j < n_tiles; ++j) {
      qk(s, j);
      pv(oacc, p, j - 1);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      if (j * kBN + kBN > seq) mask_tail(s, j * kBN, seq, t4);
      softmax_tile(s, m, l, corr);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(p);
      release(j - 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            oacc[c][4 * n + 2 * r] *= corr[r];
            oacc[c][4 * n + 2 * r + 1] *= corr[r];
          }
        }
      }
      pack_p(s, p);
    }
    pv(oacc, p, n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(oacc);

    // epilogue: divide by the row sum, round once, store the rows below seq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < seq) {
        const float inv = 1.f / l[r];
        bf16* ob = o + ((long long)bh * seq + row) * D + 2 * t4;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int n = 0; n < kChunk / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(ob + c * kChunk + 8 * n) =
                __floats2bfloat162_rn(oacc[c][4 * n + 2 * r] * inv,
                                      oacc[c][4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// (d, seq, bh) bf16 at ptr, box (64, 64, 1), 128-byte swizzle; rows past seq
// read as zeros
bool encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const void* ptr,
                int bh, int seq, int d) {
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(seq), cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(seq) * d * 2};
  const cuuint32_t box[3] = {kChunk, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kBFloat16 = 1;  // dtype code shared with attention_kernels.py
constexpr int kMaxDevices = 64;

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o, int bh,
           int seq, cudaStream_t stream) {
  // the shared-memory size and carveout are set once per device and width,
  // not on every launch
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_bh_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes<D>()));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_bh_sm90<D>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
    smem_set[dev] = true;
  }
  const dim3 grid((seq + kBM - 1) / kBM, bh);
  attention_bh_sm90<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(tq, tk, tv,
                                                                     static_cast<bf16*>(o), seq);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, seq, d) bf16, contiguous, 16-byte aligned; d in {64,
// 128}, seq >= 64. The signature is ur_attention_bh's.
int ur_attention_bh_sm90(const void* q, const void* k, const void* v, void* o, int bh, int seq,
                         int d, int dtype, void* stream) {
  if (dtype != kBFloat16 || bh <= 0 || bh > 65535 || seq < kBN || (d != 64 && d != 128))
    return int(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, q, bh, seq, d) || !encode_map(encode, &tk, k, bh, seq, d) ||
      !encode_map(encode, &tv, v, bh, seq, d))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(tq, tk, tv, o, bh, seq, s);
  return launch<128>(tq, tk, tv, o, bh, seq, s);
}

}  // extern "C"
