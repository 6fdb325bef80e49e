// Channel-flat softmax attention for Hopper (sm_90a) on wgmma and TMA: the
// bf16 path of fused_attention_btc_prescaled, replacing the Pallas TPU kernel
// _btc_kernel (unirestore_tpu/nn/pallas_attention.py:220, pallas_call :257).
//
//   ur_attention_btc_sm90: q, k, v, o (B, T, H*64) bf16, contiguous; q
//   prescaled by 64^-1/2 * log2(e); per 64-wide head window
//     o = softmax_2(q k^T) v
//   with fp32 logits, an online base-2 softmax with fp32 running max and row
//   sum, the probabilities rounded to bf16 before the PV product, fp32
//   accumulation, and one division by the row sum and rounding at the end:
//   the function of attention_btc_plain (nn/attention_kernels.py) and of
//   csrc/attention.cu:ur_attention_btc, which keeps serving fp32.
//
// What bounds it on the H100: 4*B*H*T^2*64 operations against 8*B*T*inner
// bytes of q, k, v and o, T/2 = 2048 operations per byte at T = 4096, far
// above the card's ~295: the tensor cores bound it (0.174 ms at (8, 4096,
// 320) at 989 TFLOP/s). Beside them the softmax takes B*H*T^2 exp2 on the
// special-function units (16 per clock per SM: 671 M exp2, about 0.17 ms at
// (8, 4096, 320)), as much as the tensor-core bound, so the exp2 work has to
// run under the products, not after them.
//
// Design (milestones M1 and M2 of the redesign; the mma.sync kernel of
// csrc/attention.cu is the yardstick chip_smoke.py times beside it):
// - A block owns (batch b, head h, 128 queries): grid (T/128, B*H), two
//   consumer warpgroups of 64 query rows each (wgmma has M = 64) and one
//   producer warpgroup (M2), 384 threads, one block per SM.
// - TMA brings every tile: one 3-D tensor map per operand over (inner, T, B)
//   with a (64, 128, 1) box and 128-byte swizzle. A 64-wide bf16 head row is
//   exactly one 128-byte swizzle span, so the channel-flat layout needs no
//   copy or transpose. Q (16 KB) arrives once; K and V (16 KB each per
//   128-key tile) stream through a ring of kStages stages, each guarded by a
//   "full" mbarrier (expect_tx bytes) and an "empty" one that every consumer
//   warp arrives on. One thread of the producer warpgroup issues every load
//   (M1 had a consumer thread do it, stalling its warpgroup on the other's
//   release); the producer drops to 24 registers (setmaxnreg) and the
//   consumers rise to 240. Copies need no thread arithmetic and overlap all
//   the compute of the stages ahead.
// - S = Q K^T: wgmma m64n128k16, A and B from shared memory, K-major,
//   128-byte-swizzle descriptors; four k-steps over d = 64, the start address
//   advancing 32 bytes inside the swizzle atom, SBO = 1024 bytes (8 rows).
// - The softmax stays in registers on the accumulator layout (rows g and
//   g + 8 of each warp's 16, columns 8n + 2*t4 + {0, 1}): the row max and
//   row sum need two 4-lane shuffles.
// - O += P V: wgmma m64n64k16 with A from registers (P packed to bf16: for
//   each 16-key step the accumulator layout is the register-A fragment
//   layout) and B the V tile from shared memory, MN-major (d contiguous, the
//   transpose-B immediate set): eight k-steps over 128 keys, the descriptor
//   advancing 16 rows * 128 B = 2048 B per step.
// - Softmax under the products (M2): a consumer issues S_j = Q K_j^T and
//   O += P_{j-1} V_{j-1} together, waits for S_j alone, and runs the exp2 of
//   tile j while the tensor cores finish P_{j-1} V_{j-1}; then it rescales O
//   and packs P_j. Live registers: S (64), O (32), P (32) per thread.
// - exp2 is one ex2.approx.ftz instruction: exp2f's handling of subnormal
//   results cost the softmax about a sixth of the kernel's time at T = 4096
//   on an H100 (PERF.md). A probability below 2^-126 of its row's
//   maximum becomes 0, far under the bf16 rounding the product applies.
// - Epilogue: each warpgroup divides by l, rounds once to bf16 and stores its
//   64 rows straight to global memory as bf16x2.
// - Shared memory: 16 KB of Q + kStages * 32 KB of K/V + barriers, 113 KB at
//   three stages; 384 threads at 168 registers fill the register file, so
//   one block per SM. Three stages, chosen on an H100 (PERF.md): two
//   leave the producer waiting for a release, four gain nothing.
// Tried and left out: ping-pong of the two consumer warpgroups on named
// barriers, one's softmax under the other's products (M3). It gained 6 %
// with exp2f and lost 2-3 % at T = 4096 with ex2.approx.ftz, where the
// exp2 no longer bounds the softmax.
//
// btc_supported admits T >= 1024 with T % 256 == 0 and inner % 64 == 0, so
// the 128-query and 128-key tiles need no masking; any other shape returns
// cudaErrorInvalidValue. The entry encodes the tensor maps from the pointers
// and dims it is given, with cuTensorMapEncodeTiled from
// cudaGetDriverEntryPoint (no -lcuda), and returns cudaGetLastError() after
// the launch (0 on success).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;            // head width
constexpr int kBM = 128;          // queries per block
constexpr int kBN = 128;          // keys per tile
constexpr int kStages = 3;        // K/V ring stages
constexpr int kThreads = 384;     // a producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
// registers per thread after setmaxnreg: 128 * 24 + 256 * 240 = 65,536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kTileBytes = kBN * kD * 2;  // one 128 x 64 bf16 tile: 16 KB
constexpr float kNegBig = -1e30f;

static_assert(kBM == kBN && kTileBytes % 1024 == 0, "tiles must keep 1024-byte alignment");

__host__ __device__ constexpr size_t smem_bytes() {
  // Q, the K/V ring, barriers (Q, full and empty per stage), 1024 bytes of
  // slack to align the swizzled tiles
  return size_t(kTileBytes) * (1 + 2 * kStages) + 8 * (1 + 2 * kStages) + 1024;
}

// 2^x in one special-function instruction; results below 2^-126 flush to 0
// (exp2f adds the instructions that keep them subnormal)
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

// box (64, 128, 1) at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bytes` of the barrier's expected transaction count
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

// shared-memory matrix descriptor, 128-byte swizzle. For the K-major tiles
// (Q, K) SBO is the 1024-byte stride between 8-row groups and LBO is unused;
// for the MN-major V tile with N = 64 (one swizzle span) SBO is the stride
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
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

#define UR_F8(c, a, i)                                                                    \
  c(a[i]), c(a[i + 1]), c(a[i + 2]), c(a[i + 3]), c(a[i + 4]), c(a[i + 5]), c(a[i + 6]), \
      c(a[i + 7])
#define UR_F64(c, a)                                                                      \
  UR_F8(c, a, 0), UR_F8(c, a, 8), UR_F8(c, a, 16), UR_F8(c, a, 24), UR_F8(c, a, 32),      \
      UR_F8(c, a, 40), UR_F8(c, a, 48), UR_F8(c, a, 56)
#define UR_SS_M64N128K16                                                                   \
  "{\n"                                                                                    \
  ".reg .pred p;\n"                                                                        \
  "setp.ne.b32 p, %66, 0;\n"                                                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "      \
  "%64, %65, p, 1, 1, 0, 0;\n"                                                             \
  "}\n"

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128)^T (kAccumulate: d += ...), A
// and B K-major in shared memory. The first k-step overwrites d, so d is not
// live before it.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (kAccumulate)
    asm volatile(UR_SS_M64N128K16 : UR_F64("+f", d) : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(UR_SS_M64N128K16 : UR_F64("=f", d) : "l"(da), "l"(db), "r"(0));
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
      : UR_F8("+f", d, 0), UR_F8("+f", d, 8), UR_F8("+f", d, 16), UR_F8("+f", d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef UR_SS_M64N128K16
#undef UR_F64
#undef UR_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

// online-softmax statistics of one tile of S (the accumulator layout: rows
// g and g + 8 of the warp's 16, s[4n + {0, 1}] and s[4n + {2, 3}] at columns
// 8n + 2 t4 + {0, 1}): s becomes exp2(s - m_new), m and l move on, and corr
// is the factor O must be rescaled by. The four threads of a row are lanes
// 4g .. 4g + 3.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
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
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_btc_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int seq,
                   int heads) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles start on 1024-byte boundaries
  const uint32_t q_tile = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = q_tile + kTileBytes * (1 + 2 * kStages);
  const uint32_t q_bar = bars;
  auto k_tile = [&](int s) { return q_tile + kTileBytes * (1 + 2 * s); };
  auto v_tile = [&](int s) { return q_tile + kTileBytes * (2 + 2 * s); };
  auto full_bar = [&](int s) { return bars + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // 0: producer; 1, 2: consumers of query rows 64 (wg - 1) + [0, 64)
  const int q0 = blockIdx.x * kBM;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int n_tiles = seq / kBN;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; the warpgroup gives its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      const CUtensorMap* k_map = &tk;
      const CUtensorMap* v_map = &tv;
      mbar_expect_tx(q_bar, kTileBytes);
      tma_load_3d(q_tile, &tq, q_bar, h * kD, q0, b);
      // K and V of key tile j into ring stage j % kStages once the consumers
      // have released the tile kStages before it, both on its full barrier
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar(s), ((j / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * kTileBytes);
        tma_load_3d(k_tile(s), k_map, full_bar(s), h * kD, j * kBN, b);
        tma_load_3d(v_tile(s), v_map, full_bar(s), h * kD, j * kBN, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int cw = wg - 1;
    const uint32_t q_rows = q_tile + cw * 64 * 128;  // this warpgroup's 64 rows of 128 bytes
    auto qk = [&](float (&s)[64], int st) {  // S = Q K^T: four k-steps of 16 over d = 64
      wgmma_m64n128k16_ss<false>(s, desc_sw128(q_rows), desc_sw128(k_tile(st)));
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk)
        wgmma_m64n128k16_ss<true>(s, desc_sw128(q_rows + 32 * kk),
                                  desc_sw128(k_tile(st) + 32 * kk));
      wgmma_commit();
    };
    auto pv = [&](float (&oacc)[32], const uint32_t (&p)[kBN / 16][4], int st) {
      // O += P V: eight k-steps of 16 keys (16 rows of 128 bytes each)
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64n64k16_rs(oacc, p[kk], desc_sw128(v_tile(st) + 2048 * kk));
      wgmma_commit();
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(st));
    };

    float s[64], oacc[32], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;

    // tile 0: S alone, its softmax, P
    mbar_wait(q_bar, 0);
    mbar_wait(full_bar(0), 0);
    wgmma_fence();
    qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, corr);
    pack_p(s, p);

    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together; the
    // softmax of S_j runs while the tensor cores finish P_{j-1} V_{j-1}
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages;
      const int prev = (j - 1) % kStages;
      mbar_wait(full_bar(st), (j / kStages) & 1);
      wgmma_fence();
      qk(s, st);
      pv(oacc, p, prev);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      softmax_tile(s, m, l, corr);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(p);
      release(prev);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          oacc[4 * n + 2 * r] *= corr[r];
          oacc[4 * n + 2 * r + 1] *= corr[r];
        }
      }
      pack_p(s, p);
    }
    wgmma_fence();
    pv(oacc, p, (n_tiles - 1) % kStages);
    wgmma_wait<0>();
    fence_regs(oacc);
    release((n_tiles - 1) % kStages);

    // epilogue: divide by the row sum, round once, store bf16x2 rows
    const int inner = heads * kD;
    const int row = q0 + cw * 64 + (warp & 3) * 16 + g;
    bf16* ob = o + ((long long)b * seq + row) * inner + h * kD + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(8 * r) * inner + 8 * n) =
            __floats2bfloat162_rn(oacc[4 * n + 2 * r] * inv, oacc[4 * n + 2 * r + 1] * inv);
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

// (inner, seq, batch) bf16 at ptr, box (64, 128, 1), 128-byte swizzle
bool encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const void* ptr,
                int batch, int seq, int inner) {
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(inner) * 2, cuuint64_t(seq) * inner * 2};
  const cuuint32_t box[3] = {kD, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kBFloat16 = 1;  // dtype code shared with attention_kernels.py
constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, inner) bf16 with inner = heads * 64, contiguous,
// 16-byte aligned; seq % 128 == 0. The signature is ur_attention_btc's.
int ur_attention_btc_sm90(const void* q, const void* k, const void* v, void* o, int batch,
                          int seq, int inner, int dtype, void* stream) {
  if (dtype != kBFloat16 || batch <= 0 || seq < kBN || seq % kBN != 0 || inner <= 0 ||
      inner % kD != 0)
    return int(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, q, batch, seq, inner) ||
      !encode_map(encode, &tk, k, batch, seq, inner) ||
      !encode_map(encode, &tv, v, batch, seq, inner))
    return int(cudaErrorInvalidValue);
  // the shared-memory limit is set once per device, not on every launch
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_btc_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes()));
    if (err != cudaSuccess) return int(err);
    smem_set[dev] = true;
  }
  const int heads = inner / kD;
  const dim3 grid(seq / kBM, batch * heads);
  attention_btc_sm90<<<grid, kThreads, smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), seq, heads);
  return int(cudaGetLastError());
}

}  // extern "C"
