// Wide-head softmax attention for Hopper (sm_90a) on wgmma and TMA: the bf16
// path of streaming_attention_bh_prescaled, replacing the Pallas TPU kernel
// _stream_kernel (unirestore_tpu/nn/pallas_attention.py:83, pallas_call :135),
// which serves the VAE mid-block's one 512-wide head at T = 4096.
//
//   ur_attention_stream_sm90: q, k, v, o (BH, T, D) bf16, contiguous, D in
//   {256, 384, 512}; q prescaled by D^-1/2 * log2(e);
//     o = softmax_2(q k^T) v
//   with fp32 logits, an online base-2 softmax with fp32 running max and row
//   sum, the probabilities rounded to bf16 before the PV product, fp32
//   accumulation, and one division by the row sum and rounding at the end:
//   the function of attention_bh_plain (nn/attention_kernels.py) and of
//   csrc/attention.cu:ur_attention_stream, which keeps serving fp32.
//
// What bounds it on the H100: 4*BH*T^2*D operations against 8*BH*T*D bytes
// of q, k, v and o, T/2 = 2048 operations per byte at T = 4096, far above the
// card's ~295: the tensor cores bound it (0.278 ms at (8, 4096, 512) at 989
// TFLOP/s). The softmax's BH*T^2 exp2 (run by both consumers) take about a
// quarter of that on the special-function units at D = 512 (0.07 ms), so
// they matter less than at d = 64, but still run under the products.
// What the mma.sync kernel of csrc/attention.cu lost on: its four 128-column
// blocks each recomputed q k^T at d = 512 (2.5x the tensor work) and each
// read all of K and V from L2.
//
// Design:
// - A block owns (bh, 64 queries, a block of output columns): grid (T/64,
//   BH, CB); two consumer warpgroups and one producer warp, 288 threads, one
//   block per SM. ptxas holds a thread of a block of 9-12 warps to 168
//   registers (setmaxnreg did not raise that for the consumers, measured on
//   an H100), and a consumer needs about 150 with two 64-column chunks of O
//   (64 fp32 registers) beside S and P; with three or four it spilled and
//   serialised its wgmma. So each consumer owns NO = 2 chunks of O at D = 256
//   and 512 and 1 at D = 384, and a row's D/64 chunks are split over CB = 1,
//   2 and 3 column blocks. Each column block reduces all of S itself: at
//   D = 512 the tensor work is 1.5x the minimum (the bound rises from 0.278
//   to 0.417 ms at (8, 4096, 512)), at D = 384 2x.
// - TMA brings every load in 64-column boxes with 128-byte swizzle (one
//   64-wide bf16 row is one swizzle span): one 3-D tensor map per operand
//   over (D, T, BH), box (64, 64, 1), 8 KB. Q arrives once, D/64 boxes (64 KB
//   at D = 512). Each 64-key tile's K (all D/64 chunks) lands in one K slot
//   and its V (the block's 2 NO chunks) in one of two V slots, each slot
//   guarded by one "full" mbarrier (expect_tx bytes) and one "empty" one
//   that all eight consumer warps arrive on: four barrier operations per
//   warp and tile. (A ring of 8 KB chunk slots with a barrier pair each took
//   about 30 per warp and tile, and that bookkeeping alone cost 0.93 ms of
//   1.70 at (8, 4096, 512) on an H100.) K of tile j + 1 loads once both
//   consumers have finished Q K_j^T, under the exchange, softmax and PV
//   product of tile j; V of tile j + 1 loads once P_{j-1} V_{j-1} is done.
//   Shared memory: 230,456 B at D = 512 (Q 64 KB, K 64 KB, V 2 x 32 KB,
//   exchange 32 KB).
// - S = Q K^T (64 x 64 per key tile): wgmma m64n64k16, both operands from
//   shared memory, K-major, 128-byte-swizzle descriptors; four k-steps per
//   64-column chunk, the start address advancing 32 bytes inside the swizzle
//   atom. Each consumer reduces over its own half of d (D/128 chunks) and the
//   two partial S are summed through shared memory (M2): each consumer
//   stores its partial in its own 16 KB buffer, named barrier 1 waits for
//   both, each adds the other's, and named barrier 2 frees the buffers.
//   Thread t of both holds the same elements, and fp32 addition commutes,
//   so both hold the same S bit for bit and run the same softmax. The
//   exchange has no branch on the consumer: a branch that wrote S on two
//   paths made ptxas serialise the wgmma. (M1, each consumer reducing over
//   all of d with no exchange, measured 2.2x slower on an H100.)
// - The softmax stays in registers on the accumulator layout (rows g and
//   g + 8 of each warp's 16, columns 8n + 2*t4 + {0, 1}).
// - O += P V: wgmma m64n64k16 with A from registers (P packed to bf16: for
//   each 16-key step the accumulator layout is the register-A fragment
//   layout) and B a V chunk from shared memory, MN-major (d contiguous, the
//   transpose-B immediate set): per own 64-column chunk four k-steps, the
//   descriptor advancing 16 rows * 128 B = 2048 B per step.
// - Softmax under the products: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are
//   issued together; a consumer waits for S_j alone, exchanges and runs its
//   softmax while the tensor cores finish P_{j-1} V_{j-1}, then rescales O
//   and packs P_j.
// - exp2 is one ex2.approx.ftz instruction: a probability below 2^-126 of its
//   row's maximum becomes 0, far under the bf16 rounding of P.
// - Epilogue: each consumer divides by l, rounds once to bf16 and stores its
//   columns straight to global memory as bf16x2.
//
// stream_supported admits T >= 1024 with T % 1024 == 0, so the 64-query
// blocks and 64-key tiles need no masking; any other shape returns
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

constexpr int kBM = 64;           // queries per block
constexpr int kBN = 64;           // keys per tile
constexpr int kChunk = 64;        // columns per TMA box: one 128-byte swizzle span
constexpr int kThreads = 288;     // two consumer warpgroups (warps 0-7), a producer warp (8)
constexpr int kConsumerWarps = 8;
constexpr uint32_t kChunkBytes = kBN * kChunk * 2;    // one 64 x 64 bf16 chunk: 8 KB
constexpr uint32_t kXchgBytes = 2 * kBM * kBN * 4;    // two 64 x 64 fp32 partial S: 32 KB
constexpr size_t kSmemLimit = 232448;                 // the H100's opt-in per block
constexpr float kNegBig = -1e30f;

// 64-column chunks of O a consumer owns at head width D, and column blocks
// per row
template <int D>
__host__ __device__ constexpr int out_chunks() {
  return (D / kChunk) % 4 == 0 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int col_blocks() {
  return D / kChunk / (2 * out_chunks<D>());
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q and one K tile (D/64 chunks each), two V tiles (2 NO chunks each), the
  // exchange buffers, seven barriers, 1024 bytes of slack to align the
  // swizzled chunks
  return size_t(kChunkBytes) * (2 * (D / kChunk) + 4 * out_chunks<D>()) + kXchgBytes + 8 * 7 +
         1024;
}

static_assert(smem_bytes<512>() <= kSmemLimit && smem_bytes<384>() <= kSmemLimit &&
                  smem_bytes<256>() <= kSmemLimit,
              "the block must fit the opt-in shared memory");

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
// mbarrier, named barriers and TMA
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

// the two consumer warpgroups (256 threads) on named barrier `id`
__device__ __forceinline__ void consumers_sync(uint32_t id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// box (64, 64, 1) at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing its bytes of the barrier's expected transaction count
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

// online-softmax statistics of one 64-key tile of S (the accumulator layout:
// rows g and g + 8 of the warp's 16, s[4n + {0, 1}] and s[4n + {2, 3}] at
// columns 8n + 2 t4 + {0, 1}): s becomes exp2(s - m_new), m and l move on,
// and corr is the factor O must be rescaled by. The four threads of a row
// are lanes 4g .. 4g + 3.
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
__global__ void __launch_bounds__(kThreads, 1)
attention_stream_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int seq) {
  constexpr int NC = D / kChunk;        // 64-column chunks of a row: 4, 6 or 8
  constexpr int NH = NC / 2;            // a consumer's chunks of the d-reduction
  constexpr int NO = out_chunks<D>();   // a consumer's chunks of O
  constexpr int NV = 2 * NO;            // V chunks of a tile this block reads
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled chunks start on 1024-byte boundaries
  const uint32_t q_base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_slot = q_base + kChunkBytes * NC;
  const uint32_t v_slots = k_slot + kChunkBytes * NC;
  const uint32_t xchg = v_slots + kChunkBytes * 2 * NV;
  const uint32_t bars = xchg + kXchgBytes;
  // one barrier pair per slot: "full" completes when the slot's chunks have
  // landed (expect_tx bytes), "empty" when all eight consumer warps are done
  // with them
  const uint32_t q_bar = bars, full_k = bars + 8, empty_k = bars + 16;
  auto v_slot = [&](int j) { return v_slots + kChunkBytes * NV * (j & 1); };
  auto full_v = [&](int j) { return bars + 24 + 8 * (j & 1); };
  auto empty_v = [&](int j) { return bars + 40 + 8 * (j & 1); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = warp >> 2;  // 0, 1: consumers of the block's O chunks [w NO, (w + 1) NO); 2: producer
  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int z = blockIdx.z;  // column block: V and O chunks [z NV, (z + 1) NV)
  const int n_tiles = seq / kBN;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    mbar_init(full_k, 1);
    mbar_init(empty_k, kConsumerWarps);
    for (int b = 0; b < 2; ++b) {
      mbar_init(full_v(b), 1);
      mbar_init(empty_v(b), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread loads Q, then K of tile j into the K slot once
    // every consumer has finished Q K_{j-1}^T, and V of tile j into V slot
    // j % 2 once every consumer has finished P_{j-2} V_{j-2}
    if (lane == 0) {
      mbar_expect_tx(q_bar, kChunkBytes * NC);
      for (int c = 0; c < NC; ++c)
        tma_load_3d(q_base + kChunkBytes * c, &tq, q_bar, c * kChunk, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= 1) mbar_wait(empty_k, (j - 1) & 1);
        mbar_expect_tx(full_k, kChunkBytes * NC);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(k_slot + kChunkBytes * c, &tk, full_k, c * kChunk, j * kBN, bh);
        if (j >= 2) mbar_wait(empty_v(j), ((j >> 1) - 1) & 1);
        mbar_expect_tx(full_v(j), kChunkBytes * NV);
        for (int c = 0; c < NV; ++c)
          tma_load_3d(v_slot(j) + kChunkBytes * c, &tv, full_v(j), (z * NV + c) * kChunk, j * kBN,
                      bh);
      }
    }
  } else {
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int tw = tid & 127;       // thread within the consumer warpgroup
    float* const xbuf = reinterpret_cast<float*>(smem_raw + (xchg - smem_u32(smem_raw)));

    auto release = [&](uint32_t empty_bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar);
    };
    auto qk = [&](float (&s)[32], int j) {  // Q K_j^T over this consumer's half of d
      const int first = w * NH;
      mbar_wait(full_k, j & 1);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const uint32_t qa = q_base + kChunkBytes * (first + i);
        const uint32_t ka = k_slot + kChunkBytes * (first + i);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          if (i == 0 && kk == 0)
            wgmma_m64n64k16_ss<false>(s, desc_sw128(qa), desc_sw128(ka));
          else
            wgmma_m64n64k16_ss<true>(s, desc_sw128(qa + 32 * kk), desc_sw128(ka + 32 * kk));
        }
      }
      wgmma_commit();
    };
    auto pv = [&](float (&oacc)[NO][32], const uint32_t (&p)[kBN / 16][4], int j) {
      // O += P V_j over this consumer's column chunks: four k-steps of 16 keys
      const uint32_t base = v_slot(j) + kChunkBytes * (w * NO);
      mbar_wait(full_v(j), (j >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < NO; ++i) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_m64n64k16_rs(oacc[i], p[kk], desc_sw128(base + kChunkBytes * i + 2048 * kk));
      }
      wgmma_commit();
    };
    // the two partial S summed: each consumer stores its own and adds the
    // other's; thread tw of both holds the same elements of S
    auto exchange = [&](float (&s)[32]) {
      float* mine = xbuf + w * (kBM * kBN) + tw;
      const float* other = xbuf + (1 - w) * (kBM * kBN) + tw;
#pragma unroll
      for (int i = 0; i < 32; ++i) mine[128 * i] = s[i];
      consumers_sync(1);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += other[128 * i];
      consumers_sync(2);  // both have read: the buffers may take the next tile
    };

    float s[32], oacc[NO][32], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < NO; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[i][e] = 0.f;

    // tile 0: S alone, its softmax, P
    mbar_wait(q_bar, 0);
    qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k);
    exchange(s);
    softmax_tile(s, m, l, corr);
    pack_p(s, p);

    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together; the
    // exchange and softmax of S_j run while the tensor cores finish
    // P_{j-1} V_{j-1}
    for (int j = 1; j < n_tiles; ++j) {
      qk(s, j);
      pv(oacc, p, j - 1);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      release(empty_k);
      exchange(s);
      softmax_tile(s, m, l, corr);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(p);
      release(empty_v(j - 1));
#pragma unroll
      for (int i = 0; i < NO; ++i) {
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            oacc[i][4 * n + 2 * r] *= corr[r];
            oacc[i][4 * n + 2 * r + 1] *= corr[r];
          }
        }
      }
      pack_p(s, p);
    }
    pv(oacc, p, n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(oacc);
    release(empty_v(n_tiles - 1));

    // epilogue: divide by the row sum, round once, store bf16x2 rows
    const int row = q0 + (warp & 3) * 16 + g;
    bf16* ob = o + ((long long)bh * seq + row) * D + (z * NV + w * NO) * kChunk + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 0; i < NO; ++i)
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(8 * r) * D + i * kChunk + 8 * n) =
              __floats2bfloat162_rn(oacc[i][4 * n + 2 * r] * inv,
                                    oacc[i][4 * n + 2 * r + 1] * inv);
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

// (d, seq, bh) bf16 at ptr, box (64, 64, 1), 128-byte swizzle
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
  // the shared-memory limit is set once per device and width, not on every launch
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_stream_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes<D>()));
    if (err != cudaSuccess) return int(err);
    smem_set[dev] = true;
  }
  const dim3 grid(seq / kBM, bh, col_blocks<D>());
  attention_stream_sm90<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), seq);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, seq, d) bf16, contiguous, 16-byte aligned; d in {256,
// 384, 512}, seq % 64 == 0 and seq >= 128. The signature is
// ur_attention_stream's.
int ur_attention_stream_sm90(const void* q, const void* k, const void* v, void* o, int bh,
                             int seq, int d, int dtype, void* stream) {
  if (dtype != kBFloat16 || bh <= 0 || bh > 65535 || seq < 2 * kBN || seq % kBN != 0 ||
      (d != 256 && d != 384 && d != 512))
    return int(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_map(encode, &tq, q, bh, seq, d) || !encode_map(encode, &tk, k, bh, seq, d) ||
      !encode_map(encode, &tv, v, bh, seq, d))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 256) return launch<256>(tq, tk, tv, o, bh, seq, s);
  if (d == 384) return launch<384>(tq, tk, tv, o, bh, seq, s);
  return launch<512>(tq, tk, tv, o, bh, seq, s);
}

}  // extern "C"
