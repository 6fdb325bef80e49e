// Out-projection-fused channel-flat attention for Hopper (sm_90a) on wgmma,
// TMA and thread-block clusters: the bf16 path of
// fused_attention_btc_out_prescaled, replacing the Pallas TPU kernel
// _btc_out_kernel (unirestore_tpu/nn/pallas_attention.py:269, pallas_call
// :311).
//
//   ur_attention_btc_out_sm90: q, k, v (B, T, H*64) bf16, q prescaled by
//   64^-1/2 * log2(e); wo (H*64, C) bf16; out (B, T, C) bf16; all contiguous.
//     o_h = softmax_2(q_h k_h^T) v_h       per 64-wide head h
//     out = sum_h o_h wo[64h : 64h + 64]   (the bias stays with the caller)
//   with fp32 logits, an online base-2 softmax with fp32 running max and row
//   sum, the probabilities rounded to bf16 before the PV product, each head's
//   output divided by its row sum and rounded to bf16, then the product over
//   inner summed in fp32 and rounded once: the function of
//   attention_btc_out_plain (nn/attention_kernels.py) and of
//   csrc/attention.cu:ur_attention_btc_out, which keeps serving fp32 and
//   whose bf16 mma.sync body (attention_fwd_out_mma) is the yardstick
//   chip_smoke.py times beside this kernel.
//
// What bounds it on the H100: the attention's 4*B*H*T^2*64 operations plus
// the out-projection's 2*B*T*inner*C, against (3*B*T*inner + inner*C +
// B*T*C)*2 bytes. At the restore's shapes (B, T, inner), C = inner:
//   (8, 4096, 320): 178.5 GFLOP,  84 MB -> 0.1805 ms at 989 TFLOP/s
//   (8, 1024, 640):  28.2 GFLOP,  42 MB -> 0.0285 ms
//   (8, 4096, 256): 141.7 GFLOP,  67 MB -> 0.1433 ms
//   (8, 1024, 256):   9.7 GFLOP,  17 MB -> 0.0098 ms
// so the tensor cores bound it everywhere; the exp2 of the softmax (B*H*T^2
// on the special-function units) is as large as the products at T = 4096
// and has to run under them, as in ur_attention_btc_sm90. The out-projection
// is 4 % of the operations at T = 4096 but 24 % at (8, 1024, 640).
//
// Design (milestone M2, G chosen per launch; M1 is the same kernel at G = 1):
// - The attention body is ur_attention_btc_sm90's (csrc/attention_sm90.cu;
//   its helpers are copied here, as each sm90 source carries its own): two
//   consumer warpgroups of 64 query rows and a producer warpgroup
//   (setmaxnreg 56 / 224), 3-D tensor maps over (inner, T, B) with 128-byte
//   swizzle (a 64-wide head row is one swizzle span), a three-stage K/V TMA
//   ring, S by wgmma m64n128k16 and P V by m64n64k16 with P from registers,
//   the softmax of tile j under P_{j-1} V_{j-1}, ex2.approx.ftz.
// - A cluster of G CTAs owns (batch, 128 queries); grid (G*T/128, B). CTA r
//   attends to heads r, r + G, r + 2G, ... in turn (Q double-buffered, the
//   ring running on across heads) and writes each head's normalised output,
//   rounded to bf16, by stmatrix into a 16 KB head slot of its own shared
//   memory: 128 rows of 128 bytes, 128-byte-swizzled as TMA would lay out Q,
//   so a slot is a K-major wgmma A operand by descriptor.
// - A cluster barrier, then CTA r computes its share of the C/64 output
//   chunks of 64 columns, from all H heads, NQ chunks a pass: per head,
//   wgmma m64n(64 NQ)k16 with A the head's slot (this warpgroup's 64 rows)
//   and B NQ (64 inner rows, 64 columns) boxes of wo brought by TMA (2-D map
//   over (C, inner), 128-byte swizzle: MN-major like the V tile, the boxes
//   8 KB apart), fp32 accumulators in registers. A peer's
//   slot is copied by the producer warpgroup (ld.shared::cluster, 16 bytes
//   a thread) into one of two local staging slots; wo tiles come through a
//   four-stage ring. Staging and wo ring reuse the Q and K/V space, which
//   the cluster barrier frees. A second cluster barrier ends the kernel, so
//   no CTA leaves while a peer may still read its slots.
// - G (host: cluster_size, up to 8, the portable cluster size) is chosen
//   per launch from the grid: the smallest G whose head slots fit shared
//   memory (ceil(H/G) <= 5) and whose B*T/128*G CTAs fill half the SMs.
//   G = 1 (milestone M1, no exchange) at T = 4096 and batch 4-8; 2 at
//   (8, 1024, *) and T = 6144; 4 at (1, 1536, 256), 6 at (1, 1536, 640).
//   G need not divide H: CTA r takes ceil((H - r)/G) heads, and the column
//   chunks are split as evenly (a CTA may get none), so a prime H > 8 runs
//   too (G = 1 would not fit it).
// - Shared memory: ceil(H/G) head slots, two Q slots and the K/V ring (the
//   staging slots and wo ring in their place), barriers: 145 KB at one head
//   a CTA, 16 KB more a head, 209 KB at five; one CTA an SM.
// - The epilogue's passes take up to 3 output chunks (96 fp32 accumulator
//   registers a thread; 4 spilled), so a peer's slot is copied once a pass,
//   not once a chunk; a pass past the CTA's last chunk computes that chunk
//   again and does not store it.
// - The bf16 head outputs do not depend on G; the fp32 sums over inner run
//   head by head, 16 rows of wo at a time, in another order than the plain
//   version's matmul (bf16_out_tolerance_ratio covers it).
// Tried and left out (measured on an H100, PERF.md): G for the fewest heads
// a CTA (5 at H = 5) was 28 % slower than G = 1 at (8, 4096, 320), since
// clusters of 4-6 CTAs pack fewer CTAs onto the card; one m64n64k16 per
// output chunk (A read once per chunk); passes of 4 chunks (12 bytes of
// spill); a 48-register producer, which spilled in the slot copy and made
// the kernel fail. M1 with 64-query blocks for H > 5 was not built: M2
// serves those shapes.
//
// _btc_out_dims admits T >= 1024 with T % 256 == 0, inner = 64*H <= 1536 and
// C % 128 == 0 or C in {320, 640}; the entry takes T % 128 == 0, inner %
// 64 == 0 and C % 64 == 0, and returns cudaErrorInvalidValue for any other
// shape or a dtype other than bf16. It encodes the tensor maps from the
// pointers and dims it is given, with cuTensorMapEncodeTiled from
// cudaGetDriverEntryPoint (no -lcuda), launches with cudaLaunchKernelEx and
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;             // head width
constexpr int kBM = 128;           // queries per cluster
constexpr int kBN = 128;           // keys per tile
constexpr int kStages = 3;         // K/V ring stages
constexpr int kThreads = 384;      // a producer warpgroup, two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerThreads = 128;
// registers per thread after setmaxnreg: 128 * 56 + 256 * 224 = 64,512;
// the producer's copy of a peer slot keeps 32 registers of loads in flight
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr uint32_t kTileBytes = kBN * kD * 2;  // one 128 x 64 bf16 tile or head slot: 16 KB
constexpr uint32_t kChunkBytes = kD * 64 * 2;  // one (64 inner rows, 64 columns) wo tile: 8 KB
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kMaxChunks = 3;                  // output chunks of an epilogue pass
constexpr int kWoStages = 4;                   // wo ring stages of the epilogue
constexpr int kBarriers = 22;
constexpr int kMaxSmem = 232448;               // the opt-in limit per block
constexpr float kNegBig = -1e30f;

// barriers, by index: Q full / empty per slot, K/V full / empty per stage,
// wo full / empty per stage, staging full / empty per slot
constexpr int kQFull = 0, kQEmpty = 2, kFull = 4, kEmpty = 7, kWoFull = 10, kWoEmpty = 14,
              kStFull = 18, kStEmpty = 20;
static_assert(kStEmpty + 2 == kBarriers, "barrier count");
// the epilogue's two staging slots and its wo ring of the widest passes
// fit where the two Q slots and the K/V ring were
static_assert(2 * kTileBytes + kWoStages * kMaxChunks * kChunkBytes <=
                  (2 + 2 * kStages) * kTileBytes,
              "the epilogue's buffers overflow the attention's");

// shared memory of a CTA with `slots` head slots: 1024 bytes of slack to
// align the swizzled tiles, the head slots, two Q slots, the K/V ring,
// barriers (attention_kernels.btc_out_sm90_smem_bytes copies this)
__host__ __device__ constexpr size_t smem_bytes(int slots) {
  return 1024 + size_t(kTileBytes) * (slots + 2 + 2 * kStages) + 8 * kBarriers;
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, cluster
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

// box (64, 128, 1) at (c0, c1, c2) of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// box (64, 64) at (c0, c1) of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: writes before it (shared memory
// included) are visible to reads after it in any CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// this thread's 16 bytes of each 2 KB row of a peer's 16 KB head slot,
// all eight loads in flight at once, copied into the same places of a local
// staging slot (both 1024-byte aligned, so the 128-byte swizzle carries
// over), then made visible to wgmma (the async proxy)
__device__ __forceinline__ void pull_slice(uint32_t dst, uint32_t src_local, int owner,
                                           int ptid) {
  uint32_t src;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(src) : "r"(src_local), "r"(owner));
  uint32_t r[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[i][0]), "=r"(r[i][1]), "=r"(r[i][2]), "=r"(r[i][3])
                 : "r"(src + i * 2048 + ptid * 16)
                 : "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + i * 2048 + ptid * 16),
                 "r"(r[i][0]), "r"(r[i][1]), "r"(r[i][2]), "r"(r[i][3])
                 : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle. For the K-major tiles
// (Q, K, a head slot) SBO is the 1024-byte stride between 8-row groups and
// LBO is unused; for the MN-major tiles with N = 64 (V, a wo tile: one
// swizzle span) SBO is the stride between 8-row groups of k and LBO, the
// stride between 64-column spans, is unused. Both take 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (kStride << 16) | (kStride << 32) | (1ull << 62);
}

// the same for an MN-major B of several 64-column spans (a wo stage of NQ
// chunks), each 64 rows of 128 bytes: LBO, the stride between spans, is
// one chunk (8 KB); SBO, between 8-row groups of k, 1024 bytes
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  constexpr uint64_t kSpan = (kD * 64 * 2) >> 4;
  constexpr uint64_t kStride = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (kSpan << 16) | (kStride << 32) | (1ull << 62);
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
// memory MN-major (the transpose-B immediate is 1)
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

// d (64 x N, fp32) += A (64 x 16) B (16 x N), A K-major and B MN-major in
// shared memory (transpose-A 0, transpose-B 1); N = 64, 128 or 192, B made
// of N / 64 spans of 64 columns (desc_mn)
template <int N>
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss_tb<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : UR_F8("+f", d, 0), UR_F8("+f", d, 8), UR_F8("+f", d, 16), UR_F8("+f", d, 24)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss_tb<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : UR_F8("+f", d, 0), UR_F8("+f", d, 8), UR_F8("+f", d, 16), UR_F8("+f", d, 24),
        UR_F8("+f", d, 32), UR_F8("+f", d, 40), UR_F8("+f", d, 48), UR_F8("+f", d, 56)
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss_tb<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : UR_F8("+f", d, 0), UR_F8("+f", d, 8), UR_F8("+f", d, 16), UR_F8("+f", d, 24),
        UR_F8("+f", d, 32), UR_F8("+f", d, 40), UR_F8("+f", d, 48), UR_F8("+f", d, 56),
        UR_F8("+f", d, 64), UR_F8("+f", d, 72), UR_F8("+f", d, 80), UR_F8("+f", d, 88)
      : "l"(da), "l"(db), "r"(1));
}

#undef UR_SS_M64N128K16
#undef UR_F64
#undef UR_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// four 8 x 8 bf16 matrices from registers into shared memory; lane l gives
// the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
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

// acc += A (this warpgroup's 64 rows of a head slot, 64 inner columns)
// times a wo stage (64 inner rows, NQ chunks of 64 output columns, 8 KB
// apart): four k-steps of m64n(64 NQ)k16, A advancing 32 bytes inside the
// swizzle atom, B 16 rows. acc holds chunk c's accumulator at 32 c.
template <int NQ>
__device__ __forceinline__ void epilogue_products(float (&acc)[NQ * 32], uint32_t a_rows,
                                                  uint32_t wo_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_tb<64 * NQ>(acc, desc_sw128(a_rows + 32 * kk), desc_mn(wo_tile + 2048 * kk));
  wgmma_commit();
}

template <int NQ>
__global__ void __launch_bounds__(kThreads, 1)
attention_out_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap two,
                   bf16* __restrict__ out, int seq, int heads, int c_out, int groups) {
  static_assert(NQ >= 1 && NQ <= kMaxChunks, "epilogue pass width");
  extern __shared__ unsigned char smem_raw[];
  const int rank = int(cluster_ctarank());
  const int n_own = (heads - rank + groups - 1) / groups;  // heads rank, rank + G, ...
  const int slots = (heads + groups - 1) / groups;
  // 128-byte-swizzled tiles start on 1024-byte boundaries: the head slots,
  // then a region that holds two Q slots and the K/V ring while the heads
  // are attended, two staging slots and the wo ring in the epilogue
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t region = base + kTileBytes * slots;
  const uint32_t bars = region + kTileBytes * (2 + 2 * kStages);
  auto o_slot = [&](int i) { return base + kTileBytes * i; };
  auto q_tile = [&](int s) { return region + kTileBytes * s; };
  auto k_tile = [&](int s) { return region + kTileBytes * (2 + 2 * s); };
  auto v_tile = [&](int s) { return region + kTileBytes * (3 + 2 * s); };
  auto stage_slot = [&](int p) { return region + kTileBytes * p; };
  auto wo_stage = [&](int w) { return region + kTileBytes * 2 + NQ * kChunkBytes * w; };
  auto bar = [&](int i) { return bars + 8 * i; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;  // 0: producer; 1, 2: consumers of query rows 64 (wg - 1) + [0, 64)
  const int q0 = (blockIdx.x / groups) * kBM;
  const int b = blockIdx.y;
  const int n_tiles = seq / kBN;
  // this CTA's output chunks of 64 columns, NQ a pass; a pass past c_hi
  // computes its last chunk again and does not store it
  const int n_chunks = c_out / 64;
  const int c_lo = n_chunks * rank / groups;
  const int c_hi = n_chunks * (rank + 1) / groups;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar(kQFull + s), 1);
      mbar_init(bar(kQEmpty + s), kConsumerWarps);
      mbar_init(bar(kStFull + s), kProducerThreads);
      mbar_init(bar(kStEmpty + s), kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kFull + s), 1);
      mbar_init(bar(kEmpty + s), kConsumerWarps);
    }
    for (int s = 0; s < kWoStages; ++s) {
      mbar_init(bar(kWoFull + s), 1);
      mbar_init(bar(kWoEmpty + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the heads: Q of head i into slot i % 2 once the consumers released
    // the head two before it; K and V of its tile j into the ring stage of
    // the running tile count n once they released tile n - kStages
    if (tid == 0) {
      for (int i = 0; i < n_own; ++i) {
        const int h = rank + i * groups;
        const int qs = i & 1;
        if (i >= 2) mbar_wait(bar(kQEmpty + qs), ((i >> 1) - 1) & 1);
        mbar_expect_tx(bar(kQFull + qs), kTileBytes);
        tma_load_3d(q_tile(qs), &tq, bar(kQFull + qs), h * kD, q0, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int n = i * n_tiles + j;
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(bar(kEmpty + s), ((n / kStages) - 1) & 1);
          mbar_expect_tx(bar(kFull + s), 2 * kTileBytes);
          tma_load_3d(k_tile(s), &tk, bar(kFull + s), h * kD, j * kBN, b);
          tma_load_3d(v_tile(s), &tv, bar(kFull + s), h * kD, j * kBN, b);
        }
      }
    }
    cluster_sync();  // every head slot of the cluster is written; the region is free
    // the epilogue: per output pass and head, the wo tiles by TMA (thread 0)
    // and, for a peer's head, its slot copied into a staging slot (all 128)
    int e = 0, pulls = 0;
    for (int c0 = c_lo; c0 < c_hi; c0 += NQ) {
      for (int h = 0; h < heads; ++h, ++e) {
        const int ws = e % kWoStages;
        if (tid == 0) {
          if (e >= kWoStages) mbar_wait(bar(kWoEmpty + ws), ((e / kWoStages) - 1) & 1);
          mbar_expect_tx(bar(kWoFull + ws), NQ * kChunkBytes);
#pragma unroll
          for (int c = 0; c < NQ; ++c)
            tma_load_2d(wo_stage(ws) + c * kChunkBytes, &two, bar(kWoFull + ws),
                        min(c0 + c, c_hi - 1) * 64, h * kD);
        }
        if (h % groups != rank) {
          const int ps = pulls & 1;
          if (pulls >= 2) mbar_wait(bar(kStEmpty + ps), ((pulls >> 1) - 1) & 1);
          pull_slice(stage_slot(ps), o_slot(h / groups), h % groups, tid);
          mbar_arrive(bar(kStFull + ps));
          ++pulls;
        }
      }
    }
    cluster_sync();  // no CTA leaves while a peer may still read its head slots
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int cw = wg - 1;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };

    for (int i = 0; i < n_own; ++i) {
      const int qs = i & 1;
      const uint32_t q_rows = q_tile(qs) + cw * 64 * 128;  // this warpgroup's 64 rows
      auto qk = [&](float (&s)[64], int st) {  // S = Q K^T: four k-steps of 16 over d = 64
        wgmma_m64n128k16_ss<false>(s, desc_sw128(q_rows), desc_sw128(k_tile(st)));
#pragma unroll
        for (int kk = 1; kk < kD / 16; ++kk)
          wgmma_m64n128k16_ss<true>(s, desc_sw128(q_rows + 32 * kk),
                                    desc_sw128(k_tile(st) + 32 * kk));
        wgmma_commit();
      };
      auto pv = [&](float (&oacc)[32], const uint32_t (&p)[kBN / 16][4], int st) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_m64n64k16_rs(oacc, p[kk], desc_sw128(v_tile(st) + 2048 * kk));
        wgmma_commit();
      };

      float s[64], oacc[32], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f}, corr[2];
      uint32_t p[kBN / 16][4];
#pragma unroll
      for (int x = 0; x < 32; ++x) oacc[x] = 0.f;

      // tile 0: S alone, its softmax, P
      const int n0 = i * n_tiles;
      mbar_wait(bar(kQFull + qs), (i >> 1) & 1);
      mbar_wait(bar(kFull + n0 % kStages), (n0 / kStages) & 1);
      wgmma_fence();
      qk(s, n0 % kStages);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, corr);
      pack_p(s, p);

      // tile j: S_j and O += P_{j-1} V_{j-1} issued together; the softmax
      // of S_j runs while the tensor cores finish P_{j-1} V_{j-1}
      for (int j = 1; j < n_tiles; ++j) {
        const int n = n0 + j;
        const int st = n % kStages;
        const int prev = (n - 1) % kStages;
        mbar_wait(bar(kFull + st), (n / kStages) & 1);
        wgmma_fence();
        qk(s, st);
        pv(oacc, p, prev);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
        fence_regs(s);
        softmax_tile(s, m, l, corr);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(p);
        release(bar(kEmpty + prev));
#pragma unroll
        for (int x = 0; x < kD / 8; ++x) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            oacc[4 * x + 2 * r] *= corr[r];
            oacc[4 * x + 2 * r + 1] *= corr[r];
          }
        }
        pack_p(s, p);
      }
      wgmma_fence();
      pv(oacc, p, (n0 + n_tiles - 1) % kStages);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(bar(kEmpty + (n0 + n_tiles - 1) % kStages));
      release(bar(kQEmpty + qs));

      // the head's output, divided by the row sum and rounded once, into
      // head slot i: rows 16 (warp % 4) + {g, g + 8} of this warpgroup's 64,
      // 8-column blocks x and x + 1 per stmatrix, 128-byte swizzled
      const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
      const int mrow = cw * 64 + (warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const uint32_t row_addr = o_slot(i) + mrow * 128;
#pragma unroll
      for (int x = 0; x < kD / 8; x += 2) {
        const int blk = x + (lane >> 4);
        stmatrix_x4(row_addr + ((blk ^ (mrow & 7)) << 4),
                    pack_bf16(oacc[4 * x] * inv0, oacc[4 * x + 1] * inv0),
                    pack_bf16(oacc[4 * x + 2] * inv1, oacc[4 * x + 3] * inv1),
                    pack_bf16(oacc[4 * x + 4] * inv0, oacc[4 * x + 5] * inv0),
                    pack_bf16(oacc[4 * x + 6] * inv1, oacc[4 * x + 7] * inv1));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slots, for wgmma
    cluster_sync();

    // the epilogue: per pass of NQ output chunks, every head's slot (own or
    // staged from its owner) times its wo tiles, one head in flight
    int e = 0, pulls = 0;
    for (int c0 = c_lo; c0 < c_hi; c0 += NQ) {
      float acc[NQ * 32];
#pragma unroll
      for (int x = 0; x < NQ * 32; ++x) acc[x] = 0.f;
      int prev_ws = -1, prev_ps = -1;
      for (int h = 0; h < heads; ++h, ++e) {
        const int ws = e % kWoStages;
        int ps = -1;
        uint32_t a_rows = o_slot(h / groups);
        if (h % groups != rank) {
          ps = pulls & 1;
          mbar_wait(bar(kStFull + ps), (pulls >> 1) & 1);
          a_rows = stage_slot(ps);
          ++pulls;
        }
        a_rows += cw * 64 * 128;
        mbar_wait(bar(kWoFull + ws), (e / kWoStages) & 1);
        wgmma_fence();
        epilogue_products<NQ>(acc, a_rows, wo_stage(ws));
        wgmma_wait<1>();  // the head before this one is done: free its buffers
        if (prev_ws >= 0) release(bar(kWoEmpty + prev_ws));
        if (prev_ps >= 0) release(bar(kStEmpty + prev_ps));
        prev_ws = ws;
        prev_ps = ps;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev_ws >= 0) release(bar(kWoEmpty + prev_ws));
      if (prev_ps >= 0) release(bar(kStEmpty + prev_ps));

      // round once, store bf16x2 rows
      const int row = q0 + cw * 64 + (warp & 3) * 16 + g;
      bf16* ob = out + ((long long)b * seq + row) * c_out + c0 * 64 + 2 * t4;
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        if (c0 + c >= c_hi) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(8 * r) * c_out + 64 * c + 8 * x) =
                __floats2bfloat162_rn(acc[32 * c + 4 * x + 2 * r], acc[32 * c + 4 * x + 2 * r + 1]);
      }
    }
    cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// G: the smallest G <= kMaxCluster whose head slots fit shared memory and
// whose G * blocks CTAs (blocks = batch * seq / 128, one CTA an SM) fill at
// least half the SMs, else the largest G whose slots fit. Measured on an
// H100 (PERF.md): clusters of 4-5 CTAs run 30-50 % slower than G = 1 where
// the grid already fills the card, G = 2 costs little, and below half the
// SMs more CTAs win (attention_kernels.btc_out_sm90_cluster copies this)
int cluster_size(int heads, int blocks, int sms) {
  int best = 0;
  for (int g = 1; g <= kMaxCluster && g <= heads; ++g) {
    if (smem_bytes((heads + g - 1) / g) > size_t(kMaxSmem)) continue;
    best = g;
    if (2LL * g * blocks >= sms) break;
  }
  return best;
}

// output chunks an epilogue pass takes: the most chunks a CTA has (its
// share of C / 64), in the fewest passes of at most kMaxChunks, evened out
// (attention_kernels.btc_out_sm90_chunk_group copies this)
int chunk_group(int c_out, int groups) {
  const int most = (c_out / 64 + groups - 1) / groups;
  const int passes = (most + kMaxChunks - 1) / kMaxChunks;
  return (most + passes - 1) / passes;
}

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

// a bf16 tensor map with 128-byte swizzle over `rank` dims (innermost first)
bool encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const void* ptr,
                cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kBFloat16 = 1;  // dtype code shared with attention_kernels.py
constexpr int kMaxDevices = 64;

// the SM count of the current device, read once per device (0 on an error)
int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 0;
  return count[dev];
}

template <int NQ>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& two, void* out, int batch, int seq, int heads, int c_out,
           int groups, size_t smem, cudaStream_t stream) {
  // the shared-memory limit is set once per device, not on every launch
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_out_sm90<NQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return int(err);
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * (seq / kBM), batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_out_sm90<NQ>, tq, tk, tv, two,
                           static_cast<bf16*>(out), seq, heads, c_out, groups);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v: (batch, seq, inner) bf16 with inner = heads * 64; wo: (inner,
// c_out) bf16; out: (batch, seq, c_out) bf16; all contiguous, 16-byte
// aligned; seq % 128 == 0, c_out % 64 == 0. The signature is
// ur_attention_btc_out's.
int ur_attention_btc_out_sm90(const void* q, const void* k, const void* v, const void* wo,
                              void* out, int batch, int seq, int inner, int c_out, int dtype,
                              void* stream) {
  if (dtype != kBFloat16 || batch <= 0 || seq < kBN || seq % kBM != 0 || inner <= 0 ||
      inner % kD != 0 || c_out <= 0 || c_out % 64 != 0)
    return int(cudaErrorInvalidValue);
  const int heads = inner / kD;
  const int sms = sm_count();
  if (sms == 0) return int(cudaErrorInvalidDevice);
  const int groups = cluster_size(heads, batch * (seq / kBM), sms);
  if (groups == 0) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes((heads + groups - 1) / groups);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(inner) * 2, cuuint64_t(seq) * inner * 2};
  const cuuint32_t box[3] = {kD, kBN, 1};
  const cuuint64_t wo_dims[2] = {cuuint64_t(c_out), cuuint64_t(inner)};
  const cuuint64_t wo_strides[1] = {cuuint64_t(c_out) * 2};
  const cuuint32_t wo_box[2] = {64, kD};
  CUtensorMap tq, tk, tv, two;
  if (!encode_map(encode, &tq, q, 3, dims, strides, box) ||
      !encode_map(encode, &tk, k, 3, dims, strides, box) ||
      !encode_map(encode, &tv, v, 3, dims, strides, box) ||
      !encode_map(encode, &two, wo, 2, wo_dims, wo_strides, wo_box))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kMaxChunks == 3, "one launch per pass width");
  switch (chunk_group(c_out, groups)) {
    case 1: return launch<1>(tq, tk, tv, two, out, batch, seq, heads, c_out, groups, smem, st);
    case 2: return launch<2>(tq, tk, tv, two, out, batch, seq, heads, c_out, groups, smem, st);
    default: return launch<3>(tq, tk, tv, two, out, batch, seq, heads, c_out, groups, smem, st);
  }
}

}  // extern "C"
