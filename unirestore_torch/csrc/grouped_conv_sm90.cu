// Grouped 3x3 convolution for Hopper (sm_90a) on wgmma and TMA: the bf16
// path of grouped_conv3 (nn/grouped_conv.py), replacing the Pallas TPU
// kernel of unirestore_tpu/nn/pallas_grouped_conv.py (_kernel v2 :80 and
// _kernel_v3 :98, pallas_call :167, entry grouped_conv3_pallas :190), the
// CFRM AdaNAFV2 grouped conv (unirestore_tpu/models/cfrm.py:96).
//
//   ur_grouped_conv3_sm90: x, y (B, H, W, C) bf16 NHWC, w packed per group and
//   tap as (C / cg, 9, cg_out, cg_in), bias (C) or null, cg in {16, 32, 64,
//   128}, any B, H and W;
//     y[b, i, j, g cg + o] = bias[g cg + o]
//         + sum_{dy, dx, c} x[b, i + dy - 1, j + dx - 1, g cg + c] w[g, 3 dy + dx, o, c]
//   SAME padding (zeros outside the map), stride 1; exact bf16 products, fp32
//   sums, the bias added in fp32, one rounding to bf16: the function of
//   grouped_conv3_plain and of csrc/grouped_conv.cu:ur_grouped_conv3, which
//   keeps serving fp32.
//
// What bounds it on the H100: every restore shape does 2 B H W C 9 cg =
// 154.6 GFLOP at batch 8 (0.156 ms at 989 TFLOP/s) and moves its input and
// output once, 1.07 / 0.54 / 0.27 GB (0.320 / 0.160 / 0.080 ms at 3.35 TB/s)
// at (8, 256, 256, 512) / (8, 128, 128, 1024) / (8, 64, 64, 2048), cg = 32 /
// 64 / 128: the bytes bound the first two, the operations the third. The
// mma.sync kernel it replaces (gconv3_mma, 1.18 / 0.64 / 0.66 ms) held one
// group of a 4 x 32 pixel tile per block: each pixel's input came as a
// 64-256 byte slice fetched by 16 blocks at different times, stores were
// 4-byte pieces, and every block ran nine weight copies and eighteen
// barriers in series (PERF.md, step 0).
//
// Design (M2 = M1 at cg <= 32, the transposed product at cg >= 64):
// - A block owns 64 output channels (a "slot": 64 / cg whole groups at cg <=
//   64, half of a group's outputs at cg = 128) and walks output tiles of 8 x
//   16 pixels: persistent, grid (blocks per slot, C / 64 slots), sized to
//   fill the SMs once. The slot's nine taps of weights (18 / 37 / 74 / 147
//   KB at cg = 16 / 32 / 64 / 128) are copied to shared memory once, at block
//   start, K-major under the swizzle their row width allows (32 / 64 / 128
//   bytes; cg = 128 as two 64-channel chunks), and serve every tile.
// - One producer warp and two consumer warpgroups, 288 threads.
// - Halo by TMA: a 4-D tensor map over x as (C, W, H, B), box (64 channels,
//   18, 10, 1) started at (c0, x0 - 1, y0 - 1, b), 128-byte swizzle (one
//   pixel's 64 channels are one swizzle row). TMA zero-fills every
//   coordinate outside the map: the SAME padding and the ragged edges need
//   no predicate. Each halo pixel arrives as 128 contiguous bytes, once per
//   block and tile; cg = 128 takes two boxes per tile (its 128 input
//   channels), the product running over both. Boxes land in rings of stages
//   behind full / empty mbarriers; the producer loads ahead of the products.
// - Epilogue: the bias added in fp32, one rounding, the output tile staged
//   in shared memory (128-byte swizzle, no bank conflicts) and written by one
//   TMA store, which clips what lies outside the map; the next tile's
//   products run while it drains.
// - M1 (gconv3_sm90; cg <= 32, where the bytes bound it): wgmma m64nNk16
//   (N = cg) with A from registers: each warpgroup owns 64 pixels (4 tile
//   rows) of every tile, each warp's 16 pixels x 16 channels of a tap read
//   by ldmatrix straight from the halo at the tap's (dy, dx) offset with the
//   swizzle's XOR applied per row; B, the group's tap slice, by descriptor.
//   The next tap's A fragments load while this tap's products run. One
//   two-stage ring that both warpgroups consume; two blocks an SM; 80
//   registers. Measured (PERF.md) 0.462 ms at (8, 256, 256, 512), where its
//   loads and stores alone take 91 % of it: 2.3 TB/s. At cg >= 64 its
//   products run at about half the tensor-core rate: an m64n64k16 with A by
//   ldmatrix reads 4 KB of shared memory per 32 tensor-core cycles, all of
//   the SM's 128 bytes a cycle.
// - M2 (gconv3_sm90_t; cg >= 64, where the products matter): the product
//   transposed, output channels as M (the slot's 64, the weights by
//   descriptor) and pixels as N: a tile's 8 halo rows are read as 144
//   consecutive halo pixels (N = 144; the 2 pixels past each row's 16 are
//   computed and dropped, 12.5 % more operations), from shared memory by a
//   descriptor that starts at the tap's halo row and column. The card
//   applies the 128-byte swizzle to the absolute address, so such a start
//   needs no base offset (setting it to the start's row in the pattern reads
//   wrong rows). 6.5 KB of shared memory per 72 cycles, no ldmatrix. The two
//   warpgroups take whole tiles in turns, each with a halo ring of its own
//   (two stages at cg = 64, one at 128: a ring shared by both lets a
//   warpgroup that skips the other's fills wait on a parity two phases
//   ahead). The epilogue transposes the 64 x 144 sums through
//   stmatrix.trans into the pixel-major stage; the dropped pixels go to a
//   sink. One block an SM; 119 / 167 registers at cg = 64 / 128. Measured
//   0.273 / 0.237 ms at the restore's two shapes, M1 0.312 / 0.302.
// - C need not be a multiple of 64: a slot's missing groups read zeros and
//   their outputs are clipped.
// - The shared-memory size is set once per device and width, not on every
//   launch.
// Left out: M1 at cg >= 64 (slower, above); the base offset (wrong answers).
//
// The entry encodes the tensor maps from the pointers and dims it is given,
// with cuTensorMapEncodeTiled from cudaGetDriverEntryPoint (no -lcuda), and
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 8;                       // output rows per tile
constexpr int kTW = 16;                      // output columns per tile
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kBoxC = 64;                    // channels per TMA box: one 128-byte swizzle row
constexpr int kSlotC = 64;                   // output channels per block
constexpr uint32_t kBoxBytes = kHaloH * kHaloW * kBoxC * 2;  // 23,040
constexpr uint32_t kStageBytes = (kBoxBytes + 1023) & ~1023u;
constexpr int kStages = 2;                   // halo ring
constexpr int kConsumerWarps = 8;            // two warpgroups of 64 pixels
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr uint32_t kOutBytes = 64 * kSlotC * 2;  // one warpgroup's staged output tile
constexpr size_t kSmemPerSm = 233472;        // the H100's shared memory per SM
constexpr size_t kSmemReserved = 1024;       // the runtime's share per block

// per group width: wgmma N, accumulator sets, B row bytes and k-steps per
// row, weight bytes of a slot
template <int CG>
struct Geom {
  static constexpr int N = CG <= 64 ? CG : 64;
  static constexpr int NACC = kSlotC / N;            // groups per slot (1 at cg = 128)
  static constexpr int KB = CG == 128 ? 2 : 1;       // 64-channel boxes per tile
  static constexpr int ROWB = (CG <= 64 ? CG : 64) * 2;
  static constexpr int KPR = ROWB / 32;              // 16-channel k-steps per B row
  static constexpr uint32_t MATB = N * ROWB;         // one (tap, group, chunk) B matrix
  static constexpr uint32_t WBYTES = 9 * NACC * KB * MATB;
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // descriptor swizzle
};

template <int CG>
__host__ __device__ constexpr size_t smem_bytes() {
  // halo ring, weights, two staged output tiles, barriers (full and empty per
  // stage), 1024 bytes of slack to align the swizzled buffers
  return 1024 + size_t(kStageBytes) * kStages + Geom<CG>::WBYTES + 2 * kOutBytes + 16 * kStages;
}

template <int CG>
__host__ __device__ constexpr int blocks_per_sm() {
  return smem_bytes<CG>() + kSmemReserved <= kSmemPerSm / 2 ? 2 : 1;
}

static_assert(blocks_per_sm<16>() == 2 && blocks_per_sm<32>() == 2 &&
                  blocks_per_sm<64>() == 1 && blocks_per_sm<128>() == 1,
              "two blocks an SM at cg <= 32, one above");
static_assert(smem_bytes<128>() + kSmemReserved <= kSmemPerSm, "cg = 128 fits one SM");

// byte offset o (from a 1024-aligned base) of a row-major tile with rows of
// ROWB bytes -> its place under the ROWB-byte swizzle (16-byte chunk index
// XOR the row's bits above 128 bytes), as TMA and wgmma lay it out
template <int ROWB>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & (ROWB / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, bulk groups
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

// box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory, completing
// its bytes of the barrier's expected transaction count (coordinates outside
// the tensor arrive as zeros and count all the same)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// shared memory -> the box at (c0, c1, c2, c3); elements outside the tensor
// are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
// (TMA stores, wgmma operands)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor of a K-major B operand whose rows are ROWB
// bytes under the ROWB-byte swizzle: SBO is the stride between 8-row groups,
// LBO is unused (one k-step never leaves a swizzle row)
template <int CG>
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  constexpr uint64_t kSbo = (8 * Geom<CG>::ROWB) >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kSbo << 32) |
         (Geom<CG>::LAYOUT << 62);
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
// keeps the compiler from moving accesses of registers across the
// asynchronous wgmma that reads or writes them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+f"(r[i][k])::"memory");
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
#define UR_A4(a, j) "r"(a[4 * (j)]), "r"(a[4 * (j) + 1]), "r"(a[4 * (j) + 2]), "r"(a[4 * (j) + 3])

// d (64 x N, fp32) += A (64 x 16, bf16 registers: k-step j of a) B (16 x N),
// B K-major in shared memory (the transpose-B immediate is 0); N in {16, 32, 64}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[16], int j,
                                         uint64_t db) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : UR_F8("+f", d, 0)
        : UR_A4(a, j), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : UR_F8("+f", d, 0), UR_F8("+f", d, 8)
        : UR_A4(a, j), "l"(db), "r"(1));
  } else {
    static_assert(N == 64, "wgmma N");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : UR_F8("+f", d, 0), UR_F8("+f", d, 8), UR_F8("+f", d, 16), UR_F8("+f", d, 24)
        : UR_A4(a, j), "l"(db), "r"(1));
  }
}

#undef UR_A4
#undef UR_F8

// ---------------------------------------------------------------------------
// kernel
// ---------------------------------------------------------------------------

// tile t (fastest along W, then H, then the batch) -> its batch, first
// output row and first output column
__device__ __forceinline__ void tile_origin(int t, int tiles_w, int tiles_h, int& b, int& y0,
                                            int& x0) {
  const int per_img = tiles_w * tiles_h;
  b = t / per_img;
  const int r = t - b * per_img;
  y0 = (r / tiles_w) * kTH;
  x0 = (r % tiles_w) * kTW;
}

// the slot's nine taps into shared memory at base + off0 (1024-aligned),
// once, by every thread of the block: matrix (tap, group a, chunk kc) holds
// N rows of ROWB bytes under the ROWB-byte swizzle (K-major: output
// channels by input channels); groups past the last are zeros. Followed by
// the proxy fence the async proxy (wgmma) needs and a block barrier.
template <int CG>
__device__ __forceinline__ void copy_weights(unsigned char* base, uint32_t off0,
                                             const bf16* __restrict__ w, int g0, int o0,
                                             int groups) {
  using Gm = Geom<CG>;
  constexpr int kChunks = Gm::ROWB / 16;
  constexpr int kTotal = 9 * Gm::NACC * Gm::KB * Gm::N * kChunks;
  for (int i = threadIdx.x; i < kTotal; i += blockDim.x) {
    int r = i;
    const int c16 = r % kChunks;
    r /= kChunks;
    const int o = r % Gm::N;
    r /= Gm::N;
    const int kc = r % Gm::KB;
    r /= Gm::KB;
    const int a = r % Gm::NACC;
    const int tap = r / Gm::NACC;
    const int g = g0 + a;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g < groups)
      v = __ldg(reinterpret_cast<const uint4*>(
          w + ((size_t(g) * 9 + tap) * CG + o0 + o) * CG + kc * 64 + c16 * 8));
    const uint32_t off = ((tap * Gm::NACC + a) * Gm::KB + kc) * Gm::MATB + o * Gm::ROWB + c16 * 16;
    *reinterpret_cast<uint4*>(base + off0 + swz<Gm::ROWB>(off)) = v;
  }
  fence_async_shared();
  __syncthreads();
}

// the halo box of tile t at channel c (rows y0 - 1 .. y0 + kTH, columns
// x0 - 1 .. x0 + kTW) into stage st, completing its full barrier
__device__ __forceinline__ void load_halo(const CUtensorMap* tx, uint32_t halo0, uint32_t bars,
                                          int st, int c, int t, int tiles_w, int tiles_h) {
  int b, y0, x0;
  tile_origin(t, tiles_w, tiles_h, b, y0, x0);
  mbar_expect_tx(bars + 8 * st, kBoxBytes);
  tma_load_4d(halo0 + kStageBytes * st, tx, bars + 8 * st, c, x0 - 1, y0 - 1, b);
}

// the producer (one thread): the halo boxes of the block's tiles, KB per
// tile, in order into a ring of S stages at halo0 (full barriers at bars,
// empty ones after them), each stage refilled once its consumers arrived
template <int KB, int S>
__device__ __forceinline__ void produce(const CUtensorMap* tx, uint32_t halo0, uint32_t bars,
                                        int c_in0, int tiles_w, int tiles_h, int n_tiles) {
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int kc = 0; kc < KB; ++kc, ++it) {
      const int st = it % S;
      if (it >= S) mbar_wait(bars + 8 * (S + st), ((it / S) - 1) & 1);
      load_halo(tx, halo0, bars, st, c_in0 + kc * kBoxC, t, tiles_w, tiles_h);
    }
  }
}

// ldmatrix rows of one tap: the four 16-channel k-steps of a 64-channel halo
// box for this lane's pixel (halo pixel hp; lanes 16-31 take channels + 8)
__device__ __forceinline__ void load_a(uint32_t (&a)[16], uint32_t box, int hp, int hi) {
  const uint32_t row = box + uint32_t(hp) * 128;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t r[4];
    ldmatrix_x4(r, row + ((uint32_t(2 * j + hi) ^ uint32_t(hp & 7)) << 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) a[4 * j + q] = r[q];
  }
}

template <int CG>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<CG>())
gconv3_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
            const bf16* __restrict__ w, const bf16* __restrict__ bias, int H, int C,
            int tiles_w, int tiles_h, int n_tiles) {
  using Gm = Geom<CG>;
  constexpr int N = Gm::N;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled buffers start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  const uint32_t halo0 = raw + pad;
  const uint32_t wts = halo0 + kStageBytes * kStages;
  const uint32_t outs = wts + Gm::WBYTES;
  const uint32_t bars = outs + 2 * kOutBytes;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = blockIdx.y;
  const int groups = C / CG;
  // the slot's first input and output channel, and its weights' first group
  // and output row
  const int c_in0 = CG == 128 ? (slot >> 1) * 128 : slot * kSlotC;
  const int c_out0 = slot * kSlotC;
  const int g0 = CG == 128 ? slot >> 1 : slot * Gm::NACC;
  const int o0 = CG == 128 ? (slot & 1) * 64 : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_weights<CG>(base, kStageBytes * kStages, w, g0, o0, groups);

  if (warp == kConsumerWarps) {
    if (lane == 0)
      produce<Gm::KB, kStages>(&tx, halo0, bars, c_in0, tiles_w, tiles_h, n_tiles);
    return;
  }

  const int wg = warp >> 2;  // warpgroup: tile rows 4 wg .. 4 wg + 3
  const int wr = warp & 3;   // this warp's tile row inside it
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int hi = lane >> 4;
  // this lane's ldmatrix pixel (column lane % 16 of row 4 wg + wr) in the
  // halo, at tap (0, 0)
  const int hp0 = (4 * wg + wr) * kHaloW + (lane & 15);
  const uint32_t out_tile = outs + kOutBytes * wg;
  const bool issuer = wr == 0 && lane == 0;

  float acc[Gm::NACC][N / 2];
  uint32_t a[2][16];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int b, y0, x0;
    tile_origin(t, tiles_w, tiles_h, b, y0, x0);
#pragma unroll
    for (int s = 0; s < Gm::NACC; ++s)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[s][e] = 0.f;

    for (int kc = 0; kc < Gm::KB; ++kc, ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      const uint32_t box = halo0 + kStageBytes * st;
      const uint32_t wk = wts + kc * Gm::MATB;
      load_a(a[0], box, hp0, hi);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // k-step j: channels 16 j .. 16 j + 15 of the box, group j / KPR of
          // the slot, k-step j % KPR of its B rows
          constexpr int KPR = Gm::KPR;
          const int s = j / KPR;
          const uint32_t bm = wk + ((tap * Gm::NACC + s) * Gm::KB) * Gm::MATB + (j % KPR) * 32;
          wgmma_rs<N>(acc[s], a[tap & 1], j, desc_b<CG>(bm));
        }
        wgmma_commit();
        if (tap < 8) {
          wgmma_wait<1>();  // tap - 1 is done with its A registers
          fence_regs(a);
          load_a(a[(tap + 1) & 1], box, hp0 + ((tap + 1) / 3) * kHaloW + (tap + 1) % 3, hi);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the box
    }

    // epilogue: bias in fp32, one rounding, the 64 x 64 tile staged with the
    // 128-byte swizzle and stored by TMA (clipped at the map's edges)
    if (issuer) bulk_wait_read();  // the previous tile's store has left the stage
    named_sync(1 + wg, 128);
#pragma unroll
    for (int s = 0; s < Gm::NACC; ++s) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const int c = s * N + n * 8 + 2 * t4;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr && c_out0 + c < C) {
          b0 = __bfloat162float(bias[c_out0 + c]);
          b1 = __bfloat162float(bias[c_out0 + c + 1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t m = 16 * wr + g + 8 * r;  // pixel of the warpgroup's 64
          const uint32_t off = m * 128 + c * 2;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[s][4 * n + 2 * r] + b0, acc[s][4 * n + 2 * r + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(base + (out_tile - halo0) + swz<128>(off)) = v;
        }
      }
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (issuer && y0 + 4 * wg < H) {  // a box wholly below the map stores nothing
      tma_store_4d(&ty, out_tile, c_out0, x0, y0 + 4 * wg, b);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait();
}

// ---------------------------------------------------------------------------
// M2 (cg >= 64): output channels as wgmma's M, pixels as its N
// ---------------------------------------------------------------------------

// N of the transposed product: the 8 halo rows of a tile, 18 pixels each,
// read in a row as 144 consecutive halo pixels (the 2 pixels past each
// row's 16 are computed and dropped)
constexpr int kTN = kTH * kHaloW;
constexpr uint32_t kTileOutBytes = kTH * kTW * kSlotC * 2;  // a staged 8 x 16 x 64 tile

// halo stages per consumer warpgroup: each warpgroup has a ring of its own,
// so that a stage's barriers see one consumer, which takes every fill
template <int CG>
__host__ __device__ constexpr int t_stages() {
  return CG == 64 ? 2 : 1;
}

template <int CG>
__host__ __device__ constexpr size_t t_smem_bytes() {
  // halo ring, weights, one staged output tile per warpgroup, a 1 KB sink
  // for the dropped pixels, barriers, 1024 bytes of slack
  return 1024 + size_t(kStageBytes) * 2 * t_stages<CG>() + Geom<CG>::WBYTES +
         2 * kTileOutBytes + 1024 + 32 * t_stages<CG>();
}

static_assert(t_smem_bytes<128>() + kSmemReserved <= kSmemPerSm, "cg = 128 fits one SM");
static_assert(t_smem_bytes<64>() + kSmemReserved <= kSmemPerSm, "cg = 64 fits one SM");

// shared-memory descriptor of a K-major operand of 128-byte rows under the
// 128-byte swizzle that starts at any row of a 1024-aligned tile: the card
// applies the swizzle to the absolute address, so the base offset stays 0
// (setting it to the start's row in the 8-row pattern reads wrong rows)
__device__ __forceinline__ uint64_t desc_sw128_any(uint32_t addr) {
  constexpr uint64_t kSbo = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kSbo << 32) | (1ull << 62);
}

// the M2 producer (one thread): the halo boxes of the block's tiles into one
// ring of SW stages per consumer warpgroup (warpgroup w takes the block's
// tiles w, w + 2, ...; its ring's full barriers at bars + 8 (w SW + i), the
// empty ones SW stages further on), tile pairs in order, each box of a pair
// to both rings before the next
template <int KB, int SW>
__device__ __forceinline__ void produce_t(const CUtensorMap* tx, uint32_t halo0, uint32_t bars,
                                          int c_in0, int tiles_w, int tiles_h, int n_tiles) {
  int issued[2] = {0, 0};
  for (int k0 = 0; blockIdx.x + gridDim.x * k0 < n_tiles; k0 += 2) {
    for (int kc = 0; kc < KB; ++kc) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int t = blockIdx.x + gridDim.x * (k0 + w);
        if (t >= n_tiles) continue;
        const int j = issued[w]++;
        const int st = w * SW + j % SW;
        if (j >= SW) mbar_wait(bars + 8 * (2 * SW + st), ((j / SW) - 1) & 1);
        load_halo(tx, halo0, bars, st, c_in0 + kc * kBoxC, t, tiles_w, tiles_h);
      }
    }
  }
}

#define UR_F8(c, a, i)                                                                    \
  c(a[i]), c(a[i + 1]), c(a[i + 2]), c(a[i + 3]), c(a[i + 4]), c(a[i + 5]), c(a[i + 6]), \
      c(a[i + 7])
#define UR_F72(c, a)                                                                       \
  UR_F8(c, a, 0), UR_F8(c, a, 8), UR_F8(c, a, 16), UR_F8(c, a, 24), UR_F8(c, a, 32),       \
      UR_F8(c, a, 40), UR_F8(c, a, 48), UR_F8(c, a, 56), UR_F8(c, a, 64)

// d (64 x 144, fp32) += A (64 x 16) B (144 x 16)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n144(float (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 0, 0;\n"
      "}\n"
      : UR_F72("+f", d)
      : "l"(da), "l"(db), "r"(1));
}

#undef UR_F72
#undef UR_F8

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int CG>
__global__ void __launch_bounds__(kThreads, 1)
gconv3_sm90_t(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
              const bf16* __restrict__ w, const bf16* __restrict__ bias, int H, int C,
              int tiles_w, int tiles_h, int n_tiles) {
  static_assert(CG >= 64, "one group or half of one per 64 output channels");
  using Gm = Geom<CG>;
  constexpr int SW = t_stages<CG>();
  constexpr int S = 2 * SW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* base = smem_raw + pad;
  const uint32_t halo0 = raw + pad;
  const uint32_t wts = halo0 + kStageBytes * S;
  const uint32_t outs = wts + Gm::WBYTES;
  const uint32_t sink = outs + 2 * kTileOutBytes;
  const uint32_t bars = sink + 1024;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = blockIdx.y;
  const int groups = C / CG;
  const int c_in0 = CG == 128 ? (slot >> 1) * 128 : slot * kSlotC;
  const int c_out0 = slot * kSlotC;
  const int g0 = CG == 128 ? slot >> 1 : slot;
  const int o0 = CG == 128 ? (slot & 1) * 64 : 0;
  (void)H;  // a tile's rows start inside the map; TMA clips the rest

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (S + st), 4);  // the four warps of the tile's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  copy_weights<CG>(base, kStageBytes * S, w, g0, o0, groups);

  if (warp == kConsumerWarps) {
    if (lane == 0) produce_t<Gm::KB, SW>(&tx, halo0, bars, c_in0, tiles_w, tiles_h, n_tiles);
    return;
  }

  // the two consumer warpgroups take the block's tiles in turns, each a whole
  // tile: 64 output channels (rows 16 wr + g, + 8 of this warp) by 144
  // halo-row pixels
  const int wg = warp >> 2;
  const int wr = warp & 3;
  const int g = lane >> 2;
  const uint32_t out_tile = outs + kTileOutBytes * wg;
  const bool issuer = wr == 0 && lane == 0;
  const int ch = 16 * wr + g;  // this thread's first output channel of the slot
  float b0 = 0.f, b1 = 0.f;
  if (bias != nullptr && c_out0 + ch < C) {
    b0 = __bfloat162float(bias[c_out0 + ch]);
    b1 = __bfloat162float(bias[c_out0 + ch + 8]);
  }
  // stmatrix rows of this lane: matrix q = lane / 8 of each x4 holds pixels
  // 16 jp + 8 (q / 2) + lane % 8, channels 16 wr + 8 (q % 2) + (0 .. 7)
  const int q = lane >> 3;
  const uint32_t chunk = 2 * wr + (q & 1);

  float acc[72];
  int used = 0;  // boxes taken from this warpgroup's ring
  for (int k = wg;; k += 2) {
    const int t = blockIdx.x + gridDim.x * k;
    if (t >= n_tiles) break;
    int b, y0, x0;
    tile_origin(t, tiles_w, tiles_h, b, y0, x0);
#pragma unroll
    for (int e = 0; e < 72; ++e) acc[e] = 0.f;
    for (int kc = 0; kc < Gm::KB; ++kc, ++used) {
      const int st = wg * SW + used % SW;
      mbar_wait(bars + 8 * st, (used / SW) & 1);
      const uint32_t box = halo0 + kStageBytes * st;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a_tap = wts + (tap * Gm::KB + kc) * Gm::MATB;
        const uint32_t b_tap = box + ((tap / 3) * kHaloW + tap % 3) * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n144(acc, desc_b<CG>(a_tap + 32 * kk), desc_sw128_any(b_tap + 32 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + st));  // this warp is done with the box
    }

    // epilogue: bias in fp32, one rounding, the tile transposed into its
    // pixel-major stage (128-byte swizzle) by stmatrix, stored by TMA
    if (issuer) bulk_wait_read();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int jp = 0; jp < kTN / 16; ++jp) {
      uint32_t r[4];
      r[0] = pack_bf16(acc[8 * jp + 0] + b0, acc[8 * jp + 1] + b0);
      r[1] = pack_bf16(acc[8 * jp + 2] + b1, acc[8 * jp + 3] + b1);
      r[2] = pack_bf16(acc[8 * jp + 4] + b0, acc[8 * jp + 5] + b0);
      r[3] = pack_bf16(acc[8 * jp + 6] + b1, acc[8 * jp + 7] + b1);
      const int n = 16 * jp + 8 * (q >> 1) + (lane & 7);
      const int row = n / kHaloW, col = n - row * kHaloW;
      const uint32_t p = uint32_t(row * kTW + col);
      stmatrix_x4_trans(col < kTW ? out_tile + p * 128 + ((chunk ^ (p & 7)) << 4) : sink, r);
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (issuer) {
      tma_store_4d(&ty, out_tile, c_out0, x0, y0, b);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait();
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

// (C, W, H, B) bf16 at ptr, box (64, bw, bh, 1), 128-byte swizzle;
// coordinates outside the tensor read as zeros and are not written
bool encode_map(PFN_cuTensorMapEncodeTiled_v12000 encode, CUtensorMap* map, const void* ptr,
                int B, int H, int W, int C, int bw, int bh) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(C) * 2, cuuint64_t(W) * C * 2,
                                 cuuint64_t(H) * W * C * 2};
  const cuuint32_t box[4] = {cuuint32_t(kBoxC), cuuint32_t(bw), cuuint32_t(bh), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kBFloat16 = 1;  // dtype code shared with cuda_lib.py
constexpr int kMaxDevices = 64;

using Kernel = void (*)(CUtensorMap, CUtensorMap, const bf16*, const bf16*, int, int, int, int,
                        int);

// M1 for cg <= 32, M2 (the transposed product) above
constexpr bool transposed(int cg) {
  return cg >= 64;
}

template <Kernel kKernel>
int run(size_t smem, int bps, const CUtensorMap& tx, const CUtensorMap& ty, const void* w,
        const void* bias, int B, int H, int W, int C, cudaStream_t stream) {
  // the shared-memory size is set, and the SM count read, once per device
  // and kernel, not on every launch
  static bool smem_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kKernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return int(err);
    smem_set[dev] = true;
  }
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const long long n_tiles = (long long)B * tiles_w * tiles_h;
  const int slots = (C + kSlotC - 1) / kSlotC;
  if (n_tiles > INT_MAX || slots > 65535) return int(cudaErrorInvalidValue);
  // persistent: the blocks that fit the card at once, spread evenly over the slots
  long long per_slot = (long long)sms[dev] * bps / slots;
  per_slot = per_slot < 1 ? 1 : per_slot > n_tiles ? n_tiles : per_slot;
  const dim3 grid(static_cast<unsigned>(per_slot), static_cast<unsigned>(slots));
  kKernel<<<grid, kThreads, smem, stream>>>(tx, ty, static_cast<const bf16*>(w),
                                            static_cast<const bf16*>(bias), H, C, tiles_w,
                                            tiles_h, int(n_tiles));
  return int(cudaGetLastError());
}

template <int CG>
int launch(const CUtensorMap& tx, const CUtensorMap& ty, const void* w, const void* bias, int B,
           int H, int W, int C, cudaStream_t stream) {
  if constexpr (transposed(CG))
    return run<gconv3_sm90_t<CG>>(t_smem_bytes<CG>(), 1, tx, ty, w, bias, B, H, W, C, stream);
  else
    return run<gconv3_sm90<CG>>(smem_bytes<CG>(), blocks_per_sm<CG>(), tx, ty, w, bias, B, H, W,
                                C, stream);
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C) bf16, contiguous, 16-byte aligned; w: (C / cg, 9, cg,
// cg) bf16, contiguous, 16-byte aligned; bias: (C) bf16 or null; cg in {16,
// 32, 64, 128}. The signature is ur_grouped_conv3's.
int ur_grouped_conv3_sm90(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int C, int cg, int dtype, void* stream) {
  if (dtype != kBFloat16 || B <= 0 || H <= 0 || W <= 0 || cg <= 0 || C % cg != 0 ||
      (cg != 16 && cg != 32 && cg != 64 && cg != 128))
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(w)) & 15)
    return int(cudaErrorInvalidValue);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap tx, ty;
  // M1 stores each warpgroup's half tile, M2 whole tiles
  if (!encode_map(encode, &tx, x, B, H, W, C, kHaloW, kHaloH) ||
      !encode_map(encode, &ty, y, B, H, W, C, kTW, transposed(cg) ? kTH : kTH / 2))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cg) {
    case 16: return launch<16>(tx, ty, w, bias, B, H, W, C, s);
    case 32: return launch<32>(tx, ty, w, bias, B, H, W, C, s);
    case 64: return launch<64>(tx, ty, w, bias, B, H, W, C, s);
    default: return launch<128>(tx, ty, w, bias, B, H, W, C, s);
  }
}

}  // extern "C"
