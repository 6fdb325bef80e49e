// Grouped 3x3 convolution for Hopper (sm_90a), replacing the Pallas TPU kernel
// of unirestore_tpu/nn/pallas_grouped_conv.py (_kernel v2 and _kernel_v3,
// entry grouped_conv3_pallas), the CFRM AdaNAFV2 grouped conv:
//
//   ur_grouped_conv3 <- _kernel / _kernel_v3
//
// y[b, i, j, g*cg + o] = bias[g*cg + o]
//     + sum_{dy, dx, c} x[b, i + dy - 1, j + dx - 1, g*cg + c] * w[g, 3 dy + dx, o, c]
// SAME padding (zeros outside the map), stride 1, NHWC, cin == cout = C,
// cg = C / groups in {16, 32, 64, 128}. w is packed by the wrapper per group
// and tap as (groups, 9, cg_out, cg_in). Products in the input type, sums in
// fp32, the bias added in fp32, one rounding to the input type at the end.
//
// What bounds it on the H100: at the 512 px batch-8 shapes each call is
// 154.6 GFLOP (0.156 ms at 989 TFLOP/s) against 1.07 / 0.54 / 0.27 GB of input
// plus output (0.320 / 0.160 / 0.080 ms at 3.35 TB/s) for cg = 32 / 64 / 128:
// the narrow stages are bound by bytes, the cg = 128 stage by operations. The
// TPU kernel folds groups into 128-lane supergroups with block-diagonal
// weights and so pays 128/cg times the operations (4x at cg = 32); Hopper's
// mma.sync m16n8k16 has n = 8 and k = 16, so each group is its own GEMM and
// no operation is wasted.
//
// Design (a right, simple first kernel; wgmma and TMA come later):
// - bf16: gconv3_mma. A block owns a 4 x 32 tile of output pixels and all cg
//   outputs of one group. Its input tile with the +-1 halo (6 x 34 pixels of
//   cg channels, zero-filled outside the map) is copied to shared memory
//   once with 16-byte cp.async; the output tile reads its input 1.6 times
//   (halo), every other byte once. The 9 taps' (cg x cg) weight slices
//   stream through two shared buffers, the next tap's copy overlapping this
//   tap's products (all 9 taps at cg = 128 would need 295 KB). Eight warps
//   each own 16 pixels of one tile row; A is read by ldmatrix straight from
//   the halo tile at the tap's (dy, dx) offset (an implicit GEMM: no im2col
//   in device memory), B by ldmatrix from the weight slice, both from rows
//   padded by 16 bytes (no bank conflicts). fp32 accumulators stay in
//   registers for all 9 taps.
// - fp32 (tests, the card-vs-CPU checks): gconv3_fma, the same tiling on
//   CUDA-core FMAs; each thread owns one pixel and half the group's outputs.
// Ragged H and W (not multiples of the tile) are masked.
//
// The entry returns cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 4;   // output rows per block
constexpr int kTW = 32;  // output columns per block
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = kHaloH * kHaloW;
constexpr int kThreads = 256;  // 8 warps; 128 output pixels per block

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// block -> (batch, first output row, first output column); x is the tile
// index, fastest along W
__device__ __forceinline__ void tile_origin(int tiles_h, int tiles_w, int& b, int& y0,
                                            int& x0) {
  int t = blockIdx.x;
  x0 = (t % tiles_w) * kTW;
  t /= tiles_w;
  y0 = (t % tiles_h) * kTH;
  b = t / tiles_h;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

template <int CG>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * size_t(kHaloPix + 2 * CG) * (CG + 8);
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
gconv3_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
           bf16* __restrict__ y, int H, int W, int C, int tiles_h, int tiles_w) {
  static_assert(CG % 16 == 0, "bad group width");
  constexpr int P = CG + 8;    // shared row pitch (elements) of halo pixels and weight rows
  constexpr int KS = CG / 16;  // k-steps per tap
  constexpr int NT = CG / 8;   // 8-column output tiles per warp
  constexpr int CH = CG / 8;   // 16-byte chunks per pixel or weight row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);  // kHaloPix x P
  bf16* wbuf = halo + kHaloPix * P;                // 2 x CG x P

  int b, y0, x0;
  tile_origin(tiles_h, tiles_w, b, y0, x0);
  const int g = blockIdx.y;
  const bf16* xg = x + (long long)b * H * W * C + g * CG;
  const bf16* wg = w + (long long)g * 9 * CG * CG;

  // input rows y0 - 1 .. y0 + kTH, columns x0 - 1 .. x0 + kTW; zeros outside
  for (int i = threadIdx.x; i < kHaloPix * CH; i += kThreads) {
    const int p = i / CH, c = (i % CH) * 8;
    const int yy = y0 - 1 + p / kHaloW, xx = x0 - 1 + p % kHaloW;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    cp_async16(halo + p * P + c, xg + (ok ? ((long long)yy * W + xx) * C + c : 0), ok);
  }
  auto load_tap = [&](int tap, bf16* dst) {
    const bf16* src = wg + (long long)tap * CG * CG;
    for (int i = threadIdx.x; i < CG * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      cp_async16(dst + r * P + c, src + r * CG + c, true);
    }
  };
  load_tap(0, wbuf);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = warp >> 1;         // tile row of this warp's 16 pixels
  const int col0 = (warp & 1) * 16;  // and their first column
  // ldmatrix addresses: A rows = pixels col0 + lane % 16 (channels + 8 for
  // lanes 16-31); B rows = output channels, as the k tile of attention.cu
  const bf16* a_base = halo + (row * kHaloW + col0 + (lane & 15)) * P + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) load_tap(tap + 1, wbuf + ((tap + 1) & 1) * CG * P);
    cp_async_commit();
    cp_async_wait_all_but_one();  // the halo and this tap's weights have landed
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    const bf16* a_tap = a_base + (dy * kHaloW + dx) * P;
    const bf16* b_tap = wbuf + (tap & 1) * CG * P + b_off;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, a_tap + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bw[4];
        ldmatrix_x4(bw, b_tap + np * 16 * P + kk * 16);
        mma_bf16(acc[2 * np], a, bw[0], bw[1]);
        mma_bf16(acc[2 * np + 1], a, bw[2], bw[3]);
      }
    }
    __syncthreads();  // every warp is done with this weight buffer
  }

  // accumulator rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}
  const int yy = y0 + row;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int xx = x0 + col0 + (lane >> 2) + 8 * r;
    if (yy < H && xx < W) {
      bf16* out = y + (((long long)b * H + yy) * W + xx) * C + g * CG;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * (lane & 3);
        float v0 = acc[n][2 * r], v1 = acc[n][2 * r + 1];
        if (bias != nullptr) {
          v0 += __bfloat162float(bias[g * CG + c]);
          v1 += __bfloat162float(bias[g * CG + c + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int CG>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * size_t(kHaloPix + CG) * (CG + 1);
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
gconv3_fma(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, float* __restrict__ y, int H, int W, int C,
           int tiles_h, int tiles_w) {
  constexpr int P = CG + 1;   // odd pitch: neighbouring pixels on other banks
  constexpr int NO = CG / 2;  // outputs per thread
  extern __shared__ float smf[];
  float* halo = smf;             // kHaloPix x P
  float* ws = halo + kHaloPix * P;  // CG x P, one tap

  int b, y0, x0;
  tile_origin(tiles_h, tiles_w, b, y0, x0);
  const int g = blockIdx.y;
  const float* xg = x + (long long)b * H * W * C + g * CG;
  const float* wg = w + (long long)g * 9 * CG * CG;

  for (int i = threadIdx.x; i < kHaloPix * CG; i += kThreads) {
    const int p = i / CG, c = i % CG;
    const int yy = y0 - 1 + p / kHaloW, xx = x0 - 1 + p % kHaloW;
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    halo[p * P + c] = ok ? xg[((long long)yy * W + xx) * C + c] : 0.f;
  }

  const int pix = threadIdx.x & (kTH * kTW - 1);
  const int pr = pix / kTW, pc = pix % kTW;
  const int o0 = (threadIdx.x / (kTH * kTW)) * NO;
  float acc[NO];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the halo has landed; nobody reads the previous tap any more
    for (int i = threadIdx.x; i < CG * CG; i += kThreads)
      ws[(i / CG) * P + i % CG] = wg[(long long)tap * CG * CG + i];
    __syncthreads();
    const float* a_row = halo + ((pr + tap / 3) * kHaloW + pc + tap % 3) * P;
    for (int c = 0; c < CG; ++c) {
      const float a = a_row[c];
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[o] = fmaf(a, ws[(o0 + o) * P + c], acc[o]);
    }
  }

  const int yy = y0 + pr, xx = x0 + pc;
  if (yy < H && xx < W) {
    float* out = y + (((long long)b * H + yy) * W + xx) * C + g * CG + o0;
#pragma unroll
    for (int o = 0; o < NO; ++o) out[o] = acc[o] + (bias != nullptr ? bias[g * CG + o0 + o] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
int launch_kernel(void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, int),
                  size_t smem, const void* x, const void* w, const void* bias, void* y, int B,
                  int H, int W, int C, int cg, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  const long long tiles = (long long)B * tiles_h * tiles_w;
  if (tiles > INT_MAX || C / cg > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(tiles), unsigned(C / cg));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), H, W, C, tiles_h, tiles_w);
  return int(cudaGetLastError());
}

// dtype codes shared with cuda_lib.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <int CG>
int launch_typed(int dtype, const void* x, const void* w, const void* bias, void* y, int B,
                 int H, int W, int C, void* stream) {
  if (dtype == kBFloat16)
    return launch_kernel<bf16>(gconv3_mma<CG>, mma_smem_bytes<CG>(), x, w, bias, y, B, H, W, C,
                               CG, stream);
  if (dtype == kFloat32)
    return launch_kernel<float>(gconv3_fma<CG>, fma_smem_bytes<CG>(), x, w, bias, y, B, H, W,
                                C, CG, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C) contiguous; w: (C / cg, 9, cg, cg) contiguous; bias: (C) or null.
int ur_grouped_conv3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                     int W, int C, int cg, int dtype, void* stream) {
  if (cg <= 0 || C % cg != 0 || B <= 0 || H <= 0 || W <= 0) return int(cudaErrorInvalidValue);
  switch (cg) {
    case 16: return launch_typed<16>(dtype, x, w, bias, y, B, H, W, C, stream);
    case 32: return launch_typed<32>(dtype, x, w, bias, y, B, H, W, C, stream);
    case 64: return launch_typed<64>(dtype, x, w, bias, y, B, H, W, C, stream);
    case 128: return launch_typed<128>(dtype, x, w, bias, y, B, H, W, C, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
