// Non-causal softmax attention for Hopper (sm_90a), replacing the three Pallas
// TPU kernels of unirestore_tpu/nn/pallas_attention.py that the restore path
// runs:
//
//   ur_attention_btc     <- _btc_kernel    (channel-flat (B, T, H*64) q/k/v)
//   ur_attention_bh      <- _kernel        (head-major (BH, T, D), D in {64, 128})
//   ur_attention_stream  <- _stream_kernel (head-major (BH, T, D), 128 < D <= 512)
//
// All three take q prescaled by d^-1/2 * log2(e) and compute
//   o = softmax_2(q k^T) v
// with exp2, fp32 logits, fp32 running max and row sum, the probabilities
// rounded to the input type before the PV product (the TPU kernels cast p to
// v's dtype), and the output divided by the row sum at the end.
//
// What bounds it on the H100: at T=4096, d=64 the work is 4*BH*T^2*d
// operations against 8*BH*T*d bytes of q/k/v/o in bf16, about T/2 = 2048
// operations per byte, far above the card's ~295 (989 TFLOP/s over
// 3.35 TB/s): the kernel is bound by arithmetic, so bf16 goes through the
// tensor cores. The TPU kernels keep a whole (BQ, T) logit row block in VMEM;
// a Hopper SM has at most 227 KB of shared memory, so both kernels here
// stream 64-row K/V tiles through shared memory with an online (flash-style)
// softmax, which computes the same function and never writes a logit to
// device memory.
//
// - bf16 (the restore path): attention_fwd_mma. Four warps own 16 queries
//   each; S = q k^T and O += P V are mma.sync m16n8k16 (bf16 in, fp32
//   accumulate) on fragments read with ldmatrix from shared memory rows padded
//   by 16 bytes (no bank conflicts). The S accumulator is rounded to bf16 in
//   place as the A operand of the PV product. K and V tiles arrive by
//   cp.async, each load overlapping the other half's compute. wgmma/TMA and
//   warp specialisation come later.
// - fp32: attention_fwd_fma, fp32 FMAs on the CUDA cores (64x64 register
//   tiles, 4x4 per thread); the same arithmetic as the plain version.
//
// Layouts differ only in strides. A block owns (one batch*head, 64 queries,
// DV output columns):
//   - channel-flat: row stride = inner, head offset = h*64;
//   - head-major:   row stride = D, head offset = 0.
// D > 128 (the VAE mid-block head is 512) does not fit a 64 x D fp32
// accumulator in registers, so the output columns are split over D/128
// blocks that each recompute the full q k^T (the QK^T work times D/128 on a
// kernel that runs twice per restore) and keep a 64 x 128 accumulator.
// Queries and keys past T are masked, so any T works. The bf16 kernel's
// cp.async copies need 16-byte aligned rows; the wrapper checks the pointers.
//
// Each entry returns cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;    // queries per block
constexpr int kBK = 64;    // keys per tile
constexpr float kNegBig = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

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
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

template <int D, int DV>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t(kBQ + kBK) * (D + 8) + size_t(kBK) * (DV + 8));
}

// rows [r0, r0 + 64) x cols [0, cols) of src -> dst (row pitch `pitch`); rows
// at or past seq are zero-filled
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, const bf16* src, int r0,
                                          int cols, int seq, long long row_stride) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < 64 * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r0 + r < seq;
    cp_async16(dst + r * pitch + c, src + (long long)(ok ? r0 + r : 0) * row_stride + c, ok);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads,
                  long long batch_stride, long long head_stride, long long row_stride) {
  static_assert(D % 16 == 0 && D % DV == 0 && DV % 16 == 0, "bad tile");
  constexpr int QP = D + 8;   // shared row pitch (elements) of the q and k tiles
  constexpr int VP = DV + 8;  // and of the v tile
  constexpr int KS = D / 16;  // k-steps of q k^T
  constexpr int NT = DV / 8;  // 8-column output tiles per warp
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x QP
  bf16* ks = qs + kBQ * QP;                      // kBK x QP
  bf16* vs = ks + kBK * QP;                      // kBK x VP

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int col0 = blockIdx.z * DV;
  const long long base = b * batch_stride + h * head_stride;
  const bf16* kb = k + base;
  const bf16* vb = v + base + col0;

  load_tile(qs, QP, q + base, q0, D, seq, row_stride);
  load_tile(ks, QP, kb, 0, D, seq, row_stride);
  cp_async_commit();
  load_tile(vs, VP, vb, 0, DV, seq, row_stride);
  cp_async_commit();

  // ldmatrix addresses: A (q) rows lane%16, cols +8 for lanes 16-31; B from
  // k rows (non-transposed) and from v rows (transposed)
  const bf16* qa = qs + (warp * 16 + (lane & 15)) * QP + (lane >> 4) * 8;
  const bf16* ka = ks + ((lane & 7) + ((lane >> 4) << 3)) * QP + ((lane >> 3) & 1) * 8;
  const bf16* va = vs + (lane & 15) * VP + (lane >> 4) * 8;

  unsigned qf[kQInRegs ? KS : 1][4];
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = (seq + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    cp_async_wait_all_but_one();  // q and this k tile have landed
    __syncthreads();
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
      }
    }

    // S = q k^T: 16 queries x 64 keys per warp, 8 tiles of 16x8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ka + np * 16 * QP + kk * 16);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this k tile
    if (j + 1 < n_tiles) load_tile(ks, QP, kb, k0 + kBK, D, seq, row_stride);
    cp_async_commit();

    if (k0 + kBK > seq) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + 2 * t4 + (e & 1) >= seq) s[n][e] = kNegBig;
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // threads of a row are lanes 4g .. 4g + 3
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegBig;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_new);
          sum += s[n][e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
    // P in bf16 as the A operand: keys 16kk .. 16kk + 15 are tiles 2kk, 2kk + 1
    unsigned pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    cp_async_wait_all_but_one();  // this v tile has landed (the next k may not)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, va + kk * 16 * VP + np * 16);
        mma_bf16(acc[2 * np], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this v tile
    if (j + 1 < n_tiles) load_tile(vs, VP, vb, k0 + kBK, DV, seq, row_stride);
    cp_async_commit();
  }

  bf16* ob = o + base + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < seq) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * row_stride + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kDC = 64;  // head-dim chunk of the q k^T product
constexpr int kFmaThreads = 256;

template <int D, int DV>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * (D + 1) + size_t(kBK) * (kDC + 1) + size_t(kBK) * DV +
                          size_t(kBQ) * (kBK + 1));
}

template <int D, int DV>
__global__ void __launch_bounds__(kFmaThreads)
attention_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int seq, int heads,
                  long long batch_stride, long long head_stride, long long row_stride) {
  static_assert(D % kDC == 0 && D % DV == 0 && DV % 16 == 0, "bad tile");
  constexpr int NJ = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // kBQ x (D + 1)
  float* ks = qs + kBQ * (D + 1);     // kBK x (kDC + 1)
  float* vs = ks + kBK * (kDC + 1);   // kBK x DV
  float* ps = vs + kBK * DV;          // kBQ x (kBK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 j
  const int ty = tid >> 4;  // rows 4 ty + i; a warp holds two ty, 16 tx each
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int col0 = blockIdx.z * DV;
  const long long base = b * batch_stride + h * head_stride;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* ob = o + base;

  for (int i = tid; i < kBQ * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    qs[r * (D + 1) + c] = (q0 + r < seq) ? qb[(long long)(q0 + r) * row_stride + c] : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int c0 = 0; c0 < D; c0 += kDC) {
      __syncthreads();  // previous users of ks / vs / ps are done
      for (int i = tid; i < kBK * kDC; i += kFmaThreads) {
        const int r = i / kDC, c = i % kDC;
        ks[r * (kDC + 1) + c] = (k0 + r < seq) ? kb[(long long)(k0 + r) * row_stride + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDC; ++kk) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + c0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (kDC + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= seq) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = kNegBig;
      }
    }

    // online softmax: the 16 threads of a row sit in one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }

    for (int i = tid; i < kBK * DV; i += kFmaThreads) {
      const int r = i / DV, c = i % DV;
      vs[r * DV + c] = (k0 + r < seq) ? vb[(long long)(k0 + r) * row_stride + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * DV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < seq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) ob[(long long)r * row_stride + col0 + tx + 16 * j] = acc[i][j] / l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
int launch_kernel(void (*kernel)(const T*, const T*, const T*, T*, int, int, long long,
                                 long long, long long),
                  int threads, size_t smem, int cols_split, const void* q, const void* k,
                  const void* v, void* o, int n_bh, int heads, int seq, long long batch_stride,
                  long long head_stride, long long row_stride, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((seq + kBQ - 1) / kBQ, n_bh, cols_split);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, heads, batch_stride, head_stride, row_stride);
  return int(cudaGetLastError());
}

// dtype codes shared with attention_kernels.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <int D, int DV>
int launch_typed(int dtype, const void* q, const void* k, const void* v, void* o, int n_bh,
                 int heads, int seq, long long batch_stride, long long head_stride,
                 long long row_stride, void* stream) {
  if (dtype == kBFloat16)
    return launch_kernel<bf16>(attention_fwd_mma<D, DV>, kMmaThreads, mma_smem_bytes<D, DV>(),
                               D / DV, q, k, v, o, n_bh, heads, seq, batch_stride, head_stride,
                               row_stride, stream);
  if (dtype == kFloat32)
    return launch_kernel<float>(attention_fwd_fma<D, DV>, kFmaThreads, fma_smem_bytes<D, DV>(),
                                D / DV, q, k, v, o, n_bh, heads, seq, batch_stride,
                                head_stride, row_stride, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, seq, inner) with inner = heads * 64, contiguous.
int ur_attention_btc(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                     int inner, int dtype, void* stream) {
  if (inner % 64 != 0) return int(cudaErrorInvalidValue);
  const int heads = inner / 64;
  return launch_typed<64, 64>(dtype, q, k, v, o, batch * heads, heads, seq,
                              (long long)seq * inner, 64, inner, stream);
}

// q, k, v, o: (bh, seq, d) contiguous, d in {64, 128}.
int ur_attention_bh(const void* q, const void* k, const void* v, void* o, int bh, int seq, int d,
                    int dtype, void* stream) {
  const long long bs = (long long)seq * d;
  if (d == 64) return launch_typed<64, 64>(dtype, q, k, v, o, bh, 1, seq, bs, 0, d, stream);
  if (d == 128) return launch_typed<128, 128>(dtype, q, k, v, o, bh, 1, seq, bs, 0, d, stream);
  return int(cudaErrorInvalidValue);
}

// q, k, v, o: (bh, seq, d) contiguous, d in {256, 384, 512}.
int ur_attention_stream(const void* q, const void* k, const void* v, void* o, int bh, int seq,
                        int d, int dtype, void* stream) {
  const long long bs = (long long)seq * d;
  if (d == 256) return launch_typed<256, 128>(dtype, q, k, v, o, bh, 1, seq, bs, 0, d, stream);
  if (d == 384) return launch_typed<384, 128>(dtype, q, k, v, o, bh, 1, seq, bs, 0, d, stream);
  if (d == 512) return launch_typed<512, 128>(dtype, q, k, v, o, bh, 1, seq, bs, 0, d, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
