// Non-causal softmax attention for Hopper (sm_90a), replacing the four Pallas
// TPU kernels of unirestore_tpu/nn/pallas_attention.py:
//
//   ur_attention_btc     <- _btc_kernel     (channel-flat (B, T, H*64) q/k/v)
//   ur_attention_bh      <- _kernel         (head-major (BH, T, D), D in {64, 128})
//   ur_attention_stream  <- _stream_kernel  (head-major (BH, T, D), 128 < D <= 512)
//   ur_attention_btc_out <- _btc_out_kernel (channel-flat, out-projection fused)
//
// All take q prescaled by d^-1/2 * log2(e) and compute
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
// a Hopper SM has at most 227 KB of shared memory, so the kernels here
// stream 64-row K/V tiles through shared memory with an online (flash-style)
// softmax, which computes the same function and never writes a logit to
// device memory.
//
// - bf16: attend_mma. Four warps own 16 queries each;
//   S = q k^T and O += P V are mma.sync m16n8k16 (bf16 in, fp32 accumulate)
//   on fragments read with ldmatrix from shared memory rows padded by 16
//   bytes (no bank conflicts). The S accumulator is rounded to bf16 in place
//   as the A operand of the PV product. K and V tiles arrive by cp.async,
//   each load overlapping the other half's compute. Only ur_attention_btc_out
//   routes bf16 here; the bf16 bodies of the other three entries are the
//   yardsticks of the Hopper kernels that replaced them (attention_sm90.cu,
//   attention_bh_sm90.cu, attention_stream_sm90.cu).
// - fp32: attend_fma, fp32 FMAs on the CUDA cores (BQ x 64 register tiles,
//   BQ/16 x 4 per thread); the same arithmetic as the plain version.
//
// Layouts differ only in strides. A block of the first three entries owns
// (one batch*head, 64 queries, DV output columns):
//   - channel-flat: row stride = inner, head offset = h*64;
//   - head-major:   row stride = D, head offset = 0.
// D > 128 (the VAE mid-block head is 512) does not fit a 64 x D fp32
// accumulator in registers, so the output columns are split over D/128
// blocks that each recompute the full q k^T (the QK^T work times D/128 on a
// kernel that runs twice per restore) and keep a 64 x 128 accumulator.
// Queries and keys past T are masked, so any T works. The bf16 kernel's
// cp.async copies need 16-byte aligned rows; the wrapper checks the pointers.
//
// ur_attention_btc_out computes out = concat_h(o_h) @ wo for wo (inner, C):
// the attention output never reaches device memory, as in the TPU kernel,
// whose VMEM scratch holds the (BQ, inner) per-head outputs in q's dtype
// before one (BQ, inner) @ (inner, C) product (bias added by the caller).
// Here a block owns (one batch, 64 queries) and loops over the heads with
// the same body, writing each head's normalised output, rounded to the
// input type, into a (64, inner) shared-memory tile; then it computes
// (64, inner) @ (inner, C) in 64-column chunks with wo streamed through two
// shared (64, 64) K-chunks by cp.async (the next chunk's copy overlapping
// this chunk's products), fp32 accumulation, one rounding per output.
//   - Shared memory: the bf16 tile is 128 * (inner + 8) bytes (164 KB at
//     inner = 1280) plus 27 KB of q/k/v tiles, whose space the wo chunks
//     reuse once the heads are done: 192 KB at inner = 1280, inner <= 1536
//     fits the 227 KB opt-in limit. fp32 (tests, card-vs-CPU checks) would
//     need 320 KB at 64 queries, so its block owns 16 queries (an 80 KB
//     tile at inner = 1280) and runs the FMA body with one row per thread;
//     its epilogue is FMAs too.
//   - Parallelism: the grid is B*T/64 blocks, each looping over H heads,
//     against B*H*T/64 for ur_attention_btc: at (8, 1024, 640) that is 128
//     blocks of 10 heads on 132 SMs. It is expected to lose to
//     ur_attention_btc plus a cuBLAS product at T = 1024; PERF.md has both.
//   - What bounds it: the attention's 4*B*H*T^2*64 operations, as above;
//     the epilogue adds 2*B*T*inner*C (4 % at T = 4096, C = 320) and reads
//     wo once per block from L2.
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

// One (64-query, one head) tile of softmax_2(q k^T) v: q, k, v point at the
// head's first element (row r at r * row_stride; v already offset to the
// block's DV columns). Leaves each warp's 16 rows unnormalised in acc (the
// mma C-fragment layout: rows g and g + 8, columns n*8 + 2*t4 + {0, 1}) and
// their row sums in l. Uses qs (kBQ x (D+8)), ks (kBK x (D+8)) and vs
// (kBK x (DV+8)); every warp has passed a __syncthreads after its last read
// of them when this returns.
template <int D, int DV>
__device__ __forceinline__ void attend_mma(const bf16* __restrict__ q,
                                           const bf16* __restrict__ kb,
                                           const bf16* __restrict__ vb, int q0, int seq,
                                           long long row_stride, bf16* qs, bf16* ks, bf16* vs,
                                           float (&acc)[DV / 8][4], float (&l)[2]) {
  static_assert(D % 16 == 0 && D % DV == 0 && DV % 16 == 0, "bad tile");
  constexpr int QP = D + 8;   // shared row pitch (elements) of the q and k tiles
  constexpr int VP = DV + 8;  // and of the v tile
  constexpr int KS = D / 16;  // k-steps of q k^T
  constexpr int NT = DV / 8;  // 8-column output tiles per warp
  constexpr bool kQInRegs = D <= 128;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;  // fragment column pair

  load_tile(qs, QP, q, q0, D, seq, row_stride);
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
  float m[2] = {kNegBig, kNegBig};
  l[0] = l[1] = 0.f;
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
}

template <int D, int DV>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int seq, int heads,
                  long long batch_stride, long long head_stride, long long row_stride) {
  constexpr int NT = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x (D + 8)
  bf16* ks = qs + kBQ * (D + 8);                 // kBK x (D + 8)
  bf16* vs = ks + kBK * (D + 8);                 // kBK x (DV + 8)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int col0 = blockIdx.z * DV;
  const long long base = b * batch_stride + h * head_stride;

  float acc[NT][4], l[2];
  attend_mma<D, DV>(q + base, k + base, v + base + col0, q0, seq, row_stride, qs, ks, vs, acc,
                    l);

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

// out-projection fused: see the file comment. The epilogue streams wo in
// kKC-row chunks of kOutCols columns.
constexpr int kOutCols = 64;
constexpr int kKC = 64;
constexpr int kTilePitch = 64 + 8;  // q/k/v tile and wo chunk row pitch (elements)

size_t out_mma_smem_bytes(int inner) {
  return sizeof(bf16) * (size_t(kBQ) * (inner + 8) + size_t(kBQ + 2 * kBK) * kTilePitch);
}

__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_out_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ wo,
                      bf16* __restrict__ out, int seq, int heads, int c_out) {
  constexpr int NT = kOutCols / 8;
  static_assert(2 * kKC * (kOutCols + 8) <= (kBQ + kBK) * kTilePitch, "wo chunks overflow");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int inner = heads * 64;
  const int OP = inner + 8;  // O tile row pitch: 16 bytes past a multiple of 128
  bf16* os = reinterpret_cast<bf16*>(smem_raw);  // kBQ x OP: the per-head outputs
  bf16* qs = os + kBQ * OP;                       // kBQ x kTilePitch
  bf16* ks = qs + kBQ * kTilePitch;               // kBK x kTilePitch
  bf16* vs = ks + kBK * kTilePitch;               // kBK x kTilePitch
  bf16* ws = qs;  // two kKC x kTilePitch wo chunks, over the q and k tiles once the heads are done

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const long long batch_base = (long long)blockIdx.y * seq * inner;

  for (int h = 0; h < heads; ++h) {  // one head at a time into the O tile
    const long long base = batch_base + h * 64;
    float acc[8][4], l[2];
    attend_mma<64, 64>(q + base, k + base, v + base, q0, seq, inner, qs, ks, vs, acc, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = os + (warp * 16 + g + 8 * r) * OP + h * 64 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    }
  }
  __syncthreads();  // the O tile is complete; the q/k/v tiles are free for wo

  // out[64 x C] = O[64 x inner] @ wo[inner x C]: each warp its 16 rows, all
  // warps one shared wo chunk (kKC rows x kOutCols columns) at a time
  const int k_chunks = inner / kKC;
  const int n_chunks = (c_out / kOutCols) * k_chunks;
  const bf16* oa = os + (warp * 16 + (lane & 15)) * OP + (lane >> 4) * 8;
  const int wa = (lane & 15) * kTilePitch + (lane >> 4) * 8;
  auto load_wo = [&](int i, bf16* dst) {
    const bf16* src = wo + (long long)(i % k_chunks) * kKC * c_out + (i / k_chunks) * kOutCols;
    for (int idx = threadIdx.x; idx < kKC * (kOutCols / 8); idx += kMmaThreads) {
      const int r = idx / (kOutCols / 8), c = (idx % (kOutCols / 8)) * 8;
      cp_async16(dst + r * kTilePitch + c, src + (long long)r * c_out + c, true);
    }
  };
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  load_wo(0, ws);
  cp_async_commit();
  for (int i = 0; i < n_chunks; ++i) {
    const int kc = i % k_chunks;
    const bf16* cur = ws + (i & 1) * kKC * kTilePitch;
    if (i + 1 < n_chunks) load_wo(i + 1, ws + ((i + 1) & 1) * kKC * kTilePitch);
    cp_async_commit();
    cp_async_wait_all_but_one();  // chunk i has landed
    __syncthreads();
    for (int kk = 0; kk < kKC / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, oa + kc * kKC + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bw[4];
        ldmatrix_x4_trans(bw, cur + wa + kk * 16 * kTilePitch + np * 16);
        mma_bf16(acc[2 * np], a, bw[0], bw[1]);
        mma_bf16(acc[2 * np + 1], a, bw[2], bw[3]);
      }
    }
    __syncthreads();  // every warp is done with chunk i before i + 2 overwrites it
    if (kc == k_chunks - 1) {  // this column chunk is summed: round once and store
      const int n0 = (i / k_chunks) * kOutCols;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row < seq) {
          bf16* orow = out + ((long long)blockIdx.y * seq + row) * c_out + n0 + 2 * t4;
#pragma unroll
          for (int n = 0; n < NT; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kDC = 64;  // head-dim chunk of the q k^T product
constexpr int kFmaThreads = 256;

// shared floats of attend_fma
template <int D, int DV, int BQ>
__host__ __device__ constexpr size_t fma_smem_floats() {
  return size_t(BQ) * (D + 1) + size_t(kBK) * (kDC + 1) + size_t(kBK) * DV +
         size_t(BQ) * (kBK + 1);
}

// One (BQ-query, one head) tile in fp32, the FMA counterpart of attend_mma:
// thread (ty, tx) owns rows ty*RPT + i (RPT = BQ/16) and columns tx + 16j of
// the unnormalised output acc, with row sums l. Every thread has passed a
// __syncthreads after its last read of the q tile when this returns; the
// k/v/p tiles are read until the end.
template <int D, int DV, int BQ>
__device__ __forceinline__ void attend_fma(const float* __restrict__ qb,
                                           const float* __restrict__ kb,
                                           const float* __restrict__ vb, int q0, int seq,
                                           long long row_stride, float* smem,
                                           float (&acc)[BQ / 16][DV / 16],
                                           float (&l)[BQ / 16]) {
  static_assert(D % kDC == 0 && D % DV == 0 && DV % 16 == 0 && BQ % 16 == 0, "bad tile");
  constexpr int NJ = DV / 16;  // output columns per thread
  constexpr int RPT = BQ / 16;  // query rows per thread
  float* qs = smem;                   // BQ x (D + 1)
  float* ks = qs + BQ * (D + 1);      // kBK x (kDC + 1)
  float* vs = ks + kBK * (kDC + 1);   // kBK x DV
  float* ps = vs + kBK * DV;          // BQ x (kBK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx + 16 j
  const int ty = tid >> 4;  // rows RPT ty + i; a warp holds two ty, 16 tx each

  for (int i = tid; i < BQ * D; i += kFmaThreads) {
    const int r = i / D, c = i % D;
    qs[r * (D + 1) + c] = (q0 + r < seq) ? qb[(long long)(q0 + r) * row_stride + c] : 0.f;
  }

  float m[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
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
        float qv[RPT], kv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * (D + 1) + c0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (kDC + 1) + kk];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= seq) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i][j] = kNegBig;
      }
    }

    // online softmax: the 16 threads of a row sit in one half-warp
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
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
        ps[(ty * RPT + i) * (kBK + 1) + tx + 16 * j] = p;
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
      vs[r * DV + c] = (k0 + r < seq) ? vb[(long long)(k0 + r) * row_stride + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[kk * DV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kFmaThreads)
attention_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int seq, int heads,
                  long long batch_stride, long long head_stride, long long row_stride) {
  constexpr int NJ = DV / 16;
  extern __shared__ float smem[];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int col0 = blockIdx.z * DV;
  const long long base = b * batch_stride + h * head_stride;

  float acc[4][NJ], l[4];
  attend_fma<D, DV, kBQ>(q + base, k + base, v + base + col0, q0, seq, row_stride, smem, acc,
                         l);

  float* ob = o + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < seq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) ob[(long long)r * row_stride + col0 + tx + 16 * j] = acc[i][j] / l[i];
    }
  }
}

// out-projection fused, fp32: 16 queries per block, one row per thread
constexpr int kOutFmaBQ = 16;

size_t out_fma_smem_bytes(int inner) {
  return sizeof(float) * (size_t(kOutFmaBQ) * inner + fma_smem_floats<64, 64, kOutFmaBQ>());
}

__global__ void __launch_bounds__(kFmaThreads)
attention_fwd_out_fma(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ wo,
                      float* __restrict__ out, int seq, int heads, int c_out) {
  static_assert(kKC * kOutCols <= fma_smem_floats<64, 64, kOutFmaBQ>(), "wo chunk overflow");
  extern __shared__ float smem[];
  const int inner = heads * 64;
  float* os = smem;                         // kOutFmaBQ x inner: the per-head outputs
  float* work = os + kOutFmaBQ * inner;     // attend_fma's tiles, then one wo chunk
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;          // the block's query row
  const int q0 = blockIdx.x * kOutFmaBQ;
  const long long batch_base = (long long)blockIdx.y * seq * inner;

  for (int hd = 0; hd < heads; ++hd) {
    const long long base = batch_base + hd * 64;
    float acc[1][4], l[1];
    attend_fma<64, 64, kOutFmaBQ>(q + base, k + base, v + base, q0, seq, inner, work, acc, l);
#pragma unroll
    for (int j = 0; j < 4; ++j) os[ty * inner + hd * 64 + tx + 16 * j] = acc[0][j] / l[0];
  }

  const int row = q0 + ty;
  for (int n0 = 0; n0 < c_out; n0 += kOutCols) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < inner; k0 += kKC) {
      __syncthreads();  // the O tile is complete and the last chunk consumed
      for (int i = threadIdx.x; i < kKC * kOutCols; i += kFmaThreads) {
        const int r = i / kOutCols, c = i % kOutCols;
        work[i] = wo[(long long)(k0 + r) * c_out + n0 + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float a = os[ty * inner + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, work[kk * kOutCols + tx + 16 * j], acc[j]);
      }
    }
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[((long long)blockIdx.y * seq + row) * c_out + n0 + tx + 16 * j] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t(kBQ + kBK) * (D + 8) + size_t(kBK) * (DV + 8));
}

template <int D, int DV>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * fma_smem_floats<D, DV, kBQ>();
}

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

template <typename T>
int launch_out(void (*kernel)(const T*, const T*, const T*, const T*, T*, int, int, int),
               int threads, size_t smem, int block_queries, const void* q, const void* k,
               const void* v, const void* wo, void* out, int batch, int seq, int heads,
               int c_out, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((seq + block_queries - 1) / block_queries, batch);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(wo), static_cast<T*>(out), seq, heads, c_out);
  return int(cudaGetLastError());
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

// q, k, v: (batch, seq, inner), inner = heads * 64 <= 1536; wo: (inner, c_out),
// c_out % 64 == 0; out: (batch, seq, c_out); all contiguous.
int ur_attention_btc_out(const void* q, const void* k, const void* v, const void* wo, void* out,
                         int batch, int seq, int inner, int c_out, int dtype, void* stream) {
  if (inner <= 0 || inner % 64 != 0 || c_out <= 0 || c_out % kOutCols != 0)
    return int(cudaErrorInvalidValue);
  const int heads = inner / 64;
  if (dtype == kBFloat16)
    return launch_out<bf16>(attention_fwd_out_mma, kMmaThreads, out_mma_smem_bytes(inner), kBQ,
                            q, k, v, wo, out, batch, seq, heads, c_out, stream);
  if (dtype == kFloat32)
    return launch_out<float>(attention_fwd_out_fma, kFmaThreads, out_fma_smem_bytes(inner),
                             kOutFmaBQ, q, k, v, wo, out, batch, seq, heads, c_out, stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
