// Flash attention forward and backward (kernels K5, K6 and K7 of the port)
// for Hopper, sm_90a.
//
// Replaces, in distributed_parameter_server_for_ml_training_tpu/ops/pallas/
// flash_attention.py:
//   K5  _fwd_kernel      -> flash_fwd_kernel     (O and LSE; fp32 inputs)
//   K5 on bf16           -> flash_fwd_wgmma_kernel (O and LSE, wgmma; its
//                                                 own note below)
//   K6  _bwd_dq_kernel   -> flash_bwd_dq_kernel  (dQ)
//   K7  _bwd_dkv_kernel  -> flash_bwd_dkv_kernel (dK and dV)
//   K6 + K7 on bf16      -> flash_bwd_kernel     (dQ, dK and dV in one pass,
//                                                 wgmma; its own note below)
// the per-hop block core of ring x flash attention (parallel/
// ring_attention.py) and the core of flash_attention's custom gradient.
//
// What they compute, on q/k/v [BH, T, D] (T a multiple of 64; D 64 or 128):
//   s = (q . k) * (1/sqrt(D)); keys at or beyond kv_len masked to -1e30;
//   under causal masking key (k_off + j) is kept for query (q_off + i) iff
//   k_off + j <= q_off + i (global positions: nonzero offsets make a call
//   one hop of a sharded ring);
//   K5: online softmax with m, l, acc in fp32; l = max(l, 1e-30);
//       O = acc / l (written in the output type), LSE = m + log(l) (fp32);
//   K6: p = exp(s - LSE) where kept, else 0; dp = dO . v;
//       ds = p * (dp - delta); dQ = sum ds . k * scale;
//   K7: the same p and ds per key block: dV = sum p^T . dO,
//       dK = sum ds^T . q * scale.
// delta = rowsum(dO * O) and LSE come from the caller (ring attention
// passes the merged totals). One launch covers every row of BH; rows are
// grouped into slots of rows_per_slot rows, each with its own (q_off,
// k_off), so one launch serves one ring hop over all the sequence slots.
//
// Rounding on bf16 inputs is the TPU kernel's: P is rounded to V's type
// before P.V (flash_attention.py:206), dS to the operand's type before
// dS.K and dS^T.q (:250, :305); dO is already in the input type. The TPU
// kernel's dV product takes P in fp32 (:298, `p.astype(dob.dtype)` with
// dob fp32): here P = hi + lo, each bf16, and dV gets both products, which
// carries P to ~16 significant bits. Products accumulate in fp32.
//
// Loop bounds (the TPU kernels' `_k_loop_hi` and `lo_q..hi_q`): key tiles
// wholly beyond kv_len are skipped and, under causal masking, so are key
// tiles wholly in the future of a query tile; K7 skips query tiles beyond
// q_len and, under causal masking, query tiles wholly before the key tile.
// A query tile whose every key lies in the future therefore runs no
// iteration: O = 0 and LSE = -1e30 + log(1e-30), which is -1e30 in fp32,
// the values the JAX ring's skipped-hop branch produces.
//
// Design of the first versions of K5, K6 and K7 (the wgmma kernels' are in
// their own sections). A thread block of 4 warps owns a tile of 64 rows
// (query rows for K5/K6, key rows for K7), 16 rows a warp, and loops over
// the other operand in tiles of 64 staged in shared memory. Each warp's
// products are m16n8k16 tiles: on bf16 inputs the tensor cores' mma.sync
// (bf16 in, fp32 accumulate), on fp32 inputs the same fragment computed
// with fp32 FMAs, so the softmax and masking code is shared. P and dS go
// through a per-warp shared tile to become the A operand of the next
// product.
//
// Bound: operations. At the SP path's hop shape [192, 2048, 64] bf16 K5
// does 4 BH T^2 D = 206 GFLOP (0.21 ms at 989 TFLOP/s), K6 309 and K7 412
// GFLOP, against ~0.1 GB of traffic each. The first versions have no
// software pipelining (tiles are loaded, then used) and read their
// fragments from shared memory without ldmatrix. The Python routes send
// them fp32 inputs only: bf16 inputs go to the wgmma forward and the fused
// backward. K5's first version still takes bf16, as the yardstick that
// the wgmma forward is timed against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // rows per block, and per inner tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;               // shared rows padded by 8 elements
constexpr int kMaxSlots = 32;
constexpr float kNegInf = -1e30f;

struct SlotOffsets {
  int rows_per_slot;
  int q_off[kMaxSlots];
  int k_off[kMaxSlots];
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c[16 x 8] += A[16 x 16] . B[16 x 8] for one warp. A is row-major in
// shared memory (element (r, k) at a[r * lda + k]). B's element (k, n) is
// at b[n * ldb + k] when kNMajor, else at b[k * ldb + n]. c holds the
// mma.sync accumulator fragment: lane (g = lane / 4, t = lane % 4) owns
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <bool kNMajor>
__device__ __forceinline__ void mma_tile(float c[4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t);
  const uint32_t a1 =
      *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t);
  const uint32_t a2 =
      *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t + 8);
  const uint32_t a3 =
      *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t + 8);
  uint32_t b0, b1;
  if (kNMajor) {
    b0 = *reinterpret_cast<const uint32_t*>(b + g * ldb + 2 * t);
    b1 = *reinterpret_cast<const uint32_t*>(b + g * ldb + 2 * t + 8);
  } else {
    b0 = pack2(b[(2 * t) * ldb + g], b[(2 * t + 1) * ldb + g]);
    b1 = pack2(b[(2 * t + 8) * ldb + g], b[(2 * t + 9) * ldb + g]);
  }
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kNMajor>
__device__ __forceinline__ void mma_tile(float c[4], const float* a, int lda,
                                         const float* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // Not unrolled: the fp32 instantiations would otherwise be 16 times the
  // bf16 code, and dominate the build time.
#pragma unroll 1
  for (int kk = 0; kk < 16; ++kk) {
    const float a0 = a[g * lda + kk], a1 = a[(g + 8) * lda + kk];
    const float b0 = kNMajor ? b[(2 * t) * ldb + kk] : b[kk * ldb + 2 * t];
    const float b1 =
        kNMajor ? b[(2 * t + 1) * ldb + kk] : b[kk * ldb + 2 * t + 1];
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

// acc[N/8][4] += A[16 x K] . B[K x N]: the warp's 16 rows of A against N
// columns of B, K a multiple of 16.
template <int N, int K, bool kNMajor, typename T>
__device__ __forceinline__ void warp_gemm(float (*acc)[4], const T* a,
                                          int lda, const T* b, int ldb,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const T* bt = kNMajor ? b + nt * 8 * ldb + k0 : b + k0 * ldb + nt * 8;
      mma_tile<kNMajor>(acc[nt], a + k0, lda, bt, ldb, lane);
    }
  }
}

// Copy rows [0, kTile) of a [*, D] row-major global matrix into a shared
// tile of row stride D + kPad, 16 bytes at a time.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* s, const T* g) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kLd = D + kPad;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(s + r * kLd + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * D + c);
  }
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// floor(a / b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Exclusive upper bound of the key-tile loop of query tile qb (the TPU
// kernels' _k_loop_hi at 64-row tiles).
__device__ __forceinline__ int key_tiles_hi(int qb, int tk, int kv_len,
                                            int causal, int q_off,
                                            int k_off) {
  int hi = min(tk / kTile, (kv_len + kTile - 1) / kTile);
  if (causal) {
    const int row_max = q_off + (qb + 1) * kTile - 1;
    hi = min(hi, max(0, floor_div(row_max - k_off, kTile) + 1));
  }
  return hi;
}

// ---- K5 ----------------------------------------------------------------------

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, OutT* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int kv_len,
                     int causal, float scale, SlotOffsets pos) {
  constexpr int kLd = D + kPad, kLdp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * kLd;
  T* sV = sK + kTile * kLd;
  T* sP = sV + kTile * kLd;

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int slot = bh / pos.rows_per_slot;
  const int q_off = pos.q_off[slot], k_off = pos.k_off[slot];
  const T* qg = q + ((size_t)bh * tq + (size_t)qb * kTile) * D;
  const T* kg = k + (size_t)bh * tk * D;
  const T* vg = v + (size_t)bh * tk * D;

  load_tile<T, D>(sQ, qg);
  const int hi = key_tiles_hi(qb, tk, kv_len, causal, q_off, k_off);
  const int grow[2] = {q_off + qb * kTile + row0 + g,
                       q_off + qb * kTile + row0 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = 0; kb < hi; ++kb) {
    __syncthreads();
    load_tile<T, D>(sK, kg + (size_t)kb * kTile * D);
    load_tile<T, D>(sV, vg + (size_t)kb * kTile * D);
    __syncthreads();
    float s[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    warp_gemm<kTile, D, true>(s, sQ + row0 * kLd, kLd, sK, kLd, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int col = kb * kTile + nt * 8 + 2 * t + (j & 1);
        const bool keep = col < kv_len && (!causal || k_off + col <= grow[r]);
        const float x = keep ? s[nt][j] * scale : kNegInf;
        s[nt][j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    mx[0] = group_max(mx[0]);
    mx[1] = group_max(mx[1]);
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const float p = expf(s[nt][j] - mx[r]);
        rs[r] += p;
        sP[(row0 + g + 8 * r) * kLdp + nt * 8 + 2 * t + (j & 1)] =
            from_f<T>(p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + group_sum(rs[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    __syncwarp();
    warp_gemm<D, kTile, false>(acc, sP + row0 * kLdp, kLdp, sV, kLd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lf = fmaxf(l[r], 1e-30f);
    const size_t row = (size_t)bh * tq + (size_t)qb * kTile + row0 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      OutT* dst = o + row * D + i * 8 + 2 * t;
      dst[0] = from_f<OutT>(acc[i][2 * r] / lf);
      dst[1] = from_f<OutT>(acc[i][2 * r + 1] / lf);
    }
    if (t == 0) lse[row] = m[r] + logf(lf);
  }
}

// ---- K6 ----------------------------------------------------------------------

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, OutT* __restrict__ dq,
                        int tq, int tk, int kv_len, int causal, float scale,
                        SlotOffsets pos) {
  constexpr int kLd = D + kPad, kLdp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kTile * kLd;
  T* sK = sDO + kTile * kLd;
  T* sV = sK + kTile * kLd;
  T* sS = sV + kTile * kLd;

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int slot = bh / pos.rows_per_slot;
  const int q_off = pos.q_off[slot], k_off = pos.k_off[slot];
  const size_t qrow0 = (size_t)bh * tq + (size_t)qb * kTile;
  const T* kg = k + (size_t)bh * tk * D;
  const T* vg = v + (size_t)bh * tk * D;

  load_tile<T, D>(sQ, q + qrow0 * D);
  load_tile<T, D>(sDO, dout + qrow0 * D);
  const int hi = key_tiles_hi(qb, tk, kv_len, causal, q_off, k_off);
  const int grow[2] = {q_off + qb * kTile + row0 + g,
                       q_off + qb * kTile + row0 + g + 8};
  const float lse_r[2] = {lse[qrow0 + row0 + g], lse[qrow0 + row0 + g + 8]};
  const float delta_r[2] = {delta[qrow0 + row0 + g],
                            delta[qrow0 + row0 + g + 8]};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = 0; kb < hi; ++kb) {
    __syncthreads();
    load_tile<T, D>(sK, kg + (size_t)kb * kTile * D);
    load_tile<T, D>(sV, vg + (size_t)kb * kTile * D);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    warp_gemm<kTile, D, true>(s, sQ + row0 * kLd, kLd, sK, kLd, lane);
    warp_gemm<kTile, D, true>(dp, sDO + row0 * kLd, kLd, sV, kLd, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int col = kb * kTile + nt * 8 + 2 * t + (j & 1);
        const bool keep = col < kv_len && (!causal || k_off + col <= grow[r]);
        const float p = keep ? expf(s[nt][j] * scale - lse_r[r]) : 0.f;
        sS[(row0 + g + 8 * r) * kLdp + nt * 8 + 2 * t + (j & 1)] =
            from_f<T>(p * (dp[nt][j] - delta_r[r]));
      }
    }
    __syncwarp();
    warp_gemm<D, kTile, false>(acc, sS + row0 * kLdp, kLdp, sK, kLd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = qrow0 + row0 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      OutT* dst = dq + row * D + i * 8 + 2 * t;
      dst[0] = from_f<OutT>(acc[i][2 * r] * scale);
      dst[1] = from_f<OutT>(acc[i][2 * r + 1] * scale);
    }
  }
}

// ---- K7 ----------------------------------------------------------------------

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         OutT* __restrict__ dk, OutT* __restrict__ dv, int tq,
                         int tk, int kv_len, int q_len, int causal,
                         float scale, SlotOffsets pos) {
  constexpr bool kSplitP = sizeof(T) == 2;   // P = hi + lo for dV (bf16)
  constexpr int kLd = D + kPad, kLdp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * kLd;
  T* sQ = sV + kTile * kLd;
  T* sDO = sQ + kTile * kLd;
  T* sP = sDO + kTile * kLd;
  float* sLse = reinterpret_cast<float*>(sP + kTile * kLdp);
  float* sDelta = sLse + kTile;

  const int kb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, row0 = warp * 16;
  const int slot = bh / pos.rows_per_slot;
  const int q_off = pos.q_off[slot], k_off = pos.k_off[slot];
  const size_t krow0 = (size_t)bh * tk + (size_t)kb * kTile;
  const T* qg = q + (size_t)bh * tq * D;
  const T* dog = dout + (size_t)bh * tq * D;

  load_tile<T, D>(sK, k + krow0 * D);
  load_tile<T, D>(sV, v + krow0 * D);
  // Query tiles: skip those beyond q_len and, under causal masking, those
  // wholly before this key tile's first global column.
  const int hi_q = min(tq / kTile, (q_len + kTile - 1) / kTile);
  const int lo_q =
      causal ? min(hi_q, max(0, floor_div(k_off + kb * kTile - q_off, kTile)))
             : 0;
  const int key[2] = {kb * kTile + row0 + g, kb * kTile + row0 + g + 8};
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc_k[i][0] = acc_k[i][1] = acc_k[i][2] = acc_k[i][3] = 0.f;
    acc_v[i][0] = acc_v[i][1] = acc_v[i][2] = acc_v[i][3] = 0.f;
  }

  for (int jq = lo_q; jq < hi_q; ++jq) {
    __syncthreads();
    load_tile<T, D>(sQ, qg + (size_t)jq * kTile * D);
    load_tile<T, D>(sDO, dog + (size_t)jq * kTile * D);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      sLse[i] = lse[(size_t)bh * tq + (size_t)jq * kTile + i];
      sDelta[i] = delta[(size_t)bh * tq + (size_t)jq * kTile + i];
    }
    __syncthreads();
    // p^T[key][query] = exp(k . q * scale - LSE[query]) where kept.
    float p[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
    warp_gemm<kTile, D, true>(p, sK + row0 * kLd, kLd, sQ, kLd, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int qc = nt * 8 + 2 * t + (j & 1);
        const bool keep =
            key[r] < kv_len &&
            (!causal || k_off + key[r] <= q_off + jq * kTile + qc);
        const float x = keep ? expf(p[nt][j] * scale - sLse[qc]) : 0.f;
        p[nt][j] = x;
        sP[(row0 + g + 8 * r) * kLdp + qc] = from_f<T>(x);
      }
    }
    __syncwarp();
    warp_gemm<D, kTile, false>(acc_v, sP + row0 * kLdp, kLdp, sDO, kLd, lane);
    if (kSplitP) {
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          T* dst = sP + (row0 + g + 8 * r) * kLdp + nt * 8 + 2 * t + (j & 1);
          *dst = from_f<T>(p[nt][j] - to_f(*dst));
        }
      }
      __syncwarp();
      warp_gemm<D, kTile, false>(acc_v, sP + row0 * kLdp, kLdp, sDO, kLd,
                                 lane);
    }
    // dp^T = v . dO^T; ds^T = p^T * (dp^T - delta[query]).
    float dpt[kTile / 8][4];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i)
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    warp_gemm<kTile, D, true>(dpt, sV + row0 * kLd, kLd, sDO, kLd, lane);
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const int qc = nt * 8 + 2 * t + (j & 1);
        sP[(row0 + g + 8 * r) * kLdp + qc] =
            from_f<T>(p[nt][j] * (dpt[nt][j] - sDelta[qc]));
      }
    }
    __syncwarp();
    warp_gemm<D, kTile, false>(acc_k, sP + row0 * kLdp, kLdp, sQ, kLd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = krow0 + row0 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      OutT* dkd = dk + row * D + i * 8 + 2 * t;
      OutT* dvd = dv + row * D + i * 8 + 2 * t;
      dkd[0] = from_f<OutT>(acc_k[i][2 * r] * scale);
      dkd[1] = from_f<OutT>(acc_k[i][2 * r + 1] * scale);
      dvd[0] = from_f<OutT>(acc_v[i][2 * r]);
      dvd[1] = from_f<OutT>(acc_v[i][2 * r + 1]);
    }
  }
}

// ---- fused backward: K6 + K7 on bf16 -----------------------------------------
//
// flash_bwd_kernel replaces K6 and K7 (_bwd_dq_kernel and _bwd_dkv_kernel in
// the Pallas file) for bf16 inputs: one launch computes dQ, dK and dV.
//
// Work and bound: 10 BH T^2 D operations (S^T, dP^T, dV, dK, dQ; the lo half
// of P adds 2 BH T^2 D of issued work, 12 in all). At the SP path's hop
// shape [192, 2048, 64] that is 0.5211 ms at 989 TFLOP/s against ~0.15 ms
// of bytes: the bound is operations.
//
// What the design does about the first version's three costs:
//  1. Work done twice. A block owns kBwdKeys = 128 key rows (64 a consumer
//     warpgroup), keeps its K and V tiles in shared memory and walks the
//     query tiles lo_q..hi_q (K7's bounds). S^T = K.Q^T and dP^T = V.dO^T
//     are computed once a (key tile, query tile) pair and feed all three
//     gradients. dQ is reduced across the key tiles in fp32 in device
//     memory (red.global.add.v4.f32 into the caller's dq_acc), so no second
//     kernel recomputes S and dP in the query orientation.
//  2. Slow fragments. All five products are wgmma m64nNk16 (bf16 in, fp32
//     accumulate). Q, dO, K and V sit in shared memory in the 128-byte
//     swizzle that the wgmma descriptors read, K-major for S^T and dP^T and
//     the same bytes read MN-major (transposed) as the B operand of dV, dK
//     and dQ. P^T and dS^T come out in the accumulator layout, which is the
//     A-operand register layout of the next product: dV += P^T.dO and
//     dK += dS^T.Q take A from registers. dS^T is stored once to shared
//     memory (conflict-free 32-bit stores into the swizzled layout) and
//     read MN-major as the A operand of dQ = dS.K; warpgroup w computes dQ's
//     columns [w D / 2, (w + 1) D / 2) over all 128 keys, so each dQ element
//     is added once a block.
//  3. No overlap. Q, dO, LSE and delta tiles are double-buffered: the next
//     query tile's cp.async copies (into the swizzled layout) are issued
//     before the current tile's products and land while they run. Within a
//     tile, the S^T and dP^T products are issued together, the softmax of
//     P^T runs while dP^T is in flight, dV's products are in flight while
//     dS^T is computed, and dK's while dS^T is stored. Every wgmma result
//     is read within the iteration that issued it: ptxas serializes the
//     wgmma pipeline (C7514) when a result is read an iteration later,
//     which made a version that overlapped dQ with the next tile slower.
//
// Rounding is the first version's, which is the TPU kernel's: P = hi + lo
// (two bf16 products) for dV, whose TPU product takes P in fp32; dS rounded
// once to bf16, used by dK and dQ. Blocks of one row start their query walk
// staggered by the key-tile index, so the 16 blocks of a row do not add into
// the same dQ tile together. The order in which dQ's partial sums arrive
// varies from launch to launch, so dQ's last bits do too; dK and dV are
// summed in registers in a fixed order and are the same on every launch.
// Tiles: 128 keys a block and 64 queries a step for both head dims. At
// D = 64 that leaves registers to spare; at D = 128 the dK and dV
// accumulators double and the kernel still fits 255 registers a thread
// without spills (nvcc -Xptxas -v), so a smaller tile would only add dQ
// adds and K/V reloads.
// The build keeps --fmad=false for every library (the codecs' bit identity
// needs it); the one contraction that pays here, the softmax exponent's
// S scale - LSE, is written as fmaf. The products are wgmma, which FMA
// flags do not touch.

constexpr int kBwdWG = 2;                    // consumer warpgroups a block
constexpr int kBwdKeys = 64 * kBwdWG;        // key rows a block
constexpr int kBwdThreads = 128 * kBwdWG;
constexpr int kQTile = 64;                   // query rows an iteration
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte-swizzled operand (layout type 1).
// Every product reads one 64-element swizzle column of its operands, so the
// stride between 8-row groups (1,024 bytes) is the only offset read; it
// stands in both offset fields.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

// Orders every later use of an accumulator after the wgmma.wait before it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A . B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64_kk(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A . B, m64n64k16, A and B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[16] (+)= A . B, m64n32k16, A and B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32_tt(float (&d)[16], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A . B, m64n64k16: A from registers (four bf16 pairs a thread, the
// accumulator layout of the product that made them), B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes (st.shared, cp.async) visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Copies kRows rows of a row-major [*, D] bf16 matrix (row r at g + r D)
// into shared memory at s, in the 128-byte swizzle: 64-column blocks of
// kRows x 128 bytes, 16-byte chunk c of row r of a block at
// r * 128 + ((c ^ (r & 7)) << 4). Rows at or beyond `valid` are zeros.
template <int D, int kRows>
__device__ __forceinline__ void load_swizzled(uint32_t s, const bf16* g,
                                              int valid, int tid) {
  constexpr int kPerRow = D / 8;
  constexpr int kChunks = kRows * kPerRow;
  static_assert(kChunks % kBwdThreads == 0, "tile not a whole number of "
                                            "chunks a thread");
#pragma unroll
  for (int it = 0; it < kChunks / kBwdThreads; ++it) {
    const int i = tid + it * kBwdThreads;
    const int r = i / kPerRow, cc = i % kPerRow;
    const uint32_t dst = s + (cc >> 3) * (kRows * 128) + r * 128 +
                         (((cc & 7) ^ (r & 7)) << 4);
    if (r < valid)
      cp_async16(dst, g + (size_t)r * D + cc * 8);
    else
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
                   "r"(0)
                   : "memory");
  }
}

// 2^x on the MUFU unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return (uint32_t)__bfloat16_as_ushort(h.x) |
         ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  // 1,024 for alignment | K | V | Q x 2 | dO x 2 | dS^T | (LSE, delta) x 2
  return 1024 + (size_t)(2 * kBwdKeys + 4 * kQTile) * D * 2 +
         (size_t)kBwdKeys * kQTile * 2 + 4 * kQTile * sizeof(float);
}

template <typename OutT, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, OutT* __restrict__ dk,
                     OutT* __restrict__ dv, int tq, int tk, int kv_len,
                     int q_len, int causal, float scale, SlotOffsets pos) {
  constexpr int kCB = D / 64;                   // 64-column blocks
  constexpr int kKVBytes = kBwdKeys * D * 2;
  constexpr int kQBytes = kQTile * D * 2;
  constexpr int kDqN = D / kBwdWG;              // dQ columns a warpgroup adds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;    // swizzle atoms: 1,024-aligned
  const uint32_t sV = sK + kKVBytes;
  const uint32_t sQ = sV + kKVBytes;            // two buffers
  const uint32_t sDO = sQ + 2 * kQBytes;        // two buffers
  const uint32_t sDS = sDO + 2 * kQBytes;       // dS^T [kBwdKeys][kQTile]
  const uint32_t sRow = sDS + kBwdKeys * kQTile * 2;
  // Buffer b: LSE at rows + 128 b, delta at rows + 128 b + 64.
  const float* rows = reinterpret_cast<const float*>(smem_raw + (sRow - raw));

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kb = blockIdx.x, bh = blockIdx.y;
  const int slot = bh / pos.rows_per_slot;
  const int q_off = pos.q_off[slot], k_off = pos.k_off[slot];
  const int key0 = kb * kBwdKeys;
  const int key_rows = min(kBwdKeys, tk - key0);  // rows of the block in tk
  const size_t krow0 = (size_t)bh * tk + key0;
  // Query tiles: K7's bounds. None when every key of the block is masked.
  const int hi_q = min(tq / kQTile, (q_len + kQTile - 1) / kQTile);
  int lo_q =
      causal ? min(hi_q, max(0, floor_div(k_off + key0 - q_off, kQTile))) : 0;
  if (key0 >= kv_len) lo_q = hi_q;
  const int n_q = hi_q - lo_q;
  // This thread's accumulator rows in S^T, dP^T, dK and dV: keys r_loc[0]
  // and r_loc[1] of the block's tile.
  const int r_loc[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};
  const bf16* qg = q + (size_t)bh * tq * D;
  const bf16* dog = dout + (size_t)bh * tq * D;
  const float* lseg = lse + (size_t)bh * tq;
  const float* deltag = delta + (size_t)bh * tq;

  auto load_query_tile = [&](int buf, int jq) {
    load_swizzled<D, kQTile>(sQ + buf * kQBytes, qg + (size_t)jq * kQTile * D,
                             kQTile, tid);
    load_swizzled<D, kQTile>(sDO + buf * kQBytes,
                             dog + (size_t)jq * kQTile * D, kQTile, tid);
    if (tid < 32) {     // 2 x 64 floats: 16-byte chunks 0-15 LSE, 16-31 delta
      const float* src = (tid < 16 ? lseg : deltag) + jq * kQTile +
                         (tid & 15) * 4;
      cp_async16(sRow + buf * 512 + (tid >> 4) * 256 + (tid & 15) * 16, src);
    }
    cp_async_commit();
  };

  float acc_k[kCB][32], acc_v[kCB][32];
#pragma unroll
  for (int c = 0; c < kCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;
  float s[32], dp[32], dq[kDqN / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kDqN / 2; ++i) dq[i] = 0.f;

  if (n_q > 0) {
    load_swizzled<D, kBwdKeys>(sK, k + krow0 * D, key_rows, tid);
    load_swizzled<D, kBwdKeys>(sV, v + krow0 * D, key_rows, tid);
    load_query_tile(0, lo_q + kb % n_q);
  }
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_q; ++it) {
    const int buf = it & 1;
    const int jq = lo_q + (it + kb) % n_q;
    cp_async_wait_all();
    fence_async_smem();
    // Every thread's copies of this tile have landed, and every warpgroup
    // is done with the other buffer and with dS^T (its last wgmma.wait).
    __syncthreads();
    if (it + 1 < n_q) load_query_tile(buf ^ 1, lo_q + (it + 1 + kb) % n_q);

    const uint32_t q_s = sQ + buf * kQBytes, do_s = sDO + buf * kQBytes;
    const float* lse_s = rows + buf * 128;
    const float* delta_s = lse_s + 64;

    // S^T = K.Q^T and dP^T = V.dO^T over D: A and B K-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * (kBwdKeys * 128) + wg * 64 * 128 +
                         (kk & 3) * 32;
      const uint32_t b = (kk >> 2) * (kQTile * 128) + (kk & 3) * 32;
      wgmma_ss_n64_kk(s, smem_desc(sK + a), smem_desc(q_s + b), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * (kBwdKeys * 128) + wg * 64 * 128 +
                         (kk & 3) * 32;
      const uint32_t b = (kk >> 2) * (kQTile * 128) + (kk & 3) * 32;
      wgmma_ss_n64_kk(dp, smem_desc(sV + a), smem_desc(do_s + b), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);

    // P^T = exp(S^T scale - LSE[query]) where kept, as 2^x. Accumulator element
    // 4 j + e is (row r_loc[e >> 1], query column 8 j + 2 t + (e & 1)); the
    // key is kept for column c iff c >= c_min.
    int c_min[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + r_loc[r];
      c_min[r] = key >= kv_len ? kQTile
                 : causal      ? k_off + key - q_off - jq * kQTile
                               : -(1 << 30);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const float lv = (e & 1) ? l2.y : l2.x;
        s[4 * j + e] = c >= c_min[e >> 1]
                           ? exp2_approx(
                                 fmaf(s[4 * j + e], scale_log2, -lv * kLog2e))
                           : 0.f;
      }
    }
    // P = hi + lo in bf16, as A fragments: pair m is elements 2m, 2m + 1.
    uint32_t ph[16], pl[16], ds[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * m], s[2 * m + 1]);
      ph[m] = bits(h);
      pl[m] = pack_bf16(s[2 * m] - __low2float(h),
                        s[2 * m + 1] - __high2float(h));
    }
    // dV += P^T.dO (hi and lo): A from registers, B MN-major. In flight
    // while dS^T is computed.
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        const uint32_t b = c * (kQTile * 128) + kk * 2048;
        const uint32_t fh[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                ph[4 * kk + 3]};
        const uint32_t fl[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                pl[4 * kk + 3]};
        wgmma_rs_n64_t(acc_v[c], fh, smem_desc(do_s + b));
        wgmma_rs_n64_t(acc_v[c], fl, smem_desc(do_s + b));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    pin(dp);
    // dS^T = P^T * (dP^T - delta[query]), rounded once to bf16.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 4 * j + 2 * r;
        ds[2 * j + r] = pack_bf16(s[e] * (dp[e] - d2.x),
                                  s[e + 1] * (dp[e + 1] - d2.y));
      }
    }

    // dK += dS^T.Q: A from registers, B MN-major.
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        const uint32_t fs[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                                ds[4 * kk + 3]};
        wgmma_rs_n64_t(acc_k[c], fs,
                       smem_desc(q_s + c * (kQTile * 128) + kk * 2048));
      }
    }
    wgmma_commit();

    // dS^T to shared memory, swizzled like the tiles: row r_loc[r], query
    // columns 8 j + 2 t and + 1 (row & 7 == g).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                         sDS + r_loc[r] * 128 + ((j ^ g) << 4) + 4 * t),
                     "r"(ds[2 * j + r])
                     : "memory");
    fence_async_smem();
    __syncthreads();

    // dQ[:, wg kDqN ...] = dS.K over all kBwdKeys keys: A (dS^T stored
    // key-major) and B (K) MN-major, 16 keys = 2,048 bytes a step.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
      const uint64_t a = smem_desc(sDS + kk * 2048);
      if constexpr (kDqN == 32) {   // D = 64: columns 32 wg.. of block 0
        wgmma_ss_n32_tt(dq, a, smem_desc(sK + kk * 2048 + wg * 64), kk > 0);
      } else {                      // D = 128: column block wg
        wgmma_ss_n64_tt(dq, a,
                        smem_desc(sK + wg * (kBwdKeys * 128) + kk * 2048),
                        kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(dq);

    // dq_acc += dQ * scale, 4 floats an instruction: lanes t and t ^ 1 swap
    // halves so that even t holds 4 columns of row g, odd t of row g + 8.
    float* dq_tile =
        dq_acc + ((size_t)bh * tq + (size_t)jq * kQTile) * D + wg * kDqN;
    const bool odd = t & 1;
#pragma unroll
    for (int j = 0; j < kDqN / 8; ++j) {
      const float e0 = dq[4 * j], e1 = dq[4 * j + 1];
      const float e2 = dq[4 * j + 2], e3 = dq[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? e0 : e2, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? e1 : e3, 1);
      const int row = warp * 16 + g + (odd ? 8 : 0);
      const int col = 8 * j + 2 * (t & 2);
      float* dst = dq_tile + (size_t)row * D + col;
      const float x0 = odd ? r0 : e0, x1 = odd ? r1 : e1;
      const float x2 = odd ? e2 : r0, x3 = odd ? e3 : r1;
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst),
                   "f"(x0 * scale), "f"(x1 * scale), "f"(x2 * scale),
                   "f"(x3 * scale)
                   : "memory");
    }
  }
#pragma unroll
  for (int c = 0; c < kCB; ++c) {
    pin(acc_k[c]);
    pin(acc_v[c]);
  }

  // dK = acc_k * scale, dV = acc_v: rows r_loc, columns 64 c + 8 j + 2 t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r_loc[r] >= key_rows) continue;
    const size_t row = (krow0 + r_loc[r]) * D;
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * r, col = 64 * c + 8 * j + 2 * t;
        store2(dk + row + col, acc_k[c][e] * scale, acc_k[c][e + 1] * scale);
        store2(dv + row + col, acc_v[c][e], acc_v[c][e + 1]);
      }
  }
}

// ---- K5 on bf16: the wgmma forward -------------------------------------------
//
// flash_fwd_wgmma_kernel replaces K5 (_fwd_kernel in the Pallas file) for
// bf16 inputs: O in the output type (fp32 as the ring runs it, or bf16) and
// LSE in fp32, natural-log units, exactly what the first version computes.
//
// Work and bound: 4 BH T^2 D operations (S = Q.K^T and O = P.V). At the SP
// path's hop shape [192, 2048, 64] that is 0.2084 ms at 989 TFLOP/s
// against ~0.17 GB of traffic (0.05 ms): the bound is operations. Beside
// the products, every score takes one exponent on the MUFU unit (BH T^2 =
// 0.81 G at the hop shape) and a few FMA-pipe operations, which run while
// the tensor cores work on another warpgroup's products.
//
// What the design does about the first version's costs:
//  1. Small tiles fed by scalar loads. A block of two consumer warpgroups
//     owns kFwdRows = 128 query rows (64 a warpgroup) and walks key tiles of
//     kFwdKeys = 128 rows, so each K/V byte brought on chip serves 128
//     rows. Both products are wgmma (bf16 in, fp32 accumulate): S =
//     Q.K^T as two m64n64k16 chains (keys 0-63 and 64-127) with Q and K
//     K-major in 128-byte-swizzled shared memory, O += P.V as m64n64k16
//     (two at D = 128) with V read MN-major from the same swizzled tile.
//     No fragment is assembled by hand.
//  2. P through shared memory. P comes out of the softmax in the S
//     accumulator's layout, which is the A-operand register layout of P.V:
//     it is rounded to bf16 pairs in registers and never touches shared
//     memory.
//  3. No overlap. K and V tiles are double-buffered: the next tile's
//     cp.async copies (into the swizzle; rows past Tk zero-filled) are
//     issued right after the barrier that frees its buffer and land while
//     this tile's products and softmax run; one barrier a tile. Within a
//     warpgroup the tile runs in two halves of 64 keys, each product its
//     own commit group: the first half's row maxima are taken while the
//     second half's S is in flight, and the first half's P.V is in flight
//     while the second half's exponents run. Each wgmma result is read in
//     the iteration that issued it (as in the fused backward: ptxas
//     serializes the pipeline otherwise, C7514). Across warpgroups: at
//     D = 64 a block takes ~81 KB of shared memory and at most 128
//     registers a thread (no spills; one S accumulator of 128 keys
//     spilled), so two blocks (four warpgroups) share an SM, and one's
//     softmax runs under another's products. A second S accumulator, to
//     have the next tile's S in flight during this tile's softmax, would
//     not fit those registers.
//  4. A full expf and a separate multiply a score. The softmax runs in the
//     log2 domain: P = 2^(S scale log2e - m) as one fmaf into ex2.approx,
//     with m kept in log2 units and LSE converted back to natural log at
//     the end. Tiles that no mask reaches (all keys below min(kv_len, Tk)
//     and, under causal masking, none in the future of the warpgroup's
//     first row) skip the mask; the row sums l stay per thread and are
//     reduced across the 4 lanes of a row once, at the end.
//
// Semantics are the first version's: masked scores are -1e30 (never -inf,
// so no S - m is NaN), P is rounded to bf16 only as the operand of P.V and
// l sums the fp32 P, l = max(l, 1e-30), O = acc / l, LSE = m + log(l).
// A row that no key reaches has m = -1e30: LSE = -1e30, and its O is the
// mean of V over the tiles it ran (P = 2^0), which depends on the tile size
// as in the first version and the JAX kernels (whose blocks differ); the
// ring's merge weights such a row by 0. Loop bounds are key_tiles_hi's at
// 128-key tiles; a query block with no key tile to run writes O = 0 and
// LSE = -1e30, the JAX ring's skipped-hop values. Query rows at or beyond
// Tq (Tq a multiple of 64, not always of 128) are computed on zeros and not
// written. O and LSE are the same on every launch: nothing is summed with
// atomics.

constexpr int kFwdWG = 2;                     // consumer warpgroups a block
constexpr int kFwdRows = 64 * kFwdWG;         // query rows a block
constexpr int kFwdKeys = 128;                 // key rows a tile
constexpr int kFwdThreads = 128 * kFwdWG;
static_assert(kFwdThreads == kBwdThreads,
              "load_swizzled spreads a tile over kBwdThreads threads");
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // 1,024 for alignment | Q | K x 2 | V x 2
  return 1024 + (size_t)(kFwdRows + 4 * kFwdKeys) * D * 2;
}

// The online softmax works on half tiles of 64 keys, in the log2 domain.
// s is a half's raw Q.K^T accumulator: element 4 j + e is row e >> 1 of
// this thread's two, key column col0 + 8 j + 2 t + (e & 1) of the tile.
//
// half_max folds the half's row maxima (log2 units) into mx. With kMask,
// column c of row r is kept iff c <= lim[r], and s becomes the scaled
// scores with -1e30 where masked.
template <bool kMask>
__device__ __forceinline__ void half_max(float (&s)[32], float (&mx)[2],
                                         const int (&lim)[2], int t, int col0,
                                         float scale_log2) {
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1, c = col0 + 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = c <= lim[r] ? s[i] * scale_log2 : kNegInf;
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
    float rm[2] = {s[0], s[2]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      rm[(i >> 1) & 1] = fmaxf(rm[(i >> 1) & 1], s[i]);
    mx[0] = fmaxf(mx[0], rm[0] * scale_log2);
    mx[1] = fmaxf(mx[1], rm[1] * scale_log2);
  }
}

// half_exp turns the half into P = 2^(score - m) (neg = -m), bf16 pairs in
// p in the A-operand layout of P.V (pair m is elements 2 m and 2 m + 1, of
// row m & 1), and adds the fp32 P to this thread's row sums rs.
template <bool kMask>
__device__ __forceinline__ void half_exp(const float (&s)[32],
                                         uint32_t (&p)[16], float (&rs)[2],
                                         const float (&neg)[2],
                                         float scale_log2) {
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int r = m & 1;
    const float a = kMask ? exp2_approx(s[2 * m] + neg[r])
                          : exp2_approx(fmaf(s[2 * m], scale_log2, neg[r]));
    const float b =
        kMask ? exp2_approx(s[2 * m + 1] + neg[r])
              : exp2_approx(fmaf(s[2 * m + 1], scale_log2, neg[r]));
    rs[r] += a + b;
    p[m] = pack_bf16(a, b);
  }
}

template <typename OutT, int D>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, OutT* __restrict__ o,
                           float* __restrict__ lse, int tq, int tk,
                           int kv_len, int causal, float scale,
                           SlotOffsets pos) {
  constexpr int kCB = D / 64;                   // 64-column blocks
  constexpr int kTileBytes = kFwdKeys * D * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;    // swizzle atoms: 1,024-aligned
  const uint32_t sK = sQ + kFwdRows * D * 2;    // two buffers
  const uint32_t sV = sK + 2 * kTileBytes;      // two buffers

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kFwdRows;
  const int slot = bh / pos.rows_per_slot;
  const int q_off = pos.q_off[slot], k_off = pos.k_off[slot];
  // Key tiles: key_tiles_hi's bounds at 128-key tiles, over the block's
  // rows below tq.
  const int kv_eff = min(kv_len, tk);
  int n_k = kv_eff > 0 ? (kv_eff + kFwdKeys - 1) / kFwdKeys : 0;
  if (causal) {
    const int row_max = q_off + min(q0 + kFwdRows, tq) - 1;
    n_k = min(n_k, max(0, floor_div(row_max - k_off, kFwdKeys) + 1));
  }
  // This thread's accumulator rows: query rows qrow[0] and qrow[1].
  const int wg_row0 = q0 + wg * 64;
  const int qrow[2] = {wg_row0 + warp * 16 + g, wg_row0 + warp * 16 + g + 8};
  const bf16* kg = k + (size_t)bh * tk * D;
  const bf16* vg = v + (size_t)bh * tk * D;

  auto load_kv = [&](int buf, int kb) {
    const int key0 = kb * kFwdKeys;
    load_swizzled<D, kFwdKeys>(sK + buf * kTileBytes, kg + (size_t)key0 * D,
                               tk - key0, tid);
    load_swizzled<D, kFwdKeys>(sV + buf * kTileBytes, vg + (size_t)key0 * D,
                               tk - key0, tid);
    cp_async_commit();
  };

  // acc: O; sa and sb: S of a tile's keys 0-63 and 64-127.
  float acc[kCB][32], sa[32], sb[32];
#pragma unroll
  for (int c = 0; c < kCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = sb[i] = 0.f;
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  if (n_k > 0) {
    load_swizzled<D, kFwdRows>(sQ, q + ((size_t)bh * tq + q0) * D, tq - q0,
                               tid);
    load_kv(0, 0);                              // one group with Q
  }
  for (int it = 0; it < n_k; ++it) {
    const int buf = it & 1, key0 = it * kFwdKeys;
    cp_async_wait_all();
    fence_async_smem();
    // Every thread's copies of this tile have landed, and every warpgroup
    // is done with the other buffer (its last wgmma.wait).
    __syncthreads();
    if (it + 1 < n_k) load_kv(buf ^ 1, it + 1);
    const uint32_t k_s = sK + buf * kTileBytes, v_s = sV + buf * kTileBytes;

    // S = Q.K^T over D, one commit group a half: A (this warpgroup's 64
    // query rows) and B (64 keys, 8,192 bytes a half) K-major.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = sQ + (kk >> 2) * (kFwdRows * 128) + wg * 64 * 128 +
                         (kk & 3) * 32;
      const uint32_t b = k_s + (kk >> 2) * (kFwdKeys * 128) + (kk & 3) * 32;
      wgmma_ss_n64_kk(sa, smem_desc(a), smem_desc(b), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = sQ + (kk >> 2) * (kFwdRows * 128) + wg * 64 * 128 +
                         (kk & 3) * 32;
      const uint32_t b = k_s + (kk >> 2) * (kFwdKeys * 128) + 64 * 128 +
                         (kk & 3) * 32;
      wgmma_ss_n64_kk(sb, smem_desc(a), smem_desc(b), kk > 0);
    }
    wgmma_commit();

    // Keys kept for row r: local columns c <= lim[r]. The mask is skipped
    // where it keeps every key of the tile for every row of the warpgroup.
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lim[r] = min(kv_eff - 1 - key0,
                   causal ? q_off + qrow[r] - k_off - key0 : kFwdKeys);
    const bool edge =
        key0 + kFwdKeys > kv_eff ||
        (causal && k_off + key0 + kFwdKeys - 1 > q_off + wg_row0);
    // Row maxima: the first half's while the second half's S is in flight.
    float mx[2] = {m2[0], m2[1]};
    wgmma_wait<1>();
    pin(sa);
    if (edge) half_max<true>(sa, mx, lim, t, 0, scale_log2);
    else half_max<false>(sa, mx, lim, t, 0, scale_log2);
    wgmma_wait<0>();
    pin(sb);
    if (edge) half_max<true>(sb, mx, lim, t, 64, scale_log2);
    else half_max<false>(sb, mx, lim, t, 64, scale_log2);
    float alpha[2], neg[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = group_max(mx[r]);
      alpha[r] = exp2_approx(m2[r] - mx[r]);
      m2[r] = mx[r];
      neg[r] = -mx[r];
    }
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    // P, and O += P.V a half at a time: A from registers, B (V, 16 keys =
    // 2,048 bytes a step) MN-major. The first half's product is in flight
    // while the second half's exponents run.
    uint32_t pa[16], pb[16];
    if (edge) half_exp<true>(sa, pa, rs, neg, scale_log2);
    else half_exp<false>(sa, pa, rs, neg, scale_log2);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fp[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                pa[4 * kk + 3]};
        wgmma_rs_n64_t(acc[c], fp,
                       smem_desc(v_s + c * (kFwdKeys * 128) + kk * 2048));
      }
    }
    wgmma_commit();
    if (edge) half_exp<true>(sb, pb, rs, neg, scale_log2);
    else half_exp<false>(sb, pb, rs, neg, scale_log2);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fp[4] = {pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2],
                                pb[4 * kk + 3]};
        wgmma_rs_n64_t(acc[c], fp, smem_desc(v_s + c * (kFwdKeys * 128) +
                                             (kk + 4) * 2048));
      }
    }
    wgmma_commit();
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kCB; ++c) pin(acc[c]);
  }

  // O = acc / l in the output type, LSE = m + log(l) in natural-log units:
  // rows qrow[r], columns 64 c + 8 j + 2 t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lf = fmaxf(group_sum(l[r]), 1e-30f);
    if (qrow[r] >= tq) continue;
    const float inv = 1.f / lf;
    const size_t row = (size_t)bh * tq + qrow[r];
#pragma unroll
    for (int c = 0; c < kCB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * r;
        store2(o + row * D + 64 * c + 8 * j + 2 * t, acc[c][e] * inv,
               acc[c][e + 1] * inv);
      }
    if (t == 0)
      lse[row] = m2[r] == kNegInf ? kNegInf : fmaf(m2[r], kLn2, logf(lf));
  }
}

// ---- launch ------------------------------------------------------------------

template <typename T, int D>
constexpr size_t smem_bytes(int n_tiles, int n_ptiles, int n_floats) {
  return (size_t)(n_tiles * kTile * (D + kPad) +
                  n_ptiles * kTile * (kTile + kPad)) *
             sizeof(T) +
         (size_t)n_floats * sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kBwd = 3, kFwdWgmma = 4 };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *o2;
  float *lse_out, *dq_acc;
  int bh, tq, tk, kv_len, q_len, causal;
  SlotOffsets pos;
  cudaStream_t stream;
};

template <typename T, typename OutT, int D>
cudaError_t launch(Which which, const Args& a) {
  const float scale = 1.0f / sqrtf((float)D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (which == kFwd) {
    const size_t smem = smem_bytes<T, D>(3, 1, 0);
    auto kern = flash_fwd_kernel<T, OutT, D>;
    if ((err = prepare(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3(a.tq / kTile, a.bh), kThreads, smem, a.stream>>>(
        q, k, v, static_cast<OutT*>(a.o), a.lse_out, a.tq, a.tk, a.kv_len,
        a.causal, scale, a.pos);
  } else if (which == kDq) {
    const size_t smem = smem_bytes<T, D>(4, 1, 0);
    auto kern = flash_bwd_dq_kernel<T, OutT, D>;
    if ((err = prepare(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3(a.tq / kTile, a.bh), kThreads, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<OutT*>(a.o), a.tq, a.tk, a.kv_len, a.causal, scale,
        a.pos);
  } else {
    const size_t smem = smem_bytes<T, D>(4, 1, 2 * kTile);
    auto kern = flash_bwd_dkv_kernel<T, OutT, D>;
    if ((err = prepare(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3(a.tk / kTile, a.bh), kThreads, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<OutT*>(a.o), static_cast<OutT*>(a.o2), a.tq, a.tk,
        a.kv_len, a.q_len, a.causal, scale, a.pos);
  }
  return cudaGetLastError();
}

template <typename OutT, int D>
cudaError_t launch_bwd(const Args& a) {
  const size_t smem = bwd_smem_bytes<D>();
  auto kern = flash_bwd_kernel<OutT, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((a.tk + kBwdKeys - 1) / kBwdKeys, a.bh), kBwdThreads, smem,
         a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse_in, a.delta, a.dq_acc, static_cast<OutT*>(a.o),
      static_cast<OutT*>(a.o2), a.tq, a.tk, a.kv_len, a.q_len, a.causal,
      1.0f / sqrtf((float)D), a.pos);
  return cudaGetLastError();
}

template <typename OutT, int D>
cudaError_t launch_fwd_wgmma(const Args& a) {
  const size_t smem = fwd_smem_bytes<D>();
  auto kern = flash_fwd_wgmma_kernel<OutT, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((a.tq + kFwdRows - 1) / kFwdRows, a.bh), kFwdThreads, smem,
         a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<OutT*>(a.o), a.lse_out,
      a.tq, a.tk, a.kv_len, a.causal, 1.0f / sqrtf((float)D), a.pos);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_types(Which which, const Args& a, int in_bf16,
                           int out_bf16) {
  // The wgmma kernels (the fused backward, the wgmma forward) take bf16
  // inputs only.
  if (which == kBwd || which == kFwdWgmma) {
    if (!in_bf16) return cudaErrorInvalidValue;
    if (which == kFwdWgmma)
      return out_bf16 ? launch_fwd_wgmma<bf16, D>(a)
                      : launch_fwd_wgmma<float, D>(a);
    return out_bf16 ? launch_bwd<bf16, D>(a) : launch_bwd<float, D>(a);
  }
  if (!in_bf16 && !out_bf16) return launch<float, float, D>(which, a);
  if (in_bf16 && !out_bf16) return launch<bf16, float, D>(which, a);
  if (in_bf16 && out_bf16) return launch<bf16, bf16, D>(which, a);
  return cudaErrorInvalidValue;   // fp32 in, bf16 out: not a caller's case
}

int run(Which which, Args& a, int d, int in_bf16, int out_bf16, int n_slots,
        const int* q_offs, const int* k_offs) {
  if (n_slots < 1 || n_slots > kMaxSlots || a.bh % n_slots ||
      a.tq % kTile || a.tk % kTile || a.tq <= 0 || a.tk <= 0)
    return (int)cudaErrorInvalidValue;
  a.pos.rows_per_slot = a.bh / n_slots;
  for (int i = 0; i < kMaxSlots; ++i) {
    a.pos.q_off[i] = i < n_slots ? q_offs[i] : 0;
    a.pos.k_off[i] = i < n_slots ? k_offs[i] : 0;
  }
  if (d == 64) return (int)dispatch_types<64>(which, a, in_bf16, out_bf16);
  if (d == 128) return (int)dispatch_types<128>(which, a, in_bf16, out_bf16);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points (ctypes). Pointers are device pointers of contiguous
// tensors: q [bh, tq, d], k/v [bh, tk, d], dout like q, lse/delta [bh, tq]
// fp32. n_slots slots of bh / n_slots rows each, slot i with offsets
// (q_offs[i], k_offs[i]) (host arrays). Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int dps_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int tq, int tk,
                             int d, int kv_len, int causal, int in_bf16,
                             int out_bf16, int n_slots, const int* q_offs,
                             const int* k_offs, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.bh = bh; a.tq = tq; a.tk = tk; a.kv_len = kv_len; a.q_len = tq;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kFwd, a, d, in_bf16, out_bf16, n_slots, q_offs, k_offs);
}

// The wgmma forward (bf16 inputs): o [bh, tq, d] in the output type, lse
// [bh, tq] fp32.
extern "C" int dps_flash_fwd_wgmma(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int bh,
                                   int tq, int tk, int d, int kv_len,
                                   int causal, int out_bf16, int n_slots,
                                   const int* q_offs, const int* k_offs,
                                   void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.bh = bh; a.tq = tq; a.tk = tk; a.kv_len = kv_len; a.q_len = tq;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kFwdWgmma, a, d, 1, out_bf16, n_slots, q_offs, k_offs);
}

extern "C" int dps_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int bh, int tq,
                                int tk, int d, int kv_len, int causal,
                                int in_bf16, int out_bf16, int n_slots,
                                const int* q_offs, const int* k_offs,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.o = dq;
  a.bh = bh; a.tq = tq; a.tk = tk; a.kv_len = kv_len; a.q_len = tq;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kDq, a, d, in_bf16, out_bf16, n_slots, q_offs, k_offs);
}

extern "C" int dps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int bh, int tq, int tk, int d, int kv_len,
                                 int q_len, int causal, int in_bf16,
                                 int out_bf16, int n_slots, const int* q_offs,
                                 const int* k_offs, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.o = dk; a.o2 = dv;
  a.bh = bh; a.tq = tq; a.tk = tk; a.kv_len = kv_len; a.q_len = q_len;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kDkv, a, d, in_bf16, out_bf16, n_slots, q_offs, k_offs);
}

// The fused backward (bf16 inputs): dq_acc [bh, tq, d] fp32 is added into
// (dQ in fp32); dk, dv [bh, tk, d] are written in the output type.
extern "C" int dps_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, float* dq_acc, void* dk,
                             void* dv, int bh, int tq, int tk, int d,
                             int kv_len, int q_len, int causal, int out_bf16,
                             int n_slots, const int* q_offs,
                             const int* k_offs, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq_acc = dq_acc; a.o = dk; a.o2 = dv;
  a.bh = bh; a.tq = tq; a.tk = tk; a.kv_len = kv_len; a.q_len = q_len;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kBwd, a, d, 1, out_bf16, n_slots, q_offs, k_offs);
}
