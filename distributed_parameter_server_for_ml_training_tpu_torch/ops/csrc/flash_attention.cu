// Flash attention forward and backward (kernels K5, K6 and K7 of the port)
// for Hopper, sm_90a.
//
// Replaces, in distributed_parameter_server_for_ml_training_tpu/ops/pallas/
// flash_attention.py:
//   K5  _fwd_kernel      -> flash_fwd_kernel     (O and LSE)
//   K6  _bwd_dq_kernel   -> flash_bwd_dq_kernel  (dQ)
//   K7  _bwd_dkv_kernel  -> flash_bwd_dkv_kernel (dK and dV)
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
// Design. A thread block of 4 warps owns a tile of 64 rows (query rows for
// K5/K6, key rows for K7), 16 rows a warp, and loops over the other
// operand in tiles of 64 staged in shared memory. Each warp's products
// are m16n8k16 tiles: on bf16 inputs the tensor cores' mma.sync (bf16 in,
// fp32 accumulate), on fp32 inputs the same fragment computed with fp32
// FMAs, so the softmax and masking code is shared. P and dS go through a
// per-warp shared tile to become the A operand of the next product.
//
// Bound: operations. At the SP path's hop shape [192, 2048, 64] bf16 K5
// does 4 BH T^2 D = 206 GFLOP (0.21 ms at 989 TFLOP/s), K6 309 and K7 412
// GFLOP, against ~0.1 GB of traffic each. This first version has no
// software pipelining (tiles are loaded, then used) and reads its
// fragments from shared memory without ldmatrix; wgmma and TMA are for a
// later version.

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

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *o2;
  float* lse_out;
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

template <int D>
cudaError_t dispatch_types(Which which, const Args& a, int in_bf16,
                           int out_bf16) {
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
