// Block-wise int8 quantize and dequantize (kernels K2, K3 and K4 of the
// port) for Hopper, sm_90a.
//
// Replaces, in distributed_parameter_server_for_ml_training_tpu/ops/pallas/
// quantize.py:
//   K2  _quantize_kernel (stochastic=False)  -> block_quantize_kernel<false>
//   K3  _quantize_seed_kernel -> _quantize_kernel(stochastic=True)
//                                            -> block_quantize_kernel<true>
//   K4  _dequantize_kernel                   -> block_dequantize_kernel
// the kernels of the sync int8 reduce-scatter + all-gather ring
// (parallel/sync_dp.py): every hop quantizes (K3) and dequantizes (K4).
//
// Layout, as in the reference: each row of n fp32 values is viewed as
// [rows_padded, 128], cut into quantization blocks of block_elems values
// (256 x 128, or one 32-row-aligned block when rows_padded <= 256). Per
// block:
//     scale = absmax * fp32(1/127)    (1.0 for an all-zero block)
//     K2:  q = clamp(rint(x / scale), -127, 127)
//     K3:  q = clamp(floor(x / scale + u), -127, 127),  u in [0, 1)
//     K4:  y = (float)q * scale
// with true IEEE division by the scale (__fdiv_rn), rint half to even, one
// __fadd_rn before floorf, the clamp in float before the cast, and
// __fmul_rn, so the results are bit-identical to the plain PyTorch
// versions in ops/quantize.py. The scale is a multiply by the fp32
// reciprocal of 127, not a division: the reference writes
// `abs_max / 127.0`, and XLA computes a division by a constant as that
// multiply (the two differ in 1 ulp for ~5% of values), so this is the
// reference's scale bit for bit. Build with --fmad=false and never
// --use_fast_math.
//
// Design. One launch covers a batch of rows (the ring's N slots). K2/K3
// split each quantization block over a thread-block cluster of
// C = block_elems / 4096 CTAs (block_elems is 4096 k, k = 1..8, so C <= 8,
// the portable cluster size), each CTA a 4,096-value slice, 16 values a
// thread. The clusters are persistent: as many as fit on the card at once
// (cudaOccupancyMaxActiveClusters) walk the blocks of all rows (344 on
// the ring chunk). K4 runs one thread block per tile of up to kDeqTile codes of one
// block (its note below).
//
// K3's random bits: Philox4x32-10 (Salmon et al., SC'11), keyed by the
// row's 64-bit seed, counter = (g mod 2^32, g >> 32, 0, 0) for the group g
// of four values starting at element 4g of the row; word j of the output
// serves element 4g + j, and u = (word >> 8) * 2^-24 (24 random bits, as
// the reference's quantize.py:88-93). Every element draws independent
// bits; the TPU kernel reseeds at each grid step, so its blocks share one
// stream. Both are unbiased.
//
// Bound. All three kernels move 4 + 1 bytes a value (plus a scale per
// block): on the ResNet-18 ring chunk at N = 4 (4 x 2,805,033 values) that
// is 56.1 MB a launch, 16.8 us at an H100 SXM's 3.35 TB/s. K3 also runs
// Philox, ten rounds of a 32 x 32 -> 64-bit multiply pair and two xors a
// group of four values, on the integer pipe (64 lanes a clock an SM, half
// the fp32 pipe's): chip_smoke.py:block_bound counts the built kernel's
// SASS by pipe and prices each at its rate, and on an H100 the integer
// pipe's time comes close to the bytes'. Past that, K2/K3 are bound by
// latency: a block's absmax has to be known across its cluster before any
// of its codes, and the first design (one thread block a quantization
// block, two passes over its values) left most of the memory latency
// exposed.
//
// What the design does about it:
// - One read of the input. A CTA copies its slice into shared memory with
//   cp.async (4 bytes a copy, a warp's 32 copies on 128 consecutive bytes:
//   a copy cannot shift its data, and the ring's rows of odd length start
//   4, 8 or 12 bytes past a 16-byte boundary, so every row takes the same
//   path); values past n are zero-filled. The next block's slice is in
//   flight while this one is quantized (two buffers). One float4 of
//   padding every 8 keeps a thread's reads of its four float4s free of
//   bank conflicts, and it takes its 16 values by row-element index, so a
//   misaligned row costs no extra Philox call.
// - The absmax across the cluster in distributed shared memory, with no
//   cluster barrier a block: a warp shuffle, the CTA's partial, then warp
//   0 sends it to every CTA of the cluster (itself included) by st.async,
//   which counts its bytes on the receiver's mbarrier. A cluster barrier
//   costs a GPU-scope memory fence on sm_90 (MEMBAR.ALL.GPU in the SASS),
//   which the exchange avoids. A max is exact in any order, so every CTA
//   holds the same scale bits with no trip through device memory; rank 0
//   writes it. K3's Philox words do not depend on the data and are
//   computed while the partials travel.
// - One reciprocal a block in place of a division a value: x / scale as
//   RN(x * y), y = RN(1 / scale), then two FMA corrections, which give
//   __fdiv_rn's bits (the note at the codes). A block scale or a value
//   outside the range where that holds takes __fdiv_rn in a function
//   outside the loop.
// - Each thread writes its 16 codes as one 16-byte store (a row of codes
//   starts at a multiple of n_blocks * block_elems).
// A CTA whose slice lies wholly past n still sends its partial (0) and
// writes code 0. No fallback: a refused cluster launch returns its CUDA
// error, and the wrapper raises.
//
// K4 moves 1 + 4 bytes a value; it reads the scale once a thread block,
// stages 16-byte loads in shared memory and writes float4 stores however
// the output row is aligned.
//
// NaN inputs: fmaxf drops a NaN from the absmax, where the plain version
// (torch.amax) propagates it. Gradients reaching the ring are finite.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DPS_MAX_SEEDED_ROWS 64

namespace {

struct SeedTable {
  unsigned long long s[DPS_MAX_SEEDED_ROWS];
};

constexpr int kThreads = 256;
// K2/K3: values a CTA a quantization block (16 a thread), and the most
// CTAs a cluster (one block of at most 256 x 128 values).
constexpr int kSlice = 16 * kThreads;
constexpr int kMaxCluster = 8;
// Shared float4s of one staged slice: 1,024, plus one of padding after
// every 8 so a thread's four consecutive float4s are read without bank
// conflicts.
constexpr int kStagedChunks = kSlice / 4 + kSlice / 32;
constexpr int kDeqTile = 8192;  // K4: codes a thread block at most
static_assert(kDeqTile % (16 * kThreads) == 0,
              "a K4 tile is a whole number of 16-byte loads per thread");

// Philox4x32-10 of the four groups g0 .. g0 + 3 (counters (g, g >> 32, 0,
// 0)) under one key, round by round, so each round's key is formed once.
// words[4k + j] is word j of group g0 + k.
__device__ __forceinline__ void philox4x32_10_x4(long long g0, uint2 k,
                                                 unsigned* words) {
  const unsigned int M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const unsigned int W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  uint4 c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long g = g0 + i;
    c[i] = make_uint4(static_cast<unsigned int>(g),
                      static_cast<unsigned int>(g >> 32), 0u, 0u);
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // One 32 x 32 -> 64-bit multiply gives both halves.
      const unsigned long long p0 =
          static_cast<unsigned long long>(M0) * c[i].x;
      const unsigned long long p1 =
          static_cast<unsigned long long>(M1) * c[i].z;
      c[i] = make_uint4(static_cast<unsigned int>(p1 >> 32) ^ c[i].y ^ k.x,
                        static_cast<unsigned int>(p1),
                        static_cast<unsigned int>(p0 >> 32) ^ c[i].w ^ k.y,
                        static_cast<unsigned int>(p0));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    words[4 * i] = c[i].x;
    words[4 * i + 1] = c[i].y;
    words[4 * i + 2] = c[i].z;
    words[4 * i + 3] = c[i].w;
  }
}

__device__ __forceinline__ float uniform24(unsigned int bits) {
  // 24 random bits, exactly representable; the multiply is by a power of 2.
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-8f);
}

__device__ __forceinline__ signed char to_code(float q) {
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Shared float4 index of float4 c of a slice (one of padding after 8).
__device__ __forceinline__ int staged(int c) { return c + (c >> 3); }

// An asynchronous 4-byte copy into shared memory: `bytes` (4 or 0) come
// from `src`, the rest are zero (0 reads nothing).
__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of copies is still in flight.
__device__ __forceinline__ void copies_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The absmax exchange within a cluster. Each CTA keeps, per parity of
// its item count, a slot for every CTA's partial and an mbarrier that
// completes once its own thread 0 has arrived (expecting C partials' bytes)
// and all C partials have landed. A partial goes to every CTA of the
// cluster (itself included) by st.async, which counts its bytes on the
// receiver's mbarrier: no cluster-wide barrier and no memory fence a block.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Stores v into `slot` of cluster CTA `rank` and counts its 4 bytes on that
// CTA's `bar` (both given as this CTA's addresses of the same variables).
__device__ __forceinline__ void send_partial(float* slot,
                                             unsigned long long* bar,
                                             unsigned rank, float v) {
  unsigned remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_slot)
               : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(remote_slot),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ unsigned pack_codes(const float* q) {
  return static_cast<unsigned char>(to_code(q[0])) |
         static_cast<unsigned>(static_cast<unsigned char>(to_code(q[1])))
             << 8 |
         static_cast<unsigned>(static_cast<unsigned char>(to_code(q[2])))
             << 16 |
         static_cast<unsigned>(static_cast<unsigned char>(to_code(q[3])))
             << 24;
}

// Value i of this CTA's slice goes to float i of the staged layout. The
// copies are 4 bytes each, a warp's 32 on 128 consecutive bytes, so a row
// of any alignment takes the same path (a copy cannot shift its data, and
// the ring's rows of odd length start 4, 8 or 12 bytes past a 16-byte
// boundary). A slice that is partly or wholly past n: its values past n
// as 0 (src_row is the row's first value, a valid address that a copy of
// 0 bytes never reads). Not inlined: only the last block of a row takes it.
__device__ __noinline__ void stage_partial(float* buf, const float* p,
                                           const float* src_row, int count) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kSlice / kThreads; ++k) {
    const int i = k * kThreads + t;
    copy4(buf + 4 * staged(i >> 2) + (i & 3), i < count ? p + i : src_row,
          i < count ? 4 : 0);
  }
}

// Starts the copy of this CTA's slice of block b of row `row` into `buf`.
__device__ __forceinline__ void stage_slice(float4* buf, const float* x,
                                            long long n,
                                            long long x_row_stride,
                                            int block_elems, int rank,
                                            int row, int b) {
  const float* xr = x + (long long)row * x_row_stride;
  const long long e0 = (long long)b * block_elems + (long long)rank * kSlice;
  float* bf = reinterpret_cast<float*>(buf);
  if (n - e0 < kSlice) {
    stage_partial(bf, xr + e0, xr,
                  n - e0 <= 0 ? 0 : static_cast<int>(n - e0));
    return;
  }
  const float* p = xr + e0 + threadIdx.x;
  float* d = bf + threadIdx.x + 4 * (threadIdx.x >> 5);
#pragma unroll
  for (int k = 0; k < kSlice / kThreads; ++k)
    copy4(d + k * (kThreads + kThreads / 8), p + k * kThreads, 4);
}

// Codes of one group of four quotients x / scale, with the group's Philox
// words w when stochastic.
template <bool kStochastic>
__device__ __forceinline__ unsigned group_codes(const float* x,
                                                const unsigned* w) {
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = kStochastic
               ? floorf(__fadd_rn(x[j], uniform24(w[j])))
               : rintf(x[j]);
  return pack_codes(q);
}

// The slow path of a thread's codes, for a block scale outside
// [2^-40, 2^40] or (K3) a value with 0 < |x| < scale * 2^-60, where the
// fast division's proof could meet an underflow: the same codes with
// __fdiv_rn. It takes the thread's values from registers (its staging
// buffer may be refilled by then). Not inlined, so the kernel's loop is
// the fast path.
template <bool kStochastic>
__device__ __noinline__ uint4 codes_exact(float4 c0, float4 c1, float4 c2,
                                          float4 c3, float scale, uint2 key,
                                          long long g0) {
  unsigned w[16], words[4];
  if (kStochastic) philox4x32_10_x4(g0, key, w);
  const float4 c[4] = {c0, c1, c2, c3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float d[4] = {__fdiv_rn(c[k].x, scale), __fdiv_rn(c[k].y, scale),
                        __fdiv_rn(c[k].z, scale), __fdiv_rn(c[k].w, scale)};
    words[k] = group_codes<kStochastic>(d, w + 4 * k);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// K2/K3 (the note at the top). A cluster of C CTAs takes quantization
// blocks (items) cluster_id, cluster_id + n_clusters, ... of all rows, item
// i being block i % n_blocks of row i / n_blocks; CTA rank r owns values
// r * kSlice .. r * kSlice + kSlice - 1 of each block, thread t values
// 16t .. 16t + 15 of the slice, four Philox groups. The next item's slice
// is copied in while this one is quantized, and K3's Philox words (which
// do not depend on the data) are computed while the cluster barrier of the
// absmax completes.
template <bool kStochastic>
__global__ void __launch_bounds__(kThreads, 4)
block_quantize_kernel(const float* __restrict__ x, long long n,
                      long long x_row_stride,
                      signed char* __restrict__ values,
                      float* __restrict__ scales, int block_elems,
                      int n_blocks, int n_rows, SeedTable seeds) {
  __shared__ __align__(16) float4 stage[2][kStagedChunks];
  __shared__ float warp_part[kThreads / 32];
  __shared__ float part[2][kMaxCluster];
  __shared__ unsigned long long part_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n_clusters = gridDim.x / csize;
  const int items = n_blocks * n_rows;
  const int t = threadIdx.x, lane = t & 31;

  int item = blockIdx.x / csize;
  int row = item / n_blocks, b = item - row * n_blocks;
  // Item i + n_clusters is q rows and r blocks on from item i.
  const int step_q = n_clusters / n_blocks, step_r = n_clusters % n_blocks;
  if (item < items)
    stage_slice(stage[0], x, n, x_row_stride, block_elems, rank, row, b);
  copies_commit();
  if (t == 0) {
    bar_init(&part_bar[0]);
    bar_init(&part_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's barriers ready before any partial is sent
  for (int it = 0; item < items; ++it) {
    const int next = item + n_clusters;
    int next_row = row + step_q, next_b = b + step_r;
    if (next_b >= n_blocks) {
      next_b -= n_blocks;
      ++next_row;
    }
    if (next < items)
      stage_slice(stage[(it + 1) & 1], x, n, x_row_stride, block_elems, rank,
                  next_row, next_b);
    copies_commit();
    if (t == 0) bar_expect(&part_bar[it & 1], 4u * csize);
    copies_wait_all_but_one();  // this item's slice has landed
    __syncthreads();

    const float4* buf = stage[it & 1];
    float v[16], mag[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 c = buf[staged(4 * t + k)];
      v[4 * k] = c.x;
      v[4 * k + 1] = c.y;
      v[4 * k + 2] = c.z;
      v[4 * k + 3] = c.w;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) mag[j] = fabsf(v[j]);
    // A tree, not a chain of 16.
#pragma unroll
    for (int j = 0; j < 8; ++j) mag[j] = fmaxf(mag[j], mag[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mag[j] = fmaxf(mag[j], mag[j + 4]);
    mag[0] = fmaxf(fmaxf(mag[0], mag[2]), fmaxf(mag[1], mag[3]));

    // -- the block's absmax across the cluster ----------------------------
    // Every thread of this CTA has read the last item's partials by this
    // barrier, so no peer's partial for item it + 2 (sent once it has this
    // CTA's partial for item it + 1) can land in a slot still being read.
    float m = warp_max(mag[0]);
    if (lane == 0) warp_part[t >> 5] = m;
    __syncthreads();
    if (t < 32) {
      m = warp_max(lane < kThreads / 32 ? warp_part[lane] : 0.f);
      if (lane < csize)
        send_partial(&part[it & 1][rank], &part_bar[it & 1], lane, m);
    }
    const long long e0 = (long long)b * block_elems + (long long)rank * kSlice;
    const long long g0 = (e0 >> 2) + 4 * t;
    uint2 key = make_uint2(0u, 0u);
    unsigned w[16];
    if (kStochastic) {  // the words do not depend on the data
      const unsigned long long s = seeds.s[row];
      key = make_uint2(static_cast<unsigned int>(s),
                       static_cast<unsigned int>(s >> 32));
      philox4x32_10_x4(g0, key, w);
    }
    bar_wait(&part_bar[it & 1], (it >> 1) & 1);  // all C partials landed
    m = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < csize) m = fmaxf(m, part[it & 1][r]);
    const float scale = m > 0.f ? __fmul_rn(m, 1.f / 127.f) : 1.f;
    if (rank == 0 && t == 0) scales[(long long)row * n_blocks + b] = scale;

    // -- codes: four groups, one 16-byte store ----------------------------
    // x / scale as RN(x * y) with y = RN(1 / scale), then two FMA
    // corrections: the first brings the quotient within 1 ulp, the second
    // then gives RN(x / scale) (Markstein's theorem: y within half an ulp
    // of 1/scale, an exact remainder, no underflow), __fdiv_rn's bits
    // with one reciprocal a block in place of one a value. A zero gives
    // +0 for -0 here, which makes the same code.
    // K2 needs no per-value test: a quotient below 2^-60 in magnitude
    // rounds to code 0 however its last bits fall. K3's code for such a
    // quotient depends on its sign when u = 0, so K3 takes the exact path
    // for it.
    const float tiny = __fmul_rn(scale, 0x1p-60f);
    bool exact = !(scale >= 0x1p-40f && scale <= 0x1p40f);
    if (kStochastic) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        exact |= fabsf(v[j]) < tiny && v[j] != 0.f;
    }
    uint4 codes;
    if (exact) {
      codes = codes_exact<kStochastic>(
          make_float4(v[0], v[1], v[2], v[3]),
          make_float4(v[4], v[5], v[6], v[7]),
          make_float4(v[8], v[9], v[10], v[11]),
          make_float4(v[12], v[13], v[14], v[15]), scale, key, g0);
    } else {
      unsigned words[4];
      const float y = __frcp_rn(scale);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = v[4 * k + j];
          float q = __fmul_rn(a, y);
          q = __fmaf_rn(__fmaf_rn(-scale, q, a), y, q);
          d[j] = __fmaf_rn(__fmaf_rn(-scale, q, a), y, q);
        }
        words[k] = group_codes<kStochastic>(d, w + 4 * k);
      }
      codes = make_uint4(words[0], words[1], words[2], words[3]);
    }
    reinterpret_cast<uint4*>(values + (long long)row * n_blocks * block_elems +
                             e0)[t] = codes;
    item = next;
    row = next_row;
    b = next_b;
  }
  // No CTA exits early: each waited for every peer's last partial, and no
  // peer sends after that.
}

// K4. One thread block per tile: a slice of at most kDeqTile codes of one
// quantization block of one row, so the block reads its scale once. The
// tile's codes come into shared memory by 16-byte loads (a row's codes start
// at a multiple of n_blocks * block_elems and block_elems is a multiple of
// 16, so tiles are 16-byte aligned), all issued before the first store.
// The output row may start anywhere (row r at out + r * out_row_stride; the
// ring's rows have odd length): each thread writes float4 stores at
// 16-byte-aligned addresses, taking its four codes from shared memory
// shifted by the row's misalignment (one funnel shift of two words), and
// the misaligned head and the tail of a tile, at most 3 values each, are
// written as scalars.
__global__ void __launch_bounds__(kThreads)
block_dequantize_kernel(const signed char* __restrict__ values,
                        const float* __restrict__ scales,
                        float* __restrict__ out, long long n,
                        long long out_row_stride, int block_elems,
                        int n_blocks, int tiles_per_block) {
  __shared__ __align__(16) signed char codes[kDeqTile + 16];
  const int row = blockIdx.y;
  const int b = blockIdx.x / tiles_per_block;
  const int slice = blockIdx.x - b * tiles_per_block;
  const long long e0 = (long long)b * block_elems + (long long)slice * kDeqTile;
  if (e0 >= n) return;
  const int len = min(kDeqTile, block_elems - slice * kDeqTile);
  const float scale = scales[(long long)row * n_blocks + b];

  const int4* src = reinterpret_cast<const int4*>(
      values + (long long)row * n_blocks * block_elems + e0);
  int4* staged = reinterpret_cast<int4*>(codes);
  const int len16 = len >> 4;
  int4 c[kDeqTile / 16 / kThreads];
#pragma unroll
  for (int j = 0; j < kDeqTile / 16 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < len16) c[j] = src[i];
  }
#pragma unroll
  for (int j = 0; j < kDeqTile / 16 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < len16) staged[i] = c[j];
  }
  __syncthreads();

  float* o = out + (long long)row * out_row_stride + e0;
  const int count = static_cast<int>(min((long long)len, n - e0));
  const int head = min(
      count,
      static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(o) >> 2) & 3)) & 3));
  const int groups = (count - head) >> 2;
  const int tail = head + 4 * groups;
  const int t = threadIdx.x;
  if (t < head) o[t] = __fmul_rn(static_cast<float>(codes[t]), scale);
  if (t < count - tail)
    o[tail + t] = __fmul_rn(static_cast<float>(codes[tail + t]), scale);

  // Group g covers codes head + 4g .. head + 4g + 3: bytes `head` onwards
  // of words g and g + 1.
  const unsigned* w = reinterpret_cast<const unsigned*>(codes);
  const unsigned shift = 8u * head;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int g = t; g < groups; g += kThreads) {
    const unsigned q =
        __funnelshift_r(w[g], shift ? w[g + 1] : 0u, shift);
    float4 y;
    y.x = __fmul_rn(static_cast<float>(static_cast<signed char>(q)), scale);
    y.y = __fmul_rn(static_cast<float>(static_cast<signed char>(q >> 8)),
                    scale);
    y.z = __fmul_rn(static_cast<float>(static_cast<signed char>(q >> 16)),
                    scale);
    y.w = __fmul_rn(static_cast<float>(static_cast<signed char>(q >> 24)),
                    scale);
    o4[g] = y;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream) of the calling thread's current device, does
// not synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it cannot take) so the caller can raise.

// Clusters of `csize` CTAs of K2 (stochastic = 0) or K3 (1) that fit on
// the current device at once, asked once per device and kernel.
static int resident_clusters(int stochastic, int csize,
                             cudaLaunchConfig_t config) {
  static int cache[16][2][kMaxCluster + 1];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int& n = cache[dev][stochastic][csize];
  if (n == 0) {
    config.gridDim = dim3(static_cast<unsigned>(csize));
    const cudaError_t err =
        stochastic
            ? cudaOccupancyMaxActiveClusters(&n, block_quantize_kernel<true>,
                                             &config)
            : cudaOccupancyMaxActiveClusters(&n, block_quantize_kernel<false>,
                                             &config);
    if (err != cudaSuccess) n = 0;
  }
  return n;
}

// x: n_rows rows of n fp32 values, row r at x + r * x_row_stride (any
// alignment). values: [n_rows, n_blocks * block_elems] int8, 16-byte
// aligned; scales: [n_rows, n_blocks]. block_elems is 4096 k, k = 1..8.
// seeds: host array of n_rows 64-bit seeds when stochastic, else unused.
extern "C" int dps_block_quantize(const void* x, long long n,
                                  long long x_row_stride, int n_rows,
                                  void* values, void* scales,
                                  int block_elems, int n_blocks,
                                  int stochastic,
                                  const unsigned long long* seeds,
                                  void* stream) {
  if (n_rows <= 0 || n_blocks <= 0 || n <= 0) return 0;
  const int csize = block_elems / kSlice;
  if (block_elems % kSlice != 0 || csize < 1 || csize > kMaxCluster ||
      (long long)n_blocks * n_rows > INT_MAX ||
      n > (long long)n_blocks * block_elems ||
      (reinterpret_cast<uintptr_t>(values) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0 ||
      (stochastic && (n_rows > DPS_MAX_SEEDED_ROWS || seeds == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SeedTable table = {};
  if (stochastic)
    for (int r = 0; r < n_rows; ++r) table.s[r] = seeds[r];
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(csize);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  const int fit = resident_clusters(stochastic ? 1 : 0, csize, config);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int items = n_blocks * n_rows;
  config.gridDim = dim3(static_cast<unsigned>((items < fit ? items : fit) * csize));
  const float* xf = static_cast<const float*>(x);
  signed char* v = static_cast<signed char*>(values);
  float* sc = static_cast<float*>(scales);
  const cudaError_t err =
      stochastic ? cudaLaunchKernelEx(&config, block_quantize_kernel<true>,
                                      xf, n, x_row_stride, v, sc, block_elems,
                                      n_blocks, n_rows, table)
                 : cudaLaunchKernelEx(&config, block_quantize_kernel<false>,
                                      xf, n, x_row_stride, v, sc, block_elems,
                                      n_blocks, n_rows, table);
  const cudaError_t last = cudaGetLastError();  // clears a sticky launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// values/scales as produced above; out: n_rows rows of n fp32 values, row r
// at out + r * out_row_stride. `values` is 16-byte aligned and block_elems
// a multiple of 16.
extern "C" int dps_block_dequantize(const void* values, const void* scales,
                                    void* out, long long n,
                                    long long out_row_stride, int n_rows,
                                    int block_elems, int n_blocks,
                                    void* stream) {
  if (n <= 0 || n_rows <= 0) return 0;
  if (n_rows > 65535 || block_elems <= 0 || block_elems % 16 != 0 ||
      n > (long long)n_blocks * block_elems ||
      (reinterpret_cast<uintptr_t>(values) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_block = (block_elems + kDeqTile - 1) / kDeqTile;
  const long long tiles =
      (n + block_elems - 1) / block_elems * tiles_per_block;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_rows));
  block_dequantize_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(values),
      static_cast<const float*>(scales), static_cast<float*>(out), n,
      out_row_stride, block_elems, n_blocks, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}
