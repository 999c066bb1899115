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
// Design. One launch covers a batch of rows (the ring's N slots): the
// grid's y dimension is the row. K2/K3 run one thread block per
// quantization block: a block absmax reduction (warp shuffles, then
// shared memory), then a second pass over the same values (from L2) that
// writes the codes, four consecutive values per thread. The kernel reads
// only the n valid values of a row (the row stride may be odd) and writes
// code 0 for the padding, so no padded fp32 copy is made; a zero pads to
// code 0 in both modes since floor(0 + u) = 0 for u < 1. K4 runs one
// thread block per tile of up to kDeqTile codes of one block (its note
// below).
//
// K3's random bits: Philox4x32-10 (Salmon et al., SC'11), keyed by the
// row's 64-bit seed, counter = (g mod 2^32, g >> 32, 0, 0) for the group g
// of four values starting at element 4g of the row; word j of the output
// serves element 4g + j, and u = (word >> 8) * 2^-24 (24 random bits, as
// the reference's quantize.py:88-93). Every element draws independent
// bits; the TPU kernel reseeds at each grid step, so its blocks share one
// stream. Both are unbiased.
//
// Bound: memory. K2/K3 move 4 + 1 bytes per value and K4 1 + 4 (plus a
// scale per 32,768 values); the Philox rounds cost ~25 integer operations
// per value, below the card's balance point. The ResNet-18 ring chunk at
// N = 4 is 4 x 2,805,033 values, 56.1 MB per launch, 16.7 us at an
// H100 SXM's 3.35 TB/s. K2/K3 read their input twice (absmax, then codes)
// and use scalar loads, since a row of odd length is not 16-byte aligned.
// K4's first version (block_dequantize_v1_kernel) paid a 64-bit division
// per four values, char4 loads and scalar stores behind a bounds test on a
// grid capped at 1,024 x rows; its redesign reads the scale once a thread
// block, stages 16-byte loads in shared memory and writes float4 stores
// however the output row is aligned.
//
// NaN inputs: fmaxf drops a NaN from the absmax, where the plain version
// (torch.amax) propagates it. Gradients reaching the ring are finite.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define DPS_MAX_SEEDED_ROWS 64

namespace {

struct SeedTable {
  unsigned long long s[DPS_MAX_SEEDED_ROWS];
};

constexpr int kThreads = 256;
constexpr int kDeqTile = 8192;  // K4: codes a thread block at most
static_assert(kDeqTile % (16 * kThreads) == 0,
              "a K4 tile is a whole number of 16-byte loads per thread");

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const unsigned int M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const unsigned int W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const unsigned int hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const unsigned int hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform24(unsigned int bits) {
  // 24 random bits, exactly representable; the multiply is by a power of 2.
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-8f);
}

__device__ __forceinline__ signed char to_code(float q) {
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;  // valid in thread 0
}

template <bool kStochastic>
__global__ void __launch_bounds__(kThreads)
block_quantize_kernel(const float* __restrict__ x, long long n,
                      long long x_row_stride,
                      signed char* __restrict__ values,
                      float* __restrict__ scales, int block_elems,
                      int n_blocks, SeedTable seeds) {
  const int b = blockIdx.x;
  const int row = blockIdx.y;
  const float* xr = x + (long long)row * x_row_stride;
  const long long start = (long long)b * block_elems;
  const long long valid_end = start + block_elems < n ? start + block_elems
                                                      : n;

  float m = 0.f;
  for (long long i = start + threadIdx.x; i < valid_end; i += kThreads)
    m = fmaxf(m, fabsf(xr[i]));
  m = block_max(m);

  __shared__ float s_scale;
  if (threadIdx.x == 0) {
    const float scale = m > 0.f ? __fmul_rn(m, 1.f / 127.f) : 1.f;
    scales[(long long)row * n_blocks + b] = scale;
    s_scale = scale;
  }
  __syncthreads();
  const float scale = s_scale;

  uint2 key = make_uint2(0u, 0u);
  if (kStochastic) {
    const unsigned long long s = seeds.s[row];
    key = make_uint2(static_cast<unsigned int>(s),
                     static_cast<unsigned int>(s >> 32));
  }
  char4* vr = reinterpret_cast<char4*>(
      values + (long long)row * n_blocks * block_elems);
  const long long g_end = (start + block_elems) / 4;
  for (long long g = start / 4 + threadIdx.x; g < g_end; g += kThreads) {
    const long long e = 4 * g;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e + j < n ? xr[e + j] : 0.f;
    float q[4];
    if (kStochastic) {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<unsigned int>(g),
                     static_cast<unsigned int>(g >> 32), 0u, 0u),
          key);
      const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = floorf(__fadd_rn(__fdiv_rn(v[j], scale), uniform24(w[j])));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = rintf(__fdiv_rn(v[j], scale));
    }
    char4 out;
    out.x = to_code(q[0]);
    out.y = to_code(q[1]);
    out.z = to_code(q[2]);
    out.w = to_code(q[3]);
    vr[g] = out;
  }
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

// K4's first version, kept only as the yardstick its redesign is timed
// against: one thread per four values over a grid-stride loop, the block
// index found by a 64-bit division per four values, char4 loads and scalar
// stores. No path launches it.
__global__ void __launch_bounds__(kThreads)
block_dequantize_v1_kernel(const signed char* __restrict__ values,
                           const float* __restrict__ scales,
                           float* __restrict__ out, long long n,
                           long long out_row_stride, int block_elems,
                           int n_blocks) {
  const int row = blockIdx.y;
  const char4* vr = reinterpret_cast<const char4*>(
      values + (long long)row * n_blocks * block_elems);
  const float* sr = scales + (long long)row * n_blocks;
  float* orow = out + (long long)row * out_row_stride;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long e = 4 * g;
    const char4 v = vr[g];
    // block_elems is a multiple of 4: the four values share one block.
    const float scale = sr[e / block_elems];
    const float y[4] = {__fmul_rn(static_cast<float>(v.x), scale),
                        __fmul_rn(static_cast<float>(v.y), scale),
                        __fmul_rn(static_cast<float>(v.z), scale),
                        __fmul_rn(static_cast<float>(v.w), scale)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < n) orow[e + j] = y[j];
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream) of the calling thread's current device, does
// not synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it cannot take) so the caller can raise.

// x: n_rows rows of n fp32 values, row r at x + r * x_row_stride.
// values: [n_rows, n_blocks * block_elems] int8; scales: [n_rows, n_blocks].
// seeds: host array of n_rows 64-bit seeds when stochastic, else unused.
extern "C" int dps_block_quantize(const void* x, long long n,
                                  long long x_row_stride, int n_rows,
                                  void* values, void* scales,
                                  int block_elems, int n_blocks,
                                  int stochastic,
                                  const unsigned long long* seeds,
                                  void* stream) {
  if (n_rows <= 0 || n_blocks <= 0) return 0;
  if (n_rows > 65535 || block_elems <= 0 || block_elems % 4 != 0 ||
      (stochastic && (n_rows > DPS_MAX_SEEDED_ROWS || seeds == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  SeedTable table = {};
  if (stochastic)
    for (int r = 0; r < n_rows; ++r) table.s[r] = seeds[r];
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(n_rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stochastic)
    block_quantize_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n, x_row_stride,
        static_cast<signed char*>(values), static_cast<float*>(scales),
        block_elems, n_blocks, table);
  else
    block_quantize_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n, x_row_stride,
        static_cast<signed char*>(values), static_cast<float*>(scales),
        block_elems, n_blocks, table);
  return static_cast<int>(cudaGetLastError());
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

// The first version, with the same arguments (values 4-byte aligned,
// block_elems a multiple of 4).
extern "C" int dps_block_dequantize_v1(const void* values, const void* scales,
                                       void* out, long long n,
                                       long long out_row_stride, int n_rows,
                                       int block_elems, int n_blocks,
                                       void* stream) {
  if (n <= 0 || n_rows <= 0) return 0;
  if (n_rows > 65535 || block_elems <= 0 || block_elems % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  // Enough blocks, with the rows, to fill every SM of an H100 many times;
  // the grid-stride loop covers the rest.
  if (blocks > 1024) blocks = 1024;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_rows));
  block_dequantize_v1_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(values),
      static_cast<const float*>(scales), static_cast<float*>(out), n,
      out_row_stride, block_elems, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
