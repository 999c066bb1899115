// Wire quantize (kernel K1 of the port) for Hopper, sm_90a.
//
// Replaces distributed_parameter_server_for_ml_training_tpu/ops/pallas/
// quantize.py:_wire_quantize_kernel, the TPU kernel the device push codec
// runs on every int8/int4 push. Per element:
//
//     q = clamp(rint(x / scale), -levels, levels) -> int8
//
// with a true IEEE division (__fdiv_rn: never a reciprocal multiply, which
// rounds twice), round-half-to-even (rintf, not roundf) and the clamp in
// float before the cast, so the codes are bit-identical to the NumPy
// reference codec (ops/compression.py) and to the JAX package. Build with
// --fmad=false and never --use_fast_math.
//
// The TPU kernel views the tensor as padded [rows, 128] blocks; padding
// zeros quantize to 0 and are cropped, so one flat pass over the n real
// elements computes the same codes without the pad or the crop.
//
// Bound: memory. 5 bytes move per element (4 read, 1 written) for ~4
// flops, far below the card's balance point. A full ResNet-18 push is
// 11,220,132 elements = 56.1 MB, 16.7 us at 3.35 TB/s.
//
// Two kernels:
//
// wire_quantize_multi_kernel (dps_wire_quantize_multi) quantizes a whole
// push in one launch. A push is 62 tensors for ResNet-18, most of them
// small, and one launch per tensor left a push launch-bound (~24 us of host
// time a launch against 0.27 us of bytes on average). The table of entries
// (input pointer, output offset, n, scale, levels) goes by value as a
// __grid_constant__ kernel parameter, at most 64 entries (~2.3 KB, under
// the 4 KB parameter limit), so no host->device copy precedes the launch;
// it ends with the prefix of the entries' tile counts. Each thread block
// takes one tile of kWireTile values of one entry (a tile never crosses
// entries) and finds its entry by a binary search of that prefix; the grid
// is the total tile count. Tiles of 4,096 values (16 a thread) need fewer
// registers a thread than tiles of 8,192, so more blocks stay resident. A
// full tile of a 16-byte-aligned input is read with float4 loads, all of
// a thread's loads issued before it computes, to keep enough bytes in
// flight for HBM3; a partial tile or an input off 16-byte alignment takes
// coalesced scalar loads in the same launch. The
// codes go through shared memory so that each thread writes 16-byte
// stores: all entries share one int8 buffer and each entry's offset is a
// multiple of 16, so every output tile is aligned. The bytes between an
// entry's n and its next multiple of 16 are written as code 0.
//
// wire_quantize_kernel (dps_wire_quantize) is the first version, one launch
// per tensor: float4 loads and char4 stores when both pointers are aligned,
// a scalar tail, and a grid-stride loop. It stays as the reference's
// one-tensor surface (ops/quantize.py:wire_quantize) and runs on no main
// path.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define DPS_WIRE_MAX_ENTRIES 64

namespace {

constexpr int kWireThreads = 256;
constexpr int kWireTile = 4096;                       // values a thread block
constexpr int kWirePerThread = kWireTile / kWireThreads;
static_assert(kWireTile % (16 * kWireThreads) == 0,
              "a tile is a whole number of 16-byte stores per thread");

struct WireEntry {
  const float* x;
  long long out_offset;  // bytes into the shared output, a multiple of 16
  long long n;
  float scale;
  float levels;
};

struct WireTable {
  WireEntry e[DPS_WIRE_MAX_ENTRIES];
  int tile_start[DPS_WIRE_MAX_ENTRIES + 1];  // prefix of the tile counts
  int count;
};

__device__ __forceinline__ signed char quantize_one(float x, float scale,
                                                    float levels) {
  float q = rintf(__fdiv_rn(x, scale));
  q = fminf(fmaxf(q, -levels), levels);
  return static_cast<signed char>(__float2int_rn(q));
}

__global__ void __launch_bounds__(kWireThreads)
wire_quantize_multi_kernel(const __grid_constant__ WireTable table,
                           signed char* __restrict__ out) {
  __shared__ __align__(16) signed char codes[kWireTile];
  const int tile = blockIdx.x;
  // This tile's entry: the last one whose first tile is at or before it
  // (an empty entry has no tile, so it is never the one found).
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.tile_start[mid] <= tile)
      lo = mid;
    else
      hi = mid - 1;
  }
  const WireEntry& en = table.e[lo];
  const long long start = (long long)(tile - table.tile_start[lo]) * kWireTile;
  const long long rest = en.n - start;
  const int count = rest < kWireTile ? static_cast<int>(rest) : kWireTile;
  const float* x = en.x + start;
  const float scale = en.scale, levels = en.levels;
  const int t = threadIdx.x;

  if (count == kWireTile && (reinterpret_cast<uintptr_t>(en.x) & 15) == 0) {
    float4 v[kWirePerThread / 4];
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
    for (int j = 0; j < kWirePerThread / 4; ++j) v[j] = x4[j * kWireThreads + t];
    char4* c4 = reinterpret_cast<char4*>(codes);
#pragma unroll
    for (int j = 0; j < kWirePerThread / 4; ++j) {
      char4 r;
      r.x = quantize_one(v[j].x, scale, levels);
      r.y = quantize_one(v[j].y, scale, levels);
      r.z = quantize_one(v[j].z, scale, levels);
      r.w = quantize_one(v[j].w, scale, levels);
      c4[j * kWireThreads + t] = r;
    }
  } else {
    float v[kWirePerThread];
#pragma unroll
    for (int j = 0; j < kWirePerThread; ++j) {
      const int i = j * kWireThreads + t;
      v[j] = i < count ? x[i] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kWirePerThread; ++j) {
      const int i = j * kWireThreads + t;
      codes[i] = i < count ? quantize_one(v[j], scale, levels)
                           : static_cast<signed char>(0);
    }
  }
  __syncthreads();

  const int stores = (count + 15) >> 4;
  int4* dst = reinterpret_cast<int4*>(out + en.out_offset + start);
  const int4* src = reinterpret_cast<const int4*>(codes);
#pragma unroll
  for (int j = 0; j < kWireTile / 16 / kWireThreads; ++j) {
    const int i = j * kWireThreads + t;
    if (i < stores) dst[i] = src[i];
  }
}

__global__ void wire_quantize_kernel(const float* __restrict__ x,
                                     signed char* __restrict__ out,
                                     long long n, float scale, float levels,
                                     int vectorized) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = 0;
  if (vectorized) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* o4 = reinterpret_cast<char4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      char4 r;
      r.x = quantize_one(v.x, scale, levels);
      r.y = quantize_one(v.y, scale, levels);
      r.z = quantize_one(v.z, scale, levels);
      r.w = quantize_one(v.w, scale, levels);
      o4[i] = r;
    }
    start = n4 * 4;
  }
  for (long long i = start + tid; i < n; i += stride) {
    out[i] = quantize_one(x[i], scale, levels);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`
// (PyTorch's current stream) of the calling thread's current device, does
// not synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it cannot take) so the caller can raise.

// count <= 64 entries, each given by the host arrays: the fp32 input's
// device address, its byte offset in `out` (a multiple of 16), n, scale and
// levels. `out` is 16-byte aligned. Launches nothing when every entry is
// empty.
extern "C" int dps_wire_quantize_multi(int count, const long long* x_ptrs,
                                       const long long* out_offsets,
                                       const long long* ns,
                                       const float* scales,
                                       const int* levels, void* out,
                                       void* stream) {
  if (count < 0 || count > DPS_WIRE_MAX_ENTRIES ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WireTable table = {};
  long long tiles = 0;
  for (int i = 0; i < count; ++i) {
    if (ns[i] < 0 || (out_offsets[i] & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    table.e[i].x = reinterpret_cast<const float*>(x_ptrs[i]);
    table.e[i].out_offset = out_offsets[i];
    table.e[i].n = ns[i];
    table.e[i].scale = scales[i];
    table.e[i].levels = static_cast<float>(levels[i]);
    table.tile_start[i] = static_cast<int>(tiles);
    tiles += (ns[i] + kWireTile - 1) / kWireTile;
    if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  table.tile_start[count] = static_cast<int>(tiles);
  table.count = count;
  if (tiles == 0) return 0;
  wire_quantize_multi_kernel<<<static_cast<unsigned>(tiles), kWireThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<signed char*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dps_wire_quantize(const void* x, void* out, long long n,
                                 float scale, int levels, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
      ((reinterpret_cast<uintptr_t>(out) & 3) == 0);
  const long long work = vectorized ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  // Enough blocks for every SM of an H100 many times over; the grid-stride
  // loop covers the rest.
  if (blocks > 132 * 16) blocks = 132 * 16;
  wire_quantize_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<signed char*>(out), n, scale,
      static_cast<float>(levels), vectorized);
  return static_cast<int>(cudaGetLastError());
}
