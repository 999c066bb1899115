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
// 11,220,132 elements = 56.1 MB, 16.7 us at 3.35 TB/s. The design keeps to
// that: float4 loads (16 bytes a thread) and char4 stores when both
// pointers are aligned, a scalar tail, and a grid-stride loop. This first
// version launches once per tensor: 62 launches per ResNet-18 push (20
// convs + 20 BN x 2 + head x 2), most of them on small tensors, so launch
// latency rather than bytes is expected to dominate a whole push.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ signed char quantize_one(float x, float scale,
                                                    float levels) {
  float q = rintf(__fdiv_rn(x, scale));
  q = fminf(fmaxf(q, -levels), levels);
  return static_cast<signed char>(__float2int_rn(q));
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

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns cudaGetLastError() so
// the caller can raise on a refused launch.
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
