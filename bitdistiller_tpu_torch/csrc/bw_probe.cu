// Streaming-read probe of the card's practical HBM rate, for Hopper
// (sm_90a), plain C interface for ctypes
// (bitdistiller_tpu_torch/scripts/bw_probe.py).
//
// Replaces the TPU kernel scripts/bw_probe.py:stream_kernel (:100, pallas_call
// at :120 in pallas_stream_builder): read the K and V plane sets (two
// contiguous arrays, bf16 or int8) once and fold them into an f32 chained
// across calls, c' = c * 1e-6 + (sum K + sum V) * 1e-9, so no call can be
// elided. (The TPU kernel's DMA read every byte but summed one row a block;
// here every element is summed, since a load whose value is unused would be
// dropped by the compiler.)
//
// Bound on this card: bytes, 2 * n * sizeof(element) at 3.35 TB/s; the sum
// is one add an element. Design: a grid of 4 blocks an SM strides over both
// arrays in 16-byte loads, four in flight a thread an iteration; bf16 pairs
// convert with one instruction, int8 quads sum exactly with __dp4a. Each
// block writes its partial sum; a one-block second kernel adds the partials
// in block order, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float sum16(uint4 u, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s += f.x + f.y;
  }
  return s;
}

__device__ __forceinline__ float sum16(uint4 u, const int8_t*) {
  int s = __dp4a(static_cast<int>(u.x), 0x01010101, 0);
  s = __dp4a(static_cast<int>(u.y), 0x01010101, s);
  s = __dp4a(static_cast<int>(u.z), 0x01010101, s);
  s = __dp4a(static_cast<int>(u.w), 0x01010101, s);
  return static_cast<float>(s);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;  // valid in thread 0
}

// n16: 16-byte chunks in each array
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, size_t n16,
                  float* __restrict__ partials) {
  const T* tag = nullptr;
  const size_t stride = size_t(gridDim.x) * kThreads;
  size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x;
  float s = 0.f;
  for (; i + stride < n16; i += 2 * stride) {
    const uint4 a0 = __ldcs(a + i), a1 = __ldcs(a + i + stride);
    const uint4 b0 = __ldcs(b + i), b1 = __ldcs(b + i + stride);
    s += (sum16(a0, tag) + sum16(b0, tag)) + (sum16(a1, tag) + sum16(b1, tag));
  }
  if (i < n16) s += sum16(__ldcs(a + i), tag) + sum16(__ldcs(b + i), tag);
  const float total = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ partials, int n, const float* __restrict__ c_in,
                  float* __restrict__ c_out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  const float total = block_sum(s);
  if (threadIdx.x == 0) c_out[0] = c_in[0] * 1e-6f + total * 1e-9f;
}

}  // namespace

extern "C" {

// The number of partial sums bd_stream_sum writes: its grid size.
int bd_stream_blocks(void) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms * kBlocksPerSm;
}

// a, b: two contiguous arrays of nbytes each (16-byte aligned, nbytes a
// multiple of 16), bf16 (int8_elems = 0) or int8 (1); partials: float
// [bd_stream_blocks()] scratch; c_in, c_out: one f32 each on the device.
// Returns cudaGetLastError() after the launches.
int bd_stream_sum(const void* a, const void* b, long long nbytes, int int8_elems,
                  void* partials, const void* c_in, void* c_out, void* stream) {
  if (nbytes <= 0 || nbytes % 16) return cudaErrorInvalidValue;
  const int blocks = bd_stream_blocks();
  if (blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n16 = static_cast<size_t>(nbytes) / 16;
  const uint4* ua = static_cast<const uint4*>(a);
  const uint4* ub = static_cast<const uint4*>(b);
  float* p = static_cast<float*>(partials);
  if (int8_elems)
    stream_kernel<int8_t><<<blocks, kThreads, 0, s>>>(ua, ub, n16, p);
  else
    stream_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(ua, ub, n16, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<1, kThreads, 0, s>>>(p, blocks, static_cast<const float*>(c_in),
                                        static_cast<float*>(c_out));
  return cudaGetLastError();
}

}  // extern "C"
