// Helpers shared by the port's packed-weight kernels (quant_matmul.cu,
// quant_matmul_a8.cu, fused_mlp.cu): the bf16 exponent-bias unpack of the
// pair layout, the combo-word decode and the tensor-core mma wrappers.
// Everything here is inline device code; including it adds no symbol.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bd {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int BITS>
struct Trick;
template <>
struct Trick<2> {  // bf16(4 + q) = 0x4080 | q << 5, q in [0, 4)
  static constexpr uint32_t kMask = 0x00030003u;
  static constexpr int kShift = 5;
  static constexpr uint32_t kExp = 0x40804080u;
  static constexpr float kOffset = 4.0f;
};
template <>
struct Trick<4> {  // bf16(16 + q) = 0x4180 | q << 3, q in [0, 16)
  static constexpr uint32_t kMask = 0x000F000Fu;
  static constexpr int kShift = 3;
  static constexpr uint32_t kExp = 0x41804180u;
  static constexpr float kOffset = 16.0f;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Extraction i of a pair-layout word: (off + code) of rows i*2R + 2r (x) and
// i*2R + 2r + 1 (y).
template <int BITS>
__device__ __forceinline__ float2 extract_pair(uint32_t w, int i) {
  const uint32_t t =
      (((w >> (BITS * i)) & Trick<BITS>::kMask) << Trick<BITS>::kShift) | Trick<BITS>::kExp;
  const __nv_bfloat162 pair =
      __halves2bfloat162(__ushort_as_bfloat16(static_cast<unsigned short>(t & 0xFFFFu)),
                         __ushort_as_bfloat16(static_cast<unsigned short>(t >> 16)));
  return __bfloat1622float2(pair);
}

// bf16x2 bit pattern of (off + code) for the two k of extraction i of w
template <int BITS>
__device__ __forceinline__ uint32_t extract_bits(uint32_t w, int i) {
  return (((w >> (BITS * i)) & Trick<BITS>::kMask) << Trick<BITS>::kShift) | Trick<BITS>::kExp;
}

__device__ __forceinline__ void decode_combo(uint32_t c, float& s, float& sz) {
  s = __uint_as_float(c << 16);
  sz = __uint_as_float(c & 0xFFFF0000u);
}

constexpr uint32_t kOnesBf16x2 = 0x3F803F80u;

// D += A (16 x 16, row) * B (16 x 8, col); bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bd
