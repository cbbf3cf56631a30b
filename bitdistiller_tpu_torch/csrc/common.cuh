// Helpers shared by the port's kernels (quant_matmul.cu, quant_matmul_a8.cu,
// fused_mlp.cu, decode_attention.cu): the block shape, bf16 conversions, the
// bf16 exponent-bias unpack of the pair layout, the combo-word decode and the
// tensor-core mma wrapper.
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
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// bf16x2 bit pattern of (off + code) for the two k of extraction i of w,
// ((w >> BITS*i) & kMask) << kShift | kExp, as one shift and one three-input
// LOP3 (a & b) | c with both constants in registers: written plainly it
// compiles to a shift and two LOP3s, since a LOP3 takes one immediate.
template <int BITS>
__device__ __forceinline__ uint32_t extract_bits(uint32_t w, int i) {
  const int sh = BITS * i - Trick<BITS>::kShift;
  const uint32_t t = sh >= 0 ? w >> sh : w << -sh;
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(d)
      : "r"(t), "r"(Trick<BITS>::kMask << Trick<BITS>::kShift), "r"(Trick<BITS>::kExp));
  return d;
}

// Where a lane finds its codes when the packed kernels walk K in steps of 128
// that hold 128 / G groups (G = 32, 64 or 128; a group of g > 128 is walked
// as g / 128 steps of 128 with x permuted to match, ops/quant_matmul.py:
// step_kmap). A tensor-core k-block of the step covers 16 k (KPS = 2: the
// A16 pair layout, one extraction is two k) or 32 k (KPS = 4: the A8 byte
// order, one extraction is four k) of one group, as 8 slots of KPS k: slot
// 4h + quad of k-block kb holds the k-run p = 8 * (kb % KB) + 4h + quad of
// group kb / KB, which the group's layout keeps in word row p % R, field
// p / R (quant/packing.py: k_local = field * KPS * R + KPS * row + j).
//   R >= 4: lane quad holds the step's word rows 4u + quad, u < RS / 4;
//           (kb, h) reads word u = (gs * R + p0 % R) / 4, field p0 / R
//           (p0 = 8 * (kb % KB) + 4h), all known when compiled;
//   R = 2 (int2 at G = 32): lane quad holds rows 2u + (quad & 1), u < RS / 2,
//           pre-shifted by BITS * (quad >> 1) fields; (kb, h) reads word gs,
//           field p0 / 2.
// kb runs over 128 / (8 * KPS) k-blocks a step; group gs ends after its KB.
template <int BITS, int G, int KPS>
struct StepMap {
  static constexpr int RS = 128 * BITS / 32;  // word rows a step
  static constexpr int R = G * BITS / 32;     // word rows a group
  static constexpr int SUB = 128 / G;         // groups a step
  static constexpr int KB = G / (8 * KPS);    // k-blocks a group
  static constexpr int NKB = 128 / (8 * KPS); // k-blocks a step
  static constexpr bool kNarrow = R < 4;
  static constexpr int NW = kNarrow ? RS / 2 : RS / 4;  // words a lane holds a column
  static_assert(G == 32 || G == 64 || G == 128, "a step holds whole groups");
  static_assert(R >= 2 && (R % 4 == 0 || R == 2), "word rows of a group");
  __device__ static __forceinline__ int row(int u, int quad) {
    return kNarrow ? 2 * u + (quad & 1) : 4 * u + quad;
  }
  __device__ static __forceinline__ int preshift(int quad) {
    return kNarrow ? BITS * (quad >> 1) : 0;
  }
  __host__ __device__ static constexpr int word(int kb, int h) {
    return kNarrow ? kb / KB : ((kb / KB) * R + (8 * (kb % KB) + 4 * h) % R) / 4;
  }
  __host__ __device__ static constexpr int field(int kb, int h) {
    return (8 * (kb % KB) + 4 * h) / R;
  }
  __host__ __device__ static constexpr bool group_end(int kb) { return kb % KB == KB - 1; }
};

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 consecutive activations from x (bf16, or f32 rounded to bf16 as the
// kernels multiply them), as four bf16x2 words
__device__ __forceinline__ uint4 load8_bf16(const void* x, size_t i, bool f32) {
  if (!f32) return __ldcg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + i));
  const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(x) + i);
  const float4 a = __ldcg(p), b = __ldcg(p + 1);
  uint4 r;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(a.x, a.y); r.x = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(a.z, a.w); r.y = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(b.x, b.y); r.z = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(b.z, b.w); r.w = *reinterpret_cast<uint32_t*>(&h);
  return r;
}

// out[i] in the output's dtype: bf16, or f32
__device__ __forceinline__ void store_out(void* out, size_t i, float v, bool f32) {
  if (f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

// Row of the group statistics (combo words, scales) of K step g: its first
// group's at SUB groups a step, else g / gdiv (gdiv = group / 128; 1 at
// g128, which skips the division)
__device__ __forceinline__ int step_row(int g, int sub, int gdiv) {
  return sub > 1 ? g * sub : (gdiv == 1 ? g : g / gdiv);
}

// Source k of kernel position k (a step-ordered copy of x for groups of
// g > 128): the table kmap of one period P, else k itself
__device__ __forceinline__ int src_k(int k, const int* kmap, int P) {
  return kmap ? k - k % P + __ldg(kmap + k % P) : k;
}

__device__ __forceinline__ void decode_combo(uint32_t c, float& s, float& sz) {
  s = __uint_as_float(c << 16);
  sz = __uint_as_float(c & 0xFFFF0000u);
}

// D += A (16 x 16, row) * B (16 x 8, col); bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bd
