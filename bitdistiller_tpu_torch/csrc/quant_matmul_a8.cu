// W{2,4}A8 packed matmul for Hopper (sm_90a), plain C interface for ctypes
// (bitdistiller_tpu_torch/ops/quant_matmul.py: qmm_a8).
//
// Replaces the TPU kernel bitdistiller_tpu/ops/quant_matmul.py:_qmm_a8_kernel
// (:721, pallas_call at :773) and the tensor code around it in
// quant_matmul_a8 (:794): the per-token int8 quantization of x and the
// extraction permutation for pair-layout words.
//
//   sx[m] = max(max_k |x[m, k]| / 127, 1e-8),  xi = clip(rint(x / sx), +-127)
//   out[m, n] = bf16(sx[m] * sum_g (s[g,n] * (xi . q)_g - sz[g,n] * sum(xi_g))
//                    (+ bias[n]))
//
// Two kernels, one call. quantize_rows: one block a row; the max, the IEEE
// division and rintf (half to even) are those of the plain version, so
// integer-valued rows quantize bit for bit alike (built without fast math).
// For pair-layout words it also applies the per-group permutation kmap (the
// JAX package's _a8_perm), so xi comes out in the words' extraction order.
//
// qmm_a8: in the A8 byte order, byte lane j of bit field i of word row r
// holds k = i*4R + 4r + j, so one extraction (w >> bits*i) & 0x0m0m0m0m is
// four consecutive k as four signed bytes (codes are at most 15): exactly a
// lane's B register of mma.sync.m16n8k32.s8 (k = 4*(lane%4) + 0..3 and
// +16), and four consecutive int8 of xi are its A register. One mma takes a
// k-block of 32 for 8 columns; a second against a B of 0x01 bytes gives the
// group's sum(xi). The int32 group products turn f32 once a group.
//
// Bound on this card. Decode (small M) is bound by bytes: the packed words
// (K*N*bits/8) and the f32 scales and szeros (8 bytes a group column, against
// 4 for the A16 kernels' combo word) stream from HBM once, at 3.35 TB/s.
// Prefill (large M) is bound by int8 tensor-core operations (1,979 TOP/s).
// Design: as the A16 decode kernel, a block owns 32 columns and up to 32
// rows (grid.y tiles larger M), its 8 warps split the K groups and are
// reduced in shared memory in warp order, so the sum is deterministic and no
// block carries state to another. This first version re-reads a block's
// words for every 32 rows of M: wgmma tiles for prefill are later work.

#include "common.cuh"

namespace {

using namespace bd;

constexpr int G = 128;
constexpr int NT = 4;  // n-tiles of 8 columns a block: an xi fragment serves 4 mma
constexpr int COLS = 8 * NT;
constexpr uint32_t kOnesS8x4 = 0x01010101u;

template <int BITS>
struct ByteMask;
template <>
struct ByteMask<2> {
  static constexpr uint32_t kMask = 0x03030303u;
};
template <>
struct ByteMask<4> {
  static constexpr uint32_t kMask = 0x0F0F0F0Fu;
};

// D += A (16 x 32, row) * B (32 x 8, col); s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_s8x4(const int8_t* p, bool ok) {
  return ok ? static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(p))) : 0u;
}

__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ kmap,
                         int8_t* __restrict__ xi, float* __restrict__ sx, int K) {
  __shared__ float red[kWarps];
  const int m = blockIdx.x;
  const __nv_bfloat16* xr = x + size_t(m) * K;
  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) mx = fmaxf(mx, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  const float s = fmaxf(mx / 127.0f, 1e-8f);  // IEEE division, as the plain version
  if (threadIdx.x == 0) sx[m] = s;
  for (int p = threadIdx.x; p < K; p += kThreads) {
    const int src = kmap ? (p - p % G) + kmap[p % G] : p;
    const float v = fminf(fmaxf(rintf(to_f32(xr[src]) / s), -127.f), 127.f);
    xi[size_t(m) * K + p] = static_cast<int8_t>(v);
  }
}

template <int BITS, int TILES>
__global__ void __launch_bounds__(kThreads)
    qmm_a8_kernel(const int8_t* __restrict__ xi, const float* __restrict__ sx,
                  const uint32_t* __restrict__ qw, const float* __restrict__ scales,
                  const float* __restrict__ szeros, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  constexpr int PACK = 32 / BITS;
  constexpr int R = G / PACK;  // words a column a group
  constexpr int WPL = R / 4;   // words a lane a group and n-tile
  constexpr int BPI = R / 8;   // k-blocks of 32 one extraction spans
  constexpr int NV = 4 * TILES * NT;  // accumulator values a lane
  __shared__ float red[kWarps][32][NV];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;  // k quad (A, B) and column pair (C) in a fragment
  const int row = lane >> 2;  // row (A, C) and column (B) in a fragment
  const int n0 = blockIdx.x * COLS;
  const int m_base = blockIdx.y * 16 * TILES;
  const int ng = K / G;

  float acc[TILES][NT][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  for (int g = warp; g < ng; g += kWarps) {
    uint32_t words[NT][WPL];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + 8 * nt + row;  // this lane's B column
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        words[nt][q] = n < N ? __ldg(qw + (size_t(g) * R + 4 * q + quad) * N + n) : 0u;
    }
    int part[TILES][NT][4], xs[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[t][e] = 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) part[t][nt][e] = 0;
      }
#pragma unroll
    for (int kb = 0; kb < G / 32; ++kb) {
      const int i = kb / BPI;
      const int q = 2 * (kb % BPI);
      const int k = g * G + 32 * kb + 4 * quad;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int m0 = m_base + 16 * t + row;
        const int8_t* x0 = xi + size_t(m0) * K + k;
        const int8_t* x1 = x0 + size_t(8) * K;
        const uint32_t a[4] = {load_s8x4(x0, m0 < M), load_s8x4(x1, m0 + 8 < M),
                               load_s8x4(x0 + 16, m0 < M), load_s8x4(x1 + 16, m0 + 8 < M)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(part[t][nt], a, (words[nt][q] >> (BITS * i)) & ByteMask<BITS>::kMask,
                 (words[nt][q + 1] >> (BITS * i)) & ByteMask<BITS>::kMask);
        mma_s8(xs[t], a, kOnesS8x4, kOnesS8x4);  // sum(xi), any column
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float s[2] = {0.f, 0.f}, sz[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + 8 * nt + 2 * quad + c;  // this lane's C columns
        if (n < N) {
          s[c] = __ldg(scales + size_t(g) * N + n);
          sz[c] = __ldg(szeros + size_t(g) * N + n);
        }
      }
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][nt][e] = acc[t][nt][e] + static_cast<float>(part[t][nt][e]) * s[e & 1] -
                          static_cast<float>(xs[t][e]) * sz[e & 1];
    }
  }

#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][lane][(t * NT + nt) * 4 + e] = acc[t][nt][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * NV; idx += kThreads) {
    const int l = idx / NV;
    const int v = idx - l * NV;
    const int e = v & 3;
    const int nt = (v / 4) % NT;
    const int t = v / (4 * NT);
    const int m = m_base + 16 * t + (l >> 2) + ((e & 2) ? 8 : 0);
    const int n = n0 + 8 * nt + 2 * (l & 3) + (e & 1);
    if (m < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][l][v];
      float o = sum * sx[m];
      if (bias) o += bias[n];
      out[size_t(m) * N + n] = from_f32<__nv_bfloat16>(o);
    }
  }
}

template <int BITS, int TILES>
cudaError_t launch(const int8_t* xi, const float* sx, const void* qw, const void* scales,
                   const void* szeros, const void* bias, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  dim3 grid((N + COLS - 1) / COLS, (M + 16 * TILES - 1) / (16 * TILES));
  qmm_a8_kernel<BITS, TILES><<<grid, kThreads, 0, stream>>>(
      xi, sx, static_cast<const uint32_t*>(qw), static_cast<const float*>(scales),
      static_cast<const float*>(szeros), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_mt(const int8_t* xi, const float* sx, const void* qw, const void* scales,
                      const void* szeros, const void* bias, void* out, int M, int K, int N,
                      cudaStream_t stream) {
  if (M <= 16) return launch<BITS, 1>(xi, sx, qw, scales, szeros, bias, out, M, K, N, stream);
  return launch<BITS, 2>(xi, sx, qw, scales, szeros, bias, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// x [M, K] bf16; qweight [K/pack, N] int32 (one layer: the caller offsets a
// stacked array to layer li), A8 order if kmap is null, else pair layout
// with kmap [G] int32 its extraction permutation; scales, szeros [K/G, N]
// f32; bias [N] f32 or null; xi [M, K] int8 and sx [M] f32 are scratch the
// caller allocates; out [M, N] bf16. All row-major, contiguous. G = 128,
// bits 2 or 4. Returns cudaGetLastError() after the launches (0 = launched).
int bd_qmm_a8(const void* x, const void* qweight, const void* scales, const void* szeros,
              const void* bias, const void* kmap, void* xi, void* sx, void* out, int M, int K,
              int N, int bits, int group, void* stream) {
  if (M < 1 || group != G || K % G != 0 || (bits != 2 && bits != 4)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<M, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<const int*>(kmap),
                                              static_cast<int8_t*>(xi),
                                              static_cast<float*>(sx), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int8_t* xq = static_cast<const int8_t*>(xi);
  const float* sq = static_cast<const float*>(sx);
  if (bits == 2) return launch_mt<2>(xq, sq, qweight, scales, szeros, bias, out, M, K, N, s);
  return launch_mt<4>(xq, sq, qweight, scales, szeros, bias, out, M, K, N, s);
}

}  // extern "C"
