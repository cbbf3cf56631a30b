// Packed int2/int4 dequantize-matmul for Hopper (sm_90a), plain C interface
// for ctypes (bitdistiller_tpu_torch/ops/quant_matmul.py).
//
// Replaces the TPU kernels bitdistiller_tpu/ops/quant_matmul.py:_qmm_kernel
// (:107, prefill GEMM and any un-stacked call) and _qmm_kernel_stacked (:152,
// every decode matmul of the stacked layer scan). On the GPU the stacked form
// needs no kernel of its own: the caller passes the layer's base pointer
// (qweight[li].data_ptr(), a view), so one kernel serves both.
//
//   out[m, n] = sum_g s[g,n] * (x[m, kg] . (q+off)[kg, n])
//               - (sz[g,n] + off * s[g,n]) * sum_{k in g} x[m, k]
//
// Codes come out of the pair-layout words (quant/packing.py) with one shift,
// mask and OR per PAIR of codes: (w >> bits*i) & 0x000m000m | exp_bits is a
// __nv_bfloat162 holding (off+q_lo, off+q_hi) — the TPU's exponent-bias
// trick, no int->float convert. Scale and zero come from one combo word
// (bf16 scale low, bf16 szero high). The scale/zero correction is applied
// once per (row, column, group) to an f32 accumulator.
//
// Bound on this card. Decode (M <= 32) is bound by bytes: the packed weight
// (K*N*bits/8) plus the combo words (K/G*N*4) must stream from HBM once, at
// 3.35 TB/s; x is a few KB. Design: the dot products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), because on CUDA cores the
// unpack-and-FMA work (about 26 instructions a code pair a column at M=8)
// kept the first versions at 15x the byte bound. The pair layout makes the
// B fragment free: one extraction of a word is exactly a lane's bf16x2 B
// register. A block owns 32 columns and its 8 warps split the K groups, so
// every warp has its own stream of word loads and no barrier until the final
// shared-memory reduction; a block carries no state to another block. x
// (at most 32 x 11008 bf16) is read through L1 rather than staged in shared
// memory: every block reads all of it, it stays cached, and staging cost a
// barrier a chunk. Prefill (large M) is bound by operations on the tensor
// cores (989 TFLOP/s bf16); this first version is a tiled CUDA-core FMA
// kernel (64x64 tile, 4x4 outputs a thread, one group staged at a time) and
// runs far below that bound — wgmma and TMA are later work.

#include "common.cuh"

namespace {

using namespace bd;

// ---------------------------------------------------------------------------
// Decode: M <= 16 * TILES rows. One block per 32 columns (4 n-tiles of 8,
// so a warp reads an x fragment once for 4 mma); its 8 warps split
// the K groups (warp w takes groups w, w + 8, ...) and are reduced in shared
// memory at the end. A warp computes a group with mma.sync.m16n8k16 (bf16
// inputs, f32 accumulators), one mma per k-block of 16:
//   A (16 x 16, rows m, k)  x, read through L1 as bf16 pairs;
//   B (16 x 8,  k, cols n)  off + codes, straight from the pair layout: lane
//                           l holds column l/4 of the n-tile and k pairs
//                           2(l%4) and 2(l%4) + 8 of the block, which one
//                           extraction of words r = l%4 + 4q yields as bf16x2
//                           registers;
//   a second mma against a B of ones gives sum_k x[m, k] in the same layout.
// ---------------------------------------------------------------------------

constexpr int DEC_NT = 4;  // n-tiles of 8 columns a block: x is read once for all
constexpr int DEC_COLS = 8 * DEC_NT;

template <typename T, int BITS, int TILES>
__global__ void __launch_bounds__(kThreads)
    qmm_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qw,
                      const uint32_t* __restrict__ combo, T* __restrict__ out, int M, int K,
                      int N) {
  constexpr int G = 128;
  constexpr int PACK = 32 / BITS;
  constexpr int R = G / PACK;  // words a column a group
  constexpr int WPL = R / 4;   // words a lane a group and n-tile
  constexpr int BPI = R / 8;   // k-blocks of 16 one extraction spans
  constexpr int NV = 4 * TILES * DEC_NT;  // accumulator values a lane
  __shared__ float red[kWarps][32][NV];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;  // k pair (A, B) and column pair (C) in a fragment
  const int row = lane >> 2;  // row (A, C) and column (B) in a fragment
  const int n0 = blockIdx.x * DEC_COLS;
  const int ng = K / G;

  float acc[TILES][DEC_NT][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int nt = 0; nt < DEC_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  for (int g = warp; g < ng; g += kWarps) {
    uint32_t words[DEC_NT][WPL];
#pragma unroll
    for (int nt = 0; nt < DEC_NT; ++nt) {
      const int n = n0 + 8 * nt + row;  // this lane's B column
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        words[nt][q] = n < N ? __ldg(qw + (size_t(g) * R + 4 * q + quad) * N + n) : 0u;
    }
    float part[TILES][DEC_NT][4], xs[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[t][e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < DEC_NT; ++nt) part[t][nt][e] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < G / 16; ++j) {
      const int i = j / BPI;
      const int q = 2 * (j % BPI);
      const int k = g * G + 16 * j + 2 * quad;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int m0 = 16 * t + row;
        const __nv_bfloat16* x0 = x + size_t(m0) * K + k;
        const __nv_bfloat16* x1 = x0 + size_t(8) * K;
        const uint32_t a[4] = {load_pair(x0, m0 < M), load_pair(x1, m0 + 8 < M),
                               load_pair(x0 + 8, m0 < M), load_pair(x1 + 8, m0 + 8 < M)};
#pragma unroll
        for (int nt = 0; nt < DEC_NT; ++nt)
          mma_bf16(part[t][nt], a, extract_bits<BITS>(words[nt][q], i),
                   extract_bits<BITS>(words[nt][q + 1], i));
        mma_bf16(xs[t], a, kOnesBf16x2, kOnesBf16x2);  // sum_k x, any column
      }
    }
#pragma unroll
    for (int nt = 0; nt < DEC_NT; ++nt) {
      float s[2] = {0.f, 0.f}, zc[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + 8 * nt + 2 * quad + c;  // this lane's C columns
        if (n < N) {
          float sz;
          decode_combo(__ldg(combo + size_t(g) * N + n), s[c], sz);
          zc[c] = sz + Trick<BITS>::kOffset * s[c];  // the +off of the codes
        }
      }
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][nt][e] = acc[t][nt][e] + part[t][nt][e] * s[e & 1] - xs[t][e] * zc[e & 1];
    }
  }

#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int nt = 0; nt < DEC_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][lane][(t * DEC_NT + nt) * 4 + e] = acc[t][nt][e];
  __syncthreads();
  for (int idx = threadIdx.x; idx < 32 * NV; idx += kThreads) {
    const int l = idx / NV;
    const int v = idx - l * NV;
    const int e = v & 3;
    const int nt = (v / 4) % DEC_NT;
    const int t = v / (4 * DEC_NT);
    const int m = 16 * t + (l >> 2) + ((e & 2) ? 8 : 0);
    const int n = n0 + 8 * nt + 2 * (l & 3) + (e & 1);
    if (m < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][l][v];
      out[size_t(m) * N + n] = from_f32<T>(sum);
    }
  }
}

// ---------------------------------------------------------------------------
// Prefill: 64x64 output tile a block, 4x4 outputs a thread, one group staged
// at a time. Shared memory: xs [G][XS_LD] (k-major) | cs [G][BN] | xsum [BM]
// ---------------------------------------------------------------------------

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int XS_LD = BM + 4;  // padded k-major rows: 4-way, not 32-way, store conflicts

template <int G>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (size_t(G) * XS_LD + size_t(G) * BN + BM);
}

template <typename T, int BITS, int G>
__global__ void __launch_bounds__(kThreads)
    qmm_prefill_kernel(const T* __restrict__ x, const uint32_t* __restrict__ qw,
                       const uint32_t* __restrict__ combo, T* __restrict__ out, int M, int K,
                       int N) {
  constexpr int PACK = 32 / BITS;
  constexpr int HALF = PACK / 2;
  constexpr int R = G / PACK;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* cs = xs + G * XS_LD;
  float* xsum = cs + G * BN;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. tx*4+3
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ng = K / G;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < ng; ++g) {
    __syncthreads();
    for (int idx = tid; idx < BM * G; idx += kThreads) {
      const int m = idx / G;
      const int kk = idx - m * G;
      const int row = row0 + m;
      xs[kk * XS_LD + m] = row < M ? to_f32(x[size_t(row) * K + size_t(g) * G + kk]) : 0.f;
    }
    for (int idx = tid; idx < R * BN; idx += kThreads) {
      const int r = idx / BN;
      const int c = idx - r * BN;
      const int col = col0 + c;
      const uint32_t w = col < N ? __ldg(qw + (size_t(g) * R + r) * N + col) : 0u;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float2 v = extract_pair<BITS>(w, i);
        const int k0 = i * 2 * R + 2 * r;
        cs[k0 * BN + c] = v.x;
        cs[(k0 + 1) * BN + c] = v.y;
      }
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int kk = 0; kk < G; ++kk) s += xs[kk * XS_LD + tid];
      xsum[tid] = s;
    }
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < G; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(xs + kk * XS_LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(cs + kk * BN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    __syncthreads();  // xsum is written
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      float s = 0.f, sz = 0.f;
      if (col < N) decode_combo(__ldg(combo + size_t(g) * N + col), s, sz);
      const float zc = sz + Trick<BITS>::kOffset * s;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = acc[i][j] + part[i][j] * s - xsum[ty * 4 + i] * zc;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < N) out[size_t(row) * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BITS, int TILES>
cudaError_t launch_decode(const void* x, const void* qw, const void* combo, void* out, int M,
                          int K, int N, cudaStream_t stream) {
  dim3 grid((N + DEC_COLS - 1) / DEC_COLS);
  qmm_decode_kernel<T, BITS, TILES><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const uint32_t*>(combo), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename T, int BITS, int G>
cudaError_t launch_decode_mt(const void* x, const void* qw, const void* combo, void* out,
                             int M, int K, int N, cudaStream_t stream) {
  if (M <= 16) return launch_decode<T, BITS, 1>(x, qw, combo, out, M, K, N, stream);
  return launch_decode<T, BITS, 2>(x, qw, combo, out, M, K, N, stream);
}

template <typename T, int BITS, int G>
cudaError_t launch_prefill(const void* x, const void* qw, const void* combo, void* out, int M,
                           int K, int N, cudaStream_t stream) {
  auto kernel = qmm_prefill_kernel<T, BITS, G>;
  constexpr size_t smem = prefill_smem_bytes<G>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const uint32_t*>(combo), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

// x and out are bfloat16; the wrapper raises for other dtypes
// and groups are 128 wide (the serving path's int2-g128 / int4-g128)
#define BD_DISPATCH(LAUNCH, ...)                                                    \
  do {                                                                              \
    if (group != 128) return cudaErrorInvalidValue;                                 \
    if (bits == 2) return LAUNCH<__nv_bfloat16, 2, 128>(__VA_ARGS__);                 \
    if (bits == 4) return LAUNCH<__nv_bfloat16, 4, 128>(__VA_ARGS__);                 \
    return cudaErrorInvalidValue;                                                   \
  } while (0)

}  // namespace

extern "C" {

// x [M, K], qweight [K/pack, N] (one layer: the caller offsets a stacked
// array to layer li), combo [K/G, N], out [M, N]; all row-major, contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
int bd_qmm_decode(const void* x, const void* qweight, const void* combo, void* out, int M,
                  int K, int N, int bits, int group, void* stream) {
  if (M < 1 || M > 32 || K % group != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BD_DISPATCH(launch_decode_mt, x, qweight, combo, out, M, K, N, s);
}

int bd_qmm_prefill(const void* x, const void* qweight, const void* combo, void* out, int M,
                   int K, int N, int bits, int group, void* stream) {
  if (M < 1 || K % group != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BD_DISPATCH(launch_prefill, x, qweight, combo, out, M, K, N, s);
}

}  // extern "C"
