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
// A call launches quantize_rows, then qmm_a8 (M <= 32) or group_sums and
// qmm_a8_prefill (M > 32). quantize_rows: one block a row; the max, the IEEE
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
// Design, M <= 32: as the A16 decode kernel, a block owns 32 columns and up
// to 32 rows, its 8 warps split the K groups and are reduced in shared
// memory in warp order, so the sum is deterministic and no block carries
// state to another. M > 32: s8 wgmma, the codes unpacked straight into its
// register A fragments and xi staged in shared memory by TMA, on 128- or
// 64-row tiles (see "Prefill" below).

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// Prefill (M > 32): the A16 prefill kernel's design (quant_matmul.cu) with
// int8 operands. The product is taken transposed, out^T = W^T xi^T: the
// codes are the s8 wgmma A operand in registers, xi the B operand in
// shared memory (BM x 128 int8, one 128-byte-swizzled atom a group):
//   * one block per output tile of BM = 64 or 128 rows (the wgmma N) and 128
//     columns (two warpgroups of 64, the wgmma M);
//   * a ring of PF_STAGES stages, each filled by five TMA loads that one
//     thread starts and that complete on the stage's mbarrier: the xi tile,
//     the group's words (R x 136, padded as in the A16 kernel), its f32
//     scales and szeros (128 each) and the block's int32 xi sums (BM);
//   * A fragments straight from the words: in the A8 byte order one
//     (w >> bits*i) & 0x0m0m0m0m is four consecutive k of a column, exactly
//     a register of the m16n8k32 A layout (as the decode kernel's B);
//   * part = xi_g . q_g is a fresh s32 wgmma accumulator a group (scale-d 0
//     on its first k-step), folded in f32 registers as the TPU kernel does:
//       acc += part * s - xsum * sz;  out = bf16(acc * sx[m] (+ bias[n])),
//     xsum_g[m] = sum(xi) from group_sums_kernel, a pass over xi after the
//     quantization.
// ---------------------------------------------------------------------------

constexpr int PF_BN = 128;        // output columns a block (two warpgroups of 64)
constexpr int PF_STAGES = 4;      // ring depth: 4 stages of up to 26 KB
constexpr int PF_WS = PF_BN + 8;  // word-tile row: 8 words of padding (read past N: zeros)

// xsum[g, m] = sum over group g of xi[m, :], zero for M <= m < Mp; one warp
// a (row, group)
__global__ void __launch_bounds__(kThreads)
    group_sums_kernel(const int8_t* __restrict__ xi, int* __restrict__ xsum, int M, int K,
                      int Mp) {
  const int ng = K / G;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= Mp * ng) return;
  const int m = item / ng, g = item - m * ng;
  int s = 0;
  if (m < M) s = __dp4a(__ldg(reinterpret_cast<const int*>(xi + size_t(m) * K + g * G) + lane),
                        static_cast<int>(kOnesS8x4), 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) xsum[size_t(g) * Mp + m] = s;
}

template <int BITS, int BM>
struct Prefill {
  static constexpr int R = G * BITS / 32;  // word rows a group
  static constexpr int X_BYTES = BM * G;
  static constexpr int W_BYTES = R * PF_WS * 4;
  static constexpr int S_OFF = X_BYTES + W_BYTES;  // scales, szeros, then xi sums
  static constexpr int TX_BYTES = S_OFF + 2 * PF_BN * 4 + BM * 4;  // a stage's TMA bytes
  static constexpr int STAGE = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = PF_STAGES * STAGE + PF_STAGES * 8 + 1024;  // + mbarriers, alignment
};

template <int BITS, int BM>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_a8_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap s_map,
                          const __grid_constant__ CUtensorMap z_map,
                          const __grid_constant__ CUtensorMap t_map, const float* __restrict__ sx,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                          int K, int N) {
  using P = Prefill<BITS, BM>;
  constexpr int NJ = BM / 8;    // 8-row blocks of xi: the accumulator's column blocks
  constexpr int RT = P::R / 8;  // word-row octets a group (1 at int2, 2 at int4)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int q = tid & 3;
  // this thread's accumulator rows: output columns nl and nl + 8 of the block
  const int nl = 64 * (tid >> 7) + 16 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * PF_BN;
  const int ng = K / G;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PF_STAGES * P::STAGE);

  auto load_stage = [&](int g) {  // one thread
    uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    uint64_t* bar = full + g % PF_STAGES;
    mbar_expect(bar, P::TX_BYTES);
    tma_load(st, &x_map, g * G, m0, bar);
    tma_load(st + P::X_BYTES, &w_map, n0, g * P::R, bar);
    tma_load(st + P::S_OFF, &s_map, n0, g, bar);
    tma_load(st + P::S_OFF + PF_BN * 4, &z_map, n0, g, bar);
    tma_load(st + P::S_OFF + 2 * PF_BN * 4, &t_map, m0, g, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < PF_STAGES; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < PF_STAGES - 1 && g < ng; ++g) load_stage(g);

  float acc[BM / 2];
  int part[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) {
    acc[e] = 0.f;
    part[e] = 0;
  }

  for (int g = 0; g < ng; ++g) {
    const uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    mbar_wait(full + g % PF_STAGES, (g / PF_STAGES) & 1);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + P::X_BYTES);
    // words of rows nl, nl + 8 and word rows 8t + q, 8t + q + 4 (lanes: 4
    // word rows x 8 columns, no bank conflict)
    uint32_t w[2][2 * RT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2 * RT; ++u) w[h][u] = ws[(4 * u + q) * PF_WS + nl + 8 * h];
    uint32_t a[G / 32][4];
#pragma unroll
    for (int kk = 0; kk < G / 32; ++kk) {  // k = 32kk + 4q (+16): bit field kk/RT of
      const int sh = BITS * (kk / RT), t = kk % RT;  // word rows 8t + q (+4)
      a[kk][0] = (w[0][2 * t] >> sh) & ByteMask<BITS>::kMask;
      a[kk][1] = (w[1][2 * t] >> sh) & ByteMask<BITS>::kMask;
      a[kk][2] = (w[0][2 * t + 1] >> sh) & ByteMask<BITS>::kMask;
      a[kk][3] = (w[1][2 * t + 1] >> sh) & ByteMask<BITS>::kMask;
    }
    const uint32_t xa = smem_u32(st);
    wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < G / 32; ++kk) wgmma_s8(part, a[kk], sw128_desc(xa + kk * 32), kk > 0);
    wgmma_commit();

    __syncthreads();  // every thread done with stage g-1: its slot takes group g+3
    if (tid == 0 && g + PF_STAGES - 1 < ng) load_stage(g + PF_STAGES - 1);

    const float* ss = reinterpret_cast<const float*>(st + P::S_OFF);
    const int* xs = reinterpret_cast<const int*>(st + P::S_OFF + 2 * PF_BN * 4);
    const float s[2] = {ss[nl], ss[nl + 8]};
    const float sz[2] = {ss[PF_BN + nl], ss[PF_BN + nl + 8]};
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < G / 32; ++kk) fence_regs(a[kk]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int2 xv = *reinterpret_cast<const int2*>(xs + 8 * j + 2 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float xe = static_cast<float>((e & 1) ? xv.y : xv.x);
        acc[4 * j + e] = acc[4 * j + e] + static_cast<float>(part[4 * j + e]) * s[h] - xe * sz[h];
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + nl + 8 * h;
    if (n >= N) continue;
    const float b = bias ? bias[n] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = m0 + 8 * j + 2 * q + c;
        if (m >= M) continue;
        float o = acc[4 * j + 2 * h + c] * sx[m];
        if (bias) o += b;
        out[size_t(m) * N + n] = __float2bfloat16(o);
      }
  }
}

template <int BITS, int BM>
cudaError_t launch_prefill(const int8_t* xi, const float* sx, int* xsum, const void* qw,
                           const void* scales, const void* szeros, const void* bias, void* out,
                           int M, int K, int N, cudaStream_t stream) {
  using P = Prefill<BITS, BM>;
  const int Mp = (M + 3) / 4 * 4;
  const int ng = K / G;
  CUtensorMap xm, wm, sm, zm, tm;
  if (!tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xi, M, K, BM, G, true) ||
      !tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, ng * P::R, N, P::R, PF_WS, false) ||
      !tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, ng, N, 1, PF_BN, false) ||
      !tensor_map(&zm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, szeros, ng, N, 1, PF_BN, false) ||
      !tensor_map(&tm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, xsum, ng, Mp, 1, BM, false))
    return cudaErrorInvalidValue;
  group_sums_kernel<<<(Mp * ng + kWarps - 1) / kWarps, kThreads, 0, stream>>>(xi, xsum, M, K, Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = qmm_a8_prefill_kernel<BITS, BM>;
  err = allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + PF_BN - 1) / PF_BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(xm, wm, sm, zm, tm, sx,
                                              static_cast<const float*>(bias),
                                              static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
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

// M <= 32: the decode kernel (TILES 1 or 2). Above: the prefill kernels,
// tile_m output rows a block, 128 or 64 (for a short prefill, so that every
// SM has a block); the wrapper chooses (ops/quant_matmul.py:
// prefill_tile_m).
template <int BITS>
cudaError_t launch_mt(const int8_t* xi, const float* sx, int* xsum, const void* qw,
                      const void* scales, const void* szeros, const void* bias, void* out, int M,
                      int K, int N, int tile_m, cudaStream_t stream) {
  if (M <= 16) return launch<BITS, 1>(xi, sx, qw, scales, szeros, bias, out, M, K, N, stream);
  if (M <= 32) return launch<BITS, 2>(xi, sx, qw, scales, szeros, bias, out, M, K, N, stream);
  if (tile_m == 128)
    return launch_prefill<BITS, 128>(xi, sx, xsum, qw, scales, szeros, bias, out, M, K, N, stream);
  if (tile_m == 64)
    return launch_prefill<BITS, 64>(xi, sx, xsum, qw, scales, szeros, bias, out, M, K, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [M, K] bf16; qweight [K/pack, N] int32 (one layer: the caller offsets a
// stacked array to layer li), A8 order if kmap is null, else pair layout
// with kmap [G] int32 its extraction permutation; scales, szeros [K/G, N]
// f32; bias [N] f32 or null; xi [M, K] int8 and sx [M] f32 are scratch the
// caller allocates, and above 32 rows xsum, int32 scratch of K/G x
// round_up(M, 4); out [M, N] bf16. All row-major, contiguous. G = 128, bits
// 2 or 4; above 32 rows N a multiple of 4 and tile_m 64 or 128. Returns
// cudaGetLastError() after the launches (0 = launched).
int bd_qmm_a8(const void* x, const void* qweight, const void* scales, const void* szeros,
              const void* bias, const void* kmap, void* xi, void* sx, void* xsum, void* out,
              int M, int K, int N, int bits, int group, int tile_m, void* stream) {
  if (M < 1 || group != G || K % G != 0 || (bits != 2 && bits != 4)) return cudaErrorInvalidValue;
  if (M > 32 && (N % 4 != 0 || xsum == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_rows_kernel<<<M, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<const int*>(kmap),
                                              static_cast<int8_t*>(xi),
                                              static_cast<float*>(sx), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int8_t* xq = static_cast<const int8_t*>(xi);
  const float* sq = static_cast<const float*>(sx);
  int* xs = static_cast<int*>(xsum);
  if (bits == 2)
    return launch_mt<2>(xq, sq, xs, qweight, scales, szeros, bias, out, M, K, N, tile_m, s);
  return launch_mt<4>(xq, sq, xs, qweight, scales, szeros, bias, out, M, K, N, tile_m, s);
}

}  // extern "C"
