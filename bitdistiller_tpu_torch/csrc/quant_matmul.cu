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
// cores (989 TFLOP/s bf16). Design: Hopper's warpgroup MMA (wgmma), the
// codes unpacked straight into its register A fragments and x staged in
// shared memory by TMA, on 128- or 64-row tiles (see "Prefill" below).

#include "common.cuh"
#include "hopper.cuh"

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
// Prefill (M > 32). The product is taken transposed, out^T = W^T x^T, so
// that the unpacked codes are the wgmma A operand, held in registers, and x
// the B operand, read by the tensor cores from shared memory as it came:
//   * one block per output tile of BM = 64 or 128 rows (the wgmma N) and 128
//     columns: two warpgroups of 64 columns each (the wgmma M);
//   * K is walked one group (128) a step through a ring of PF_STAGES stages,
//     each filled by five TMA loads that one thread starts and that complete
//     on the stage's mbarrier: the x tile (BM x 128 bf16, two 64-k atoms,
//     128-byte swizzle), the group's packed words (R x 136: 8 columns of
//     padding keep the fragment reads free of bank conflicts), its combo
//     words (128) and its x sums (BM); groups g+1 .. g+3 are in flight while
//     group g computes;
//   * A fragments straight from the words: under the pair layout one
//     extraction is the bf16x2 (off + q) of two consecutive k of a column,
//     exactly a register of the m16n8k16 A layout (as the decode kernel's B);
//   * part = x_g . (off + q)_g is a fresh f32 wgmma accumulator a group
//     (scale-d 0 on its first k-step), folded in registers:
//       acc += part * s - xsum * (sz + off * s),
//     xsum_g[m] from group_sums_kernel, one pass over x before the matmul.
// Shared memory carries x alone: 2 x BM x 32 bytes of wgmma reads a k-step,
// half of what the codes as a second shared operand would add (an earlier
// version unpacked them into a shared bf16 tile and ran 1.6x slower). No
// split-K: a block writes its own tile, so the result is deterministic.
// ---------------------------------------------------------------------------

constexpr int PF_G = 128;
constexpr int PF_BN = 128;        // output columns a block (two warpgroups of 64)
constexpr int PF_STAGES = 4;      // ring depth: 4 stages of up to 42 KB
constexpr int PF_WS = PF_BN + 8;  // word-tile row: 8 words of padding (read past N: zeros)

// xsum[g, m] = sum over group g of x[m, :] in f32, zero for M <= m < Mp; one
// warp a (row, group)
__global__ void __launch_bounds__(kThreads)
    group_sums_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xsum, int M,
                      int K, int Mp) {
  const int ng = K / PF_G;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= Mp * ng) return;
  const int m = item / ng, g = item - m * ng;
  float s = 0.f;
  if (m < M) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(x + size_t(m) * K + g * PF_G) + lane);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    s = (a.x + a.y) + (b.x + b.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) xsum[size_t(g) * Mp + m] = s;
}

template <int BITS, int BM>
struct Prefill {
  static constexpr int R = PF_G * BITS / 32;  // word rows a group
  static constexpr int X_BYTES = BM * PF_G * 2;
  static constexpr int W_BYTES = R * PF_WS * 4;
  static constexpr int C_OFF = X_BYTES + W_BYTES;  // combo words, then x sums
  static constexpr int TX_BYTES = C_OFF + PF_BN * 4 + BM * 4;  // a stage's TMA bytes
  static constexpr int STAGE = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = PF_STAGES * STAGE + PF_STAGES * 8 + 1024;  // + mbarriers, alignment
};

template <int BITS, int BM>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const __grid_constant__ CUtensorMap s_map, __nv_bfloat16* __restrict__ out,
                       int M, int K, int N) {
  using P = Prefill<BITS, BM>;
  constexpr int NJ = BM / 8;    // 8-row blocks of x: the accumulator's column blocks
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
  const int ng = K / PF_G;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PF_STAGES * P::STAGE);

  auto load_stage = [&](int g) {  // one thread
    uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    uint64_t* bar = full + g % PF_STAGES;
    mbar_expect(bar, P::TX_BYTES);
    tma_load(st, &x_map, g * PF_G, m0, bar);
    tma_load(st + BM * 128, &x_map, g * PF_G + 64, m0, bar);
    tma_load(st + P::X_BYTES, &w_map, n0, g * P::R, bar);
    tma_load(st + P::C_OFF, &c_map, n0, g, bar);
    tma_load(st + P::C_OFF + PF_BN * 4, &s_map, m0, g, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < PF_STAGES; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < PF_STAGES - 1 && g < ng; ++g) load_stage(g);

  float acc[BM / 2], part[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) acc[e] = part[e] = 0.f;

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
    uint32_t a[PF_G / 16][4];
#pragma unroll
    for (int kk = 0; kk < PF_G / 16; ++kk) {  // k = 16kk + 2q (+8): extraction kk/RT of
      const int i = kk / RT, t = kk % RT;       // word rows 8t + q (+4)
      a[kk][0] = extract_bits<BITS>(w[0][2 * t], i);
      a[kk][1] = extract_bits<BITS>(w[1][2 * t], i);
      a[kk][2] = extract_bits<BITS>(w[0][2 * t + 1], i);
      a[kk][3] = extract_bits<BITS>(w[1][2 * t + 1], i);
    }
    const uint32_t xa = smem_u32(st);
    wgmma_fence();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < PF_G / 16; ++kk)  // atom kk/4, byte 32(kk%4) of its rows
      wgmma_bf16(part, a[kk], sw128_desc(xa + (kk >> 2) * (BM * 128) + (kk & 3) * 32), kk > 0);
    wgmma_commit();

    __syncthreads();  // every thread done with stage g-1: its slot takes group g+3
    if (tid == 0 && g + PF_STAGES - 1 < ng) load_stage(g + PF_STAGES - 1);

    const uint32_t* cs = reinterpret_cast<const uint32_t*>(st + P::C_OFF);
    const float* xs = reinterpret_cast<const float*>(st + P::C_OFF + PF_BN * 4);
    float s[2], zc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sz;
      decode_combo(cs[nl + 8 * h], s[h], sz);
      zc[h] = sz + Trick<BITS>::kOffset * s[h];
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int kk = 0; kk < PF_G / 16; ++kk) fence_regs(a[kk]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + 8 * j + 2 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float xe = (e & 1) ? xv.y : xv.x;
        acc[4 * j + e] = acc[4 * j + e] + part[4 * j + e] * s[h] - xe * zc[h];
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + nl + 8 * h;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = m0 + 8 * j + 2 * q + c;
        if (m < M) out[size_t(m) * N + n] = __float2bfloat16(acc[4 * j + 2 * h + c]);
      }
  }
}

template <int BITS, int BM>
cudaError_t launch_prefill(const void* x, const void* qw, const void* combo, void* xsum,
                           void* out, int M, int K, int N, cudaStream_t stream) {
  using P = Prefill<BITS, BM>;
  const int Mp = (M + 3) / 4 * 4;
  const int ng = K / PF_G;
  CUtensorMap xm, wm, cm, sm;
  if (!tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, 64, true) ||
      !tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, ng * P::R, N, P::R, PF_WS, false) ||
      !tensor_map(&cm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, combo, ng, N, 1, PF_BN, false) ||
      !tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xsum, ng, Mp, 1, BM, false))
    return cudaErrorInvalidValue;
  group_sums_kernel<<<(Mp * ng + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(xsum), M, K, Mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = qmm_prefill_kernel<BITS, BM>;
  err = allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + PF_BN - 1) / PF_BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(xm, wm, cm, sm, static_cast<__nv_bfloat16*>(out),
                                              M, K, N);
  return cudaGetLastError();
}

// tile_m: output rows a block, 128 or 64 (for a short prefill, so that
// every SM has a block); the wrapper chooses (ops/quant_matmul.py:
// prefill_tile_m).
template <int BITS>
cudaError_t launch_prefill_tm(const void* x, const void* qw, const void* combo, void* xsum,
                              void* out, int M, int K, int N, int tile_m, cudaStream_t stream) {
  if (tile_m == 128) return launch_prefill<BITS, 128>(x, qw, combo, xsum, out, M, K, N, stream);
  if (tile_m == 64) return launch_prefill<BITS, 64>(x, qw, combo, xsum, out, M, K, N, stream);
  return cudaErrorInvalidValue;
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

// The same for the prefill kernels (any M; the wrapper sends M > 32), with
// N a multiple of 4 and x, qweight, combo 16-byte aligned (TMA), tile_m 64
// or 128, and xsum f32 scratch of K/G x round_up(M, 4) that the caller
// allocates.
int bd_qmm_prefill(const void* x, const void* qweight, const void* combo, void* xsum, void* out,
                   int M, int K, int N, int bits, int group, int tile_m, void* stream) {
  if (M < 1 || group != PF_G || K % PF_G != 0 || N % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2) return launch_prefill_tm<2>(x, qweight, combo, xsum, out, M, K, N, tile_m, s);
  if (bits == 4) return launch_prefill_tm<4>(x, qweight, combo, xsum, out, M, K, N, tile_m, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
