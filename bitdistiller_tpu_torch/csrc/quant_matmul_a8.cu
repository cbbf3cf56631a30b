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
// A call launches quantize_rows, then qmm_a8_decode (M <= 32, as its
// programmatic dependent) or group_sums and qmm_a8_prefill (M > 32). The
// quantization's max, IEEE division and rintf (half to even) are those of the
// plain version, so integer-valued rows quantize bit for bit alike (built
// without fast math). For pair-layout words it also applies the per-group
// permutation kmap (the JAX package's _a8_perm), so xi comes out in the
// words' extraction order.
// At g = 32 and 64 K may be 64 mod 128 (Falcon-7B's 4544): the last K step
// of 128 is then a half step, its word and scale rows past K zero-filled
// and never read, its xi past K staged as zeros (the quantization never
// sees them: xi stays [M, K]).
//
// In the A8 byte order, byte lane j of bit field i of word row r holds
// k = i*4R + 4r + j, so one extraction (w >> bits*i) & 0x0m0m0m0m is four
// consecutive k as four signed bytes (codes are at most 15): exactly a
// register of the s8 m16n8k32 A layout (k = 4*(lane%4) + 0..3 and +16). Both
// kernels take the product transposed, out^T = q^T xi^T: the codes are the
// A operand straight from the words, xi the B operand. The int32 group
// products turn f32 once a group.
//
// Bound on this card. Decode (small M) is bound by bytes: the packed words
// (K*N*bits/8) and the f32 scales and szeros (8 bytes a group column, against
// 4 for the A16 kernels' combo word) stream from HBM once, at 3.35 TB/s, so
// the design keeps enough of them in flight: clusters that split K, a
// cp.async ring several groups deep for every warp, two CTAs an SM (see
// "Decode" below and stream.cuh). Every CTA also reads its K slice of xi
// from L2: N / 256 * M * K bytes a call, 0.5 MB for o and 2.8 MB for gate_up
// at M = 8, against 5 and 28 MB of weights from HBM. Prefill (large M) is
// bound by int8 tensor-core operations (1,979 TOP/s): s8 wgmma, the codes
// unpacked straight into its register A fragments and xi staged in shared
// memory by TMA, on 128- or 64-row tiles (see "Prefill" below).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "stream.cuh"

namespace {

using namespace bd;

constexpr int G = 128;  // K step: 128 / g groups (g = 32, 64), or one (g >= 128)
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

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));  // IEEE division
}

// Per-token quantization ahead of the decode and prefill kernels. Block
// (m, part) stages row m in shared memory (16-byte loads, several in flight
// a thread), takes its max and quantizes its `chunk` of the row (decode:
// several parts a row, each reading the row from L2; prefill: one,
// chunk = K). The max, the IEEE
// division and rintf (half to even) are the plain version's, so
// integer-valued rows quantize bit for bit alike (built without fast math).
// For pair-layout words it also applies the per-group permutation kmap (the
// JAX package's _a8_perm), so xi comes out in the words' extraction order.
// A programmatic dependent may start at once: it waits (grid_dep_wait)
// before it reads xi.
// XT: x's dtype (bf16, or f32 quantized as it is: the plain version's
// x.to(f32)); kmap of period P (the group) or null.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const XT* __restrict__ x, const int* __restrict__ kmap,
                         int8_t* __restrict__ xi, float* __restrict__ sx, int K, int chunk,
                         int P) {
  grid_dep_launch();
  extern __shared__ __align__(16) uint8_t qsm[];
  const XT* xs = reinterpret_cast<const XT*>(qsm);
  __shared__ float red[kWarps];
  constexpr int EV = 16 / int(sizeof(XT));  // elements a 16-byte load
  const int m = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + size_t(m) * K);
  float mx = 0.f;
  pipelined<4>(threadIdx.x, K / EV, kThreads, [&](int i) { return __ldg(xr + i); },
               [&](int i, uint4 v) {
                 reinterpret_cast<uint4*>(qsm)[i] = v;
                 const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                 for (int e = 0; e < 4; ++e) {
                   float2 f;  // the word's two bf16, or one f32
                   if constexpr (sizeof(XT) == 2) {
                     f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
                   } else {
                     f = make_float2(__uint_as_float(w[e]), 0.f);
                   }
                   mx = fmaxf(mx, fmaxf(fabsf(f.x), fabsf(f.y)));
                 }
               });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();  // the row and the warps' maxima in shared memory
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  const float s = fmaxf(mx / 127.0f, 1e-8f);
  if (blockIdx.y == 0 && threadIdx.x == 0) sx[m] = s;
  const int p1 = min(K, (blockIdx.y + 1) * chunk);
  for (int p = blockIdx.y * chunk + 4 * threadIdx.x; p < p1; p += 4 * kThreads) {  // 4 k a thread
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v |= uint32_t(uint8_t(quantize(float(xs[src_k(p + e, kmap, P)]), s))) << (8 * e);
    *reinterpret_cast<uint32_t*>(xi + size_t(m) * K + p) = v;
  }
}

constexpr int QUANT_CHUNK = 1024;  // decode: k a quantize block, 4 blocks a row at K = 4096

// ---------------------------------------------------------------------------
// Decode (M <= 32), the streaming plan of stream.cuh. A cluster of C CTAs
// owns DEC_COLS = 256 output columns; CTA `rank` walks its share of the K
// groups. Warp w owns 32 of the columns (two m16 tiles, so a word row is a
// 128-byte line) over all of the CTA's groups and streams their words
// through a DEC_STAGES-deep cp.async ring of its own (the group's R word
// rows x 32 columns, their f32 scales and szeros),
// DEC_STAGES - 1 groups in flight, so it folds them itself, with no barrier
// and no reduction inside the CTA. The product is taken transposed,
// out^T = q^T xi^T, so that 8 tokens fill the mma's n = 8 and no row is
// padding at M = 8: in the A8 byte order one (w >> bits*i) & 0x0m0m0m0m is
// four consecutive k of a column, a register of the m16n8k32 A layout (the
// lane's columns 16mt + row and + 8, as the prefill kernel's), and four
// consecutive int8 of a token's xi are a B register:
//   part = q_g^T xi_g^T (mma.sync.m16n8k32.s8, B from the CTA's int8 xi
//   slice in shared memory), xsum_g = sum(xi_g) by __dp4a on the same B
//   registers, acc += part * s - xsum_g * sz.
// The C partial tiles are summed in rank order through distributed shared
// memory, each CTA finishing 1/C of the tile: out = bf16(sum * sx (+ bias)).
// The quantization runs first, in quantize_rows_kernel; this kernel is its
// programmatic dependent: it fills the rings with words (which do not depend
// on x), then waits for xi and copies its K slice to shared memory.
// ---------------------------------------------------------------------------

constexpr int DEC_COLS = 256;  // output columns a cluster: 32 a warp, two m16 tiles
constexpr int DEC_STAGES = 4;  // a warp's ring: 3 groups in flight

template <int BITS, int TOK, int GG>
struct Dec {
  using Map = StepMap<BITS, GG, 4>;
  static constexpr int SUB = Map::SUB;             // groups (scale rows) a step
  static constexpr int R = G * BITS / 32;          // word rows a step
  static constexpr int WC = DEC_COLS / kWarps;     // columns a warp
  static constexpr int MT = WC / 16;               // m16 tiles a warp
  static constexpr int WLD = WC + 8;               // staged word row: 4 k quads x 8 columns hit 32 banks
  static constexpr int WSTAGE = R * WLD + 2 * SUB * WC;  // words, then scales and szeros rows
  static constexpr int MROWS = 8 * TOK;            // token rows: TOK n-tiles of 8
  static constexpr int RED = MROWS * DEC_COLS * 4;  // the partial tile, over the drained rings
  static constexpr int RINGS = kWarps * DEC_STAGES * WSTAGE * 4;
  static constexpr int RING = RINGS > RED ? RINGS : RED;
  // xi row: lanes' tokens land 4 banks apart
  __host__ __device__ static int xld(int ngs_max) { return ngs_max * G + 16; }
  __host__ __device__ static size_t smem(int ngs_max) {
    return RING + size_t(MROWS) * xld(ngs_max) + 32 * 4;
  }
};

// GG: the group when it is 32, 64 or 128; 128 also for g = gdiv * 128 (the
// scale row of step j is j / gdiv; xi arrives in step order). out: bf16, or
// f32 with out_f32.
template <int BITS, int TOK, int GG>
__global__ void __launch_bounds__(kThreads, 2)
    qmm_a8_decode_kernel(const int8_t* __restrict__ xi_g, const float* __restrict__ sx_g,
                         const uint32_t* __restrict__ qw, const float* __restrict__ scales,
                         const float* __restrict__ szeros, const float* __restrict__ bias,
                         void* __restrict__ out, int M, int K, int N, int ngs_max, int vec,
                         int gdiv, int out_f32) {
  using D = Dec<BITS, TOK, GG>;
  using Map = typename D::Map;
  constexpr int MROWS = D::MROWS, WC = D::WC, MT = D::MT, COLS = DEC_COLS, SUB = D::SUB;
  constexpr int NW = Map::NW;  // words a lane holds a step and column
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, row = lane >> 2;
  const int n0 = blockIdx.y * COLS;
  // steps of K; at g = 32, 64 the last may be a half step (K = 64 mod 128)
  const int ng = GG < G ? (K + G - 1) / G : K / G;
  const int g0 = rank * ng / C, ngs = (rank + 1) * ng / C - g0;
  const int k0 = g0 * G, kn = ngs * G;
  const int xld = D::xld(ngs_max);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + warp * DEC_STAGES * D::WSTAGE;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + D::RING);
  float* sxs = reinterpret_cast<float*>(xs + MROWS * xld);

  auto issue = [&](int j) {  // step g0 + j of this warp's columns; always one commit group
    if (j < ngs) {
      uint32_t* st = ring + (j % DEC_STAGES) * D::WSTAGE;
      const int g = g0 + j, wn = n0 + warp * WC, srow = step_row(g, SUB, gdiv);
      // the first r word rows and s scale rows of the step
      auto copy = [&](int r, int s) {
        warp_copy<WC>(st, qw + size_t(g) * D::R * N, r, D::WLD, wn, N, vec, lane);
        warp_copy<WC>(st + D::R * D::WLD, scales + size_t(srow) * N, s, WC, wn, N, vec, lane);
        warp_copy<WC>(st + D::R * D::WLD + SUB * WC, szeros + size_t(srow) * N, s, WC, wn, N,
                      vec, lane);
      };
      if (GG == G || K % G == 0 || g != ng - 1) {
        copy(D::R, SUB);
      } else {  // K = 64 mod 128: a half last step, its upper half zeros (past K, never read)
        copy(D::R / 2, SUB / 2);
        warp_zero<WC>(st + D::R / 2 * D::WLD, D::R / 2, D::WLD, lane);
        warp_zero<WC>(st + D::R * D::WLD + SUB / 2 * WC, SUB / 2, WC, lane);
        warp_zero<WC>(st + D::R * D::WLD + (SUB + SUB / 2) * WC, SUB / 2, WC, lane);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < DEC_STAGES - 1; ++j) issue(j);

  grid_dep_wait();  // xi and sx are quantize_rows_kernel's; read past L1
  const int per = kn / 16;
  pipelined<4>(
      tid, MROWS * per, kThreads,
      [&](int idx) {
        const int r = idx / per;
        // xi past K (a half last step): zeros
        return r < M && (GG == G || k0 + (idx - r * per) * 16 < K)
                   ? __ldcg(reinterpret_cast<const uint4*>(xi_g + size_t(r) * K + k0 +
                                                           (idx - r * per) * 16))
                   : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int idx, uint4 v) {
        const int r = idx / per;
        *reinterpret_cast<uint4*>(xs + r * xld + (idx - r * per) * 16) = v;
      });
  if (tid < MROWS) sxs[tid] = tid < M ? __ldcg(sx_g + tid) : 0.f;
  __syncthreads();  // xi and sx in shared memory

  float acc[TOK][MT][4];
#pragma unroll
  for (int t = 0; t < TOK; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.f;

  const int pre = Map::preshift(quad);
  for (int j = 0; j < ngs; ++j) {
    cp_wait<DEC_STAGES - 2>();  // this lane's copies of step j landed
    __syncwarp();               // and the other lanes'; slot (j - 1) is free
    issue(j + DEC_STAGES - 1);
    const uint32_t* ws = ring + (j % DEC_STAGES) * D::WSTAGE;
    uint32_t w[MT][2][NW];  // words of the lane's columns 16mt + row and 16mt + row + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < NW; ++u)
          w[mt][h][u] = ws[Map::row(u, quad) * D::WLD + 16 * mt + 8 * h + row] >> pre;
    int part[TOK][MT][4], xq[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      xq[t] = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[t][mt][e] = 0;
    }
    const float* ss = reinterpret_cast<const float*>(ws + D::R * D::WLD);
#pragma unroll
    for (int kb = 0; kb < G / 32; ++kb) {
      const int u0 = Map::word(kb, 0), u1 = Map::word(kb, 1);
      const int sh0 = BITS * Map::field(kb, 0), sh1 = BITS * Map::field(kb, 1);
      constexpr uint32_t mask = ByteMask<BITS>::kMask;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = (w[mt][0][u0] >> sh0) & mask;
        a[mt][1] = (w[mt][1][u0] >> sh0) & mask;
        a[mt][2] = (w[mt][0][u1] >> sh1) & mask;
        a[mt][3] = (w[mt][1][u1] >> sh1) & mask;
      }
#pragma unroll
      for (int t = 0; t < TOK; ++t) {  // token row 8t + row, k = 32kb + 4quad (+16)
        const int8_t* xr = xs + (8 * t + row) * xld + j * G + 32 * kb + 4 * quad;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(part[t][mt], a[mt], b0, b1);
        xq[t] = __dp4a(static_cast<int>(b1), static_cast<int>(kOnesS8x4),
                       __dp4a(static_cast<int>(b0), static_cast<int>(kOnesS8x4), xq[t]));
      }
      if (Map::group_end(kb)) {
        // fold group gs of the step: the lane's accumulators are columns
        // 16mt + row, + 8 (e >> 1) x tokens 8t + 2quad, + 1 (e & 1)
        const float* sg = ss + (kb / Map::KB) * WC;
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          int xsum = xq[t] + __shfl_xor_sync(0xffffffffu, xq[t], 1);  // sum(xi) of token 8t + row
          xsum += __shfl_xor_sync(0xffffffffu, xsum, 2);
          const float xt[2] = {static_cast<float>(__shfl_sync(0xffffffffu, xsum, 8 * quad)),
                               static_cast<float>(__shfl_sync(0xffffffffu, xsum, 8 * quad + 4))};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = 16 * mt + 8 * (e >> 1) + row;
              acc[t][mt][e] = acc[t][mt][e] + static_cast<float>(part[t][mt][e]) * sg[cl] -
                              xt[e & 1] * sg[SUB * WC + cl];
              part[t][mt][e] = 0;
            }
          xq[t] = 0;
        }
      }
    }
  }

  // the partial tile over the drained rings, then the cluster's sum in rank order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [MROWS][COLS]
#pragma unroll
  for (int t = 0; t < TOK; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * t + 2 * quad + (e & 1)) * COLS + warp * WC + 16 * mt + 8 * (e >> 1) + row] =
            acc[t][mt][e];
  cluster.sync();
  const int e0 = rank * MROWS * COLS / C, e1 = (rank + 1) * MROWS * COLS / C;
  for (int idx = e0 + tid; idx < e1; idx += kThreads) {
    const int r = idx / COLS, n = n0 + idx % COLS;
    if (r < M && n < N) {
      float part[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)  // all loads in flight, then the sum in rank order
        if (q < C) part[q] = cluster.map_shared_rank(red, q)[idx];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) sum += part[q];
      float o = sum * sxs[r];
      if (bias) o += bias[n];
      store_out(out, size_t(r) * N + n, o, out_f32);
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
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
//     a register of the m16n8k32 A layout (as in the decode kernel);
//   * part = xi_g . q_g is a fresh s32 wgmma accumulator a group (scale-d 0
//     on its first k-step), folded in f32 registers as the TPU kernel does:
//       acc += part * s - xsum * sz;  out = bf16(acc * sx[m] (+ bias[n])),
//     xsum_g[m] = sum(xi) from group_sums_kernel, a pass over xi after the
//     quantization.
// ---------------------------------------------------------------------------

constexpr int PF_BN = 128;        // output columns a block (two warpgroups of 64)
constexpr int PF_STAGES = 4;      // ring depth: 4 stages of up to 26 KB
constexpr int PF_WS = PF_BN + 8;  // word-tile row: 8 words of padding (read past N: zeros)

// xsum[fg, m] = sum over fold group fg (FG = min(g, 128) k) of xi[m, :],
// zero for M <= m < Mp; one warp a (row, fold group)
__global__ void __launch_bounds__(kThreads)
    group_sums_kernel(const int8_t* __restrict__ xi, int* __restrict__ xsum, int M, int K,
                      int Mp, int FG) {
  const int nf = K / FG;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= Mp * nf) return;
  const int m = item / nf, fg = item - m * nf;
  int s = 0;
  if (m < M && 4 * lane < FG)
    s = __dp4a(__ldg(reinterpret_cast<const int*>(xi + size_t(m) * K + fg * FG) + lane),
               static_cast<int>(kOnesS8x4), 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) xsum[size_t(fg) * Mp + m] = s;
}

template <int BITS, int BM, int GG>
struct Prefill {
  using Map = StepMap<BITS, GG, 4>;
  static constexpr int SUB = Map::SUB;     // groups a step
  static constexpr int R = G * BITS / 32;  // word rows a step
  static constexpr int X_BYTES = BM * G;
  static constexpr int W_BYTES = R * PF_WS * 4;
  static constexpr int S_OFF = X_BYTES + W_BYTES;  // scales, szeros [SUB][PF_BN], then xi sums [SUB][BM]
  static constexpr int TX_BYTES = S_OFF + 2 * SUB * PF_BN * 4 + SUB * BM * 4;  // a stage's TMA bytes
  static constexpr int STAGE = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = PF_STAGES * STAGE + PF_STAGES * 8 + 1024;  // + mbarriers, alignment
};

template <int BITS, int BM, int GG>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_a8_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap s_map,
                          const __grid_constant__ CUtensorMap z_map,
                          const __grid_constant__ CUtensorMap t_map, const float* __restrict__ sx,
                          const float* __restrict__ bias, void* __restrict__ out, int M,
                          int K, int N, int gdiv, int out_f32) {
  using P = Prefill<BITS, BM, GG>;
  using Map = typename P::Map;
  constexpr int NJ = BM / 8;    // 8-row blocks of xi: the accumulator's column blocks
  constexpr int NW = Map::NW, SUB = P::SUB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int q = tid & 3;
  // this thread's accumulator rows: output columns nl and nl + 8 of the block
  const int nl = 64 * (tid >> 7) + 16 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * PF_BN;
  const int ng = (K + G - 1) / G;  // a half last step at K = 64 mod 128: the maps end at K

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PF_STAGES * P::STAGE);

  auto load_stage = [&](int g) {  // one thread
    uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    uint64_t* bar = full + g % PF_STAGES;
    const int srow = step_row(g, SUB, gdiv);
    mbar_expect(bar, P::TX_BYTES);
    tma_load(st, &x_map, g * G, m0, bar);
    tma_load(st + P::X_BYTES, &w_map, n0, g * P::R, bar);
    tma_load(st + P::S_OFF, &s_map, n0, srow, bar);
    tma_load(st + P::S_OFF + SUB * PF_BN * 4, &z_map, n0, srow, bar);
    tma_load(st + P::S_OFF + 2 * SUB * PF_BN * 4, &t_map, m0, g * SUB, bar);
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

  const int pre = Map::preshift(q);
  for (int g = 0; g < ng; ++g) {
    const uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    mbar_wait(full + g % PF_STAGES, (g / PF_STAGES) & 1);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + P::X_BYTES);
    // words of columns nl, nl + 8 and the step's word rows Map::row(u, q)
    uint32_t w[2][NW];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < NW; ++u) w[h][u] = ws[Map::row(u, q) * PF_WS + nl + 8 * h] >> pre;
    uint32_t a[G / 32][4];
#pragma unroll
    for (int kk = 0; kk < G / 32; ++kk) {  // k = 32kk + 4q (+16)
      const int u0 = Map::word(kk, 0), u1 = Map::word(kk, 1);
      const int sh0 = BITS * Map::field(kk, 0), sh1 = BITS * Map::field(kk, 1);
      a[kk][0] = (w[0][u0] >> sh0) & ByteMask<BITS>::kMask;
      a[kk][1] = (w[1][u0] >> sh0) & ByteMask<BITS>::kMask;
      a[kk][2] = (w[0][u1] >> sh1) & ByteMask<BITS>::kMask;
      a[kk][3] = (w[1][u1] >> sh1) & ByteMask<BITS>::kMask;
    }
    const uint32_t xa = smem_u32(st);
    const float* ss = reinterpret_cast<const float*>(st + P::S_OFF);
    const int* xs = reinterpret_cast<const int*>(st + P::S_OFF + 2 * SUB * PF_BN * 4);
#pragma unroll
    for (int gs = 0; gs < SUB; ++gs) {  // a fresh accumulator a group of the step
      wgmma_fence();
      fence_regs(part);
#pragma unroll
      for (int kk = gs * Map::KB; kk < (gs + 1) * Map::KB; ++kk)
        wgmma_s8(part, a[kk], sw128_desc(xa + kk * 32), kk > gs * Map::KB);
      wgmma_commit();
      if (gs == 0) {
        __syncthreads();  // every thread done with stage g-1: its slot takes step g+3
        if (tid == 0 && g + PF_STAGES - 1 < ng) load_stage(g + PF_STAGES - 1);
      }
      const float s[2] = {ss[gs * PF_BN + nl], ss[gs * PF_BN + nl + 8]};
      const float sz[2] = {ss[(SUB + gs) * PF_BN + nl], ss[(SUB + gs) * PF_BN + nl + 8]};
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < G / 32; ++kk) fence_regs(a[kk]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int2 xv = *reinterpret_cast<const int2*>(xs + gs * BM + 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float xe = static_cast<float>((e & 1) ? xv.y : xv.x);
          acc[4 * j + e] = acc[4 * j + e] + static_cast<float>(part[4 * j + e]) * s[h] - xe * sz[h];
        }
      }
    }
  }

  // the tile in out's dtype, the dtype test hoisted out of the stores
  auto store = [&](auto* y) {
    using T = std::remove_pointer_t<decltype(y)>;
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
          y[size_t(m) * N + n] = from_f32<T>(o);
        }
    }
  };
  if (out_f32)
    store(static_cast<float*>(out));
  else
    store(static_cast<__nv_bfloat16*>(out));
}

struct A8Args {
  const void* x;
  const int* kmap;
  int8_t* xi;
  float* sx;
  const uint32_t* qw;
  const float* scales;
  const float* szeros;
  const float* bias;
  void* out;
  int M, K, N, g, x_f32;
};

template <int BITS, int BM, int GG>
cudaError_t launch_prefill(const A8Args& a, int* xsum, cudaStream_t stream) {
  using P = Prefill<BITS, BM, GG>;
  const int Mp = (a.M + 3) / 4 * 4;
  const int FG = G / P::SUB, gdiv = GG == 128 ? a.g / G : 1;
  CUtensorMap xm, wm, sm, zm, tm;  // each ends at K: a half last step reads zeros past it
  if (!tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.xi, a.M, a.K, BM, G, true) ||
      !tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.qw, a.K * BITS / 32, a.N, P::R, PF_WS,
                  false) ||
      !tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.scales, a.K / a.g, a.N, P::SUB,
                  PF_BN, false) ||
      !tensor_map(&zm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.szeros, a.K / a.g, a.N, P::SUB,
                  PF_BN, false) ||
      !tensor_map(&tm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, xsum, a.K / FG, Mp, P::SUB, BM, false))
    return cudaErrorInvalidValue;
  group_sums_kernel<<<(Mp * (a.K / FG) + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.xi, xsum, a.M, a.K, Mp, FG);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = qmm_a8_prefill_kernel<BITS, BM, GG>;
  err = allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + PF_BN - 1) / PF_BN, (a.M + BM - 1) / BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(xm, wm, sm, zm, tm, a.sx, a.bias, a.out, a.M, a.K,
                                              a.N, gdiv, a.x_f32);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_quantize_t(const A8Args& a, int chunk, cudaStream_t stream) {
  const size_t smem = size_t(a.K) * sizeof(XT);  // the row
  const cudaError_t err = allow_smem(quantize_rows_kernel<XT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.M, (a.K + chunk - 1) / chunk);
  quantize_rows_kernel<XT><<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(a.x), a.kmap,
                                                             a.xi, a.sx, a.K, chunk, a.g);
  return cudaGetLastError();
}

cudaError_t launch_quantize(const A8Args& a, int chunk, cudaStream_t stream) {
  return a.x_f32 ? launch_quantize_t<float>(a, chunk, stream)
                 : launch_quantize_t<__nv_bfloat16>(a, chunk, stream);
}

template <int BITS, int TOK, int GG>
cudaError_t launch_decode(const A8Args& a, int cluster, cudaStream_t stream) {
  const int ngs_max = ((a.K + G - 1) / G + cluster - 1) / cluster;
  const int vec = a.N % 4 == 0 && aligned16(a.qw) && aligned16(a.scales) && aligned16(a.szeros);
  const int gdiv = GG == 128 ? a.g / G : 1;
  const cudaError_t err = launch_quantize(a, QUANT_CHUNK, stream);
  if (err != cudaSuccess) return err;
  return launch_cluster(qmm_a8_decode_kernel<BITS, TOK, GG>,
                        dim3(cluster, (a.N + DEC_COLS - 1) / DEC_COLS, 1), cluster,
                        Dec<BITS, TOK, GG>::smem(ngs_max), true, stream, a.xi, a.sx, a.qw,
                        a.scales, a.szeros, a.bias, a.out, a.M, a.K, a.N, ngs_max, vec, gdiv,
                        a.x_f32);
}

// M <= 32: the decode kernel (8, 16 or 32 token rows), on clusters of
// `cluster` CTAs. Above: the prefill kernels, tile_m output rows a block,
// 128 or 64 (for a short prefill, so that every SM has a block). The
// wrapper chooses both (ops/quant_matmul.py: decode_plan, prefill_tile_m).
template <int BITS, int GG>
cudaError_t launch_mt(const A8Args& a, int* xsum, int tile_m, int cluster, cudaStream_t s) {
  if (a.M <= 32) {
    if (cluster < 1 || cluster > kMaxCluster || cluster > (a.K + G - 1) / G)
      return cudaErrorInvalidValue;
    if (a.M <= 8) return launch_decode<BITS, 1, GG>(a, cluster, s);
    if (a.M <= 16) return launch_decode<BITS, 2, GG>(a, cluster, s);
    return launch_decode<BITS, 4, GG>(a, cluster, s);
  }
  if (tile_m != 64 && tile_m != 128) return cudaErrorInvalidValue;
  const cudaError_t err = launch_quantize(a, a.K, s);
  if (err != cudaSuccess) return err;
  return tile_m == 128 ? launch_prefill<BITS, 128, GG>(a, xsum, s)
                       : launch_prefill<BITS, 64, GG>(a, xsum, s);
}

template <int BITS>
cudaError_t launch_g(const A8Args& a, int* xsum, int tile_m, int cluster, cudaStream_t s) {
  if (a.g == 32) return launch_mt<BITS, 32>(a, xsum, tile_m, cluster, s);
  if (a.g == 64) return launch_mt<BITS, 64>(a, xsum, tile_m, cluster, s);
  return launch_mt<BITS, 128>(a, xsum, tile_m, cluster, s);
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_f32 = 0) or f32 (1), 16-byte aligned; qweight [K/pack, N]
// int32 (one layer: the caller offsets a stacked array to layer li); kmap
// [g] int32 or null: the kernel position -> source k of x within a group
// (pair-layout words: the JAX package's _a8_perm composed, for g > 128, with
// the step order; A8-ordered words: null up to g = 128, the step order
// above; ops/quant_matmul.py: a8_kmap); scales, szeros [K/g, N] f32; bias
// [N] f32 or null; out [M, N] in x's dtype. All row-major, contiguous. g 32
// or 64 (K a multiple of 64), or a multiple of 128 dividing K; bits 2 or 4.
// Scratch the caller allocates: xi [M, K] int8 and sx [M] f32, and above 32
// rows xsum, int32 of K / min(g, 128) x round_up(M, 4). M <= 32: clusters
// of 1 <= cluster <= min(8, ceil(K/128)) CTAs (decode_plan); a cluster the card
// cannot hold launches nothing and returns its error. Above: N a multiple
// of 4 and tile_m 64 or 128. Returns 0 once launched, else the CUDA error.
int bd_qmm_a8(const void* x, const void* qweight, const void* scales, const void* szeros,
              const void* bias, const void* kmap, void* xi, void* sx, void* xsum, void* out,
              int M, int K, int N, int bits, int group, int tile_m, int cluster, int x_f32,
              void* stream) {
  const bool g_ok = group == 32 || group == 64 || (group >= G && group % G == 0);
  if (M < 1 || !g_ok || K % 64 != 0 || K % group != 0 || (bits != 2 && bits != 4) ||
      !aligned16(x) || xi == nullptr || sx == nullptr)
    return cudaErrorInvalidValue;
  if (M > 32 && (N % 4 != 0 || xsum == nullptr)) return cudaErrorInvalidValue;
  const A8Args a{x, static_cast<const int*>(kmap), static_cast<int8_t*>(xi),
                 static_cast<float*>(sx), static_cast<const uint32_t*>(qweight),
                 static_cast<const float*>(scales), static_cast<const float*>(szeros),
                 static_cast<const float*>(bias), out, M, K, N, group, x_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* xs = static_cast<int*>(xsum);
  if (bits == 2) return launch_g<2>(a, xs, tile_m, cluster, s);
  return launch_g<4>(a, xs, tile_m, cluster, s);
}

}  // extern "C"
