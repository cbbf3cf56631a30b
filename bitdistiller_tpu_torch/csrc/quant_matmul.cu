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
// 3.35 TB/s; x is a few KB. Design: the streaming plan of stream.cuh, as
// the A8 decode kernel and the fused MLP use it (see "Decode" below):
// clusters that split K so that every SM holds two CTAs, a cp.async ring
// several groups deep for every warp, the dot products on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate; on CUDA cores the
// unpack-and-FMA work kept the first versions at 15x the byte bound) with
// the product transposed, so that the pair layout's extractions are the A
// fragments and 8 tokens fill the mma's n. Every CTA reads its K slice of x
// from L2 once. Prefill (large M) is bound by operations on the tensor
// cores (989 TFLOP/s bf16). Design: Hopper's warpgroup MMA (wgmma), the
// codes unpacked straight into its register A fragments and x staged in
// shared memory by TMA, on 128- or 64-row tiles (see "Prefill" below).

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "stream.cuh"

namespace {

using namespace bd;

// ---------------------------------------------------------------------------
// Decode (M <= 32), the streaming plan of stream.cuh. A cluster of C CTAs
// owns COLS = 8 * WC output columns (WC = 16 or 32 a warp: one or two m16
// tiles; the wrapper chooses, ops/quant_matmul.py: a16_decode_plan); CTA
// `rank` walks K steps of 128 [rank*ng/C, (rank+1)*ng/C). Warp w owns WC of the
// columns over all of the CTA's groups and streams their packed words and
// combo words through a DEC_STAGES-deep cp.async ring of its own,
// DEC_STAGES - 1 groups in flight, waiting on its own copies only: no block
// barrier in the K loop. The product is taken transposed, out^T = W^T x^T:
//   A (16 x 16)  off + codes of the lane's columns 16mt + row and + 8, exactly
//                the pair layout's extractions of the staged words (as the
//                prefill kernel's A fragments);
//   B (16 x 8)   8 tokens of bf16 x, from the CTA's x slice staged in shared
//                memory (past L1, once), so no row is padding at M = 8;
//   sum(x_g)     in f32, once a CTA from its x slice (not in every warp),
//                no second mma;
//   fold         acc += part * s - sum(x_g) * (sz + off * s), s and sz
//                decoded from the staged combo word (4 bytes a group column).
// A step of 128 k holds 128/g groups at g = 32 and 64 (each folds at its end;
// common.cuh: StepMap says which word and field a lane reads), one at 128;
// a group of g > 128 is g/128 steps whose x the staging reads in step order
// (kmap). At g = 32 and 64 K may end half way through a step (K = 64 mod
// 128, as Falcon-7B's 4544): the last step is a half step, its word rows
// and combo rows past K zero-filled by the copies (never read) and its x
// past K staged as zeros, so the missing half adds nothing. f32 x is
// rounded to bf16 as it is staged; out takes x's dtype.
// The C partial tiles are summed in rank order through distributed shared
// memory, each CTA finishing 1/C of the tile: deterministic, no atomics.
// ---------------------------------------------------------------------------

constexpr int DEC_G = 128;         // K step of the kernels: 128 / G groups, or 1 / (g / 128)
constexpr int DEC_STAGES = 4;     // a warp's ring: 3 groups in flight
constexpr bool DEC_PDL = true;    // a programmatic dependent: rings fill as the kernel before ends

template <int BITS, int TOK, int WC, int G>
struct Dec {
  using Map = StepMap<BITS, G, 2>;
  static constexpr int R = DEC_G * BITS / 32;     // word rows a step
  static constexpr int SUB = Map::SUB;            // groups (combo rows) a step
  static constexpr int MT = WC / 16;              // m16 tiles a warp
  static constexpr int COLS = kWarps * WC;        // output columns a cluster
  static constexpr int WLD = WC + 8;              // staged word row: fragment reads hit 32 banks
  static constexpr int WSTAGE = R * WLD + SUB * WC;  // words, then combo words
  static constexpr int MROWS = 8 * TOK;           // token rows: TOK n-tiles of 8
  static constexpr int RED = MROWS * COLS * 4;    // the partial tile, over the drained rings
  static constexpr int RINGS = kWarps * DEC_STAGES * WSTAGE * 4;
  static constexpr int RING = RINGS > RED ? RINGS : RED;
  // x row: lanes' tokens land 4 banks apart
  __host__ __device__ static int xld(int ngs_max) { return ngs_max * DEC_G + 8; }
  __host__ __device__ static size_t xbytes(int ngs_max) {
    return size_t(MROWS) * xld(ngs_max) * 2;
  }
  // the ring, the x slice, then its group sums [MROWS][ngs_max * SUB] f32
  __host__ __device__ static size_t smem(int ngs_max) {
    return RING + xbytes(ngs_max) + size_t(MROWS) * ngs_max * SUB * 4;
  }
};

// Two CTAs an SM, but one at 32 token rows and 32 columns a warp (its 32
// accumulators and 32 partials a thread, with the words, spill at 128
// registers).
// G: the group when it is 32, 64 or 128; 128 also for g = gdiv * 128 (the
// combo row of step j is j / gdiv, and x is read through kmap, the step
// order of ops/quant_matmul.py: step_kmap, period g). x is bf16 or, with
// x_f32, f32 rounded to bf16 as it is staged; out takes x's dtype.
template <int BITS, int TOK, int WC, int G>
__global__ void __launch_bounds__(kThreads, TOK == 4 && WC == 32 ? 1 : 2)
    qmm_decode_stream_kernel(const void* __restrict__ x, const uint32_t* __restrict__ qw,
                             const uint32_t* __restrict__ combo, void* __restrict__ out,
                             const int* __restrict__ kmap, int M, int K, int N, int ngs_max,
                             int vec, int gdiv, int x_f32) {
  using D = Dec<BITS, TOK, WC, G>;
  using Map = typename D::Map;
  constexpr int MROWS = D::MROWS, MT = D::MT, COLS = D::COLS, SUB = D::SUB;
  constexpr int NW = Map::NW;           // words a lane holds a step and column
  constexpr int FG = DEC_G / SUB;       // k a fold (a group, or a step)
  constexpr float kOff = Trick<BITS>::kOffset;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, row = lane >> 2;
  const int n0 = blockIdx.y * COLS;
  // steps of K; at g = 32, 64 the last may be a half step (K = 64 mod 128)
  const int ng = G < DEC_G ? (K + DEC_G - 1) / DEC_G : K / DEC_G;
  const int g0 = rank * ng / C, ngs = (rank + 1) * ng / C - g0;
  const int k0 = g0 * DEC_G, kn = ngs * DEC_G;
  const int xld = D::xld(ngs_max), xsld = ngs_max * SUB;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + warp * DEC_STAGES * D::WSTAGE;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + D::RING);
  float* xsum_s = reinterpret_cast<float*>(smem + D::RING + D::xbytes(ngs_max));

  // the lane's pieces of a step, 4 columns each: word piece lane + 32k (row
  // r, column c of the warp's R x WC), combo piece lane (lanes < SUB * WC/4:
  // combo row lane / (WC/4)); the offsets and the columns' bounds do not
  // change from step to step
  constexpr int C4 = WC / 4, PW = D::R * C4 / 32;
  const int wn = n0 + warp * WC, cs_row = lane / C4, cc = (lane % C4) * 4;
  const int c_ok = min(max(N - wn - cc, 0), 4);  // columns of a piece below N
  int w_src[PW], w_dst[PW], w_ok[PW];
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    const int i = lane + 32 * k, r = i / C4, c = (i % C4) * 4;
    w_src[k] = r * N + wn + c;
    w_dst[k] = r * D::WLD + c;
    w_ok[k] = min(max(N - wn - c, 0), 4);
  }
  auto piece = [&](uint32_t* dst, const uint32_t* src, const uint32_t* any, int ok) {
    if (vec) {
      cp_async16(dst, ok ? src : any, ok * 4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < ok ? src + e : any, e < ok ? 4 : 0);
    }
  };
  auto issue = [&](int j) {  // step g0 + j of this warp's columns; always one commit group
    if (j < ngs) {
      uint32_t* st = ring + (j % DEC_STAGES) * D::WSTAGE;
      const uint32_t* src = qw + size_t(g0 + j) * D::R * N;
      // K = 64 mod 128: a half last step, whose upper half of word rows (a
      // piece lane + 32k of row >= R/2) and combo rows is zeros (past K,
      // never read)
      const bool half = G < DEC_G && K % DEC_G != 0 && g0 + j == ng - 1;
#pragma unroll
      for (int k = 0; k < PW; ++k)
        piece(st + w_dst[k], src + w_src[k], qw,
              half && lane + 32 * k >= D::R / 2 * C4 ? 0 : w_ok[k]);
      const int crow = step_row(g0 + j, SUB, gdiv) + cs_row;
      if (lane < SUB * C4)
        piece(st + D::R * D::WLD + cs_row * WC + cc, combo + size_t(crow) * N + wn + cc, combo,
              half && cs_row >= SUB / 2 ? 0 : c_ok);
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < DEC_STAGES - 1; ++j) issue(j);

  grid_dep_wait();  // x is the previous kernel's (a no-op unless launched with PDL)
  // this CTA's x slice, 16 bytes of bf16 a load (4 in flight a thread), past
  // L1, and its group sums: a fold group of a row is FG / 8 consecutive
  // loads, so as many consecutive lanes, summed by shuffles
  const int per = kn / 8, total = MROWS * per;  // total: a multiple of 16
  const int P = gdiv * DEC_G;                   // kmap's period
  for (int base = 0; base < total; base += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads + tid, r = idx / per;
      // x past K (a half last step): zeros
      v[u] = idx < total && r < M && (G == DEC_G || k0 + (idx - r * per) * 8 < K)
                 ? load8_bf16(x, size_t(r) * K + src_k(k0 + (idx - r * per) * 8, kmap, P), x_f32)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * kThreads + tid, r = idx / per, c = idx - r * per;
      if (idx < total) *reinterpret_cast<uint4*>(xs + r * xld + c * 8) = v[u];
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        sum += f.x + f.y;
      }
#pragma unroll
      for (int off = 1; off < FG / 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (idx < total && c % (FG / 8) == 0) xsum_s[r * xsld + c / (FG / 8)] = sum;
    }
  }
  __syncthreads();  // the x slice and its group sums in shared memory

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
    float part[TOK][MT][4];
#pragma unroll
    for (int t = 0; t < TOK; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[t][mt][e] = 0.f;
    const uint32_t* cs = ws + D::R * D::WLD;
#pragma unroll
    for (int kb = 0; kb < DEC_G / 16; ++kb) {
      const int u0 = Map::word(kb, 0), u1 = Map::word(kb, 1);
      const int i0 = Map::field(kb, 0), i1 = Map::field(kb, 1);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = extract_bits<BITS>(w[mt][0][u0], i0);
        a[mt][1] = extract_bits<BITS>(w[mt][1][u0], i0);
        a[mt][2] = extract_bits<BITS>(w[mt][0][u1], i1);
        a[mt][3] = extract_bits<BITS>(w[mt][1][u1], i1);
      }
#pragma unroll
      for (int t = 0; t < TOK; ++t) {  // token row 8t + row, k = 16kb + 2quad (+8)
        const __nv_bfloat16* xr = xs + (8 * t + row) * xld + j * DEC_G + 16 * kb + 2 * quad;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(part[t][mt], a[mt], b0, b1);
      }
      if (Map::group_end(kb)) {
        // fold group gs of the step: the lane's accumulators are columns
        // 16mt + row, + 8 (e >> 1) x tokens 8t + 2quad, + 1 (e & 1)
        const int gs = kb / Map::KB;
        float s[MT][2], zc[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sz;
            decode_combo(cs[gs * WC + 16 * mt + 8 * h + row], s[mt][h], sz);
            zc[mt][h] = sz + kOff * s[mt][h];  // the +off of the codes
          }
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          const float* xq = xsum_s + (8 * t + 2 * quad) * xsld + j * SUB + gs;
          const float xt[2] = {xq[0], xq[xsld]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[t][mt][e] = acc[t][mt][e] + part[t][mt][e] * s[mt][e >> 1] -
                              xt[e & 1] * zc[mt][e >> 1];
              part[t][mt][e] = 0.f;
            }
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
      store_out(out, size_t(r) * N + n, sum, x_f32);
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// ---------------------------------------------------------------------------
// Prefill (M > 32). The product is taken transposed, out^T = W^T x^T, so
// that the unpacked codes are the wgmma A operand, held in registers, and x
// the B operand, read by the tensor cores from shared memory as it came:
//   * one block per output tile of BM = 64 or 128 rows (the wgmma N) and 128
//     columns: two warpgroups of 64 columns each (the wgmma M);
//   * K is walked one step of 128 at a time through a ring of PF_STAGES stages,
//     each filled by five TMA loads that one thread starts and that complete
//     on the stage's mbarrier: the x tile (BM x 128 bf16, two 64-k atoms,
//     128-byte swizzle), the group's packed words (R x 136: 8 columns of
//     padding keep the fragment reads free of bank conflicts), its combo
//     words (128) and its x sums (BM); groups g+1 .. g+3 are in flight while
//     group g computes;
//   * A fragments straight from the words: under the pair layout one
//     extraction is the bf16x2 (off + q) of two consecutive k of a column,
//     exactly a register of the m16n8k16 A layout (as in the decode kernel);
//   * part = x_g . (off + q)_g is a fresh f32 wgmma accumulator a group
//     (scale-d 0 on its first k-step), folded in registers:
//       acc += part * s - xsum * (sz + off * s),
//     xsum_g[m] from prefill_prep_kernel, one pass over x before the matmul;
//   * groups of 32 and 64 (C1): the step's 128 k hold 128 / g groups, each a
//     commit of its own k-steps folded at its end (slower: the wgmma waits a
//     group); at K = 64 mod 128 the last step is a half step whose x, word
//     rows, combo rows and x sums past K TMA fills with zeros (the maps end
//     at K); a group of g > 128 is g / 128 steps read in the order of
//     step_kmap, through the prep pass's bf16 copy of x, which also holds f32
//     x rounded to bf16 (the output then in f32).
// Shared memory carries x alone: 2 x BM x 32 bytes of wgmma reads a k-step,
// half of what the codes as a second shared operand would add (an earlier
// version unpacked them into a shared bf16 tile and ran 1.6x slower). No
// split-K: a block writes its own tile, so the result is deterministic.
// ---------------------------------------------------------------------------

constexpr int PF_G = 128;         // K step: 128 / G groups, or 1 / (g / 128)
constexpr int PF_BN = 128;        // output columns a block (two warpgroups of 64)
constexpr int PF_STAGES = 4;      // ring depth: 4 stages of up to 42 KB
constexpr int PF_WS = PF_BN + 8;  // word-tile row: 8 words of padding (read past N: zeros)

// One pass over x ahead of the prefill kernels, one warp a (row, fold group
// of FG = min(g, 128) k): xsum[fg, m] = the f32 sum of the fold group's x as
// the kernel multiplies it (rounded to bf16), zero for M <= m < Mp; and, for
// f32 x or a kmap (g > 128), the bf16 copy xb[m, k] = bf16(x[m, src_k(k)])
// that the kernel's TMA then reads in place of x.
__global__ void __launch_bounds__(kThreads)
    prefill_prep_kernel(const void* __restrict__ x, const int* __restrict__ kmap,
                        __nv_bfloat16* __restrict__ xb, float* __restrict__ xsum, int M, int K,
                        int Mp, int FG, int P, int x_f32) {
  const int nf = K / FG;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= Mp * nf) return;
  const int m = item / nf, fg = item - m * nf;
  float s = 0.f;
  if (m < M && !x_f32 && !xb) {  // bf16 x read in place: FG / 32 consecutive k a lane
    const __nv_bfloat16* xr = static_cast<const __nv_bfloat16*>(x) + size_t(m) * K + fg * FG;
    if (FG == 128) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr) + lane);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      s = (a.x + a.y) + (b.x + b.y);
    } else if (FG == 64) {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(xr) + lane);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
      s = a.x + a.y;
    } else {
      s = __bfloat162float(xr[lane]);
    }
  } else if (m < M) {
    for (int e = lane; e < FG; e += 32) {
      const int k = fg * FG + e, src = src_k(k, kmap, P);
      const float v = x_f32 ? round_to_bf16(static_cast<const float*>(x)[size_t(m) * K + src])
                            : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[size_t(m) * K + src]);
      if (xb) xb[size_t(m) * K + k] = __float2bfloat16(v);
      s += v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) xsum[size_t(fg) * Mp + m] = s;
}

template <int BITS, int BM, int G>
struct Prefill {
  using Map = StepMap<BITS, G, 2>;
  static constexpr int SUB = Map::SUB;         // groups a step
  static constexpr int R = PF_G * BITS / 32;  // word rows a step
  static constexpr int X_BYTES = BM * PF_G * 2;
  static constexpr int W_BYTES = R * PF_WS * 4;
  static constexpr int C_OFF = X_BYTES + W_BYTES;  // combo words [SUB][PF_BN], then x sums [SUB][BM]
  static constexpr int TX_BYTES = C_OFF + SUB * PF_BN * 4 + SUB * BM * 4;  // a stage's TMA bytes
  static constexpr int STAGE = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = PF_STAGES * STAGE + PF_STAGES * 8 + 1024;  // + mbarriers, alignment
};

// G as in the decode kernel (gdiv: combo row of step g is g / gdiv); out is
// bf16 or, with out_f32, f32.
template <int BITS, int BM, int G>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_prefill_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const __grid_constant__ CUtensorMap s_map, void* __restrict__ out,
                       int M, int K, int N, int gdiv, int out_f32) {
  using P = Prefill<BITS, BM, G>;
  using Map = typename P::Map;
  constexpr int NJ = BM / 8;    // 8-row blocks of x: the accumulator's column blocks
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
  const int ng = (K + PF_G - 1) / PF_G;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PF_STAGES * P::STAGE);

  auto load_stage = [&](int g) {  // one thread
    uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    uint64_t* bar = full + g % PF_STAGES;
    mbar_expect(bar, P::TX_BYTES);  // a box's bytes, zeros past the map included
    tma_load(st, &x_map, g * PF_G, m0, bar);
    tma_load(st + BM * 128, &x_map, g * PF_G + 64, m0, bar);
    tma_load(st + P::X_BYTES, &w_map, n0, g * P::R, bar);
    tma_load(st + P::C_OFF, &c_map, n0, step_row(g, SUB, gdiv), bar);
    tma_load(st + P::C_OFF + SUB * PF_BN * 4, &s_map, m0, g * SUB, bar);
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

  const int pre = Map::preshift(q);
  for (int g = 0; g < ng; ++g) {
    const uint8_t* st = smem + (g % PF_STAGES) * P::STAGE;
    mbar_wait(full + g % PF_STAGES, (g / PF_STAGES) & 1);
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(st + P::X_BYTES);
    // words of columns nl, nl + 8 and the step's word rows Map::row(u, q)
    // (lanes: 4 word rows x 8 columns, no bank conflict)
    uint32_t w[2][NW];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < NW; ++u) w[h][u] = ws[Map::row(u, q) * PF_WS + nl + 8 * h] >> pre;
    uint32_t a[PF_G / 16][4];
#pragma unroll
    for (int kk = 0; kk < PF_G / 16; ++kk) {  // k = 16kk + 2q (+8)
      const int u0 = Map::word(kk, 0), u1 = Map::word(kk, 1);
      const int i0 = Map::field(kk, 0), i1 = Map::field(kk, 1);
      a[kk][0] = extract_bits<BITS>(w[0][u0], i0);
      a[kk][1] = extract_bits<BITS>(w[1][u0], i0);
      a[kk][2] = extract_bits<BITS>(w[0][u1], i1);
      a[kk][3] = extract_bits<BITS>(w[1][u1], i1);
    }
    const uint32_t xa = smem_u32(st);
    const uint32_t* cs = reinterpret_cast<const uint32_t*>(st + P::C_OFF);
    const float* xs = reinterpret_cast<const float*>(st + P::C_OFF + SUB * PF_BN * 4);
#pragma unroll
    for (int gs = 0; gs < SUB; ++gs) {  // a fresh accumulator a group of the step
      wgmma_fence();
      fence_regs(part);
#pragma unroll
      for (int kk = gs * Map::KB; kk < (gs + 1) * Map::KB; ++kk)  // atom kk/4, byte 32(kk%4)
        wgmma_bf16(part, a[kk], sw128_desc(xa + (kk >> 2) * (BM * 128) + (kk & 3) * 32),
                   kk > gs * Map::KB);
      wgmma_commit();
      if (gs == 0) {
        __syncthreads();  // every thread done with stage g-1: its slot takes step g+3
        if (tid == 0 && g + PF_STAGES - 1 < ng) load_stage(g + PF_STAGES - 1);
      }
      float s[2], zc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sz;
        decode_combo(cs[gs * PF_BN + nl + 8 * h], s[h], sz);
        zc[h] = sz + Trick<BITS>::kOffset * s[h];
      }
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < PF_G / 16; ++kk) fence_regs(a[kk]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + gs * BM + 8 * j + 2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float xe = (e & 1) ? xv.y : xv.x;
          acc[4 * j + e] = acc[4 * j + e] + part[4 * j + e] * s[h] - xe * zc[h];
        }
      }
    }
  }

  // the tile in out's dtype, the dtype test hoisted out of the stores
  auto store = [&](auto* o) {
    using T = std::remove_pointer_t<decltype(o)>;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + nl + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + 8 * j + 2 * q + c;
          if (m < M) o[size_t(m) * N + n] = from_f32<T>(acc[4 * j + 2 * h + c]);
        }
    }
  };
  if (out_f32)
    store(static_cast<float*>(out));
  else
    store(static_cast<__nv_bfloat16*>(out));
}

struct PfArgs {
  const void* x;      // the caller's x (bf16 or f32)
  const int* kmap;    // step order for g > 128, else null
  void* xb;           // bf16 copy scratch [M, K] for f32 x or a kmap, else null
  const void* qw;
  const void* combo;
  void* xsum;         // f32 [K / FG, round_up(M, 4)]
  void* out;
  int M, K, N, g, x_f32;
};

template <int BITS, int BM, int G>
cudaError_t launch_prefill(const PfArgs& a, cudaStream_t stream) {
  using P = Prefill<BITS, BM, G>;
  const int Mp = (a.M + 3) / 4 * 4;
  const int FG = PF_G / P::SUB, gdiv = G == 128 ? a.g / PF_G : 1;
  const void* xt = a.xb ? a.xb : a.x;  // what TMA reads: bf16
  CUtensorMap xm, wm, cm, sm;  // each ends at K: a half last step reads zeros past it
  if (!tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xt, a.M, a.K, BM, 64, true) ||
      !tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.qw, a.K * BITS / 32, a.N, P::R, PF_WS,
                  false) ||
      !tensor_map(&cm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.combo, a.K / a.g, a.N, P::SUB, PF_BN,
                  false) ||
      !tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.xsum, a.K / FG, Mp, P::SUB, BM, false))
    return cudaErrorInvalidValue;
  prefill_prep_kernel<<<(Mp * (a.K / FG) + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      a.x, a.kmap, static_cast<__nv_bfloat16*>(a.xb), static_cast<float*>(a.xsum), a.M, a.K, Mp,
      FG, a.g, a.x_f32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = qmm_prefill_kernel<BITS, BM, G>;
  err = allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + PF_BN - 1) / PF_BN, (a.M + BM - 1) / BM);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(xm, wm, cm, sm, a.out, a.M, a.K, a.N, gdiv,
                                              a.x_f32);
  return cudaGetLastError();
}

// tile_m: output rows a block, 128 or 64 (for a short prefill, so that
// every SM has a block); the wrapper chooses (ops/quant_matmul.py:
// prefill_tile_m).
template <int BITS, int G>
cudaError_t launch_prefill_tm(const PfArgs& a, int tile_m, cudaStream_t stream) {
  if (tile_m == 128) return launch_prefill<BITS, 128, G>(a, stream);
  if (tile_m == 64) return launch_prefill<BITS, 64, G>(a, stream);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t launch_prefill_g(const PfArgs& a, int tile_m, cudaStream_t stream) {
  if (a.g == 32) return launch_prefill_tm<BITS, 32>(a, tile_m, stream);
  if (a.g == 64) return launch_prefill_tm<BITS, 64>(a, tile_m, stream);
  return launch_prefill_tm<BITS, 128>(a, tile_m, stream);
}

struct DecArgs {
  const void* x;
  const void* qw;
  const void* combo;
  void* out;
  const int* kmap;
  int M, K, N, g, x_f32;
};

template <int BITS, int TOK, int WC, int G>
cudaError_t launch_decode(const DecArgs& a, int cluster, cudaStream_t stream) {
  using D = Dec<BITS, TOK, WC, G>;
  const int ngs_max = ((a.K + DEC_G - 1) / DEC_G + cluster - 1) / cluster;
  const int vec = a.N % 4 == 0 && aligned16(a.qw) && aligned16(a.combo);
  const int gdiv = G == 128 ? a.g / DEC_G : 1;
  return launch_cluster(qmm_decode_stream_kernel<BITS, TOK, WC, G>,
                        dim3(cluster, (a.N + D::COLS - 1) / D::COLS, 1), cluster,
                        D::smem(ngs_max), DEC_PDL, stream, a.x,
                        static_cast<const uint32_t*>(a.qw), static_cast<const uint32_t*>(a.combo),
                        a.out, a.kmap, a.M, a.K, a.N, ngs_max, vec, gdiv, a.x_f32);
}

// 8, 16 or 32 token rows a CTA
template <int BITS, int WC, int G>
cudaError_t launch_decode_mt(const DecArgs& a, int cluster, cudaStream_t s) {
  if (a.M <= 8) return launch_decode<BITS, 1, WC, G>(a, cluster, s);
  if (a.M <= 16) return launch_decode<BITS, 2, WC, G>(a, cluster, s);
  return launch_decode<BITS, 4, WC, G>(a, cluster, s);
}

template <int BITS, int WC>
cudaError_t launch_decode_g(const DecArgs& a, int cluster, cudaStream_t s) {
  if (a.g == 32) return launch_decode_mt<BITS, WC, 32>(a, cluster, s);
  if (a.g == 64) return launch_decode_mt<BITS, WC, 64>(a, cluster, s);
  return launch_decode_mt<BITS, WC, 128>(a, cluster, s);
}

// g: 32 or 64 with K a multiple of 64 (K = 64 mod 128: a half last step),
// or a multiple of 128 that divides K (kmap given above 128)
bool group_ok(int g, int K, const void* kmap) {
  if (g == 32 || g == 64) return K % 64 == 0 && kmap == nullptr;
  return g >= 128 && g % 128 == 0 && K % g == 0 && (g == 128) == (kmap == nullptr);
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_f32 = 0) or f32 (1), 16-byte aligned; qweight [K/pack, N]
// int32 (one layer: the caller offsets a stacked array to layer li), combo
// [K/g, N] int32, out [M, N] in x's dtype; all row-major, contiguous. bits 2
// or 4; g 32 or 64 (K a multiple of 64), or a multiple of 128 dividing K,
// above 128 with kmap [g] int32 (ops/quant_matmul.py: step_kmap), else
// kmap null. M <= 32. Clusters of 1 <= cluster <= min(8, ceil(K/128)) CTAs,
// warp_cols (16 or 32) columns a warp (ops/quant_matmul.py:
// a16_decode_plan); a cluster the card cannot hold launches nothing and
// returns its error. Returns 0 once launched, else the CUDA error.
int bd_qmm_decode(const void* x, const void* qweight, const void* combo, const void* kmap,
                  void* out, int M, int K, int N, int bits, int group, int cluster, int warp_cols,
                  int x_f32, void* stream) {
  if (M < 1 || M > 32 || N < 1 || !group_ok(group, K, kmap) || (bits != 2 && bits != 4) ||
      !aligned16(x) || cluster < 1 || cluster > kMaxCluster || cluster > (K + DEC_G - 1) / DEC_G ||
      (warp_cols != 16 && warp_cols != 32))
    return cudaErrorInvalidValue;
  const DecArgs a{x, qweight, combo, out, static_cast<const int*>(kmap), M, K, N, group, x_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2)
    return warp_cols == 16 ? launch_decode_g<2, 16>(a, cluster, s)
                           : launch_decode_g<2, 32>(a, cluster, s);
  return warp_cols == 16 ? launch_decode_g<4, 16>(a, cluster, s)
                         : launch_decode_g<4, 32>(a, cluster, s);
}

// The same for the prefill kernels (any M; the wrapper sends M > 32), with
// N a multiple of 4 and x, qweight, combo 16-byte aligned (TMA), tile_m 64
// or 128. Scratch the caller allocates: xsum f32 [K / min(g, 128),
// round_up(M, 4)], and xb bf16 [M, K] for f32 x or a kmap (null otherwise).
int bd_qmm_prefill(const void* x, const void* qweight, const void* combo, const void* kmap,
                   void* xb, void* xsum, void* out, int M, int K, int N, int bits, int group,
                   int tile_m, int x_f32, void* stream) {
  if (M < 1 || !group_ok(group, K, kmap) || N % 4 != 0 || (bits != 2 && bits != 4) ||
      ((x_f32 || kmap) && xb == nullptr))
    return cudaErrorInvalidValue;
  const PfArgs a{x, static_cast<const int*>(kmap), xb, qweight, combo, xsum, out,
                 M, K, N, group, x_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2) return launch_prefill_g<2>(a, tile_m, s);
  return launch_prefill_g<4>(a, tile_m, s);
}

}  // extern "C"
