// Fused packed MLP for Hopper (sm_90a), plain C interface for ctypes
// (bitdistiller_tpu_torch/experimental/fused_mlp.py).
//
// Replaces the TPU kernel bitdistiller_tpu/experimental/fused_mlp.py:_mlp_kernel
// (:57, pallas_call at :119 in _fused_mlp_2d):
//
//   out = sum_f (act(x @ Wg[:, f]) * (x @ Wu[:, f])) @ Wd[f, :]
//
// with Wg, Wu, Wd int2/int4 in the pair layout, f32 scales and szeros, x
// and mid fed to the products as bf16, each group's correction
// acc + partial*s - sum(x_g)*(sz + off*s) on an f32 accumulator (sum(x_g) in
// f32 of the unrounded values: for the down product the f32 mid), act silu
// or tanh-gelu, out rounded once.
//
// Bound on this card: bytes at decode widths. The three packed weights
// ((2*K*F + F*D) * bits/8) and their f32 scales and szeros (8 bytes a group
// column) stream from HBM once, at 3.35 TB/s. Design: two launches in one
// call, both on the streaming plan of stream.cuh (a cluster of CTAs splits
// the K groups of a column tile, a cp.async ring keeps several groups in
// flight, the partial tiles are summed in rank order through distributed
// shared memory), the second a programmatic dependent of the first:
//   * gate/up: a cluster of C1 CTAs owns an ffn tile of 128 columns (one
//     group of Wd's rows) and splits the K walk; warp w owns the tile's
//     columns 16w .. 16w + 15 of both Wg and Wu and streams their words
//     through a ring of its own. The products are taken transposed
//     (mma.sync.m16n8k16, the warp's 16 columns as the A operand straight
//     from the staged pair-layout words, 8 tokens of bf16 x as B; f32 out),
//     so no row is padding at M = 8; sum(x_g) in f32 from the B registers. CTA
//     rank r finishes rows r, r + C1, ... of the summed tile:
//     mid = act(gate) * up, written as bf16 [M, F], and the f32 sum of the
//     unrounded mid over the tile, msum [M, F/128], the down product's
//     group sums;
//   * down: mid @ Wd, a packed decode matmul over K = F (clusters of C2 CTAs
//     split the F groups; the sum over F runs in group order inside a CTA,
//     then in rank order). Its ring fills with Wd's words while the
//     gate/up launch finishes; it waits for mid before it reads it.
// So mid passes through L2: M * F * (2 + 4/128) bytes, 179 KB at M = 8 and
// 7B widths, under 1% of the 42 MB of weights. (The JAX kernel keeps mid in
// VMEM: a layout choice of the TPU, not part of the function.) No partial
// planes, no float atomics: two calls on the same inputs give the same
// bytes. A CTA takes 8, 16 or 32 token rows; M > 32 runs in chunks of 32
// (grid z), each streaming the weights again. At g = 32 and 64 K may be 64
// mod 128 (Falcon-7B's hidden size 4544): gate/up's last K step is then a
// half step, its word and scale rows past K zero-filled and never read, its
// x past K staged as zeros.

#include "common.cuh"
#include "stream.cuh"

namespace {

using namespace bd;

constexpr int G = 128;  // K step: 128 / g groups (g = 32, 64), or one (g >= 128)
constexpr int COLS = 128;  // columns a cluster; for gate/up the ffn tile, one group of Wd's rows
constexpr int kSilu = 0;
constexpr int kGeluTanh = 1;

template <int ACT>
__device__ __forceinline__ float act(float g) {
  if constexpr (ACT == kSilu) {
    return g * (1.f / (1.f + expf(-g)));  // x * sigmoid(x), as jax.nn.silu
  } else {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return g * (0.5f * (1.f + tanhf(c * (g + 0.044715f * g * g * g))));
  }
}

// Shared-memory plan of one launch: NW weights (2: gate and up, 1: down) of
// COLS = 128 columns, 8 * TOK token rows of x. Each warp streams its 16
// columns of every weight through a ring of its own, STAGES deep.
template <int BITS, int TOK, int NW, int GG>
struct Mlp {
  using Map = StepMap<BITS, GG, 2>;
  static constexpr int SUB = Map::SUB;      // groups (scale rows) a step of 128
  static constexpr int R = G * BITS / 32;  // word rows a step
  static constexpr int WC = COLS / kWarps;  // columns a warp: one m16 tile
  static constexpr int WLD = WC + 8;        // staged word row: 4 k quads x 8 columns hit 32 banks
  static constexpr int WWORDS = R * WLD;           // a weight's staged words
  static constexpr int WSTAGE = WWORDS + 2 * SUB * WC;  // then its scales and szeros rows
  static constexpr int STAGES = NW == 2 ? 4 : 6;   // groups in flight a warp: STAGES - 1
  static constexpr int MROWS = 8 * TOK;
  static constexpr int RED = MROWS * NW * COLS * 4;  // the partial tile, over the drained rings
  static constexpr int RINGS = kWarps * STAGES * NW * WSTAGE * 4;
  static constexpr int RING = RINGS > RED ? RINGS : RED;
  static constexpr int MIDF = NW == 2 ? MROWS * COLS * 4 : 0;  // gate/up: f32 mid, over the x slice
  // x row: lanes' tokens land 4 banks apart
  __host__ __device__ static int xld(int ngs_max) { return ngs_max * G + 8; }
  __host__ __device__ static size_t xbytes(int ngs_max) {
    const size_t b = size_t(MROWS) * xld(ngs_max) * 2;
    return b > MIDF ? b : MIDF;
  }
  // + the fold groups' sums: down's, or gate/up's of f32 x
  __host__ __device__ static size_t smem(int ngs_max, bool sums) {
    return RING + xbytes(ngs_max) + (sums ? size_t(MROWS) * ngs_max * SUB * 4 : 0);
  }
};

// NW 2: x [M, K] against gate (q0, s0, z0) and up (q1, s1, z1) [K, N = F];
// writes mid y [M, F] bf16 and its tile sums ysum [M, F/128] f32.
// NW 1: x = mid [M, K = F] with its group sums xsum_g [M, F/128] against down
// (q0, s0, z0) [F, N = D]; writes out y [M, D] bf16.
// The product is taken transposed (out^T = W^T x^T): a warp's 16 columns are
// the m16n8k16 A operand, whose registers are exactly the pair layout's
// extractions for the lane's columns row and row + 8 (as the A16 prefill
// kernel's), and 8 tokens of x the B operand, so no row is padding at M = 8.
// Two CTAs an SM, but one for gate/up at 32 token rows (its 32 f32
// accumulators and 32 partials a thread, with the words, spill at 128
// registers).
// GG: the group when it is 32, 64 or 128; 128 also for g = gdiv * 128 (the
// scale row of step j is j / gdiv, and x is read through kmap, the step
// order of period g). x is bf16, or for gate/up with x_f32 f32 rounded to
// bf16 as it is staged (out then f32). ysum / xsum_g hold one f32 sum a
// fold group of F / FG (FG = min(g, 128)).
template <int BITS, int TOK, int NW, int ACT, int GG>
__global__ void __launch_bounds__(kThreads, NW == 2 && TOK == 4 ? 1 : 2)
    mlp_stream_kernel(const void* __restrict__ x, const float* __restrict__ xsum_g,
                      const uint32_t* __restrict__ q0, const float* __restrict__ s0,
                      const float* __restrict__ z0, const uint32_t* __restrict__ q1,
                      const float* __restrict__ s1, const float* __restrict__ z1,
                      void* __restrict__ y, float* __restrict__ ysum,
                      const int* __restrict__ kmap, int M, int K, int N, int ngs_max, int vec,
                      int gdiv, int x_f32) {
  using P = Mlp<BITS, TOK, NW, GG>;
  using Map = typename P::Map;
  constexpr bool GATE_UP = NW == 2;
  constexpr int MROWS = P::MROWS, WC = P::WC, STAGES = P::STAGES, SUB = P::SUB;
  constexpr int NWD = Map::NW;  // words a lane holds a step and column
  constexpr int FG = G / SUB;   // k a fold group
  constexpr float kOff = Trick<BITS>::kOffset;
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (GATE_UP) grid_dep_launch();  // the down launch may start filling its rings
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane & 3, row = lane >> 2;
  const int n0 = blockIdx.y * COLS, m0 = blockIdx.z * MROWS;
  // steps of K; at g = 32, 64 the last may be a half step (K = 64 mod 128)
  const int ng = GG < G ? (K + G - 1) / G : K / G;
  const int g0 = rank * ng / C, ngs = (rank + 1) * ng / C - g0;
  const int k0 = g0 * G, kn = ngs * G;
  const int xld = P::xld(ngs_max), xsld = ngs_max * SUB;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + warp * STAGES * NW * P::WSTAGE;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + P::RING);
  // the fold groups' f32 sums of x: down's from the gate/up launch, gate/up's
  // of f32 x from x itself (the unrounded values, as the plain version)
  float* xsum_s = reinterpret_cast<float*>(smem + P::RING + P::xbytes(ngs_max));
  const uint32_t* qsrc[2] = {q0, q1};
  const float* ssrc[2] = {s0, s1};
  const float* zsrc[2] = {z0, z1};

  auto issue = [&](int j) {  // step g0 + j of this warp's columns; always one commit group
    if (j < ngs) {
      uint32_t* st = ring + (j % STAGES) * NW * P::WSTAGE;
      const int g = g0 + j, wn = n0 + warp * WC, srow = step_row(g, SUB, gdiv);
      if (GG == G || K % G == 0 || g != ng - 1) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t* sw = st + w * P::WSTAGE;
          warp_copy<WC>(sw, qsrc[w] + size_t(g) * P::R * N, P::R, P::WLD, wn, N, vec, lane);
          warp_copy<WC>(sw + P::WWORDS, ssrc[w] + size_t(srow) * N, SUB, WC, wn, N, vec, lane);
          warp_copy<WC>(sw + P::WWORDS + SUB * WC, zsrc[w] + size_t(srow) * N, SUB, WC, wn, N,
                        vec, lane);
        }
      } else {  // K = 64 mod 128: a half last step, its upper half zeros (past K, never read)
        constexpr int R2 = P::R / 2, S2 = SUB / 2;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          uint32_t* sw = st + w * P::WSTAGE;
          warp_copy<WC>(sw, qsrc[w] + size_t(g) * P::R * N, R2, P::WLD, wn, N, vec, lane);
          warp_copy<WC>(sw + P::WWORDS, ssrc[w] + size_t(srow) * N, S2, WC, wn, N, vec, lane);
          warp_copy<WC>(sw + P::WWORDS + SUB * WC, zsrc[w] + size_t(srow) * N, S2, WC, wn, N,
                        vec, lane);
          warp_zero<WC>(sw + R2 * P::WLD, P::R - R2, P::WLD, lane);
          warp_zero<WC>(sw + P::WWORDS + S2 * WC, SUB - S2, WC, lane);
          warp_zero<WC>(sw + P::WWORDS + (SUB + S2) * WC, SUB - S2, WC, lane);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);

  if constexpr (!GATE_UP) grid_dep_wait();  // mid and msum are the gate/up launch's
  const int per = kn / 8;  // this CTA's x slice, past L1
  const int xf = GATE_UP && x_f32, Pk = gdiv * G;
  pipelined<4>(
      tid, MROWS * per, kThreads,
      [&](int idx) {
        const int r = idx / per;
        // x past K (a half last step): zeros
        return m0 + r < M && (GG == G || k0 + (idx - r * per) * 8 < K)
                   ? load8_bf16(x, size_t(m0 + r) * K +
                                       src_k(k0 + (idx - r * per) * 8, kmap, Pk), xf)
                   : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int idx, uint4 v) {
        const int r = idx / per;
        *reinterpret_cast<uint4*>(xs + r * xld + (idx - r * per) * 8) = v;
      });
  if (xf) {  // gate/up with f32 x: a warp a (row, fold group)
    for (int idx = warp; idx < MROWS * ngs * SUB; idx += kWarps) {
      const int r = idx / (ngs * SUB), j = idx - r * (ngs * SUB);
      float sum = 0.f;
      if (m0 + r < M && (GG == G || k0 + j * FG < K))  // a fold group past K: 0
        for (int e = lane; e < FG; e += 32)
          sum += static_cast<const float*>(x)[size_t(m0 + r) * K + src_k(k0 + j * FG + e, kmap, Pk)];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) xsum_s[r * xsld + j] = sum;
    }
  }
  if constexpr (!GATE_UP) {
    const int nf = ng * SUB;  // fold groups of the row
    for (int idx = tid; idx < MROWS * ngs * SUB; idx += kThreads) {
      const int r = idx / (ngs * SUB), j = idx - r * (ngs * SUB);
      xsum_s[r * xsld + j] =
          m0 + r < M ? __ldcg(xsum_g + size_t(m0 + r) * nf + g0 * SUB + j) : 0.f;
    }
  }
  __syncthreads();  // the x slice (and the down launch's group sums) in shared memory

  float acc[NW][TOK][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < TOK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][t][e] = 0.f;

  const int pre = Map::preshift(quad);
  for (int j = 0; j < ngs; ++j) {
    cp_wait<STAGES - 2>();  // this lane's copies of step j landed
    __syncwarp();           // and the other lanes'; slot (j - 1) is free
    issue(j + STAGES - 1);
    const uint32_t* st = ring + (j % STAGES) * NW * P::WSTAGE;
    uint32_t wd[NW][2][NWD];  // words of the lane's columns row and row + 8
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < NWD; ++u)
          wd[w][h][u] = st[w * P::WSTAGE + Map::row(u, quad) * P::WLD + 8 * h + row] >> pre;
    float part[NW][TOK][4], xq[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      xq[t] = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[w][t][e] = 0.f;
    }
#pragma unroll
    for (int kb = 0; kb < G / 16; ++kb) {
      const int u0 = Map::word(kb, 0), u1 = Map::word(kb, 1);
      const int i0 = Map::field(kb, 0), i1 = Map::field(kb, 1);
      uint32_t a[NW][4];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        a[w][0] = extract_bits<BITS>(wd[w][0][u0], i0);
        a[w][1] = extract_bits<BITS>(wd[w][1][u0], i0);
        a[w][2] = extract_bits<BITS>(wd[w][0][u1], i1);
        a[w][3] = extract_bits<BITS>(wd[w][1][u1], i1);
      }
#pragma unroll
      for (int t = 0; t < TOK; ++t) {  // token row 8t + row, k = 16kb + 2quad (+8)
        const __nv_bfloat16* xr = xs + (8 * t + row) * xld + j * G + 16 * kb + 2 * quad;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
        for (int w = 0; w < NW; ++w) mma_bf16(part[w][t], a[w], b0, b1);
        if constexpr (GATE_UP) {  // f32 sum of the token's x over the group
          const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b0));
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b1));
          xq[t] += (u.x + u.y) + (v.x + v.y);
        }
      }
      if (Map::group_end(kb)) {
        // fold group gs of the step: the lane's accumulators are columns
        // row, row + 8 (e >> 1) x tokens 8t + 2quad, + 1 (e & 1)
        const int gs = kb / Map::KB;
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          float xt[2];
          if (GATE_UP && !xf) {
            float xg = xq[t] + __shfl_xor_sync(0xffffffffu, xq[t], 1);  // sum of token 8t + row
            xg += __shfl_xor_sync(0xffffffffu, xg, 2);
            xt[0] = __shfl_sync(0xffffffffu, xg, 8 * quad);
            xt[1] = __shfl_sync(0xffffffffu, xg, 8 * quad + 4);
            xq[t] = 0.f;
          } else {  // from xsum_s: the f32 mid's (down), or f32 x's (gate/up)
            xt[0] = xsum_s[(8 * t + 2 * quad) * xsld + j * SUB + gs];
            xt[1] = xsum_s[(8 * t + 2 * quad + 1) * xsld + j * SUB + gs];
          }
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const float* ss = reinterpret_cast<const float*>(st + w * P::WSTAGE + P::WWORDS);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cl = gs * WC + 8 * (e >> 1) + row;
              const float s = ss[cl], zc = ss[SUB * WC + cl] + kOff * s;
              acc[w][t][e] = acc[w][t][e] + part[w][t][e] * s - xt[e & 1] * zc;
              part[w][t][e] = 0.f;
            }
          }
        }
      }
    }
  }

  // the partial tile over the drained rings, then the cluster's sum in rank order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [MROWS][NW * COLS]
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < TOK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * t + 2 * quad + (e & 1)) * (NW * COLS) + w * COLS + warp * WC + 8 * (e >> 1) +
            row] = acc[w][t][e];
  cluster.sync();
  if constexpr (GATE_UP) {
    float* midf = reinterpret_cast<float*>(xs);  // [MROWS][COLS]; the x slice is read no more
    const int rows = rank < MROWS ? (MROWS - rank + C - 1) / C : 0;  // rows rank, rank + C, ...
    for (int idx = tid; idx < rows * COLS; idx += kThreads) {
      const int r = rank + C * (idx / COLS), c = idx % COLS;
      float g[kMaxCluster], u[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)  // all loads in flight, then the sums in rank order
        if (q < C) {
          const float* pr = cluster.map_shared_rank(red, q) + r * 2 * COLS;
          g[q] = pr[c];
          u[q] = pr[COLS + c];
        }
      float gs = 0.f, us = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < C) gs += g[q], us += u[q];
      const float mid = act<ACT>(gs) * us;
      midf[r * COLS + c] = mid;
      if (m0 + r < M)
        static_cast<__nv_bfloat16*>(y)[size_t(m0 + r) * N + n0 + c] = __float2bfloat16(mid);
    }
    __syncthreads();
    // f32 sums of mid over the tile's fold groups (FG / 4 lanes each), fixed order
    for (int ri = warp; ri < rows; ri += kWarps) {
      const int r = rank + C * ri;
      const float4 v = *reinterpret_cast<const float4*>(midf + r * COLS + 4 * lane);
      float s = (v.x + v.y) + (v.z + v.w);
#pragma unroll
      for (int off = FG / 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane % (FG / 4) == 0 && m0 + r < M)
        ysum[size_t(m0 + r) * (N / FG) + blockIdx.y * SUB + lane / (FG / 4)] = s;
    }
  } else {
    const int e0 = rank * MROWS * COLS / C, e1 = (rank + 1) * MROWS * COLS / C;
    for (int idx = e0 + tid; idx < e1; idx += kThreads) {
      const int r = idx / COLS, n = n0 + idx % COLS;
      if (m0 + r < M && n < N) {
        float part[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)  // all loads in flight, then the sum in rank order
          if (q < C) part[q] = cluster.map_shared_rank(red, q)[idx];
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < C) sum += part[q];
        store_out(y, size_t(m0 + r) * N + n, sum, x_f32);
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

struct MlpArgs {
  const void* x;
  const uint32_t *gq, *uq, *dq;
  const float *gs, *gz, *us, *uz, *ds, *dz;
  const int *kmap_k, *kmap_f;  // step order of x (period g, K) and of mid (F), for g > 128
  __nv_bfloat16* mid;
  float* msum;
  void* out;
  int M, K, F, D, g, x_f32;
};

template <int BITS, int TOK, int ACT, int GG>
cudaError_t launch(const MlpArgs& a, int cluster1, int cluster2, cudaStream_t s) {
  using P1 = Mlp<BITS, TOK, 2, GG>;
  using P2 = Mlp<BITS, TOK, 1, GG>;
  const int n1 = ((a.K + G - 1) / G + cluster1 - 1) / cluster1;
  const int n2 = (a.F / G + cluster2 - 1) / cluster2;
  const int rows = (a.M + P1::MROWS - 1) / P1::MROWS;  // row chunks (grid z)
  const int gdiv = GG == 128 ? a.g / G : 1;
  const int vec1 = aligned16(a.gq) && aligned16(a.gs) && aligned16(a.gz) && aligned16(a.uq) &&
                   aligned16(a.us) && aligned16(a.uz);  // F % 128 == 0
  const int vec2 = a.D % 4 == 0 && aligned16(a.dq) && aligned16(a.ds) && aligned16(a.dz);
  const cudaError_t err = launch_cluster(
      mlp_stream_kernel<BITS, TOK, 2, ACT, GG>, dim3(cluster1, a.F / COLS, rows), cluster1,
      P1::smem(n1, a.x_f32), false, s, a.x, nullptr, a.gq, a.gs, a.gz, a.uq, a.us, a.uz,
      static_cast<void*>(a.mid), a.msum, a.kmap_k, a.M, a.K, a.F, n1, vec1, gdiv, a.x_f32);
  if (err != cudaSuccess) return err;
  return launch_cluster(mlp_stream_kernel<BITS, TOK, 1, kSilu, GG>,
                        dim3(cluster2, (a.D + COLS - 1) / COLS, rows), cluster2, P2::smem(n2, true),
                        true, s, static_cast<const void*>(a.mid), a.msum, a.dq, a.ds, a.dz,
                        nullptr, nullptr, nullptr, a.out, nullptr, a.kmap_f, a.M, a.F, a.D, n2,
                        vec2, gdiv, a.x_f32);
}

// 8, 16 or 32 token rows a CTA (above 32, chunks of 32 along grid z)
template <int BITS, int ACT, int GG>
cudaError_t launch_mt(const MlpArgs& a, int cluster1, int cluster2, cudaStream_t s) {
  if (a.M <= 8) return launch<BITS, 1, ACT, GG>(a, cluster1, cluster2, s);
  if (a.M <= 16) return launch<BITS, 2, ACT, GG>(a, cluster1, cluster2, s);
  return launch<BITS, 4, ACT, GG>(a, cluster1, cluster2, s);
}

template <int BITS, int ACT>
cudaError_t launch_g(const MlpArgs& a, int cluster1, int cluster2, cudaStream_t s) {
  if (a.g == 32) return launch_mt<BITS, ACT, 32>(a, cluster1, cluster2, s);
  if (a.g == 64) return launch_mt<BITS, ACT, 64>(a, cluster1, cluster2, s);
  return launch_mt<BITS, ACT, 128>(a, cluster1, cluster2, s);
}

}  // namespace

extern "C" {

// x [M, K] bf16 (x_f32 = 0) or f32 (1), 16-byte aligned; gate and up:
// qweight [K/pack, F] int32, scales and szeros [K/g, F] f32; down: qweight
// [F/pack, D], scales and szeros [F/g, D]; mid [M, F] bf16 and msum
// [M, F / min(g, 128)] f32 scratch the caller allocates; out [M, D] in x's
// dtype. Pair layout, bits 2 or 4, F a multiple of 128; g 32 or 64 with K
// a multiple of 64, or a multiple of 128 dividing K and F, with kmap_k and
// kmap_f [g] int32 (the step order, ops/quant_matmul.py: step_kmap) above
// 128, else null; act 0 = silu, 1 = tanh-gelu. Clusters of cluster1 CTAs
// (1 .. min(8, ceil(K/128))) an ffn
// tile, of cluster2 CTAs (1 .. min(8, F/128)) a down tile
// (experimental/fused_mlp.py: mlp_plan). Returns 0 once both launches are
// made, else the CUDA error (a cluster the card cannot hold launches
// nothing).
int bd_fused_mlp(const void* x, const void* gq, const void* gs, const void* gz, const void* uq,
                 const void* us, const void* uz, const void* dq, const void* ds, const void* dz,
                 const void* kmap_k, const void* kmap_f, void* mid, void* msum, void* out, int M,
                 int K, int F, int D, int bits, int group, int act_kind, int cluster1,
                 int cluster2, int x_f32, void* stream) {
  const bool big = group > G;
  const bool g_ok = group == 32 || group == 64 || group == G ||
                    (big && group % G == 0 && K % group == 0 && F % group == 0 && kmap_k && kmap_f);
  if (M < 1 || !g_ok || (!big && (kmap_k || kmap_f)) || K % (group < G ? 64 : G) ||
      F % COLS || D < 1 || (bits != 2 && bits != 4) ||
      (act_kind != kSilu && act_kind != kGeluTanh) || !aligned16(x) || cluster1 < 1 ||
      cluster1 > kMaxCluster || cluster1 > (K + G - 1) / G ||
      cluster2 < 1 || cluster2 > kMaxCluster || cluster2 > F / G)
    return cudaErrorInvalidValue;
  const MlpArgs a{x, static_cast<const uint32_t*>(gq), static_cast<const uint32_t*>(uq),
                  static_cast<const uint32_t*>(dq), static_cast<const float*>(gs),
                  static_cast<const float*>(gz), static_cast<const float*>(us),
                  static_cast<const float*>(uz), static_cast<const float*>(ds),
                  static_cast<const float*>(dz), static_cast<const int*>(kmap_k),
                  static_cast<const int*>(kmap_f), static_cast<__nv_bfloat16*>(mid),
                  static_cast<float*>(msum), out, M, K, F, D, group, x_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 2)
    return act_kind == kSilu ? launch_g<2, kSilu>(a, cluster1, cluster2, s)
                             : launch_g<2, kGeluTanh>(a, cluster1, cluster2, s);
  return act_kind == kSilu ? launch_g<4, kSilu>(a, cluster1, cluster2, s)
                           : launch_g<4, kGeluTanh>(a, cluster1, cluster2, s);
}

}  // extern "C"
