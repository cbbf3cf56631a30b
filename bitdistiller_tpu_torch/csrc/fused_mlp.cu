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
// f32 of the unrounded values), act silu or tanh-gelu, out rounded once.
//
// Bound on this card: bytes at decode widths. The three packed weights
// ((2*K*F + F*D) * bits/8) and their f32 scales and szeros (8 bytes a group
// column) stream from HBM once, at 3.35 TB/s. Design: one block per (ffn
// tile of 128 = one group of Wd's rows, up to 32 rows of x). Its 8 warps
// each compute 16 columns of gate AND the same 16 of up over all of K
// (mma.sync.m16n8k16, bf16 in, f32 out, B fragments straight from the pair
// layout as in quant_matmul.cu), so act(gate)*up is lane-local; the [rows,
// 128] mid tile stays in shared memory and never reaches HBM. The block
// then multiplies bf16(mid) by its 128 rows of Wd for all D columns and
// writes an f32 partial [rows, D]. CUDA blocks cannot carry the TPU grid's
// accumulator across ffn tiles, so a second kernel sums the partials in
// ffn-tile order, one thread an output: deterministic, no atomics. That
// costs 2 * F/128 * M * D * 4 bytes of HBM traffic beyond the bound (11 MB
// at M=8 and 7B widths) and leaves F/128 blocks a 32-row chunk (86 at 7B),
// fewer than the 132 SMs: both are later work.

#include "common.cuh"

namespace {

using namespace bd;

constexpr int G = 128;
constexpr int FT = 128;     // ffn columns a block: one group of Wd's rows
constexpr int MID_LD = FT + 4;  // padded rows: A-fragment loads hit 8 banks, not 1
constexpr int NT = 4;       // down n-tiles a warp does at once
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BITS, int TILES, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_tile_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ gq,
                    const float* __restrict__ gs, const float* __restrict__ gz,
                    const uint32_t* __restrict__ uq, const float* __restrict__ us,
                    const float* __restrict__ uz, const uint32_t* __restrict__ dq,
                    const float* __restrict__ ds, const float* __restrict__ dz,
                    float* __restrict__ partial, int M, int K, int F, int D) {
  constexpr int PACK = 32 / BITS;
  constexpr int R = G / PACK;  // words a column a group
  constexpr int WPL = R / 4;   // words a lane a group and n-tile
  constexpr int BPI = R / 8;   // k-blocks of 16 one extraction spans
  constexpr int MROWS = 16 * TILES;
  constexpr float kOff = Trick<BITS>::kOffset;
  __shared__ float mid_s[MROWS][MID_LD];
  __shared__ float msum[MROWS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  const int row = lane >> 2;
  const int tile = blockIdx.x;
  const int f0 = tile * FT;
  const int m_base = blockIdx.y * MROWS;
  const int ngk = K / G;

  // ---- gate and up: warp w owns tile columns 16w .. 16w + 15 of both ----
  float ga[TILES][2][4], ua[TILES][2][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ga[t][j][e] = ua[t][j][e] = 0.f;

  for (int g = 0; g < ngk; ++g) {
    uint32_t gw[2][WPL], uw[2][WPL];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = f0 + 16 * warp + 8 * j + row;  // this lane's B column (F % 128 == 0)
#pragma unroll
      for (int q = 0; q < WPL; ++q) {
        const size_t off = (size_t(g) * R + 4 * q + quad) * F + n;
        gw[j][q] = __ldg(gq + off);
        uw[j][q] = __ldg(uq + off);
      }
    }
    float pg[TILES][2][4], pu[TILES][2][4], xs[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[t][e] = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) pg[t][j][e] = pu[t][j][e] = 0.f;
      }
#pragma unroll
    for (int kb = 0; kb < G / 16; ++kb) {
      const int i = kb / BPI;
      const int q = 2 * (kb % BPI);
      const int k = g * G + 16 * kb + 2 * quad;
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int m0 = m_base + 16 * t + row;
        const __nv_bfloat16* x0 = x + size_t(m0) * K + k;
        const __nv_bfloat16* x1 = x0 + size_t(8) * K;
        const uint32_t a[4] = {load_pair(x0, m0 < M), load_pair(x1, m0 + 8 < M),
                               load_pair(x0 + 8, m0 < M), load_pair(x1 + 8, m0 + 8 < M)};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(pg[t][j], a, extract_bits<BITS>(gw[j][q], i),
                   extract_bits<BITS>(gw[j][q + 1], i));
          mma_bf16(pu[t][j], a, extract_bits<BITS>(uw[j][q], i),
                   extract_bits<BITS>(uw[j][q + 1], i));
        }
        mma_bf16(xs[t], a, kOnesBf16x2, kOnesBf16x2);  // sum_k x, any column
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t sc = size_t(g) * F + f0 + 16 * warp + 8 * j + 2 * quad + c;
        const float sg = __ldg(gs + sc), zg = __ldg(gz + sc) + kOff * sg;
        const float su = __ldg(us + sc), zu = __ldg(uz + sc) + kOff * su;
#pragma unroll
        for (int t = 0; t < TILES; ++t)
#pragma unroll
          for (int e = c; e < 4; e += 2) {
            ga[t][j][e] = ga[t][j][e] + pg[t][j][e] * sg - xs[t][e] * zg;
            ua[t][j][e] = ua[t][j][e] + pu[t][j][e] * su - xs[t][e] * zu;
          }
      }
  }

  // ---- mid = act(gate) * up, kept in shared memory ----
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * t + row + ((e & 2) ? 8 : 0);
        const int c = 16 * warp + 8 * j + 2 * quad + (e & 1);
        mid_s[r][c] = act<ACT>(ga[t][j][e]) * ua[t][j][e];
      }
  __syncthreads();
  if (threadIdx.x < MROWS) {
    float s = 0.f;
    for (int c = 0; c < FT; ++c) s += mid_s[threadIdx.x][c];
    msum[threadIdx.x] = s;  // sum of the f32 mid, as the TPU kernel's xsum
  }
  // A fragments of bf16(mid) for all 8 k-blocks of the tile
  uint32_t af[TILES][G / 16][4];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int kb = 0; kb < G / 16; ++kb) {
      const int r0 = 16 * t + row;
      const int c0 = 16 * kb + 2 * quad;
      af[t][kb][0] = pack_bf16x2(mid_s[r0][c0], mid_s[r0][c0 + 1]);
      af[t][kb][1] = pack_bf16x2(mid_s[r0 + 8][c0], mid_s[r0 + 8][c0 + 1]);
      af[t][kb][2] = pack_bf16x2(mid_s[r0][c0 + 8], mid_s[r0][c0 + 9]);
      af[t][kb][3] = pack_bf16x2(mid_s[r0 + 8][c0 + 8], mid_s[r0 + 8][c0 + 9]);
    }
  __syncthreads();  // msum is written
  float xm[TILES][2];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    xm[t][0] = msum[16 * t + row];
    xm[t][1] = msum[16 * t + row + 8];
  }

  // ---- down: this tile's 128 rows of Wd (group `tile`) for all D columns ----
  for (int chunk = warp; chunk * 8 * NT < D; chunk += kWarps) {
    const int n0 = chunk * 8 * NT;
    uint32_t dw[NT][WPL];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + 8 * nt + row;
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        dw[nt][q] = n < D ? __ldg(dq + (size_t(tile) * R + 4 * q + quad) * D + n) : 0u;
    }
    float pd[TILES][NT][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pd[t][nt][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < G / 16; ++kb) {
      const int i = kb / BPI;
      const int q = 2 * (kb % BPI);
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(pd[t][nt], af[t][kb], extract_bits<BITS>(dw[nt][q], i),
                   extract_bits<BITS>(dw[nt][q + 1], i));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + 8 * nt + 2 * quad + c;
        if (n >= D) continue;
        const float s = __ldg(ds + size_t(tile) * D + n);
        const float zc = __ldg(dz + size_t(tile) * D + n) + kOff * s;
#pragma unroll
        for (int t = 0; t < TILES; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m_base + 16 * t + row + 8 * h;
            if (m < M)
              partial[(size_t(tile) * M + m) * D + n] = pd[t][nt][2 * h + c] * s - xm[t][h] * zc;
          }
      }
  }
}

// out[m, n] = sum over ffn tiles, in tile order, of partial[tile, m, n]
__global__ void __launch_bounds__(kThreads)
    sum_tiles_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                     int tiles, int MD) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= MD) return;
  float s = 0.f;
  for (int f = 0; f < tiles; ++f) s += partial[size_t(f) * MD + idx];
  out[idx] = from_f32<__nv_bfloat16>(s);
}

template <int BITS, int TILES, int ACT>
cudaError_t launch(const void* const* w, const void* x, void* partial, int M, int K, int F,
                   int D, cudaStream_t stream) {
  dim3 grid(F / FT, (M + 16 * TILES - 1) / (16 * TILES));
  mlp_tile_kernel<BITS, TILES, ACT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(w[0]),
      static_cast<const float*>(w[1]), static_cast<const float*>(w[2]),
      static_cast<const uint32_t*>(w[3]), static_cast<const float*>(w[4]),
      static_cast<const float*>(w[5]), static_cast<const uint32_t*>(w[6]),
      static_cast<const float*>(w[7]), static_cast<const float*>(w[8]),
      static_cast<float*>(partial), M, K, F, D);
  return cudaGetLastError();
}

template <int BITS, int ACT>
cudaError_t launch_mt(const void* const* w, const void* x, void* partial, int M, int K, int F,
                      int D, cudaStream_t stream) {
  if (M <= 16) return launch<BITS, 1, ACT>(w, x, partial, M, K, F, D, stream);
  return launch<BITS, 2, ACT>(w, x, partial, M, K, F, D, stream);
}

}  // namespace

extern "C" {

// x [M, K] bf16; gate and up: qweight [K/pack, F] int32, scales and szeros
// [K/G, F] f32; down: qweight [F/pack, D], scales and szeros [F/G, D];
// partial [F/128, M, D] f32 scratch the caller allocates; out [M, D] bf16.
// Pair layout, G = 128, bits 2 or 4, K and F multiples of 128; act 0 = silu,
// 1 = tanh-gelu. Returns cudaGetLastError() after the launches.
int bd_fused_mlp(const void* x, const void* gq, const void* gs, const void* gz, const void* uq,
                 const void* us, const void* uz, const void* dq, const void* ds, const void* dz,
                 void* partial, void* out, int M, int K, int F, int D, int bits, int group,
                 int act_kind, void* stream) {
  if (M < 1 || group != G || K % G || F % FT || D < 1 || (bits != 2 && bits != 4) ||
      (act_kind != kSilu && act_kind != kGeluTanh))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w[9] = {gq, gs, gz, uq, us, uz, dq, ds, dz};
  cudaError_t err;
  if (bits == 2)
    err = act_kind == kSilu ? launch_mt<2, kSilu>(w, x, partial, M, K, F, D, s)
                            : launch_mt<2, kGeluTanh>(w, x, partial, M, K, F, D, s);
  else
    err = act_kind == kSilu ? launch_mt<4, kSilu>(w, x, partial, M, K, F, D, s)
                            : launch_mt<4, kGeluTanh>(w, x, partial, M, K, F, D, s);
  if (err != cudaSuccess) return err;
  const int md = M * D;
  sum_tiles_kernel<<<(md + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), F / FT, md);
  return cudaGetLastError();
}

}  // extern "C"
