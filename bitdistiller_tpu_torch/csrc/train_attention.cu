// Causal flash attention for training, forward and backward, for Hopper
// (sm_90a), plain C interface for ctypes
// (bitdistiller_tpu_torch/ops/train_attention.py).
//
// Replaces the TPU kernels that bitdistiller_tpu/models/layers.py:
// flash_train_attention (:341) reaches through JAX's stock Pallas TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py): the
// forward _flash_attention_kernel (:331, pallas_call at :758), the backward
// _flash_attention_dkv_kernel (:796, :1121) and _flash_attention_dq_kernel
// (:1146, :1456). The function, not the TPU blocks:
//
//   s[i, j] = q_i . k_j / sqrt(D)   where j <= i and seg[j] == seg[i], else
//                                   the finite mask value -0.7 * FLT_MAX
//   o_i = softmax_j(s[i, :]) v,     lse_i = log sum_j exp(s[i, j])
//
// with GQA (query head h reads kv head h / rep) and segment ids (1 real, 0
// pad; none given: one segment). The backward recomputes p = exp(s - lse)
// and takes di = rowsum(o * do) from the caller (plain PyTorch, as JAX
// computes it outside Pallas):
//   dv_j = sum_i p_ij do_i,   ds_ij = p_ij (do_i . v_j - di_i),
//   dk_j = scale * sum_i ds_ij q_i,   dq_i = scale * sum_j ds_ij k_j.
// q, o, do [B, S, Hq, D]; k, v, dk, dv [B, S, Hkv, D]; lse [B, Hq, S] f32;
// di [B, S, Hq] f32. Any S, any D that is a multiple of 16 (the wrapper pads
// any other D with zero columns and passes the real D's scale): rows past S
// and columns past D are zero-filled in shared memory and never written, so
// the kernels make no padded copy.
//
// Bound on this card: operations. The causal forward is 2 * B * Hq * S^2 * D
// multiply-adds' worth of flops (two products over half the score matrix),
// the backward about 2.5x that, against 989 TFLOP/s of bf16 tensor cores;
// the bytes (q, k, v, o once) are a few MB.
//
// Design, bf16 (every kernel at every D): warp-specialised CTAs whose
// consumer warpgroups (128 threads) compute and whose one producer warp
// keeps a ring of shared-memory stages full by TMA (4-D tensor maps over
// [B, S, H, D], so a box reads rows past S and columns past D as zeros,
// never a neighbour's), with full and empty mbarriers. Every product is a
// warpgroup MMA (wgmma): the score products read both operands from the
// 128-byte-swizzled K-major tiles TMA wrote; the products of a probability
// (or ds) tile read it from registers, rounded to bf16 in the accumulator's
// own layout, or from a swizzled shared slot, against the MN-major
// (transposed) tile of V, dO, Q or K. No kernel has an mma.sync.
// Registers bound the layout: with 9 or more warps a CTA, or two CTAs of 5
// an SM, ptxas gives each thread at most 168 (setmaxnreg over a producer
// warpgroup did not change what it allocated), so no warpgroup holds more
// than one 64 x 128 f32 accumulator beside its score tiles.
//   * forward: a CTA is one consumer warpgroup owning 64 query rows of one
//     (batch, query head) and the producer warp, 3, 2 or 1 CTAs an SM at
//     D = 64, 128, 256; it walks the key tiles of 64 rows on or below the
//     diagonal through 4 stages (2 above D = 64) with an online softmax in
//     f32 (exp2 of log2-scaled scores), masking only where a tile crosses
//     the diagonal or S or holds another segment than the row (a padded
//     row's tiles); query tiles are launched longest first.
//   * dq: the forward's CTA (one consumer warpgroup of 64 query rows, one
//     producer warp, longest tiles first, 2, 2 or 1 CTAs an SM at D = 64,
//     128, 256 through 4, 2 and 2 stages), Q and dO resident; per key tile
//     s = Q K^T and dp = dO V^T issued together, p and ds = p (dp - di) in
//     registers (the same masking rule), then dq += ds K with K, already in
//     the stage, as the MN-major operand. Its products run over every
//     64-column box of a tile (all loaded; past D they are zeros) with no
//     test of D between the wgmmas: with one, ptxas waited after every
//     wgmma (scripts/kernel_sass.py counts the waits). The CTA owns its
//     rows' dq: no atomics, deterministic.
//   * dkv: a thread block cluster of C = min(rep, 8) CTAs owns 64 key rows
//     of one (batch, kv head); CTA c walks query heads c, c + C, ... of the
//     kv head (ops/train_attention.py: dkv_plan, dkv_walk) and for each the
//     64-row query tiles on or below the diagonal, streaming Q, dO, lse and
//     di through a ring. Up to D = 128 (3 stages) its two consumer
//     warpgroups split the four products over the same keys (p and dv; dp,
//     ds and dk), p handed over in shared memory. Above (the wide kernel,
//     2 stages of 64 KB) a warpgroup owns half of D's columns and the CTA
//     walks twice, dv then dk: each warpgroup scores 32 of a stage's 64
//     queries and hands its p (ds) to the other through a swizzled bf16
//     slot that both read as the A operand. The C partial dk and dv tiles
//     are summed in rank order through distributed shared memory: no
//     atomics, deterministic.
// f32 (JAX's compute dtype float32, `--dtype float32`): the forward, dkv
// and dq at D <= 128 are 3xTF32 wgmma kernels fed by a TMA ring (see their
// section: every A from registers, the products over rows taken
// transposed), bound by operations at 495 / 3 = 165 TFLOP/s. Above, up to
// D = 1024, the same three kernels run on clusters that split D's columns
// into ns = ceil(D / 128) CTAs (2 to 8), each taking the score products
// over its 128 columns, leaving its partial scores in its own shared memory
// and pulling the ns partials in rank order (split_sum, one protocol for
// the three). bf16 at 256 < D <= 1024 runs the f32 splits on f32 copies
// that the wrapper makes (a bf16 value is exact in tf32), the outputs
// rounded to bf16 once.
// Above D = 1024 (ns would pass the portable cluster of 8) the three run on
// CUDA cores (one warp a row, the CTAs splitting D's output columns into
// slices of WIDE_COLS, each slice recomputing the scores, so no register
// array grows with D), both dtypes.

#include <float.h>
#include <limits.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "stream.cuh"

namespace {

using namespace bd;

constexpr float kMaskValue = -0.7f * FLT_MAX;  // flash_attention.py: DEFAULT_MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- bf16 forward, dq and dkv: wgmma fed by a TMA ring ------------------------

constexpr int kWg = 128;        // threads a warpgroup
constexpr int kBoxRow = 128;    // bytes of a box row: 64 bf16 columns
constexpr int TQ = 64;          // query rows of a forward or dq CTA, of a dkv ring stage
constexpr int TK = 64;          // key rows of a forward ring stage, of a dkv CTA
constexpr int kFullCount = 33;  // the producer warp's lanes + lane 0's expect_tx
constexpr int kMixed = -4;      // a tile's segment id when its rows hold more than one

// 2^x by the MUFU unit alone (exp2f adds range handling around it: a fifth
// of the forward's time at D = 64); subnormal results flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// bf16 A fragment k-block kb (columns 16kb ..) of a 64 x 64 accumulator
__device__ __forceinline__ void acc_a_frag(uint32_t (&a)[4], const float (&x)[32], int kb) {
  a[0] = pack_bf16(x[8 * kb], x[8 * kb + 1]);
  a[1] = pack_bf16(x[8 * kb + 2], x[8 * kb + 3]);
  a[2] = pack_bf16(x[8 * kb + 4], x[8 * kb + 5]);
  a[3] = pack_bf16(x[8 * kb + 6], x[8 * kb + 7]);
}

// x (64 x 64) = the rows of tile A (at a, 64-row boxes) times those of tile
// B (at bt), over k < D: both K-major and swizzled, as TMA wrote them
template <int DT>
__device__ __forceinline__ void rows_by_rows(float (&x)[32], uint32_t a, uint32_t bt, int D) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    if (16 * kk >= D) break;
    const uint32_t off = (kk >> 2) * 64 * kBoxRow + (kk & 3) * 32;
    if (kk == 0)
      wgmma_ss_bf16<false>(x, sw128_desc(a + off), sw128_desc(bt + off));
    else
      wgmma_ss_bf16<true>(x, sw128_desc(a + off), sw128_desc(bt + off));
  }
}

// acc (64 x DT) += p (64 x 64, bf16 A fragments) times tile T (at t: 64
// rows, its columns the N dimension: the MN-major operand)
template <int DT>
__device__ __forceinline__ void frags_by_tile(float (&acc)[DT / 64][32], const uint32_t (&p)[4][4],
                                              uint32_t t, int D) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) {
      if (64 * c >= D) break;
      wgmma_bf16_tb(acc[c], p[kb], mn_desc(t + c * 64 * kBoxRow + kb * 16 * kBoxRow, 64 * kBoxRow));
    }
}

template <int DT>
struct Fwd {
  static constexpr int ST = DT <= 64 ? 4 : 2;  // ring stages
  static constexpr int THREADS = kWg + 32;     // one consumer warpgroup, one producer warp
  // CTAs an SM (registers a thread: 128, 168, 255), as shared memory allows
  static constexpr int MIN_BLOCKS = DT <= 64 ? 3 : DT <= 128 ? 2 : 1;
  static constexpr int TILE = DT / 64 * 64 * kBoxRow;  // a 64-row tile of Q, K or V
  static constexpr int SEG = (1 + 2 * ST) * TILE;     // Q, then stage st's K and V
  // keys' segment ids [ST][TK], the tile's one [ST]; then the mbarriers, 8-byte aligned
  static constexpr int BAR = (SEG + ST * (TK + 1) * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR + (2 * ST + 1) * 8 + 1024;  // full, empty, q; alignment
};

// One CTA a (query head, batch, query tile of 64 rows, the longest first):
// a consumer warpgroup and a producer warp.
template <int DT>
__global__ void __launch_bounds__(Fwd<DT>::THREADS, Fwd<DT>::MIN_BLOCKS)
    train_attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int Hq,
                          int Hkv, int D, float scale) {
  using F = Fwd<DT>;
  constexpr int ST = F::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  int* segs = reinterpret_cast<int*>(smem + F::SEG);
  int* tsegs = segs + ST * TK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::BAR);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = h / (Hq / Hkv), nb = (D + 63) / 64;
  const int nkt = min(q0, S - 1) / TK + 1;  // key tiles on or below the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(qbar, nb * TQ * kBoxRow);
      for (int c = 0; c < nb; ++c) tma_load_4d(smem + c * TQ * kBoxRow, &q_map, 64 * c, h, q0, b, qbar);
    }
    for (int t = 0; t < nkt; ++t) {
      const int st = t % ST, k0 = t * TK;
      if (t >= ST) mbar_wait(empty + st, (t / ST - 1) & 1);
      uint8_t* kt = smem + (1 + 2 * st) * F::TILE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * nb * TK * kBoxRow);
        for (int c = 0; c < nb; ++c) {
          tma_load_4d(kt + c * TK * kBoxRow, &k_map, 64 * c, hk, k0, b, full + st);
          tma_load_4d(kt + F::TILE + c * TK * kBoxRow, &v_map, 64 * c, hk, k0, b, full + st);
        }
      }
      int lo = INT_MAX, hi = INT_MIN;
      for (int i = lane; i < TK; i += 32) {
        const int key = k0 + i;
        const int v = key < S ? (seg ? seg[size_t(b) * S + key] : 1) : -1;
        segs[st * TK + i] = v;
        lo = min(lo, v);
        hi = max(hi, v);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) tsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const float qs = scale * kLog2e;
  int rows[2], segq[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    rows[half] = q0 + 16 * warp + (lane >> 2) + 8 * half;
    segq[half] = rows[half] < S ? (seg ? seg[size_t(b) * S + rows[half]] : 1) : -2;
  }
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float o[DT / 64][32];
#pragma unroll
  for (int c = 0; c < DT / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  const uint32_t qa = smem_u32(smem);
  mbar_wait(qbar, 0);

  for (int t = 0; t < nkt; ++t) {
    const int st = t % ST, k0 = t * TK;
    mbar_wait(full + st, (t / ST) & 1);
    const uint32_t ka = smem_u32(smem + (1 + 2 * st) * F::TILE), va = ka + F::TILE;
    float s[32];
    wgmma_fence();
    rows_by_rows<DT>(s, qa, ka, D);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int* sk = segs + st * TK;
    // this thread's rows need the per-element test unless the tile is at or
    // below the diagonal, inside S, and of their one segment
    const int ts = tsegs[st];
    const bool mask = k0 + TK - 1 > q0 || k0 + TK > S || ts != segq[0] || ts != segq[1];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad + (i & 1);
      float x = s[i] * qs;
      if (mask && !(k0 + kc <= rows[half] && sk[kc] == segq[half])) x = kMaskValue;
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = ex2(m[half] - mx[half]);
      m[half] = mx[half];
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const float p = s[i] == kMaskValue ? 0.f : ex2(s[i] - m[half]);
      s[i] = p;
      l[half] += p;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) acc_a_frag(pa[kb], s, kb);
#pragma unroll
    for (int c = 0; c < DT / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) fence_regs(o[c]);
    frags_by_tile<DT>(o, pa, va, D);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) fence_regs(pa[kb]);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    inv[half] = 1.f / l[half];
    if (quad == 0 && rows[half] < S)
      lse[(size_t(b) * Hq + h) * S + rows[half]] = (m[half] + log2f(l[half])) * kLn2;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= S) continue;
    __nv_bfloat16* po = out + ((size_t(b) * S + rows[half]) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DT / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * quad;
        if (col < D)
          *reinterpret_cast<uint32_t*>(po + col) = pack_bf16(o[c][4 * j + 2 * half] * inv[half],
                                                             o[c][4 * j + 2 * half + 1] * inv[half]);
      }
  }
}

// x (64 x 64) = the rows of tile A (descriptor da) times those of tile B
// (db) over all DT columns, both K-major and swizzled as TMA wrote them: the
// dq kernel's score products. No test of D between the wgmmas (with one,
// ptxas waited after each): the kernel loads every box of a tile, so
// columns past D are zeros and add nothing.
template <int DT, int KK = 0>
__device__ __forceinline__ void tiles_by_tiles(float (&x)[32], uint64_t da, uint64_t db) {
  if constexpr (KK < DT / 16) {
    wgmma_ss_bf16_at<KK != 0, ((KK >> 2) * 64 * kBoxRow + (KK & 3) * 32) / 16>(x, da, db);
    tiles_by_tiles<DT, KK + 1>(x, da, db);
  }
}

template <int DT>
struct DqWs {
  static constexpr int ST = DT <= 64 ? 4 : 2;  // ring stages
  static constexpr int THREADS = kWg + 32;     // one consumer warpgroup, one producer warp
  // CTAs an SM, as shared memory allows; registers a thread: 168 at two (ten
  // warps an SM), 255 at one
  static constexpr int MIN_BLOCKS = DT <= 128 ? 2 : 1;
  static constexpr int TILE = DT / 64 * 64 * kBoxRow;  // a 64-row tile of Q, dO, K or V
  static constexpr int SEG = (2 + 2 * ST) * TILE;     // Q, dO, then stage st's K and V
  // keys' segment ids [ST][TK], the tile's one [ST]; then the mbarriers, 8-byte aligned
  static constexpr int BAR = (SEG + ST * (TK + 1) * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR + (2 * ST + 1) * 8 + 1024;  // full, empty, q; alignment
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory of an SM");
};

// dq: one CTA a (query head, batch, query tile of 64 rows, the longest
// first), as the forward: a consumer warpgroup that owns the tile's rows and
// their 64 x D f32 accumulator, and a producer warp that loads Q and dO once
// and streams the key tiles on or below the diagonal (K, V and the keys'
// segment ids) through the ring. For each key tile: s = Q K^T and
// dp = dO V^T issued together (shared x shared, K-major), then in registers
// p = 2^(s scale log2e - lse log2e) (0 where masked) and ds = p (dp - di),
// then dq += ds K with ds rounded to bf16 A fragments against K as the
// MN-major operand (the forward's p V with K for V). Each CTA writes only
// its own rows: no atomics, the same bits on every run.
template <int DT>
__global__ void __launch_bounds__(DqWs<DT>::THREADS, DqWs<DT>::MIN_BLOCKS)
    train_attn_dq_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map, const int* __restrict__ seg,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            __nv_bfloat16* __restrict__ dq, int S, int Hq, int Hkv, int D,
                            float scale) {
  using P = DqWs<DT>;
  constexpr int ST = P::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  int* segs = reinterpret_cast<int*>(smem + P::SEG);
  int* tsegs = segs + ST * TK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  constexpr int NB = DT / 64;  // boxes a tile, all loaded: those past D are zeros
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = h / (Hq / Hkv);
  const int nkt = q0 / TK + 1;  // key tiles on or below the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(qbar, 2 * NB * TQ * kBoxRow);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem + c * TQ * kBoxRow, &q_map, 64 * c, h, q0, b, qbar);
        tma_load_4d(smem + P::TILE + c * TQ * kBoxRow, &do_map, 64 * c, h, q0, b, qbar);
      }
    }
    for (int t = 0; t < nkt; ++t) {
      const int st = t % ST, k0 = t * TK;
      if (t >= ST) mbar_wait(empty + st, (t / ST - 1) & 1);
      uint8_t* kt = smem + (2 + 2 * st) * P::TILE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * NB * TK * kBoxRow);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(kt + c * TK * kBoxRow, &k_map, 64 * c, hk, k0, b, full + st);
          tma_load_4d(kt + P::TILE + c * TK * kBoxRow, &v_map, 64 * c, hk, k0, b, full + st);
        }
      }
      int lo = INT_MAX, hi = INT_MIN;
      for (int i = lane; i < TK; i += 32) {
        const int key = k0 + i;
        const int v = key < S ? (seg ? seg[size_t(b) * S + key] : 1) : -1;
        segs[st * TK + i] = v;
        lo = min(lo, v);
        hi = max(hi, v);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) tsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const float qs = scale * kLog2e;
  int rows[2], segq[2];
  float lse2[2], dii[2];  // rows past S: 0, never stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * half;
    const bool in = row < S;
    rows[half] = row;
    segq[half] = in ? (seg ? seg[size_t(b) * S + row] : 1) : -2;
    lse2[half] = in ? lse[(size_t(b) * Hq + h) * S + row] * kLog2e : 0.f;
    dii[half] = in ? di[(size_t(b) * S + row) * Hq + h] : 0.f;
  }
  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint64_t qd = sw128_desc(smem_u32(smem)), od = sw128_desc(smem_u32(smem + P::TILE));
  mbar_wait(qbar, 0);

  for (int t = 0; t < nkt; ++t) {
    const int st = t % ST, k0 = t * TK;
    mbar_wait(full + st, (t / ST) & 1);
    const uint32_t ka = smem_u32(smem + (2 + 2 * st) * P::TILE);
    float s[32], dp[32];
    wgmma_fence();
    tiles_by_tiles<DT>(s, qd, sw128_desc(ka));
    tiles_by_tiles<DT>(dp, od, sw128_desc(ka + P::TILE));  // dp = do v^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int* sk = segs + st * TK;
    // the per-element test only where the tile crosses the diagonal or S or
    // holds another segment than this thread's rows, as in the forward
    const int ts = tsegs[st];
    const bool mask = k0 + TK - 1 > q0 || k0 + TK > S || ts != segq[0] || ts != segq[1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad + (i & 1);
      float p = ex2(s[i] * qs - lse2[half]);
      if (mask && !(k0 + kc <= rows[half] && sk[kc] == segq[half])) p = 0.f;
      s[i] = p * (dp[i] - dii[half]);  // ds
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) acc_a_frag(da[kb], s, kb);

    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)  // dq += ds k, every box (no test of D, as above)
#pragma unroll
      for (int c = 0; c < NB; ++c)
        wgmma_bf16_tb(acc[c], da[kb], mn_desc(ka + (c * 64 + kb * 16) * kBoxRow, 64 * kBoxRow));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) fence_regs(da[kb]);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= S) continue;
    __nv_bfloat16* pq = dq + ((size_t(b) * S + rows[half]) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * quad;
        if (col < D)
          *reinterpret_cast<uint32_t*>(pq + col) = pack_bf16(acc[c][4 * j + 2 * half] * scale,
                                                             acc[c][4 * j + 2 * half + 1] * scale);
      }
  }
}

template <int DT>
struct DkvWs {
  static constexpr int ST = 3;  // ring stages
  static constexpr int TILE = DT / 64 * 64 * kBoxRow;  // a 64-row tile of K, V, Q or dO
  // K at 0, V at TILE, stage st's Q at (2 + 2st) TILE and dO after it
  static constexpr int XCH = (2 + 2 * ST) * TILE;  // p, warpgroup 0 -> 1: [2][32][kWg] f32
  static constexpr int SCAL = XCH + 2 * 32 * kWg * 4;  // [ST][3][TQ]: lse2, di, seg
  // then the query tile's one segment id [ST]; then full, empty, kv, 8-byte aligned
  static constexpr int BAR = (SCAL + ST * (3 * TQ + 1) * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR + (2 * ST + 1) * 8 + 1024;
  static constexpr int PAIRS = DT / 4 * kWg;  // f32 pairs of one 64 x DT partial tile
  static_assert(2 * PAIRS * 8 <= XCH, "the partial tiles overlay the tiles");
};

// The cluster's C partial dv and dk tiles (float2 pairs in register order:
// pair pr of thread t of warpgroup w at w * PAIRS + pr * 128 + t), summed in
// rank order: CTA `rank` sums its 1/C of the pairs over ranks 0 .. C-1 and
// writes them (dk times scale).
template <int DT>
__device__ __forceinline__ void cluster_sum_store(const float2* red, __nv_bfloat16* dv,
                                                  __nv_bfloat16* dk, int b, int k0, int S,
                                                  int Hkv, int hk, int D, float scale, int C,
                                                  int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int NP = DkvWs<DT>::PAIRS;
  const int per = (2 * NP + C - 1) / C, lo = rank * per, hi = min(2 * NP, lo + per);
  for (int p = lo + int(threadIdx.x); p < hi; p += 2 * kWg) {
    float2 acc = make_float2(0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float2 v = cluster.map_shared_rank(red, r)[p];
      acc.x += v.x;
      acc.y += v.y;
    }
    const int w = p / NP, rem = p - w * NP, pr = rem / kWg, t = rem % kWg;
    const int c = pr >> 4, j = (pr & 15) >> 1, half = pr & 1, ln = t & 31;
    const int key = k0 + 16 * (t >> 5) + (ln >> 2) + 8 * half;
    const int col = 64 * c + 8 * j + 2 * (ln & 3);
    const float mul = w ? scale : 1.f;
    if (key < S && col < D)
      *reinterpret_cast<uint32_t*>((w ? dk : dv) + ((size_t(b) * S + key) * Hkv + hk) * D + col) =
          pack_bf16(acc.x * mul, acc.y * mul);
  }
}

// dkv, D <= 128: a cluster of C CTAs a (key tile of 64 rows, kv head,
// batch), the grid (C, key tiles x Hkv, B) with the key tile slowest (the
// longest walks first). CTA `rank` walks query heads hk * rep + rank, + C,
// ... and for each the query tiles from the diagonal to the end
// (ops/train_attention.py: dkv_walk). Both consumer warpgroups own the
// CTA's 64 keys and split the four products: warpgroup 0 takes s^T = k q^T,
// p and dv += p^T do; warpgroup 1 takes dp^T = v do^T, ds = p (dp - di)
// (p handed over in shared memory, f32, double buffered between named
// barriers) and dk += ds^T q. Each holds one 64 x D accumulator.
template <int DT>
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    train_attn_dkv_ws_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map, const int* __restrict__ seg,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                             int Hq, int Hkv, int D, float scale) {
  using P = DkvWs<DT>;
  constexpr int ST = P::ST;
  constexpr int kPFull = 2, kPEmpty = 4;  // named barriers of the p hand-over, a slot each
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* xch = reinterpret_cast<float*>(smem + P::XCH);
  float* scal = reinterpret_cast<float*>(smem + P::SCAL);
  int* qsegs = reinterpret_cast<int*>(scal + ST * 3 * TQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;
  const int C = gridDim.x, rank = blockIdx.x;
  const int kt = blockIdx.y / Hkv, hk = blockIdx.y - kt * Hkv, b = blockIdx.z, k0 = kt * TK;
  const int rep = Hq / Hkv, nb = (D + 63) / 64;
  const int qt0 = k0 / TQ, nqs = (S + TQ - 1) / TQ - qt0;  // query tiles a head
  const int steps = (rep - rank + C - 1) / C * nqs;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 8);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 2 * kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(kvbar, 2 * nb * TK * kBoxRow);
      for (int c = 0; c < nb; ++c) {
        tma_load_4d(smem + c * TK * kBoxRow, &k_map, 64 * c, hk, k0, b, kvbar);
        tma_load_4d(smem + P::TILE + c * TK * kBoxRow, &v_map, 64 * c, hk, k0, b, kvbar);
      }
    }
    for (int i = 0; i < steps; ++i) {
      const int st = i % ST;
      const int h = hk * rep + rank + C * (i / nqs), q0 = (qt0 + i % nqs) * TQ;
      if (i >= ST) mbar_wait(empty + st, (i / ST - 1) & 1);
      uint8_t* qt = smem + (2 + 2 * st) * P::TILE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * nb * TQ * kBoxRow);
        for (int c = 0; c < nb; ++c) {
          tma_load_4d(qt + c * TQ * kBoxRow, &q_map, 64 * c, h, q0, b, full + st);
          tma_load_4d(qt + P::TILE + c * TQ * kBoxRow, &do_map, 64 * c, h, q0, b, full + st);
        }
      }
      float* sc = scal + st * 3 * TQ;
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < TQ; j += 32) {
        const int row = q0 + j;
        const bool in = row < S;
        sc[j] = in ? lse[(size_t(b) * Hq + h) * S + row] * kLog2e : 0.f;
        sc[TQ + j] = in ? di[(size_t(b) * S + row) * Hq + h] : 0.f;
        const int v = in ? (seg ? seg[size_t(b) * S + row] : 1) : -3;
        reinterpret_cast<int*>(sc)[2 * TQ + j] = v;
        lo = min(lo, v);
        hi = max(hi, v);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) qsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    if (C > 1)  // the consumers' two cluster barriers
      for (int i = 0; i < 2; ++i) cluster_barrier();
    return;
  }

  const int wg = tid >> 7, t128 = tid & (kWg - 1), warp = t128 >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const float qs = scale * kLog2e;
  int keys[2], segk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    keys[half] = k0 + 16 * warp + (lane >> 2) + 8 * half;
    segk[half] = keys[half] < S ? (seg ? seg[size_t(b) * S + keys[half]] : 1) : -1;
  }
  float acc[DT / 64][32];  // warpgroup 0: dv; 1: dk
#pragma unroll
  for (int c = 0; c < DT / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const uint32_t ka = smem_u32(smem), va = ka + P::TILE;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < steps; ++i) {
    const int st = i % ST, q0 = (qt0 + i % nqs) * TQ, slot = i & 1;
    float* xs = xch + slot * 32 * kWg + t128;
    mbar_wait(full + st, (i / ST) & 1);
    const uint32_t qa = smem_u32(smem + (2 + 2 * st) * P::TILE), oa = qa + P::TILE;
    const float* sc = scal + st * 3 * TQ;
    float x[32];
    uint32_t fa[4][4];
    wgmma_fence();
    if (wg == 0) {
      rows_by_rows<DT>(x, ka, qa, D);  // s^T: keys x queries
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      const int* sq = reinterpret_cast<const int*>(sc) + 2 * TQ;
      const int ts = qsegs[st];  // as in the forward, keys and query rows swapped
      const bool mask = q0 < k0 + TK - 1 || q0 + TQ > S || ts != segk[0] || ts != segk[1];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int half = (r >> 1) & 1, c = 8 * (r >> 2) + 2 * quad + (r & 1);
        float p = ex2(x[r] * qs - sc[c]);
        if (mask && !(keys[half] <= q0 + c && sq[c] == segk[half])) p = 0.f;
        x[r] = p;
      }
      if (i >= 2) named_sync(kPEmpty + slot, 2 * kWg);  // warpgroup 1 has read step i - 2's p
#pragma unroll
      for (int r = 0; r < 32; ++r) xs[r * kWg] = x[r];
      named_arrive(kPFull + slot, 2 * kWg);
    } else {
      rows_by_rows<DT>(x, va, oa, D);  // dp^T = v do^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      named_sync(kPFull + slot, 2 * kWg);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int c = 8 * (r >> 2) + 2 * quad + (r & 1);
        x[r] = xs[r * kWg] * (x[r] - sc[TQ + c]);  // ds
      }
      if (i + 2 < steps) named_arrive(kPEmpty + slot, 2 * kWg);
    }
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) acc_a_frag(fa[kb], x, kb);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) fence_regs(acc[c]);
    frags_by_tile<DT>(acc, fa, wg == 0 ? oa : qa, D);  // dv += p^T do, dk += ds^T q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) fence_regs(fa[kb]);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  if (C == 1) {  // no peer: straight from the registers
    __nv_bfloat16* dst = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (keys[half] >= S) continue;
      __nv_bfloat16* row = dst + ((size_t(b) * S + keys[half]) * Hkv + hk) * D;
#pragma unroll
      for (int c = 0; c < DT / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * quad;
          if (col < D)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(acc[c][4 * j + 2 * half] * mul, acc[c][4 * j + 2 * half + 1] * mul);
        }
    }
    return;
  }
  // the partial tiles overlay K, V and the ring, which both warpgroups are done with
  float2* red = reinterpret_cast<float2*>(smem);
  named_sync(1, 2 * kWg);
#pragma unroll
  for (int c = 0; c < DT / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        red[wg * P::PAIRS + (c * 16 + 2 * j + half) * kWg + t128] =
            make_float2(acc[c][4 * j + 2 * half], acc[c][4 * j + 2 * half + 1]);
  cluster_barrier();
  cluster_sum_store<DT>(red, dv, dk, b, k0, S, Hkv, hk, D, scale, C, rank);
  cluster_barrier();  // no CTA leaves while a peer still reads its shared memory
}

// ---- bf16 dkv above D = 128: two walks, D's columns split ---------------------

struct DkvWide {
  static constexpr int DT = 256;
  static constexpr int NB = DT / 64;         // boxes a tile, all loaded: those past D are zeros
  static constexpr int ST = 2;               // ring stages
  static constexpr int TILE = NB * 64 * kBoxRow;  // a 64-row tile of K, V, Q or dO: 32 KB
  // K at 0, V at TILE, stage st's Q at (2 + 2st) TILE and dO after it
  static constexpr int SLOT = TK * kBoxRow;  // p or ds, keys x queries, bf16, swizzled: 8 KB
  static constexpr int XCH = (2 + 2 * ST) * TILE;  // two slots
  static constexpr int SCAL = XCH + 2 * SLOT;      // [ST][3][TQ]: lse2, di, seg
  // then the query tile's one segment id [ST]; then full, empty, kv, 8-byte aligned
  static constexpr int BAR = (SCAL + ST * (3 * TQ + 1) * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR + (2 * ST + 1) * 8 + 1024;
  static constexpr int HALF = DT / 8 * kWg;  // f32 pairs of a warpgroup's 64 x DT/2 partial tile
  static_assert(2 * HALF * 8 <= ST * 2 * TILE, "a walk's partial tiles overlay the ring");
  static_assert(SMEM + 1024 <= 233472, "shared memory of an SM");
};

// x (64 keys x 32 queries) = the rows of tile A (descriptor da: K or V, 64
// rows) times 32 rows of tile B (db: Q or dO), over all DT columns, both
// K-major and swizzled; no test of D between the wgmmas (columns past D are
// zeros).
template <int KK = 0>
__device__ __forceinline__ void keys_by_queries(float (&x)[16], uint64_t da, uint64_t db) {
  if constexpr (KK < DkvWide::DT / 16) {
    wgmma_ss_n32_at<KK != 0, ((KK >> 2) * 64 * kBoxRow + (KK & 3) * 32) / 16>(x, da, db);
    keys_by_queries<KK + 1>(x, da, db);
  }
}

// acc (64 keys x 128 columns, two 64-column halves) += the slot (64 keys x 64
// queries, descriptor xd: the A operand, K-major) times 128 columns of a Q
// or dO tile (bd: its first box, the MN-major operand)
template <int KB = 0>
__device__ __forceinline__ void slot_by_tile(float (&acc)[2][32], uint64_t xd, uint64_t bd) {
  if constexpr (KB < TQ / 16) {
    wgmma_ss_tb_at<KB * 32 / 16, KB * 16 * kBoxRow / 16>(acc[0], xd, bd);
    wgmma_ss_tb_at<KB * 32 / 16, (64 * kBoxRow + KB * 16 * kBoxRow) / 16>(acc[1], xd, bd);
    slot_by_tile<KB + 1>(acc, xd, bd);
  }
}

// One walk of the wide dkv kernel's consumers over its `steps` ring stages
// (i0 the ring index of the first): per stage, this warpgroup's 32 query
// columns of s^T = k q^T (and, for dk, of dp^T = v do^T), then p (ds =
// p (dp - di)) rounded to bf16 into the stage's slot; after a named barrier
// over both warpgroups the slot holds all 64 queries, and each warpgroup
// adds its 128 columns of p^T do (ds^T q) to acc.
template <bool DK>
__device__ __forceinline__ void dkv_wide_walk(float (&acc)[2][32], uint8_t* smem,
                                              const float* scal, const int* qsegs,
                                              uint64_t* full, uint64_t* empty, int i0,
                                              int steps, int nqs, int qt0, int k0, int S,
                                              const int (&keys)[2], const int (&segk)[2],
                                              float qs) {
  using P = DkvWide;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & (kWg - 1)) >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const uint64_t kd = sw128_desc(smem_u32(smem)), vd = sw128_desc(smem_u32(smem + P::TILE));
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[c][r] = 0.f;
  for (int j = 0; j < steps; ++j) {
    const int i = i0 + j, st = i % P::ST, q0 = (qt0 + j % nqs) * TQ;
    mbar_wait(full + st, (i / P::ST) & 1);
    const uint32_t qa = smem_u32(smem + (2 + 2 * st) * P::TILE), oa = qa + P::TILE;
    const float* sc = scal + st * 3 * TQ;
    float x[16], y[16];
    wgmma_fence();
    keys_by_queries(x, kd, sw128_desc(qa + 32 * wg * kBoxRow));    // s^T
    if constexpr (DK) keys_by_queries(y, vd, sw128_desc(oa + 32 * wg * kBoxRow));  // dp^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (DK) fence_regs(y);
    const int* sq = reinterpret_cast<const int*>(sc) + 2 * TQ;
    const int ts = qsegs[st];  // as in the forward, keys and query rows swapped
    const bool mask = q0 < k0 + TK - 1 || q0 + TQ > S || ts != segk[0] || ts != segk[1];
    uint8_t* slot = smem + P::XCH + (i & 1) * P::SLOT;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * jj + 2 * half + e, c = 32 * wg + 8 * jj + 2 * quad + e;
          float p = ex2(x[r] * qs - sc[c]);
          if (mask && !(keys[half] <= q0 + c && sq[c] == segk[half])) p = 0.f;
          if constexpr (DK) p *= y[r] - sc[TQ + c];
          v[e] = p;
        }
        // (key row, query column c) at row * 128 + ((2c / 16) ^ (row % 8)) * 16 + 2c % 16
        const int row = 16 * warp + (lane >> 2) + 8 * half;
        *reinterpret_cast<uint32_t*>(slot + row * kBoxRow + (((4 * wg + jj) ^ (row & 7)) << 4) +
                                     4 * quad) = pack_bf16(v[0], v[1]);
      }
    fence_proxy_async();
    // both halves in the slot; the slot of stage i - 2 read by both (each
    // warpgroup waited for its products of i - 2 before this barrier of i - 1)
    named_sync(1, 2 * kWg);
    wgmma_fence();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    slot_by_tile(acc, sw128_desc(smem_u32(slot)),
                 mn_desc((DK ? qa : oa) + 2 * wg * 64 * kBoxRow, 64 * kBoxRow));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }
}

// A walk's dv (dk) tile: warpgroup wg holds columns 128 wg + 64 c + 8 j +
// 2 quad (+1) of keys k0 + 16 warp + lane / 4 (+8). With no peer (C = 1)
// it goes straight from the registers; else the C partial tiles (float2
// pairs in register order, overlaying the ring: pair pr of thread t of
// warpgroup w at w * HALF + pr * 128 + t) are summed in rank order through
// distributed shared memory, CTA `rank` summing and writing 1/C of them.
__device__ __forceinline__ void dkv_wide_store(const float (&acc)[2][32], uint8_t* smem,
                                               __nv_bfloat16* dst, float mul, int b, int k0,
                                               int S, int Hkv, int hk, int D, int C, int rank) {
  using P = DkvWide;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & (kWg - 1), lane = tid & 31;
  if (C == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + 16 * (t128 >> 5) + (lane >> 2) + 8 * half;
      if (key >= S) continue;
      __nv_bfloat16* row = dst + ((size_t(b) * S + key) * Hkv + hk) * D;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 128 * wg + 64 * c + 8 * j + 2 * (lane & 3);
          if (col < D)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf16(acc[c][4 * j + 2 * half] * mul, acc[c][4 * j + 2 * half + 1] * mul);
        }
    }
    return;
  }
  float2* red = reinterpret_cast<float2*>(smem + 2 * P::TILE);
  named_sync(1, 2 * kWg);  // both warpgroups are done with the ring
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        red[wg * P::HALF + (c * 16 + 2 * j + half) * kWg + t128] =
            make_float2(acc[c][4 * j + 2 * half], acc[c][4 * j + 2 * half + 1]);
  cluster_barrier();
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (2 * P::HALF + C - 1) / C, lo = rank * per, hi = min(2 * P::HALF, lo + per);
  for (int p = lo + tid; p < hi; p += 2 * kWg) {
    float2 s = make_float2(0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float2 v = cluster.map_shared_rank(red, r)[p];
      s.x += v.x;
      s.y += v.y;
    }
    const int w = p / P::HALF, rem = p - w * P::HALF, pr = rem / kWg, t = rem % kWg;
    const int c = pr >> 4, j = (pr & 15) >> 1, half = pr & 1, ln = t & 31;
    const int key = k0 + 16 * (t >> 5) + (ln >> 2) + 8 * half;
    const int col = 128 * w + 64 * c + 8 * j + 2 * (ln & 3);
    if (key < S && col < D)
      *reinterpret_cast<uint32_t*>(dst + ((size_t(b) * S + key) * Hkv + hk) * D + col) =
          pack_bf16(s.x * mul, s.y * mul);
  }
  cluster_barrier();  // no CTA reuses or leaves its tile while a peer still reads it
}

// dkv, 128 < D <= 256 (the DT = 256 tiles; columns past D arrive as zeros):
// the grid and clusters of train_attn_dkv_ws_kernel (dkv_plan), the same
// walk over query heads and tiles (dkv_walk), K and V resident, Q, dO, lse,
// di and the query rows' segment ids streamed through a ring of 2 stages by
// the producer warp. A 64 x D f32 accumulator a warpgroup does not fit
// beside the score tiles (ptxas caps a thread at 168 registers at 9 warps),
// so the two consumer warpgroups split D's columns, 128 each, and the
// kernel walks twice: dv += p^T do, then dk += ds^T q, each warpgroup
// computing the scores of 32 of the stage's 64 queries (s^T; in the second
// walk dp^T too) and handing p (ds) to the other through a shared slot.
// Five products for the four of one walk, no spill. With a cluster, dv's
// partial tiles are summed after the first walk (the producer holds the
// second walk's loads until the ring is free again), dk's after the second.
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    train_attn_dkv_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const int* __restrict__ seg, const float* __restrict__ lse,
                               const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int S, int Hq, int Hkv, int D,
                               float scale) {
  using P = DkvWide;
  constexpr int ST = P::ST, NB = P::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* scal = reinterpret_cast<float*>(smem + P::SCAL);
  int* qsegs = reinterpret_cast<int*>(scal + ST * 3 * TQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;
  const int C = gridDim.x, rank = blockIdx.x;
  const int kt = blockIdx.y / Hkv, hk = blockIdx.y - kt * Hkv, b = blockIdx.z, k0 = kt * TK;
  const int rep = Hq / Hkv;
  const int qt0 = k0 / TQ, nqs = (S + TQ - 1) / TQ - qt0;  // query tiles a head
  const int steps = (rep - rank + C - 1) / C * nqs;          // ring stages a walk
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 8);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 2 * kWg) {  // the producer warp: both walks' stages, in order
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(kvbar, 2 * NB * TK * kBoxRow);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem + c * TK * kBoxRow, &k_map, 64 * c, hk, k0, b, kvbar);
        tma_load_4d(smem + P::TILE + c * TK * kBoxRow, &v_map, 64 * c, hk, k0, b, kvbar);
      }
    }
    for (int i = 0; i < 2 * steps; ++i) {
      if (i == steps && C > 1)  // the consumers' two cluster barriers around dv's sum
        for (int n = 0; n < 2; ++n) cluster_barrier();
      const int st = i % ST, j = i < steps ? i : i - steps;
      const int h = hk * rep + rank + C * (j / nqs), q0 = (qt0 + j % nqs) * TQ;
      if (i >= ST) mbar_wait(empty + st, (i / ST - 1) & 1);
      uint8_t* qt = smem + (2 + 2 * st) * P::TILE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * NB * TQ * kBoxRow);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(qt + c * TQ * kBoxRow, &q_map, 64 * c, h, q0, b, full + st);
          tma_load_4d(qt + P::TILE + c * TQ * kBoxRow, &do_map, 64 * c, h, q0, b, full + st);
        }
      }
      float* sc = scal + st * 3 * TQ;
      int lo = INT_MAX, hi = INT_MIN;
      for (int r = lane; r < TQ; r += 32) {
        const int row = q0 + r;
        const bool in = row < S;
        sc[r] = in ? lse[(size_t(b) * Hq + h) * S + row] * kLog2e : 0.f;
        sc[TQ + r] = in ? di[(size_t(b) * S + row) * Hq + h] : 0.f;
        const int v = in ? (seg ? seg[size_t(b) * S + row] : 1) : -3;
        reinterpret_cast<int*>(sc)[2 * TQ + r] = v;
        lo = min(lo, v);
        hi = max(hi, v);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) qsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    if (C > 1)  // the consumers' two around dk's sum
      for (int n = 0; n < 2; ++n) cluster_barrier();
    return;
  }

  const int warp = (tid & (kWg - 1)) >> 5, lane = tid & 31;
  int keys[2], segk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    keys[half] = k0 + 16 * warp + (lane >> 2) + 8 * half;
    segk[half] = keys[half] < S ? (seg ? seg[size_t(b) * S + keys[half]] : 1) : -1;
  }
  const float qs = scale * kLog2e;
  float acc[2][32];
  mbar_wait(kvbar, 0);
  dkv_wide_walk<false>(acc, smem, scal, qsegs, full, empty, 0, steps, nqs, qt0, k0, S, keys,
                       segk, qs);
  dkv_wide_store(acc, smem, dv, 1.f, b, k0, S, Hkv, hk, D, C, rank);
  dkv_wide_walk<true>(acc, smem, scal, qsegs, full, empty, steps, steps, nqs, qt0, k0, S, keys,
                      segk, qs);
  dkv_wide_store(acc, smem, dk, scale, b, k0, S, Hkv, hk, D, C, rank);
}

// ---- f32 forward, dkv and dq: 3xTF32 wgmma fed by a TMA ring ---------------------
//
// tf32 wgmma reads both operands K-major, so no product can read a tile
// transposed as the bf16 kernels read V, dO, Q and K. Here every product takes
// A from registers, gathered with ld.shared in whatever order it needs, split
// into hi and lo there (hopper.cuh: tf32_split), and B from shared memory as
// hi and lo planes, K-major:
//   * the score products contract over D, and D is contiguous, so the
//     streamed operand (dkv: Q and dO; dq and the forward: K and V) is B as
//     TMA lands it, split in place (hi over the raw tile, lo beside it) once
//     a stage; the resident operand (dkv: K, V; dq: Q, dO; the forward: Q)
//     stays raw and is A;
//   * the products over rows are taken transposed: dv^T = dO^T p,
//     dk^T = Q^T ds (dkv), dq^T = K^T ds^T (dq), o^T = V^T p^T (the
//     forward): A gathered from the stage's
//     planes by column, B the p or ds tile written from the score
//     accumulator into hi and lo planes in the swizzle TMA uses, rows of TS
//     f32 (128 bytes);
//   * the accumulators hold the results transposed (D's columns as rows);
//     the epilogue writes them through shared memory as [row][D] tiles.
// Every product is three wgmmas (hi hi, hi lo, lo hi). f32 tiles are twice
// bf16's and each B needs its lo plane, so stages are TS = 32 rows and
// one consumer warpgroup does all the products, its gathers, splits and
// exponentials in series with them. At D <= 64 two CTAs share an SM (one
// ring stage, 97 or 81 KB of shared memory, 168 registers a thread), so one
// CTA's elementwise work overlaps the other's products (faster than one
// CTA with a deeper ring, which only hides the loads). At D = 128
// the resident raw tiles (64 KB) and a stage (64 KB) allow one CTA an SM
// (up to 227 KB, 255 registers). Above D = 128 neither tiles nor
// accumulators of the D = 128 layout fit twice in a CTA, so the CTAs of a
// cluster split D, 128 columns each (see split_sum).

constexpr int TS = 32;  // rows of a tf32 ring stage: queries (dkv) or keys (dq); a p/ds row
static_assert(TS == 32, "the producer warp reads a stage's scalars a row a lane");
constexpr int kSplitCols = 128;  // D's columns of a CTA of a split (DT = 128)
constexpr int kMaxSplit = 8;     // CTAs a split: D <= 1024

// CTAs splitting D's columns (1 below kSplitCols)
__host__ __device__ __forceinline__ int split_ctas(int D) {
  return D <= kSplitCols ? 1 : (D + kSplitCols - 1) / kSplitCols;
}

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<I + 1, N>(f);
  }
}

struct Frag {  // a 64 x 8 A operand: hi and lo tf32
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void fence_frag(Frag& f) {
  fence_regs(f.hi);
  fence_regs(f.lo);
}

// An R-row f32 tile in boxes of 32 columns, 128-byte swizzled as TMA writes
// it, holds element (row, col) at float (col / 32) * 32 R + 32 row +
// 4 (((col / 4) % 8) ^ (row % 8)) + col % 4. The gathers below address it
// as a per-thread base XOR a constant: the thread's row (or column) fixes
// the bits above and below the 16-byte chunk, the constant flips chunk bits
// only, so ptxas keeps a few bases across the stage loop instead of one
// address an element.

// Thread base (floats) of row_frag: rows r0, r0 + 8 of a tile, k-column q
__device__ __forceinline__ int row_base(int r0, int q) { return r0 * 32 + ((r0 & 7) << 2) + q; }

// The A fragment of k-step KK of rows r0, r0 + 8 (base rb = row_base) of a
// raw R-row f32 tile t (K columns), split: element (r, 8 KK + q (+4)) in
// chunk (2 (KK % 4) (+1)) ^ (r % 8) of its row
template <int R, int KK>
__device__ __forceinline__ void row_frag(Frag& f, const float* t, int rb) {
  constexpr int BOX = (KK >> 2) * R * 32, X = (2 * (KK & 3)) << 2;
  tf32_split(t[(rb ^ X) + BOX], f.hi[0], f.lo[0]);
  tf32_split(t[(rb ^ X) + BOX + 256], f.hi[1], f.lo[1]);
  tf32_split(t[(rb ^ (X + 4)) + BOX], f.hi[2], f.lo[2]);
  tf32_split(t[(rb ^ (X + 4)) + BOX + 256], f.hi[3], f.lo[3]);
}

// Thread base (floats) of col_frag for A rows m0 = 64 mt + r0, r0 = 16 w +
// l/4 (l the lane), q = l % 4, in an R-row plane: column m0 % 64 at row q
template <int R>
__device__ __forceinline__ int col_base(int r0, int q) {
  const int w = r0 >> 4, g = r0 & 7;
  return (w >> 1) * R * 32 + q * 32 + ((((w & 1) << 2 | g >> 2) ^ q) << 2) + (g & 3);
}

// The A fragment of k-step KK of the transpose of split planes th, tl (R
// rows: A's K dimension runs down the rows; its M rows m0, m0 + 8 =
// 64 MT + r0 (+8) are columns; base cb = col_base): element (m, k) at row
// k = 8 KK + q (+4), column m; +8 columns and +4 rows flip chunk bits 1, 2
template <int R, int MT, int KK>
__device__ __forceinline__ void col_frag(Frag& f, const float* th, const float* tl, int cb) {
  constexpr int C0 = MT * 2 * R * 32 + KK * 256;
  const int i[4] = {cb + C0, (cb ^ 8) + C0, (cb ^ 16) + C0 + 128, (cb ^ 24) + C0 + 128};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f.hi[j] = __float_as_uint(th[i[j]]);
    f.lo[j] = __float_as_uint(tl[i[j]]);
  }
}

// d (+)= A * B in 3xTF32: B's hi and lo planes by descriptors bh, bl
template <bool ACC, int OFF16, int N>
__device__ __forceinline__ void mma3(float (&d)[N], const Frag& a, uint64_t bh, uint64_t bl) {
  wgmma_tf32<ACC, OFF16>(d, a.hi, bh);
  wgmma_tf32<true, OFF16>(d, a.hi, bl);
  wgmma_tf32<true, OFF16>(d, a.lo, bh);
}

// hi (in place) and lo planes of the N f32 at t, by the warpgroup: the
// swizzle is a permutation inside 1024-byte atoms, so the planes keep the
// raw tile's layout
template <int N>
__device__ __forceinline__ void split_plane(float* t, float* lo, int t128) {
  static_assert(N % (4 * kWg) == 0, "a float4 a thread a pass");
#pragma unroll
  for (int j = 0; j < N / (4 * kWg); ++j) {
    const int i = 4 * (t128 + j * kWg);
    const float4 x = *reinterpret_cast<const float4*>(t + i);
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// x, y (64 x TS) = rows of raw tiles a1, a2 (64 rows; rb: row_base of this
// thread's) times the rows of the split TS-row planes of descriptors
// b1h/b1l, b2h/b2l, over DT columns (zeros past D): the score products, in chunks of KC
// k-steps, each chunk's A fragments gathered and split, then its 6 KC
// wgmmas issued and waited for (registers: 16 KC for the fragments).
// With TWO false only x (the forward's one score product; y, a2 and b2 are
// not read).
template <int DT, int KC, bool TWO = true>
__device__ __forceinline__ void scores_tf32(float (&x)[16], float (&y)[16], const float* a1,
                                            const float* a2, uint64_t b1h, uint64_t b1l,
                                            uint64_t b2h, uint64_t b2l, int rb) {
  static_for<0, DT / 8 / KC>([&](auto cc) {
    constexpr int K0 = decltype(cc)::value * KC;
    Frag f1[KC], f2[KC];
    static_for<0, KC>([&](auto jj) {
      constexpr int J = decltype(jj)::value;
      row_frag<64, K0 + J>(f1[J], a1, rb);
      if constexpr (TWO) row_frag<64, K0 + J>(f2[J], a2, rb);
    });
    wgmma_fence();
    if constexpr (K0 > 0) {
      fence_regs(x);
      if constexpr (TWO) fence_regs(y);
    }
    static_for<0, KC>([&](auto jj) {
      constexpr int J = decltype(jj)::value, K = K0 + J;
      constexpr int OFF = ((K >> 2) * TS * 128 + (K & 3) * 32) / 16;
      mma3<K != 0, OFF>(x, f1[J], b1h, b1l);
      if constexpr (TWO) mma3<K != 0, OFF>(y, f2[J], b2h, b2l);
    });
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if constexpr (TWO) fence_regs(y);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      fence_frag(f1[j]);
      if constexpr (TWO) fence_frag(f2[j]);
    }
  });
}

// d1 (64 x 64) += the transpose of split planes t1h/t1l (TS rows: the K
// dimension; columns 64 M1 .. 64 M1 + 63: the M rows) times the 64 x TS
// tile of descriptors b1h/b1l (64 rows of TS f32: one box); with TWO, d2 the
// same from t2h/t2l, columns 64 M2 .., b2h/b2l in the same wgmma group.
// cb: col_base<TS>.
template <int M1, int M2, bool TWO>
__device__ __forceinline__ void tcols_tf32(float (&d1)[32], float (&d2)[32], const float* t1h,
                                           const float* t1l, const float* t2h, const float* t2l,
                                           uint64_t b1h, uint64_t b1l, uint64_t b2h, uint64_t b2l,
                                           int cb) {
  Frag f1[TS / 8], f2[TS / 8];
  static_for<0, TS / 8>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    col_frag<TS, M1, K>(f1[K], t1h, t1l, cb);
    if constexpr (TWO) col_frag<TS, M2, K>(f2[K], t2h, t2l, cb);
  });
  wgmma_fence();
  fence_regs(d1);
  if constexpr (TWO) fence_regs(d2);
  static_for<0, TS / 8>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    mma3<true, K * 32 / 16>(d1, f1[K], b1h, b1l);
    if constexpr (TWO) mma3<true, K * 32 / 16>(d2, f2[K], b2h, b2l);
  });
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d1);
  if constexpr (TWO) fence_regs(d2);
#pragma unroll
  for (int kk = 0; kk < TS / 8; ++kk) {
    fence_frag(f1[kk]);
    if constexpr (TWO) fence_frag(f2[kk]);
  }
}

// v (64 x TS, the score accumulator's layout) into the hi and lo planes at
// h, l: 64 rows of TS f32 (one box), swizzled; the pair (r, 8j + 2q) in
// chunk (2j + q / 2) ^ (r % 8)
__device__ __forceinline__ void store_split(float* h, float* l, const float (&v)[16], int r0,
                                            int q) {
  const int sb = r0 * 32 + (((q >> 1) ^ (r0 & 7)) << 2) + 2 * (q & 1);  // the pair (r0, 2q)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = (sb ^ (j << 3)) + 256 * half;
      uint2 hv, lv;
      tf32_split(v[4 * j + 2 * half], hv.x, lv.x);
      tf32_split(v[4 * j + 2 * half + 1], hv.y, lv.y);
      *reinterpret_cast<uint2*>(h + i) = hv;
      *reinterpret_cast<uint2*>(l + i) = lv;
    }
}

// A split of ns CTAs (f32, 128 < D <= 1024: the forward, dkv and dq),
// cluster ranks base .. base + ns - 1; column rank `side` owns D's columns
// 128 side .. 128 side + 127 and takes the score products over them only:
// NT partial 64 x TS tiles a stage (the forward s; dkv s^T and dp^T, dq s
// and dp). Each CTA pulls: it leaves its partials in its own p (ds) slots
// (thread t's 16 floats of a tile as float4s at i kWg + t, so that a warp
// reads 512 contiguous bytes an instruction; NT 8 KB, within the hi slot at
// NT = 1, the hi and lo slots at 2), and every CTA reads the ns partials in
// rank order, ((p0 + p1) + p2) + ..., so all hold the same bits and the
// same p, ds, m, l and lse follow with no second exchange. (A push would
// need ns - 1 landing slots where the slots hold one; at ns = 2 the pull
// was measured no slower than the push.) Two mbarriers a CTA, each counting
// an arrival a warp (after a __syncwarp, lane r arrives on rank r, so the
// releases at cluster scope go out together): xready, from each warp of the
// ns - 1 peers (their partials are in place), and xfree, from each warp of
// all ns CTAs, this one's too (split_free: every warp of the split has read
// this CTA's partials). Only then may a warp overwrite its rows of the
// slots with p or ds: in the layout above, warp w's rows of p (ds) are
// float4 chunk w of every thread's partial, which the CTA's other warps
// read as well. Both are waited for in every stage, so after a CTA's last
// split_free no peer reads its shared memory or arrives on it any more.
// The next stage's partial lands in the slots that this CTA's own product
// of the stage (o^T += V^T p^T, dv^T += dO^T p, dq^T += K^T ds^T, ...)
// reads: the named barrier after that stage's split_plane covers it, every
// warp being past the product's wgmma_wait by then.

// The arrival of this warp on the barrier at bar's offset in every CTA of
// the split (SELF) or in every peer
template <bool SELF>
__device__ __forceinline__ void split_arrive(uint64_t* bar, int base, int side, int ns, int lane) {
  __syncwarp();
  if (lane < ns && (SELF || lane != side)) mbar_arrive_cluster(bar, base + lane);
}

// x (and y, NT = 2) (+)= the partials at p, thread tid's (split_sum's layout)
template <bool ADD, int NT>
__device__ __forceinline__ void add_split(float (&x)[16], float (&y)[16], const float4* p,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) {
    const float4 v = p[i * kWg + tid];
    float* d = i < 4 ? x + 4 * i : y + 4 * (i - 4);
    d[0] = ADD ? d[0] + v.x : v.x;
    d[1] = ADD ? d[1] + v.y : v.y;
    d[2] = ADD ? d[2] + v.z : v.z;
    d[3] = ADD ? d[3] + v.w : v.w;
  }
}

// Stage t's sum: x (and y, NT = 2) into this CTA's slots at xs (NT 8 KB),
// then the ns CTAs' partials in rank order into x (and y)
template <int NT>
__device__ __forceinline__ void split_sum(float (&x)[16], float (&y)[16], float* xs,
                                          uint64_t* xready, int t, int base, int side, int ns,
                                          int lane, int tid) {
  static_assert(NT == 1 || NT == 2, "one or two partial tiles");
  cg::cluster_group cluster = cg::this_cluster();
  float4* own = reinterpret_cast<float4*>(xs);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    own[i * kWg + tid] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    if constexpr (NT == 2)
      own[(4 + i) * kWg + tid] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
  }
  split_arrive<false>(xready, base, side, ns, lane);
  mbar_wait_cluster(xready, t & 1);
  for (int r = 0; r < ns; ++r) {
    const float4* p = r == side ? own : cluster.map_shared_rank(own, base + r);
    if (r == 0)
      add_split<false, NT>(x, y, p, tid);
    else
      add_split<true, NT>(x, y, p, tid);
  }
}

// After the sums' values have been used (so the warp's reads are done):
// tell every CTA of the split, this one included, and wait until every warp
// of the split has read this CTA's partials
__device__ __forceinline__ void split_free(uint64_t* xfree, int t, int base, int side, int ns,
                                           int lane) {
  split_arrive<true>(xfree, base, side, ns, lane);
  mbar_wait_cluster(xfree, t & 1);
}

// acc (DT/64 tiles of 64 x 64: D's columns 64 mt + 16 w + l/4 (+8) as rows,
// 64 rows of the output as columns) into out[row][d] (row stride DT + 4
// floats: the warp's four row pairs land in distinct banks)
template <int DT>
__device__ __forceinline__ void acc_to_rows(float* out, const float (&acc)[DT / 64][32], int warp,
                                            int lane) {
#pragma unroll
  for (int mt = 0; mt < DT / 64; ++mt)
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int d = 64 * mt + 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1);
      const int row = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      out[row * (DT + 4) + d] = acc[mt][r];
    }
}

template <int DT, bool SPLIT = false>
struct DkvTf32 {
  static constexpr int ST = DT <= 64 ? 1 : 2;     // ring stages
  static constexpr int KC = 2;                    // k-steps a chunk of the score products
  static constexpr int MIN_BLOCKS = DT <= 64 ? 2 : 1;  // CTAs an SM (registers: 168, 255)
  static constexpr int TILE = 64 * DT * 4;        // K or V: 64 keys
  static constexpr int PLANE = TS * DT * 4;       // a stage's Q or dO, hi or lo
  static constexpr int SLOT = 64 * TS * 4;        // p or ds (keys x queries), hi or lo
  // K at 0, V at TILE; stage st's Q hi, Q lo, dO hi, dO lo at 2 TILE + (4 st + i) PLANE
  static constexpr int XCH = 2 * TILE + 4 * ST * PLANE;  // p hi, p lo, ds hi, ds lo
  static constexpr int SCAL = XCH + 4 * SLOT;            // [ST][3][TS]: lse2, di, seg
  // then the query stage's one segment id [ST]; then full, empty, kv (and a
  // split's xready, xfree), 8-byte aligned
  static constexpr int BAR = (SCAL + ST * (3 * TS + 1) * 4 + 7) / 8 * 8;
  static constexpr int SMEM = BAR + (2 * ST + 1 + (SPLIT ? 2 : 0)) * 8 + 1024;
  static constexpr int OUT = 64 * (DT + 4);  // floats of a [key][D] partial tile, padded rows
  static_assert(2 * OUT * 4 <= XCH, "the partial tiles overlay K, V and the ring");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory of an SM");
};

// dkv, f32, D <= 128: the grid and clusters of train_attn_dkv_ws_kernel
// (dkv_plan: C = min(rep, 8) CTAs a (key tile of 64 rows, kv head, batch),
// the key tile slowest), CTA `rank` walking query heads rank, rank + C, ...
// and for each the query stages of TS rows from the diagonal to the end
// (dkv_walk with query tiles of TS). A producer warp loads raw K and V once
// and streams Q, dO, lse, di and the rows' segment ids through ST stages;
// one consumer warpgroup owns the 64 keys: per stage it splits Q and dO in
// place, takes s^T = K Q^T and dp^T = V dO^T (K and V gathered and split as
// A), p and ds = p (dp - di) into the hi/lo slots, then dv^T += dO^T p and
// dk^T += Q^T ds. The C partial tiles are summed in rank order through
// distributed shared memory ([key][D] rows, coalesced): no atomics, the same
// bits on every run.
// SPLIT (128 < D <= 1024, DT = 128): clusters of ns C CTAs, ns =
// split_ctas(D), C = min(rep, 8 / ns); CTA ns rank + side walks head rank
// `rank`'s heads over D's columns 128 side .. 128 side + 127 beside the
// other column ranks of its head rank (split_sum after the score
// products), and the C partial tiles of one column rank are summed in rank
// order.
template <int DT, bool SPLIT>
__device__ __forceinline__ void dkv_tf32(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, const CUtensorMap& do_map,
                                         const int* __restrict__ seg, const float* __restrict__ lse,
                                         const float* __restrict__ di, float* __restrict__ dk,
                                         float* __restrict__ dv, int S, int Hq, int Hkv, int D,
                                         float scale) {
  using P = DkvTf32<DT, SPLIT>;
  constexpr int ST = P::ST, NB = DT / 32;
  const int ns = SPLIT ? split_ctas(D) : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* scal = reinterpret_cast<float*>(smem + P::SCAL);
  int* qsegs = reinterpret_cast<int*>(scal + ST * 3 * TS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;
  uint64_t* xready = kvbar + 1;  // a split's only
  uint64_t* xfree = xready + 1;
  const int C = gridDim.x / ns, rank = blockIdx.x / ns;
  const int side = blockIdx.x - ns * rank, c0 = DT * side;  // D's columns of this CTA
  const int kt = blockIdx.y / Hkv, hk = blockIdx.y - kt * Hkv, b = blockIdx.z, k0 = kt * TK;
  const int rep = Hq / Hkv;
  const int qs0 = k0 / TS, nqs = (S + TS - 1) / TS - qs0;  // query stages a head
  const int steps = (rep - rank + C - 1) / C * nqs;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    mbar_init(kvbar, 1);
    if constexpr (SPLIT) {
      mbar_init(xready, 4 * (ns - 1));  // each consumer warp of each peer
      mbar_init(xfree, 4 * ns);         // ... and of this CTA
    }
    fence_mbar_init();
  }
  if constexpr (SPLIT)
    cluster_barrier();  // the peers' mbarriers are set before their first arrival
  else
    __syncthreads();

  if (tid >= kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(kvbar, 2 * P::TILE);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem + c * TK * kBoxRow, &k_map, c0 + 32 * c, hk, k0, b, kvbar);
        tma_load_4d(smem + P::TILE + c * TK * kBoxRow, &v_map, c0 + 32 * c, hk, k0, b, kvbar);
      }
    }
    for (int i = 0; i < steps; ++i) {
      const int st = i % ST;
      const int h = hk * rep + rank + C * (i / nqs), q0 = (qs0 + i % nqs) * TS;
      if (i >= ST) mbar_wait(empty + st, (i / ST - 1) & 1);
      uint8_t* qt = smem + 2 * P::TILE + 4 * st * P::PLANE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * P::PLANE);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(qt + c * TS * kBoxRow, &q_map, c0 + 32 * c, h, q0, b, full + st);
          tma_load_4d(qt + 2 * P::PLANE + c * TS * kBoxRow, &do_map, c0 + 32 * c, h, q0, b,
                      full + st);
        }
      }
      float* sc = scal + st * 3 * TS;
      const int row = q0 + lane;  // TS == 32: a row a lane
      const bool in = row < S;
      sc[lane] = in ? lse[(size_t(b) * Hq + h) * S + row] * kLog2e : 0.f;
      sc[TS + lane] = in ? di[(size_t(b) * S + row) * Hq + h] : 0.f;
      const int v = in ? (seg ? seg[size_t(b) * S + row] : 1) : -3;
      reinterpret_cast<int*>(sc)[2 * TS + lane] = v;
      const int lo = __reduce_min_sync(0xffffffffu, v), hi = __reduce_max_sync(0xffffffffu, v);
      if (lane == 0) qsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    if (SPLIT || C > 1)  // the consumers' two cluster barriers
      for (int i = 0; i < 2; ++i) cluster_barrier();
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3, r0 = 16 * warp + (lane >> 2);
  const int rb = row_base(r0, quad), cb = col_base<TS>(r0, quad);
  const float qs = scale * kLog2e;
  int keys[2], segk[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    keys[half] = k0 + r0 + 8 * half;
    segk[half] = keys[half] < S ? (seg ? seg[size_t(b) * S + keys[half]] : 1) : -1;
  }
  float dva[DT / 64][32], dka[DT / 64][32];  // dv^T, dk^T: D's columns x 64 keys
#pragma unroll
  for (int mt = 0; mt < DT / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[mt][i] = dka[mt][i] = 0.f;
  const float* kr = reinterpret_cast<const float*>(smem);
  const float* vr = reinterpret_cast<const float*>(smem + P::TILE);
  float* ph = reinterpret_cast<float*>(smem + P::XCH);  // p hi, p lo, ds hi, ds lo
  float* pl = ph + P::SLOT / 4;
  float* dsh = pl + P::SLOT / 4;
  float* dsl = dsh + P::SLOT / 4;
  const uint32_t pa = smem_u32(ph);
  const uint64_t phd = sw128_desc(pa), pld = sw128_desc(pa + P::SLOT);
  const uint64_t dshd = sw128_desc(pa + 2 * P::SLOT), dsld = sw128_desc(pa + 3 * P::SLOT);
  mbar_wait(kvbar, 0);

  for (int i = 0; i < steps; ++i) {
    const int st = i % ST, q0 = (qs0 + i % nqs) * TS;
    mbar_wait(full + st, (i / ST) & 1);
    float* qh = reinterpret_cast<float*>(smem + 2 * P::TILE + 4 * st * P::PLANE);
    float* ql = qh + P::PLANE / 4;
    float* oh = ql + P::PLANE / 4;
    float* ol = oh + P::PLANE / 4;
    split_plane<TS * DT>(qh, ql, tid);
    split_plane<TS * DT>(oh, ol, tid);
    fence_proxy_async();
    named_sync(1, kWg);
    const uint32_t qa = smem_u32(qh);
    float x[16], y[16];  // s^T, dp^T: 64 keys x TS queries
    scores_tf32<DT, P::KC>(x, y, kr, vr, sw128_desc(qa), sw128_desc(qa + P::PLANE),
                           sw128_desc(qa + 2 * P::PLANE), sw128_desc(qa + 3 * P::PLANE), rb);
    // the partials of s^T and dp^T in the ds slots (written below)
    if constexpr (SPLIT) split_sum<2>(x, y, dsh, xready, i, ns * rank, side, ns, lane, tid);
    const float* sc = scal + st * 3 * TS;
    const int* sq = reinterpret_cast<const int*>(sc) + 2 * TS;
    const int ts = qsegs[st];  // as in the forward, keys and query rows swapped
    const bool mask = q0 < k0 + TK - 1 || q0 + TS > S || ts != segk[0] || ts != segk[1];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int half = (r >> 1) & 1, c = 8 * (r >> 2) + 2 * quad + (r & 1);
      float p = ex2(x[r] * qs - sc[c]);
      if (mask && !(keys[half] <= q0 + c && sq[c] == segk[half])) p = 0.f;
      x[r] = p;
      y[r] = p * (y[r] - sc[TS + c]);  // ds
    }
    store_split(ph, pl, x, r0, quad);
    if constexpr (SPLIT) split_free(xfree, i, ns * rank, side, ns, lane);
    store_split(dsh, dsl, y, r0, quad);
    fence_proxy_async();
    named_sync(1, kWg);
    static_for<0, DT / 64>([&](auto m) {  // dv^T += dO^T p, dk^T += Q^T ds
      constexpr int MT = decltype(m)::value;
      tcols_tf32<MT, MT, true>(dva[MT], dka[MT], oh, ol, qh, ql, phd, pld, dshd, dsld, cb);
    });
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  // [key][D] partial tiles, dv then dk, over K, V and the ring (every stage
  // consumed; the named barrier: every warp is done with them)
  float* red = reinterpret_cast<float*>(smem);
  named_sync(1, kWg);
  acc_to_rows<DT>(red, dva, warp, lane);
  acc_to_rows<DT>(red + P::OUT, dka, warp, lane);
  if (SPLIT || C > 1)
    cluster_barrier();
  else
    named_sync(1, kWg);
  // CTA `rank` sums its 1/C of the 2 x 64 rows' float4s over ranks 0 .. C-1
  // (of its column rank, for a split)
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int N4 = 2 * 64 * DT / 4;
  const int per = (N4 + C - 1) / C, lo = rank * per, hi = min(N4, lo + per);
  for (int n = lo + tid; n < hi; n += kWg) {
    const int rr = n / (DT / 4), col = 4 * (n - rr * (DT / 4)), w = rr >> 6, key = k0 + (rr & 63);
    const int at = w * P::OUT + (rr & 63) * (DT + 4) + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          (SPLIT || C > 1 ? cluster.map_shared_rank(red, r * ns + side) : red) + at);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (key < S && c0 + col < D) {
      const float mul = w ? scale : 1.f;
      *reinterpret_cast<float4*>((w ? dk : dv) + ((size_t(b) * S + key) * Hkv + hk) * D + c0 +
                                 col) = make_float4(s.x * mul, s.y * mul, s.z * mul, s.w * mul);
    }
  }
  if (SPLIT || C > 1)
    cluster_barrier();  // no CTA leaves while a peer still reads its shared memory
}

template <int DT>
__global__ void __launch_bounds__(kWg + 32, DkvTf32<DT>::MIN_BLOCKS)
    train_attn_dkv_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const int* __restrict__ seg, const float* __restrict__ lse,
                               const float* __restrict__ di, float* __restrict__ dk,
                               float* __restrict__ dv, int S, int Hq, int Hkv, int D,
                               float scale) {
  dkv_tf32<DT, false>(q_map, k_map, v_map, do_map, seg, lse, di, dk, dv, S, Hq, Hkv, D, scale);
}

// dkv, f32, 128 < D <= 1024: dkv_tf32's split (on clusters of ns min(rep, 8 / ns))
__global__ void __launch_bounds__(kWg + 32, 1)
    train_attn_dkv_tf32_split_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const __grid_constant__ CUtensorMap do_map,
                                     const int* __restrict__ seg, const float* __restrict__ lse,
                                     const float* __restrict__ di, float* __restrict__ dk,
                                     float* __restrict__ dv, int S, int Hq, int Hkv, int D,
                                     float scale) {
  dkv_tf32<128, true>(q_map, k_map, v_map, do_map, seg, lse, di, dk, dv, S, Hq, Hkv, D, scale);
}

template <int DT, bool SPLIT = false>
struct DqTf32 {
  static constexpr int ST = DT <= 64 ? 1 : 2;  // ring stages
  static constexpr int KC = DT <= 64 ? 2 : 4;  // k-steps a chunk of the score products
  static constexpr int MIN_BLOCKS = DT <= 64 ? 2 : 1;  // CTAs an SM (registers: 168, 255)
  static constexpr int TILE = 64 * DT * 4;     // Q or dO: 64 query rows
  static constexpr int PLANE = TS * DT * 4;    // a stage's K or V, hi or lo
  static constexpr int SLOT = 64 * TS * 4;     // ds (queries x keys), hi or lo
  // Q at 0, dO at TILE; stage st's K hi, K lo, V hi, V lo at 2 TILE + (4 st + i) PLANE
  static constexpr int XCH = 2 * TILE + 4 * ST * PLANE;  // ds hi, ds lo
  static constexpr int SEG = XCH + 2 * SLOT;  // keys' segment ids [ST][TS], the stage's one [ST]
  static constexpr int BAR = (SEG + ST * (TS + 1) * 4 + 7) / 8 * 8;
  // full, empty, q (and a split's xready, xfree); alignment
  static constexpr int SMEM = BAR + (2 * ST + 1 + (SPLIT ? 2 : 0)) * 8 + 1024;
  static constexpr int OUT = 64 * (DT + 4);  // floats of the [query][D] tile, padded rows
  static_assert(OUT * 4 <= XCH, "the dq tile overlays Q, dO and the ring");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory of an SM");
};

// dq, f32, D <= 128: one CTA a (query head, batch, query tile of 64 rows, the
// longest first), as train_attn_dq_ws_kernel: a producer warp loads raw Q
// and dO once and streams the key stages (TS rows) on or below the diagonal,
// K, V and the keys' segment ids, through ST stages; one consumer warpgroup
// owns the 64 rows: per stage it splits K and V in place, takes s = Q K^T
// and dp = dO V^T (Q and dO gathered and split as A), ds = p (dp - di) into
// the hi/lo slots, then dq^T += K^T ds^T. The CTA writes only its own rows:
// no atomics, the same bits on every run.
// SPLIT (128 < D <= 1024, DT = 128): grid (ns Hq, B, query tiles) on
// clusters of ns = split_ctas(D) along x; CTA side = blockIdx.x % ns owns
// D's columns 128 side .. 128 side + 127 of Q, dO, K and V, takes its
// partial s and dp (split_sum, after which p and ds are the same bits in
// every CTA) and accumulates dq for its own columns.
template <int DT, bool SPLIT>
__device__ __forceinline__ void dq_tf32(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                        const CUtensorMap& v_map, const CUtensorMap& do_map,
                                        const int* __restrict__ seg, const float* __restrict__ lse,
                                        const float* __restrict__ di, float* __restrict__ dq, int S,
                                        int Hq, int Hkv, int D, float scale) {
  using P = DqTf32<DT, SPLIT>;
  constexpr int ST = P::ST, NB = DT / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  int* segs = reinterpret_cast<int*>(smem + P::SEG);
  int* tsegs = segs + ST * TS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  uint64_t* xready = qbar + 1;  // a split's only
  uint64_t* xfree = xready + 1;
  const int ns = SPLIT ? split_ctas(D) : 1;
  const int h = blockIdx.x / ns, side = blockIdx.x - ns * h, c0 = DT * side;  // D's columns
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = h / (Hq / Hkv);
  const int nks = min(q0 / TS + TQ / TS, (S + TS - 1) / TS);  // key stages on or below the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    if constexpr (SPLIT) {
      mbar_init(xready, 4 * (ns - 1));  // each consumer warp of each peer
      mbar_init(xfree, 4 * ns);         // ... and of this CTA
    }
    fence_mbar_init();
  }
  if constexpr (SPLIT)
    cluster_barrier();  // the peers' mbarriers are set before their first arrival
  else
    __syncthreads();

  if (tid >= kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(qbar, 2 * P::TILE);
      for (int c = 0; c < NB; ++c) {
        tma_load_4d(smem + c * TQ * kBoxRow, &q_map, c0 + 32 * c, h, q0, b, qbar);
        tma_load_4d(smem + P::TILE + c * TQ * kBoxRow, &do_map, c0 + 32 * c, h, q0, b, qbar);
      }
    }
    for (int t = 0; t < nks; ++t) {
      const int st = t % ST, k0 = t * TS;
      if (t >= ST) mbar_wait(empty + st, (t / ST - 1) & 1);
      uint8_t* kt = smem + 2 * P::TILE + 4 * st * P::PLANE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * P::PLANE);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(kt + c * TS * kBoxRow, &k_map, c0 + 32 * c, hk, k0, b, full + st);
          tma_load_4d(kt + 2 * P::PLANE + c * TS * kBoxRow, &v_map, c0 + 32 * c, hk, k0, b,
                      full + st);
        }
      }
      const int key = k0 + lane;  // TS == 32: a key a lane
      const int v = key < S ? (seg ? seg[size_t(b) * S + key] : 1) : -1;
      segs[st * TS + lane] = v;
      const int lo = __reduce_min_sync(0xffffffffu, v), hi = __reduce_max_sync(0xffffffffu, v);
      if (lane == 0) tsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3, r0 = 16 * warp + (lane >> 2);
  const int rb = row_base(r0, quad), cb = col_base<TS>(r0, quad);
  const float qs = scale * kLog2e;
  int rows[2], segq[2];
  float lse2[2], dii[2];  // rows past S: 0, never stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    const bool in = row < S;
    rows[half] = row;
    segq[half] = in ? (seg ? seg[size_t(b) * S + row] : 1) : -2;
    lse2[half] = in ? lse[(size_t(b) * Hq + h) * S + row] * kLog2e : 0.f;
    dii[half] = in ? di[(size_t(b) * S + row) * Hq + h] : 0.f;
  }
  float acc[DT / 64][32];  // dq^T: D's columns x 64 query rows
#pragma unroll
  for (int mt = 0; mt < DT / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
  const float* qr = reinterpret_cast<const float*>(smem);
  const float* dor = reinterpret_cast<const float*>(smem + P::TILE);
  float* dsh = reinterpret_cast<float*>(smem + P::XCH);
  float* dsl = dsh + P::SLOT / 4;
  const uint64_t dshd = sw128_desc(smem_u32(dsh)), dsld = sw128_desc(smem_u32(dsl));
  mbar_wait(qbar, 0);

  for (int t = 0; t < nks; ++t) {
    const int st = t % ST, k0 = t * TS;
    mbar_wait(full + st, (t / ST) & 1);
    float* kh = reinterpret_cast<float*>(smem + 2 * P::TILE + 4 * st * P::PLANE);
    float* kl = kh + P::PLANE / 4;
    float* vh = kl + P::PLANE / 4;
    float* vl = vh + P::PLANE / 4;
    split_plane<TS * DT>(kh, kl, tid);
    split_plane<TS * DT>(vh, vl, tid);
    fence_proxy_async();
    named_sync(1, kWg);
    const uint32_t ka = smem_u32(kh);
    float s[16], dp[16];  // 64 query rows x TS keys
    scores_tf32<DT, P::KC>(s, dp, qr, dor, sw128_desc(ka), sw128_desc(ka + P::PLANE),
                           sw128_desc(ka + 2 * P::PLANE), sw128_desc(ka + 3 * P::PLANE), rb);
    // the partials of s and dp in the ds slots (written below)
    if constexpr (SPLIT) split_sum<2>(s, dp, dsh, xready, t, 0, side, ns, lane, tid);
    const int* sk = segs + st * TS;
    // the per-element test only where the stage crosses the diagonal or S or
    // holds another segment than this thread's rows, as in the forward
    const int ts = tsegs[st];
    const bool mask = k0 + TS - 1 > q0 || k0 + TS > S || ts != segq[0] || ts != segq[1];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad + (i & 1);
      float p = ex2(s[i] * qs - lse2[half]);
      if (mask && !(k0 + kc <= rows[half] && sk[kc] == segq[half])) p = 0.f;
      s[i] = p * (dp[i] - dii[half]);  // ds
    }
    if constexpr (SPLIT) split_free(xfree, t, 0, side, ns, lane);
    store_split(dsh, dsl, s, r0, quad);
    fence_proxy_async();
    named_sync(1, kWg);
    // dq^T += K^T ds^T, both of D's 64-column tiles in one group at DT = 128
    tcols_tf32<0, 1, (DT > 64)>(acc[0], acc[DT / 64 - 1], kh, kl, kh, kl, dshd, dsld, dshd, dsld,
                                cb);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  // the [query][D] tile over Q, dO and the ring (every stage consumed; the
  // named barrier: every warp is done with them), then coalesced rows
  float* out = reinterpret_cast<float*>(smem);
  named_sync(1, kWg);
  acc_to_rows<DT>(out, acc, warp, lane);
  named_sync(1, kWg);
  for (int n = tid; n < 64 * DT / 4; n += kWg) {
    const int row = n / (DT / 4), col = 4 * (n - row * (DT / 4));
    if (q0 + row >= S || c0 + col >= D) continue;
    const float4 v = *reinterpret_cast<const float4*>(out + row * (DT + 4) + col);
    *reinterpret_cast<float4*>(dq + ((size_t(b) * S + q0 + row) * Hq + h) * D + c0 + col) =
        make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
  }
}

template <int DT>
__global__ void __launch_bounds__(kWg + 32, DqTf32<DT>::MIN_BLOCKS)
    train_attn_dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const int* __restrict__ seg, const float* __restrict__ lse,
                              const float* __restrict__ di, float* __restrict__ dq, int S, int Hq,
                              int Hkv, int D, float scale) {
  dq_tf32<DT, false>(q_map, k_map, v_map, do_map, seg, lse, di, dq, S, Hq, Hkv, D, scale);
}

// dq, f32, 128 < D <= 1024: dq_tf32's split (on clusters of split_ctas(D))
__global__ void __launch_bounds__(kWg + 32, 1)
    train_attn_dq_tf32_split_kernel(const __grid_constant__ CUtensorMap q_map,
                                    const __grid_constant__ CUtensorMap k_map,
                                    const __grid_constant__ CUtensorMap v_map,
                                    const __grid_constant__ CUtensorMap do_map,
                                    const int* __restrict__ seg, const float* __restrict__ lse,
                                    const float* __restrict__ di, float* __restrict__ dq, int S,
                                    int Hq, int Hkv, int D, float scale) {
  dq_tf32<128, true>(q_map, k_map, v_map, do_map, seg, lse, di, dq, S, Hq, Hkv, D, scale);
}

template <int DT, bool SPLIT = false>
struct FwdTf32 {
  static constexpr int ST = 2;                 // ring stages
  static constexpr int KC = DT <= 64 ? 2 : 4;  // k-steps a chunk of the score product
  static constexpr int MIN_BLOCKS = DT <= 64 ? 2 : 1;  // CTAs an SM
  static constexpr int TILE = 64 * DT * 4;     // Q: 64 query rows
  static constexpr int PLANE = TS * DT * 4;    // a stage's K or V, hi or lo
  static constexpr int SLOT = 64 * TS * 4;     // p (queries x keys), hi or lo
  // Q at 0; stage st's K hi, K lo, V hi, V lo at TILE + (4 st + i) PLANE
  static constexpr int XCH = TILE + 4 * ST * PLANE;  // p hi, p lo
  static constexpr int FAC = XCH + 2 * SLOT;  // the rows' factors [64]: alpha a stage, then 1/l
  static constexpr int SEG = FAC + 64 * 4;    // keys' segment ids [ST][TS], the stage's one [ST]
  static constexpr int BAR = (SEG + ST * (TS + 1) * 4 + 7) / 8 * 8;
  // full, empty, q (and a split's xready, xfree); alignment
  static constexpr int SMEM = BAR + (2 * ST + 1 + (SPLIT ? 2 : 0)) * 8 + 1024;
  static constexpr int OUT = 64 * (DT + 4);  // floats of the [query][D] tile, padded rows
  static_assert(OUT * 4 <= XCH, "the o tile overlays Q and the ring");
  static_assert(SLOT == 16 * 4 * kWg, "a split's partial scores fill the p hi slot");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory of an SM");
};

// The forward, f32, D <= 128: one CTA a (query head, batch, query tile of 64
// rows, the longest first), the dq kernel's shape: a producer warp loads raw
// Q once and streams the key stages (TS rows) on or below the diagonal, K,
// V and the keys' segment ids, through ST stages; one consumer warpgroup
// owns the 64 rows: per stage it splits K and V in place, takes s = Q K^T
// (Q gathered and split as A), runs the online softmax on the register
// scores (masking only a stage that crosses the diagonal or S or holds
// another segment than a row), writes p into the hi/lo slots, then
// o^T += V^T p^T (V^T gathered from the stage's planes by column). o^T holds
// the query rows as wgmma's N index, so each stage's rescale factor, one a
// row, goes through a 64-float row of shared memory, written beside p
// before the barrier the product needs anyway (one pass; a two-pass design
// would take the score product twice). The epilogue writes o (times 1/l,
// the same row) and the f32 lse as the CUDA-core kernel did, rows past S
// never stored: no atomics, the same bits on every run.
// SPLIT (128 < D <= 1024, DT = 128): grid (ns Hq, B, query tiles) on
// clusters of ns = split_ctas(D) along x; CTA side = blockIdx.x % ns owns
// D's columns 128 side .. 128 side + 127: its Q, K and V boxes, its partial
// s (split_sum into the p hi slot, after which s, m, l and p are the same
// bits in every CTA; split_free before p overwrites the slot) and its
// columns of o; side 0 writes the lse.
template <int DT, bool SPLIT>
__device__ __forceinline__ void fwd_tf32(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, const int* __restrict__ seg,
                                         float* __restrict__ o, float* __restrict__ lse, int S,
                                         int Hq, int Hkv, int D, float scale) {
  using P = FwdTf32<DT, SPLIT>;
  constexpr int ST = P::ST, NB = DT / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* fac = reinterpret_cast<float*>(smem + P::FAC);
  int* segs = reinterpret_cast<int*>(smem + P::SEG);
  int* tsegs = segs + ST * TS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  uint64_t* xready = qbar + 1;  // a split's only
  uint64_t* xfree = xready + 1;
  const int ns = SPLIT ? split_ctas(D) : 1;
  const int h = blockIdx.x / ns, side = blockIdx.x - ns * h, c0 = DT * side;  // D's columns
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int hk = h / (Hq / Hkv);
  const int nks = min(q0 / TS + TQ / TS, (S + TS - 1) / TS);  // key stages on or below the diagonal
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kFullCount);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    if constexpr (SPLIT) {
      mbar_init(xready, 4 * (ns - 1));  // each consumer warp of each peer
      mbar_init(xfree, 4 * ns);         // ... and of this CTA
    }
    fence_mbar_init();
  }
  if constexpr (SPLIT)
    cluster_barrier();  // the peers' mbarriers are set before their first arrival
  else
    __syncthreads();

  if (tid >= kWg) {  // the producer warp
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect(qbar, P::TILE);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(smem + c * TQ * kBoxRow, &q_map, c0 + 32 * c, h, q0, b, qbar);
    }
    for (int t = 0; t < nks; ++t) {
      const int st = t % ST, k0 = t * TS;
      if (t >= ST) mbar_wait(empty + st, (t / ST - 1) & 1);
      uint8_t* kt = smem + P::TILE + 4 * st * P::PLANE;
      if (lane == 0) {
        mbar_expect(full + st, 2 * P::PLANE);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(kt + c * TS * kBoxRow, &k_map, c0 + 32 * c, hk, k0, b, full + st);
          tma_load_4d(kt + 2 * P::PLANE + c * TS * kBoxRow, &v_map, c0 + 32 * c, hk, k0, b,
                      full + st);
        }
      }
      const int key = k0 + lane;  // TS == 32: a key a lane
      const int v = key < S ? (seg ? seg[size_t(b) * S + key] : 1) : -1;
      segs[st * TS + lane] = v;
      const int lo = __reduce_min_sync(0xffffffffu, v), hi = __reduce_max_sync(0xffffffffu, v);
      if (lane == 0) tsegs[st] = lo == hi ? lo : kMixed;
      mbar_arrive(full + st);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, quad = lane & 3, r0 = 16 * warp + (lane >> 2);
  const int rb = row_base(r0, quad), cb = col_base<TS>(r0, quad);
  const float qs = scale * kLog2e;
  int rows[2], segq[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    rows[half] = q0 + r0 + 8 * half;
    segq[half] = rows[half] < S ? (seg ? seg[size_t(b) * S + rows[half]] : 1) : -2;
  }
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};  // log2 units
  float acc[DT / 64][32];  // o^T: D's columns x 64 query rows
#pragma unroll
  for (int mt = 0; mt < DT / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
  const float* qr = reinterpret_cast<const float*>(smem);
  float* ph = reinterpret_cast<float*>(smem + P::XCH);
  float* pl = ph + P::SLOT / 4;
  const uint64_t phd = sw128_desc(smem_u32(ph)), pld = sw128_desc(smem_u32(pl));
  mbar_wait(qbar, 0);

  for (int t = 0; t < nks; ++t) {
    const int st = t % ST, k0 = t * TS;
    mbar_wait(full + st, (t / ST) & 1);
    float* kh = reinterpret_cast<float*>(smem + P::TILE + 4 * st * P::PLANE);
    float* kl = kh + P::PLANE / 4;
    float* vh = kl + P::PLANE / 4;
    float* vl = vh + P::PLANE / 4;
    split_plane<TS * DT>(kh, kl, tid);
    split_plane<TS * DT>(vh, vl, tid);
    fence_proxy_async();
    named_sync(1, kWg);
    const uint32_t ka = smem_u32(kh);
    float s[16];  // 64 query rows x TS keys
    scores_tf32<DT, P::KC, false>(s, s, qr, qr, sw128_desc(ka), sw128_desc(ka + P::PLANE), 0, 0,
                                  rb);
    // the partial scores in the p hi slot (written below)
    if constexpr (SPLIT) split_sum<1>(s, s, ph, xready, t, 0, side, ns, lane, tid);
    const int* sk = segs + st * TS;
    const int ts = tsegs[st];
    const bool mask = k0 + TS - 1 > q0 || k0 + TS > S || ts != segq[0] || ts != segq[1];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1, kc = 8 * (i >> 2) + 2 * quad + (i & 1);
      float x = s[i] * qs;
      if (mask && !(k0 + kc <= rows[half] && sk[kc] == segq[half])) x = kMaskValue;
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = ex2(m[half] - mx[half]);
      m[half] = mx[half];
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int half = (i >> 1) & 1;
      const float p = s[i] == kMaskValue ? 0.f : ex2(s[i] - m[half]);
      s[i] = p;
      l[half] += p;
    }
    if constexpr (SPLIT) split_free(xfree, t, 0, side, ns, lane);
    store_split(ph, pl, s, r0, quad);
    if (quad == 0) {
      fac[r0] = alpha[0];
      fac[r0 + 8] = alpha[1];
    }
    fence_proxy_async();
    named_sync(1, kWg);
    // o^T's columns are query rows 8 (r / 4) + 2 quad + r % 2: rescale them
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = *reinterpret_cast<const float2*>(fac + 8 * j + 2 * quad);
#pragma unroll
      for (int mt = 0; mt < DT / 64; ++mt) {
        acc[mt][4 * j] *= f.x;
        acc[mt][4 * j + 1] *= f.y;
        acc[mt][4 * j + 2] *= f.x;
        acc[mt][4 * j + 3] *= f.y;
      }
    }
    // o^T += V^T p^T, both of D's 64-column tiles in one group at DT = 128
    tcols_tf32<0, 1, (DT > 64)>(acc[0], acc[DT / 64 - 1], vh, vl, vh, vl, phd, pld, phd, pld, cb);
    if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
  }

  // the [query][D] tile over Q and the ring (every stage consumed; the
  // named barrier: every warp is done with them and with fac), 1/l a row in
  // fac, then coalesced rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    if (quad == 0 && rows[half] < S && side == 0)
      lse[(size_t(b) * Hq + h) * S + rows[half]] = (m[half] + log2f(l[half])) * kLn2;
  }
  float* out = reinterpret_cast<float*>(smem);
  named_sync(1, kWg);
  if (quad == 0) {
    fac[r0] = 1.f / l[0];
    fac[r0 + 8] = 1.f / l[1];
  }
  acc_to_rows<DT>(out, acc, warp, lane);
  named_sync(1, kWg);
  for (int n = tid; n < 64 * DT / 4; n += kWg) {
    const int row = n / (DT / 4), col = 4 * (n - row * (DT / 4));
    if (q0 + row >= S || c0 + col >= D) continue;
    const float4 v = *reinterpret_cast<const float4*>(out + row * (DT + 4) + col);
    const float f = fac[row];
    *reinterpret_cast<float4*>(o + ((size_t(b) * S + q0 + row) * Hq + h) * D + c0 + col) =
        make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
  }
}

template <int DT>
__global__ void __launch_bounds__(kWg + 32, FwdTf32<DT>::MIN_BLOCKS)
    train_attn_fwd_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const int* __restrict__ seg, float* __restrict__ o,
                               float* __restrict__ lse, int S, int Hq, int Hkv, int D,
                               float scale) {
  fwd_tf32<DT, false>(q_map, k_map, v_map, seg, o, lse, S, Hq, Hkv, D, scale);
}

// The forward, f32, 128 < D <= 1024: fwd_tf32's split (on clusters of split_ctas(D))
__global__ void __launch_bounds__(kWg + 32, 1)
    train_attn_fwd_tf32_split_kernel(const __grid_constant__ CUtensorMap q_map,
                                     const __grid_constant__ CUtensorMap k_map,
                                     const __grid_constant__ CUtensorMap v_map,
                                     const int* __restrict__ seg, float* __restrict__ o,
                                     float* __restrict__ lse, int S, int Hq, int Hkv, int D,
                                     float scale) {
  fwd_tf32<128, true>(q_map, k_map, v_map, seg, o, lse, S, Hq, Hkv, D, scale);
}

// ---- CUDA cores, one warp a row: the forward, dkv and dq above D = 1024 ----------
//
// F32_ROWS rows (warps) a CTA. D's output columns are split into slices of
// WIDE_COLS, one a CTA along grid z (b * slices + slice), each slice
// recomputing the row's scores, so no register array grows with D; the row
// dots loop over D, reading the rows from memory. f32 arithmetic; bf16
// inputs widened as read, outputs rounded once.

constexpr int F32_ROWS = 8;      // rows (warps) a CTA
constexpr int WIDE_COLS = 256;   // output columns a CTA
constexpr int WIDE_PER = WIDE_COLS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the dot of rows a and b (D elements) by the warp, the lane taking c = lane + 32i
template <typename T>
__device__ __forceinline__ float row_dot(const T* a, const T* b, int D, int lane) {
  float d = 0.f;
  for (int c = lane; c < D; c += 32) d = fmaf(to_f32(a[c]), to_f32(b[c]), d);
  return warp_sum(d);
}

// grid z: the batch row b and the first column c0 of the CTA's slice
__device__ __forceinline__ void core_slice(int D, int& b, int& c0) {
  const int nsl = (D + WIDE_COLS - 1) / WIDE_COLS;
  b = blockIdx.z / nsl;
  c0 = (blockIdx.z - b * nsl) * WIDE_COLS;
}

template <typename T>
__global__ void __launch_bounds__(F32_ROWS * 32)
    train_attn_fwd_cores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ seg,
                                T* __restrict__ out, float* __restrict__ lse, int S, int Hq,
                                int Hkv, int D, float scale) {
  int b, c0;
  core_slice(D, b, c0);
  const int h = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * F32_ROWS + (threadIdx.x >> 5);
  if (i >= S) return;
  const int hk = h / (Hq / Hkv), si = seg ? seg[size_t(b) * S + i] : 1;
  const T* qr = q + ((size_t(b) * S + i) * Hq + h) * D;
  float acc[WIDE_PER];
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) acc[c] = 0.f;
  float m = kMaskValue, l = 0.f;
  for (int j = 0; j <= i; ++j) {
    if (seg && seg[size_t(b) * S + j] != si) continue;
    const size_t kv = ((size_t(b) * S + j) * Hkv + hk) * D;
    const float s = row_dot(qr, k + kv, D, lane) * scale;
    const float mn = fmaxf(m, s), alpha = expf(m - mn), p = expf(s - mn);
    l = l * alpha + p;
#pragma unroll
    for (int c = 0; c < WIDE_PER; ++c) {
      const int col = c0 + lane + 32 * c;
      acc[c] = acc[c] * alpha + (col < D ? p * to_f32(v[kv + col]) : 0.f);
    }
    m = mn;
  }
  T* o = out + ((size_t(b) * S + i) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) {
    const int col = c0 + lane + 32 * c;
    if (col < D) o[col] = from_f32<T>(acc[c] / l);
  }
  if (c0 == 0 && lane == 0) lse[(size_t(b) * Hq + h) * S + i] = m + logf(l);
}

template <typename T>
__global__ void __launch_bounds__(F32_ROWS * 32)
    train_attn_dq_cores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const int* __restrict__ seg,
                               const T* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ di, T* __restrict__ dq, int S, int Hq,
                               int Hkv, int D, float scale) {
  int b, c0;
  core_slice(D, b, c0);
  const int h = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * F32_ROWS + (threadIdx.x >> 5);
  if (i >= S) return;
  const int hk = h / (Hq / Hkv), si = seg ? seg[size_t(b) * S + i] : 1;
  const size_t qi = ((size_t(b) * S + i) * Hq + h) * D;
  const T *qr = q + qi, *dor = dout + qi;
  float acc[WIDE_PER];
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) acc[c] = 0.f;
  const float li = lse[(size_t(b) * Hq + h) * S + i], dii = di[(size_t(b) * S + i) * Hq + h];
  for (int j = 0; j <= i; ++j) {
    if (seg && seg[size_t(b) * S + j] != si) continue;
    const size_t kv = ((size_t(b) * S + j) * Hkv + hk) * D;
    const float p = expf(row_dot(qr, k + kv, D, lane) * scale - li);
    const float ds = p * (row_dot(dor, v + kv, D, lane) - dii);
#pragma unroll
    for (int c = 0; c < WIDE_PER; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < D) acc[c] = fmaf(ds, to_f32(k[kv + col]), acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) {
    const int col = c0 + lane + 32 * c;
    if (col < D) dq[qi + col] = from_f32<T>(acc[c] * scale);
  }
}

// one warp a (key row, kv head, column slice): the rep query heads and the
// rows at or below it
template <typename T>
__global__ void __launch_bounds__(F32_ROWS * 32)
    train_attn_dkv_cores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const int* __restrict__ seg,
                                const T* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ di, T* __restrict__ dk,
                                T* __restrict__ dv, int S, int Hq, int Hkv, int D, float scale) {
  int b, c0;
  core_slice(D, b, c0);
  const int hk = blockIdx.y, lane = threadIdx.x & 31;
  const int j = blockIdx.x * F32_ROWS + (threadIdx.x >> 5);
  if (j >= S) return;
  const int rep = Hq / Hkv, sj = seg ? seg[size_t(b) * S + j] : 1;
  const size_t kv = ((size_t(b) * S + j) * Hkv + hk) * D;
  const T *kr = k + kv, *vr = v + kv;
  float ak[WIDE_PER], av[WIDE_PER];
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) ak[c] = av[c] = 0.f;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int i = j; i < S; ++i) {
      if (seg && seg[size_t(b) * S + i] != sj) continue;
      const size_t qi = ((size_t(b) * S + i) * Hq + h) * D;
      const float li = lse[(size_t(b) * Hq + h) * S + i];
      const float p = expf(row_dot(kr, q + qi, D, lane) * scale - li);
      const float ds = p * (row_dot(vr, dout + qi, D, lane) - di[(size_t(b) * S + i) * Hq + h]);
#pragma unroll
      for (int c = 0; c < WIDE_PER; ++c) {
        const int col = c0 + lane + 32 * c;
        if (col < D) {
          av[c] = fmaf(p, to_f32(dout[qi + col]), av[c]);
          ak[c] = fmaf(ds, to_f32(q[qi + col]), ak[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < WIDE_PER; ++c) {
    const int col = c0 + lane + 32 * c;
    if (col < D) {
      dv[kv + col] = from_f32<T>(av[c]);
      dk[kv + col] = from_f32<T>(ak[c] * scale);
    }
  }
}

// ---- launch ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *seg, *dout, *lse_in, *di;
  void *o0, *o1, *lse_out;
  int B, S, Hq, Hkv, D;
  float scale;
  int cluster;  // CTAs a cluster (ops/train_attention.py: fwd_plan, dkv_plan, dq_plan)
};

enum Which { kFwd = 0, kDkv = 1, kDq = 2 };

template <int DT>
cudaError_t launch_bf16(Which w, const Args& a, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const auto* seg = static_cast<const int*>(a.seg);
  CUtensorMap qm, km, vm, om;  // 64-row boxes of q, k, v and (backward) dout
  if (!tensor_map_bshd(&qm, a.q, a.B, a.S, a.Hq, a.D, TQ) ||
      !tensor_map_bshd(&km, a.k, a.B, a.S, a.Hkv, a.D, TK) ||
      !tensor_map_bshd(&vm, a.v, a.B, a.S, a.Hkv, a.D, TK) ||
      (w != kFwd && !tensor_map_bshd(&om, a.dout, a.B, a.S, a.Hq, a.D, TQ)))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (w == kFwd) {
    using F = Fwd<DT>;
    auto kern = train_attn_fwd_kernel<DT>;
    if ((err = allow_smem(kern, F::SMEM)) != cudaSuccess) return err;
    kern<<<dim3(a.Hq, a.B, (a.S + TQ - 1) / TQ), F::THREADS, F::SMEM, s>>>(
        qm, km, vm, seg, static_cast<bf*>(a.o0), static_cast<float*>(a.lse_out), a.S, a.Hq, a.Hkv,
        a.D, a.scale);
  } else if (w == kDkv) {  // on clusters of a.cluster CTAs, the grid of dkv_plan
    const dim3 grid(a.cluster, (a.S + TK - 1) / TK * a.Hkv, a.B);
    const auto* lse = static_cast<const float*>(a.lse_in);
    const auto* di = static_cast<const float*>(a.di);
    if constexpr (DT <= 128)
      return launch_cluster_block(train_attn_dkv_ws_kernel<DT>, grid, 2 * kWg + 32, a.cluster,
                                  DkvWs<DT>::SMEM, false, s, qm, km, vm, om, seg, lse, di,
                                  static_cast<bf*>(a.o0), static_cast<bf*>(a.o1), a.S, a.Hq,
                                  a.Hkv, a.D, a.scale);
    else  // 128 < D <= 256: two walks, D's columns split between the warpgroups
      return launch_cluster_block(train_attn_dkv_wide_kernel, grid, 2 * kWg + 32, a.cluster,
                                  DkvWide::SMEM, false, s, qm, km, vm, om, seg, lse, di,
                                  static_cast<bf*>(a.o0), static_cast<bf*>(a.o1), a.S, a.Hq,
                                  a.Hkv, a.D, a.scale);
  } else {  // dq
    using P = DqWs<DT>;
    auto kern = train_attn_dq_ws_kernel<DT>;
    if ((err = allow_smem(kern, P::SMEM)) != cudaSuccess) return err;
    kern<<<dim3(a.Hq, a.B, (a.S + TQ - 1) / TQ), P::THREADS, P::SMEM, s>>>(
        qm, km, vm, om, seg, static_cast<const float*>(a.lse_in), static_cast<const float*>(a.di),
        static_cast<bf*>(a.o0), a.S, a.Hq, a.Hkv, a.D, a.scale);
  }
  return cudaGetLastError();
}

// SPLIT: the clusters above D = 128 (DT = 128, D <= 1024) that split D's
// columns, a.cluster CTAs a cluster (dkv: ns head-rank splits; the forward
// and dq: ns along x, the CTAs of a query head)
template <int DT, bool SPLIT = false>
cudaError_t launch_tf32(Which w, const Args& a, cudaStream_t s) {
  // dkv: 64-row boxes of k, v (resident), TS-row boxes of q, dout (streamed);
  // the forward and dq the other way round (the forward has no dout)
  const uint32_t rq = w == kDkv ? TS : TQ, rk = w == kDkv ? TK : TS;
  CUtensorMap qm, km, vm, om;
  if (!tensor_map_bshd_f32(&qm, a.q, a.B, a.S, a.Hq, a.D, rq) ||
      !tensor_map_bshd_f32(&km, a.k, a.B, a.S, a.Hkv, a.D, rk) ||
      !tensor_map_bshd_f32(&vm, a.v, a.B, a.S, a.Hkv, a.D, rk) ||
      (w != kFwd && !tensor_map_bshd_f32(&om, a.dout, a.B, a.S, a.Hq, a.D, rq)))
    return cudaErrorInvalidValue;
  const auto* seg = static_cast<const int*>(a.seg);
  const dim3 fgrid(a.Hq, a.B, (a.S + TQ - 1) / TQ);
  if (w == kFwd) {
    auto* o = static_cast<float*>(a.o0);
    auto* lse = static_cast<float*>(a.lse_out);
    if constexpr (SPLIT)
      return launch_cluster_block(train_attn_fwd_tf32_split_kernel,
                                  dim3(a.cluster * fgrid.x, fgrid.y, fgrid.z), kWg + 32,
                                  a.cluster, FwdTf32<DT, true>::SMEM, false, s, qm, km, vm, seg, o,
                                  lse, a.S, a.Hq, a.Hkv, a.D, a.scale);
    auto kern = train_attn_fwd_tf32_kernel<DT>;
    cudaError_t err = allow_smem(kern, FwdTf32<DT>::SMEM);
    if (err != cudaSuccess) return err;
    kern<<<fgrid, kWg + 32, FwdTf32<DT>::SMEM, s>>>(qm, km, vm, seg, o, lse, a.S, a.Hq, a.Hkv,
                                                   a.D, a.scale);
    return cudaGetLastError();
  }
  const auto* lse = static_cast<const float*>(a.lse_in);
  const auto* di = static_cast<const float*>(a.di);
  if (w == kDkv) {  // on clusters of a.cluster CTAs, the grid of dkv_plan
    auto kern = train_attn_dkv_tf32_kernel<DT>;
    if constexpr (SPLIT) kern = train_attn_dkv_tf32_split_kernel;
    return launch_cluster_block(kern, dim3(a.cluster, (a.S + TK - 1) / TK * a.Hkv, a.B),
                                kWg + 32, a.cluster, DkvTf32<DT, SPLIT>::SMEM, false, s, qm, km,
                                vm, om, seg, lse, di, static_cast<float*>(a.o0),
                                static_cast<float*>(a.o1), a.S, a.Hq, a.Hkv, a.D, a.scale);
  }
  auto* dq = static_cast<float*>(a.o0);
  if constexpr (SPLIT)
    return launch_cluster_block(train_attn_dq_tf32_split_kernel,
                                dim3(a.cluster * fgrid.x, fgrid.y, fgrid.z), kWg + 32,
                                a.cluster, DqTf32<DT, true>::SMEM, false, s, qm, km, vm, om, seg,
                                lse, di, dq, a.S, a.Hq, a.Hkv, a.D, a.scale);
  auto kern = train_attn_dq_tf32_kernel<DT>;
  cudaError_t err = allow_smem(kern, DqTf32<DT>::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<fgrid, kWg + 32, DqTf32<DT>::SMEM, s>>>(qm, km, vm, om, seg, lse, di, dq, a.S, a.Hq,
                                                  a.Hkv, a.D, a.scale);
  return cudaGetLastError();
}

// the CUDA-core kernels: the three above D = 1024 (both dtypes)
template <typename T>
cudaError_t launch_cores(Which w, const Args& a, cudaStream_t s) {
  const dim3 grid((a.S + F32_ROWS - 1) / F32_ROWS, w == kDkv ? a.Hkv : a.Hq,
                  a.B * ((a.D + WIDE_COLS - 1) / WIDE_COLS));
  const auto* q = static_cast<const T*>(a.q);
  const auto* k = static_cast<const T*>(a.k);
  const auto* v = static_cast<const T*>(a.v);
  const auto* seg = static_cast<const int*>(a.seg);
  const auto* dout = static_cast<const T*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse_in);
  const auto* di = static_cast<const float*>(a.di);
  if (w == kDq)
    train_attn_dq_cores_kernel<T><<<grid, F32_ROWS * 32, 0, s>>>(
        q, k, v, seg, dout, lse, di, static_cast<T*>(a.o0), a.S, a.Hq, a.Hkv, a.D, a.scale);
  else if (w == kFwd)
    train_attn_fwd_cores_kernel<T><<<grid, F32_ROWS * 32, 0, s>>>(
        q, k, v, seg, static_cast<T*>(a.o0), static_cast<float*>(a.lse_out), a.S, a.Hq, a.Hkv,
        a.D, a.scale);
  else
    train_attn_dkv_cores_kernel<T><<<grid, F32_ROWS * 32, 0, s>>>(
        q, k, v, seg, dout, lse, di, static_cast<T*>(a.o0), static_cast<T*>(a.o1), a.S, a.Hq,
        a.Hkv, a.D, a.scale);
  return cudaGetLastError();
}

// The route (ops/train_attention.py: fwd_plan, dkv_plan, dq_plan). bf16: the
// wgmma kernels up to D = 256. f32: 3xTF32 up to 128; above, the same
// kernels on splits of ns = split_ctas(D) CTAs a cluster up to 1024. bf16
// at 256 < D <= 1024 is the f32 splits on f32 copies, which the wrapper
// makes: refused here. The CUDA cores above 1024, both dtypes. The clusters
// each takes: dkv ns min(rep, 8 / ns) CTAs (ns = 1 for bf16: min(rep, 8)),
// the forward and dq ns, 1 on the CUDA cores; any other is refused.
cudaError_t dispatch(Which w, const Args& a, int f32, void* stream) {
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.Hq % a.Hkv || a.D < 16 || a.D % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = a.Hq / a.Hkv, ns = f32 ? split_ctas(a.D) : 1;
  const bool cores = a.D > kSplitCols * kMaxSplit;
  if (!f32 && !cores && a.D > 256) return cudaErrorInvalidValue;  // bf16 there: widened
  const int cluster = cores ? 1 : w == kDkv ? ns * std::min(rep, kMaxCluster / ns) : ns;
  if (a.cluster != cluster) return cudaErrorInvalidValue;
  if (cores)
    return f32 ? launch_cores<float>(w, a, s) : launch_cores<__nv_bfloat16>(w, a, s);
  if (ns > 1) return launch_tf32<128, true>(w, a, s);
  if (f32) return a.D <= 64 ? launch_tf32<64>(w, a, s) : launch_tf32<128>(w, a, s);
  if (a.D <= 64) return launch_bf16<64>(w, a, s);
  if (a.D <= 128) return launch_bf16<128>(w, a, s);
  return launch_bf16<256>(w, a, s);
}

}  // namespace

extern "C" {

// All tensors contiguous, on one device: q, out [B, S, Hq, D] and k, v
// [B, S, Hkv, D] of one dtype (f32 = 0: bfloat16, 16-byte aligned; 1:
// float32); seg [B, S] int32 or null; lse [B, Hq, S] f32. D a multiple of
// 16 (above 1024: the CUDA-core kernels), Hq a multiple of Hkv; scale
// the real D's 1/sqrt(D) (the wrapper pads other D). Each returns 0 once
// launched, else the CUDA error. bf16 at 256 < D <= 1024 is refused (the
// wrapper passes f32 copies there). cluster: ns = ceil(D / 128) for f32 at
// 128 < D <= 1024, else 1 (fwd_plan).
int bd_train_attn_fwd(const void* q, const void* k, const void* v, const void* seg, void* out,
                      void* lse, int B, int S, int Hq, int Hkv, int D, float scale, int cluster,
                      int f32, void* stream) {
  const Args a{q, k, v, seg, nullptr, nullptr, nullptr, out, nullptr, lse,
               B, S, Hq, Hkv, D, scale, cluster};
  return dispatch(kFwd, a, f32, stream);
}

// dout [B, S, Hq, D], lse [B, Hq, S] f32 (the forward's), di [B, S, Hq] f32
// (rowsum(o * dout)); writes dk, dv [B, S, Hkv, D] in the inputs' dtype
// (bf16 at 256 < D <= 1024 refused, as the forward's). cluster: ns
// min(Hq / Hkv, 8 / ns), ns = ceil(D / 128) for f32 above D = 128, else 1;
// above D = 1024, 1 (dkv_plan). A cluster the card cannot hold launches
// nothing and returns the error.
int bd_train_attn_dkv(const void* q, const void* k, const void* v, const void* seg,
                      const void* dout, const void* lse, const void* di, void* dk, void* dv,
                      int B, int S, int Hq, int Hkv, int D, float scale, int cluster, int f32,
                      void* stream) {
  const Args a{q, k, v, seg, dout, lse, di, dk, dv, nullptr, B, S, Hq, Hkv, D, scale, cluster};
  return dispatch(kDkv, a, f32, stream);
}

// The same inputs; writes dq [B, S, Hq, D] in the inputs' dtype. cluster:
// ns for f32 at 128 < D <= 1024, else 1 (dq_plan).
int bd_train_attn_dq(const void* q, const void* k, const void* v, const void* seg,
                     const void* dout, const void* lse, const void* di, void* dq, int B, int S,
                     int Hq, int Hkv, int D, float scale, int cluster, int f32, void* stream) {
  const Args a{q, k, v, seg, dout, lse, di, dq, nullptr, nullptr, B, S, Hq, Hkv, D, scale, cluster};
  return dispatch(kDq, a, f32, stream);
}

}  // extern "C"
