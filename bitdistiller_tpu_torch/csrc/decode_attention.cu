// Single-token (S=1) GQA decode attention over the stacked head-major KV
// cache, for Hopper (sm_90a), plain C interface for ctypes
// (bitdistiller_tpu_torch/ops/decode_attention.py).
//
// Replaces the TPU kernel bitdistiller_tpu/ops/decode_attention.py:_fd2_kernel
// (:106, pallas_call at :314 in flash_decode_stacked) and, called on one
// layer's cache, the first-generation per-layer kernel
// bitdistiller_tpu/experimental/flash_decode.py:_fd_kernel (:33, pallas_call
// at :150 in flash_decode_attention). Same semantics: cache
// rows t < start[b] are valid (and t < attn_len; with a window only
// t > start - window), the fresh token at position `start` is folded in
// last, softmax in f32. For an int8 cache the per-(head, token) f32 scales
// multiply the score row and the prob row, so codes are never dequantized
// into memory. The layer is a pointer offset into the stacked cache (the
// caller passes ck[li].data_ptr(), a view): no layer is copied. GQA rep
// (query heads a kv head) 1, 2, 4 or 8 at D 32, 64, 128 or 256 (a row on at
// most 32 lanes) has an instance of its own; any other rep and D up to 512
// take the general route (below); q, the fresh k/v and the output are bf16
// or f32.
//
// Bound on this card: bytes. Each valid K and V row (D elements of the cache
// dtype, plus one f32 scale each for int8) must be read once from HBM at
// 3.35 TB/s; the arithmetic is 4*D flops a row and a head. The rows of a
// (slot, kv head) are as many as the slot's length, so the longest slot
// sets the time unless its rows are split; and at 2-4 bytes a row element
// the instructions a row, not the bytes, set the pace unless they are few.
// Design:
//   * a thread block cluster of C CTAs a (slot, kv head), the grid (C, Hkv,
//     B); each CTA reads start[b], computes the slot's valid range and takes
//     the rank-th of C contiguous runs of it (a run may be empty), so a long
//     slot spreads over C SMs with no host plan (C: ops/decode_attention.py:
//     attention_plan);
//   * a row is held by LPR = D / EPL lanes, EPL = 16, 8 or 4 elements each
//     (fewer as rep grows, for registers), so a warp takes 32 / LPR rows at
//     once, one a lane group, and a score needs log2(LPR) shuffles: at rep 1
//     and D = 128, 8 lanes a row and 4 rows a warp instruction;
//   * the CTA's 8 warps take interleaved runs of ROWS consecutive rows; a
//     warp streams its runs' K and V rows (and int8 scales) through a
//     cp.async ring of its own, FD_STAGES - 1 runs ahead, waiting on its own
//     copies only, and each lane group keeps an online softmax in f32 (on
//     log2-scaled scores, exp2) for the rep query heads of the group, so one
//     read of a K/V row serves them all;
//   * the lane groups' (max, sum, acc) are merged by shuffles, the warps' in
//     shared memory (over the drained rings) into the CTA's state, then rank
//     0 merges the C states in rank order through distributed shared memory
//     (a cluster of one finishes alone, with no cluster barrier), folds the
//     fresh token last and normalises: deterministic, no atomics, no partial
//     planes in HBM. An empty run contributes m = -1e30, l = 0.
// The general route (GEN): the same kernel on a head tile of REP = RT = 2
// query heads (1 at rep 1; tiles of 2 beat 1, 4 and 8 on the H100, PERF.md)
// and a width template D = DT in {32, .., 512}, the least at or above D,
// with the real rep and D taken at run time (ops/decode_attention.py:
// decode_tile mirrors the choice). The grid walks ceil(rep / RT) tiles a kv
// head (rep 71: 36 tiles of 2, each reading the kv head's rows once more,
// from L2);
// heads past rep are masked, and columns at or past D are zero in q, in the
// fresh k/v and in the ring (zeroed once), so they add nothing and are never
// stored. A cache row whose bytes are not whole 16-byte pieces (D * the
// element size not a multiple of 16) is copied by element, synchronously,
// in place of cp.async: the cache is read where it lies, never padded.

#include <type_traits>

#include "common.cuh"
#include "stream.cuh"

namespace {

using namespace bd;

constexpr float kNeg = -1e30f;  // as the TPU kernel: finite, so no inf - inf
constexpr float kLog2e = 1.4426950408889634f;
constexpr int FD_STAGES = 4;    // a warp's ring: FD_STAGES - 1 runs in flight

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// N contiguous elements at p (shared memory, 4 * N or N bytes aligned) -> f32
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  static_assert(N == 4 || N == 8, "bf16 vectors of 8 or 16 bytes");
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* o) {
  static_assert(N == 4 || N == 8 || N == 16, "int8 vectors of 4, 8 or 16 bytes");
  uint32_t w[N / 4];
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    o[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
}

// sum over the LANES lanes of a lane group (a power of two, aligned)
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The plan of one instantiation. A lane holds EPL elements of a row: NV
// vectors of VEC, lane j of a group vector c at elements (c * LPR + j) * VEC,
// so a group's lanes read consecutive 16-byte pieces. A warp's ring slot
// holds one run: ROWS K rows, ROWS V rows (ROW bytes each) and, for int8,
// their K and V scales; the warps' merge buffers (acc [kWarps][REP][D], m
// and l [kWarps][REP], f32) overlay the drained rings.
template <typename KV, int REP, int D>
struct Fd {
  static constexpr bool kQuant = sizeof(KV) == 1;
  // at most 32 lanes a row: D = 256 takes 8 elements a lane at rep >= 2
  static constexpr int EPL_REP = REP == 1 ? 16 : REP == 2 ? 8 : 4;
  static constexpr int EPL = EPL_REP > D / 32 ? EPL_REP : D / 32;
  static constexpr int LPR = D / EPL;                   // lanes a row: 2 .. 32
  static constexpr int RPW = 32 / LPR;                  // rows a warp at once
  static constexpr int ROW = D * int(sizeof(KV));       // 32 .. 1024 bytes, whole 16-byte pieces
  static constexpr int STEPS_4 = RPW >= 4 ? 1 : 4 / RPW;  // steps a run: at least 4 rows a run,
  static constexpr int STEPS_CAP = 2048 / (RPW * ROW) > 0 ? 2048 / (RPW * ROW) : 1;
  static constexpr int STEPS =  // ... but above D = 256 at most 2 KB of K rows a run (the rings)
      D > 256 && STEPS_CAP < STEPS_4 ? STEPS_CAP : STEPS_4;
  static constexpr int ROWS = RPW * STEPS;              // rows a run
  static constexpr int VEC = int(16 / sizeof(KV)) < EPL ? int(16 / sizeof(KV)) : EPL;
  static constexpr int NV = EPL / VEC;
  static constexpr int CH = ROW / 16;
  static constexpr int PIECES = 2 * ROWS * CH;          // 16-byte copies a run
  static constexpr int PPL = (PIECES + 31) / 32;        // ... a lane
  static constexpr int SLOT = 2 * ROWS * ROW + (kQuant ? 2 * ROWS * 4 : 0);
  static constexpr int RING = kWarps * FD_STAGES * SLOT;
  static constexpr int MERGE = kWarps * REP * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
  static_assert(LPR >= 1 && LPR <= 32 && EPL % VEC == 0, "a row spans whole lanes");
};

// KV: cache dtype (bf16, or int8 with f32 scales); QT: the dtype of q, the
// fresh k/v and out (bf16, or f32). Two CTAs an SM (a 64 KB ring each at
// D = 128), one at rep 8 and above D = 256. GEN: the general route, with
// the real head dim d_rt <= D and rep rep_rt, grid.y = Hkv * tiles (head
// tiles of REP); otherwise d_rt, rep_rt and tiles are not read.
template <typename KV, int REP, int D, typename QT, bool GEN>
__global__ void __launch_bounds__(kThreads, REP == 8 || D > 256 ? 1 : 2)
    fd_kernel(const QT* __restrict__ q, const KV* __restrict__ ck,
              const KV* __restrict__ cv, const float* __restrict__ ks,
              const float* __restrict__ vs, const QT* __restrict__ kn,
              const QT* __restrict__ vn, const int* __restrict__ start,
              QT* __restrict__ out, int Hkv, int T_len, int t_lim, int window,
              float scale, int d_rt, int rep_rt, int tiles) {
  using P = Fd<KV, REP, D>;
  constexpr bool kQuant = P::kQuant;
  constexpr int EPL = P::EPL, LPR = P::LPR, RPW = P::RPW, STEPS = P::STEPS, ROWS = P::ROWS;
  constexpr int VEC = P::VEC, NV = P::NV, CH = P::CH;
  constexpr int STEP = kWarps * ROWS;  // rows between a warp's runs
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float cta_m[REP], cta_l[REP], s_new[REP];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, j = lane % LPR;  // the lane's row of a step, its place in the row
  const float qs = scale * kLog2e;             // scores in log2 units: exp2 below
  // the real head dim and rep; the kv head, and the tile's first head and
  // its heads (GEN: of head tile blockIdx.y % tiles)
  const int dd = GEN ? d_rt : D, rr = GEN ? rep_rt : REP;
  const int h = GEN ? blockIdx.y / tiles : blockIdx.y;
  const int r0 = GEN ? (blockIdx.y - h * tiles) * REP : 0;
  const int nr = GEN ? min(REP, rr - r0) : REP;
  const size_t plane = size_t(b) * Hkv + h;
  const size_t qh0 = plane * rr + r0;  // query head row of the tile's head r: qh0 + r
  const int rowg = dd * int(sizeof(KV));  // a cache row's bytes
  const bool by16 = !GEN || rowg % 16 == 0;  // else copied by element

  const int st = start[b];  // first: the copies wait for it
  const int t_hi = min(st, t_lim);
  const int t_lo = window > 0 ? max(0, st - window + 1) : 0;
  const int n = max(t_hi - t_lo, 0);
  const int lo = t_lo + rank * n / C, hi = t_lo + (rank + 1) * n / C;  // this CTA's run
  const uint8_t* kp = reinterpret_cast<const uint8_t*>(ck + plane * T_len * dd);
  const uint8_t* vp = reinterpret_cast<const uint8_t*>(cv + plane * T_len * dd);
  const float* ksp = kQuant ? ks + plane * T_len : nullptr;
  const float* vsp = kQuant ? vs + plane * T_len : nullptr;
  uint8_t* ring = smem + warp * FD_STAGES * P::SLOT;
  const int first = lo + warp * ROWS;  // the warp's runs: first + jr * STEP
  const int runs = first < hi ? (hi - first + STEP - 1) / STEP : 0;

  // the lane's 16-byte pieces of a run: piece lane + 32k is row u of K (or
  // V), column piece c; the offsets do not change from run to run
  int p_row[P::PPL], p_src[P::PPL], p_dst[P::PPL];
  bool p_v[P::PPL];  // a V piece
#pragma unroll
  for (int k = 0; k < P::PPL; ++k) {
    const int i = lane + 32 * k, u = (i / CH) % ROWS, c = i % CH;
    p_v[k] = i / (ROWS * CH) == 1;
    p_row[k] = i < P::PIECES && c < rowg / 16 ? u : ROWS;  // ROWS: no piece
    p_src[k] = u * rowg + c * 16;
    p_dst[k] = ((p_v[k] ? ROWS : 0) + u) * P::ROW + c * 16;
  }
  auto issue = [&](int jr) {  // run jr of this warp; always one commit group
    if (jr < runs) {
      uint8_t* sl = ring + (jr % FD_STAGES) * P::SLOT;
      const int t0 = first + jr * STEP;
      if (by16) {
        const size_t base = size_t(t0) * rowg;
#pragma unroll
        for (int k = 0; k < P::PPL; ++k) {
          if (p_row[k] < ROWS) {
            const bool ok = t0 + p_row[k] < hi;  // rows past the run: zeros, masked below
            const uint8_t* src = (p_v[k] ? vp : kp) + base + p_src[k];
            cp_async16(sl + p_dst[k], ok ? src : kp, ok ? 16 : 0);
          }
        }
      } else {  // GEN, rows of dd elements that are not whole 16-byte pieces
        using Raw = std::conditional_t<sizeof(KV) == 1, uint8_t, uint16_t>;
        for (int i = lane; i < 2 * ROWS * dd; i += 32) {
          const int kv = i / (ROWS * dd), e = i - kv * ROWS * dd, u = e / dd, c = e - u * dd;
          const Raw* src = reinterpret_cast<const Raw*>(kv ? vp : kp) + size_t(t0 + u) * dd + c;
          reinterpret_cast<Raw*>(sl + (kv * ROWS + u) * P::ROW)[c] = t0 + u < hi ? *src : Raw(0);
        }
      }
      if constexpr (kQuant) {
        if (lane < 2 * ROWS) {
          const int u = lane % ROWS;
          const float* src = lane < ROWS ? ksp : vsp;
          const bool ok = t0 + u < hi;
          cp_async4(sl + 2 * ROWS * P::ROW + lane * 4, ok ? src + t0 + u : src, ok ? 4 : 0);
        }
      }
    }
    cp_commit();
  };
  if (GEN && dd < D) {  // columns dd .. D of every row of the warp's ring, zeroed once
    const int tb = (D - dd) * int(sizeof(KV));
    for (int i = lane; i < FD_STAGES * 2 * ROWS * tb; i += 32) {
      const int rw = i / tb, sl = rw / (2 * ROWS);
      ring[sl * P::SLOT + (rw - sl * 2 * ROWS) * P::ROW + rowg + (i - rw * tb)] = 0;
    }
    __syncwarp();
  }
#pragma unroll
  for (int jr = 0; jr < FD_STAGES - 1; ++jr) issue(jr);

  // q, and the fresh k and v that rank 0 folds in the end, are read after
  // the first copies are under way, so that their latency overlaps the
  // rows' rather than adding to the CTA's
  float qr[REP][EPL];  // the lane's elements (c * LPR + j) * VEC + i of each head
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int col = (c * LPR + j) * VEC + i;
        qr[r][c * VEC + i] =
            !GEN || (r < nr && col < dd) ? to_f32(q[(qh0 + r) * dd + col]) : 0.f;
      }
  constexpr int OUTS = (REP * D + kThreads - 1) / kThreads;  // outputs a thread
  float knr[EPL], vnr[OUTS];
  if (rank == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int col = (c * LPR + j) * VEC + i;
        knr[c * VEC + i] = !GEN || col < dd ? to_f32(kn[plane * dd + col]) : 0.f;
      }
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int idx = threadIdx.x + o * kThreads, col = idx % D;
      vnr[o] = idx < REP * D && (!GEN || col < dd) ? to_f32(vn[plane * dd + col]) : 0.f;
    }
  }

  float m[REP], l[REP], acc[REP][EPL];  // the lane group's online softmax
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  // the online softmax rescales once a run
  for (int jr = 0; jr < runs; ++jr) {
    cp_wait<FD_STAGES - 2>();  // this lane's copies of run jr landed
    __syncwarp();              // and the other lanes'; slot (jr - 1) is free
    issue(jr + FD_STAGES - 1);
    const uint8_t* sl = ring + (jr % FD_STAGES) * P::SLOT;
    const int t0 = first + jr * STEP;
    float kf[STEPS][EPL], vf[STEPS][EPL], ksc[STEPS], vsc[STEPS];
    bool ok[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int u = s * RPW + grp;  // the group's row of step s
      ok[s] = t0 + u < hi;
      const KV* kr = reinterpret_cast<const KV*>(sl + u * P::ROW);
      const KV* vr = reinterpret_cast<const KV*>(sl + (ROWS + u) * P::ROW);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        load_vec<VEC>(kr + (c * LPR + j) * VEC, kf[s] + c * VEC);
        load_vec<VEC>(vr + (c * LPR + j) * VEC, vf[s] + c * VEC);
      }
      const float* sc = reinterpret_cast<const float*>(sl + 2 * ROWS * P::ROW);
      ksc[s] = kQuant ? sc[u] : 1.f;
      vsc[s] = kQuant ? sc[ROWS + u] : 1.f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float sco[STEPS];
      float m_new = m[r];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        float d0 = 0.f, d1 = 0.f;  // two chains
#pragma unroll
        for (int e = 0; e < EPL; e += 2) {
          d0 = fmaf(qr[r][e], kf[s][e], d0);
          d1 = fmaf(qr[r][e + 1], kf[s][e + 1], d1);
        }
        sco[s] = group_sum<LPR>(d0 + d1) * qs;
        if (kQuant) sco[s] *= ksc[s];  // q.(s_t k_t) = s_t (q.k_t)
        if (!ok[s]) sco[s] = kNeg;
        m_new = fmaxf(m_new, sco[s]);
      }
      const float alpha = exp2f(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const float p = ok[s] ? exp2f(sco[s] - m_new) : 0.f;
        l[r] += p;
        // the prob row enters the PV product in the cache's precision, as
        // on the TPU: bf16(p) for bf16, bf16(p * s_t) for int8 codes
        const float pv = round_bf16(kQuant ? p * vsc[s] : p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pv, vf[s][e], acc[r][e]);
      }
      m[r] = m_new;
    }
  }

  // the warp's lane groups merged by shuffles (a fixed butterfly order)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float mw = m[r];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
    const float f = exp2f(m[r] - mw);
    l[r] *= f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] *= f;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
    m[r] = mw;
  }

  cp_wait<0>();
  __syncthreads();  // every ring drained: the merge buffers overlay them
  float* sm_acc = reinterpret_cast<float*>(smem);  // [kWarps][REP][D]
  float* sm_m = sm_acc + kWarps * REP * D;         // [kWarps][REP]
  float* sm_l = sm_m + kWarps * REP;
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (lane == 0) {
        sm_m[warp * REP + r] = m[r];
        sm_l[warp * REP + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          sm_acc[(warp * REP + r) * D + (c * LPR + j) * VEC + i] = acc[r][c * VEC + i];
    }
  }
  // the fresh token's score for query head r, by warp r of rank 0
  if (rank == 0 && warp < REP) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r != warp) continue;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], knr[e], d);
      d = group_sum<LPR>(d) * qs;
      if (lane == 0) s_new[r] = d;
    }
  }
  __syncthreads();

  // the fresh token folded last into a merged state (m, l, a) of query
  // head r, normalised; the thread's output o of this (slot, kv head)
  auto finish = [&](int o, int r, float mx, float lsum, float a) {
    const float sn = s_new[r];
    const float mf = fmaxf(mx, sn);
    const float alpha = exp2f(mx - mf);
    const float pn = exp2f(sn - mf);
    const int col = threadIdx.x + o * kThreads - r * D;
    if (GEN && (r >= nr || col >= dd)) return;  // a head past rep, a column past D
    out[(qh0 + r) * dd + col] = from_f32<QT>((a * alpha + pn * vnr[o]) / (lsum * alpha + pn));
  };

  // the CTA's state, its warps merged in order; with one CTA a cluster it is
  // the result, else acc lands in warp 0's slot (which only the thread of
  // that element reads) for rank 0 to merge
#pragma unroll
  for (int o = 0; o < OUTS; ++o) {
    const int idx = threadIdx.x + o * kThreads;
    if (idx >= REP * D) break;
    const int r = idx / D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * REP + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w * REP + r] - mx);
      lsum += sm_l[w * REP + r] * f;
      a += sm_acc[w * REP * D + idx] * f;
    }
    if (C == 1) {
      finish(o, r, mx, lsum, a);
    } else {
      sm_acc[idx] = a;
      if (idx - r * D == 0) {
        cta_m[r] = mx;
        cta_l[r] = lsum;
      }
    }
  }
  if (C == 1) return;  // no peer: no cluster barrier
  cluster.sync();      // every CTA's state in its shared memory

  if (rank == 0) {
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int idx = threadIdx.x + o * kThreads;
      if (idx >= REP * D) break;
      const int r = idx / D;
      float pm[kMaxCluster], pl[kMaxCluster], pa[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)  // all loads in flight, then the merge in rank order
        if (c < C) {
          pm[c] = cluster.map_shared_rank(cta_m, c)[r];
          pl[c] = cluster.map_shared_rank(cta_l, c)[r];
          pa[c] = cluster.map_shared_rank(sm_acc, c)[idx];
        }
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < C) mx = fmaxf(mx, pm[c]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < C) {
          const float f = exp2f(pm[c] - mx);
          lsum += pl[c] * f;
          a += pa[c] * f;
        }
      finish(o, r, mx, lsum, a);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its shared memory
}

struct FdArgs {
  const void *q, *ck, *cv, *ks, *vs, *kn, *vn, *start;
  void* out;
  int B, Hkv, rep, T_len, D, t_lim, window;
  float scale;
  int cluster;
};

template <typename KV, int REP, int D, typename QT, bool GEN>
cudaError_t launch(const FdArgs& a, cudaStream_t stream) {
  const int tiles = GEN ? (a.rep + REP - 1) / REP : 1;
  return launch_cluster(
      fd_kernel<KV, REP, D, QT, GEN>, dim3(a.cluster, a.Hkv * tiles, a.B), a.cluster,
      Fd<KV, REP, D>::SMEM, false, stream, static_cast<const QT*>(a.q),
      static_cast<const KV*>(a.ck), static_cast<const KV*>(a.cv), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const QT*>(a.kn),
      static_cast<const QT*>(a.vn), static_cast<const int*>(a.start), static_cast<QT*>(a.out),
      a.Hkv, a.T_len, a.t_lim, a.window, a.scale, a.D, a.rep, tiles);
}

template <typename KV, typename QT>
cudaError_t launch_shape(const FdArgs& a, cudaStream_t stream) {
  const int rep = a.rep, d = a.D;
#define BD_FD_CASE(REP, D) \
  if (rep == REP && d == D) return launch<KV, REP, D, QT, false>(a, stream);
  BD_FD_CASE(1, 256) BD_FD_CASE(2, 256) BD_FD_CASE(4, 256) BD_FD_CASE(8, 256)
  BD_FD_CASE(1, 128) BD_FD_CASE(2, 128) BD_FD_CASE(4, 128) BD_FD_CASE(8, 128)
  BD_FD_CASE(1, 64) BD_FD_CASE(2, 64) BD_FD_CASE(4, 64) BD_FD_CASE(8, 64)
  BD_FD_CASE(1, 32) BD_FD_CASE(2, 32) BD_FD_CASE(4, 32) BD_FD_CASE(8, 32)
#undef BD_FD_CASE
  // the general route: head tiles of 2 (1 at rep 1), the least width >= d
#define BD_FD_GEN(DT)                                                   \
  if (d <= DT) return rep == 1 ? launch<KV, 1, DT, QT, true>(a, stream) \
                               : launch<KV, 2, DT, QT, true>(a, stream);
  BD_FD_GEN(32) BD_FD_GEN(64) BD_FD_GEN(128) BD_FD_GEN(256) BD_FD_GEN(512)
#undef BD_FD_GEN
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_kv(int int8_cache, const FdArgs& a, cudaStream_t s) {
  if (int8_cache) return launch_shape<int8_t, QT>(a, s);
  return launch_shape<__nv_bfloat16, QT>(a, s);
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D]; ck/cv: layer li of the stacked cache, [B, Hkv, T, D],
// 16-byte aligned; ks/vs: layer li of the [L, B, Hkv, T] f32 scales (int8
// cache) or null; kn/vn [B, Hkv, D]; start [B] int32; out [B, Hkv*rep, D].
// window <= 0 means none; t_lim bounds the rows read (attn_len, or T).
// q, kn, vn and out are bfloat16 (q_f32 = 0) or float32 (1); int8_cache =
// 0 for a bfloat16 cache, 1 for int8 codes with scales. Rep 1, 2, 4 or 8
// at D 32, 64, 128 or 256 run an instance of their own; any other rep and
// D <= 512 the general route, whose grid holds ceil(rep / 2) head tiles a
// kv head (1 at rep 1). scale: 1/sqrt(D). Clusters of 1 <= cluster <= 8
// CTAs a (slot, kv head, head tile) (attention_plan); a cluster the card
// cannot hold launches nothing and returns its error. The cache is 16-byte
// aligned where a row is whole 16-byte pieces. Returns 0 once launched,
// else the CUDA error.
int bd_flash_decode(const void* q, const void* ck, const void* cv, const void* ks,
                    const void* vs, const void* kn, const void* vn, const void* start,
                    void* out, int int8_cache, int B, int Hkv, int rep, int T_len, int D,
                    int t_lim, int window, float scale, int cluster, int q_f32, void* stream) {
  const bool by16 = D * (int8_cache ? 1 : 2) % 16 == 0;
  if (cluster < 1 || cluster > kMaxCluster || rep < 1 || D < 1 ||
      (by16 && (!aligned16(ck) || !aligned16(cv))) ||
      (int8_cache && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  const FdArgs a{q, ck, cv, ks, vs, kn, vn, start, out, B, Hkv, rep, T_len, D, t_lim,
                 window, scale, cluster};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_f32) return launch_kv<float>(int8_cache, a, s);
  return launch_kv<__nv_bfloat16>(int8_cache, a, s);
}

}  // extern "C"
