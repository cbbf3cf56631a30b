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
// (query heads a kv head) is 1, 2, 4 or 8, D 32, 64 or 128.
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
  static constexpr int EPL = REP == 1 ? 16 : REP == 2 ? 8 : 4;
  static constexpr int LPR = D / EPL;                   // lanes a row: 2 .. 32
  static constexpr int RPW = 32 / LPR;                  // rows a warp at once
  static constexpr int STEPS = RPW >= 4 ? 1 : 4 / RPW;  // steps a run: at least 4 rows a run
  static constexpr int ROWS = RPW * STEPS;              // rows a run
  static constexpr int VEC = int(16 / sizeof(KV)) < EPL ? int(16 / sizeof(KV)) : EPL;
  static constexpr int NV = EPL / VEC;
  static constexpr int ROW = D * int(sizeof(KV));       // 32 .. 256 bytes, whole 16-byte pieces
  static constexpr int CH = ROW / 16;
  static constexpr int PIECES = 2 * ROWS * CH;          // 16-byte copies a run
  static constexpr int PPL = (PIECES + 31) / 32;        // ... a lane
  static constexpr int SLOT = 2 * ROWS * ROW + (kQuant ? 2 * ROWS * 4 : 0);
  static constexpr int RING = kWarps * FD_STAGES * SLOT;
  static constexpr int MERGE = kWarps * REP * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
  static_assert(LPR >= 1 && LPR <= 32 && EPL % VEC == 0, "a row spans whole lanes");
};

// KV: cache dtype (bf16, or int8 with f32 scales); q, fresh k/v and out are
// bf16. Two CTAs an SM (a 64 KB ring each at D = 128), one at rep 8.
template <typename KV, int REP, int D>
__global__ void __launch_bounds__(kThreads, REP == 8 ? 1 : 2)
    fd_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ ck,
              const KV* __restrict__ cv, const float* __restrict__ ks,
              const float* __restrict__ vs, const __nv_bfloat16* __restrict__ kn,
              const __nv_bfloat16* __restrict__ vn, const int* __restrict__ start,
              __nv_bfloat16* __restrict__ out, int Hkv, int T_len, int t_lim, int window,
              float scale) {
  using P = Fd<KV, REP, D>;
  constexpr bool kQuant = P::kQuant;
  constexpr int EPL = P::EPL, LPR = P::LPR, RPW = P::RPW, STEPS = P::STEPS, ROWS = P::ROWS;
  constexpr int VEC = P::VEC, NV = P::NV, CH = P::CH;
  constexpr int STEP = kWarps * ROWS;  // rows between a warp's runs
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float cta_m[REP], cta_l[REP], s_new[REP];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, j = lane % LPR;  // the lane's row of a step, its place in the row
  const float qs = scale * kLog2e;             // scores in log2 units: exp2 below
  const size_t plane = size_t(b) * Hkv + h;
  const size_t q0 = (plane * REP) * D;         // query head h*REP + r

  const int st = start[b];  // first: the copies wait for it
  const int t_hi = min(st, t_lim);
  const int t_lo = window > 0 ? max(0, st - window + 1) : 0;
  const int n = max(t_hi - t_lo, 0);
  const int lo = t_lo + rank * n / C, hi = t_lo + (rank + 1) * n / C;  // this CTA's run
  const uint8_t* kp = reinterpret_cast<const uint8_t*>(ck + plane * T_len * D);
  const uint8_t* vp = reinterpret_cast<const uint8_t*>(cv + plane * T_len * D);
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
    p_row[k] = i < P::PIECES ? u : ROWS;  // ROWS: no piece
    p_src[k] = u * P::ROW + c * 16;
    p_dst[k] = ((p_v[k] ? ROWS : 0) + u) * P::ROW + c * 16;
  }
  auto issue = [&](int jr) {  // run jr of this warp; always one commit group
    if (jr < runs) {
      uint8_t* sl = ring + (jr % FD_STAGES) * P::SLOT;
      const int t0 = first + jr * STEP;
      const size_t base = size_t(t0) * P::ROW;
#pragma unroll
      for (int k = 0; k < P::PPL; ++k) {
        if (p_row[k] < ROWS) {
          const bool ok = t0 + p_row[k] < hi;  // rows past the run: zeros, masked below
          const uint8_t* src = (p_v[k] ? vp : kp) + base + p_src[k];
          cp_async16(sl + p_dst[k], ok ? src : kp, ok ? 16 : 0);
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
      for (int i = 0; i < VEC; ++i)
        qr[r][c * VEC + i] = to_f32(q[q0 + size_t(r) * D + (c * LPR + j) * VEC + i]);
  constexpr int OUTS = (REP * D + kThreads - 1) / kThreads;  // outputs a thread
  float knr[EPL], vnr[OUTS];
  if (rank == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        knr[c * VEC + i] = to_f32(kn[plane * D + (c * LPR + j) * VEC + i]);
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int idx = threadIdx.x + o * kThreads;
      vnr[o] = idx < REP * D ? to_f32(vn[plane * D + idx % D]) : 0.f;
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
    out[(plane * REP) * D + threadIdx.x + o * kThreads] =
        from_f32<__nv_bfloat16>((a * alpha + pn * vnr[o]) / (lsum * alpha + pn));
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

template <typename KV, int REP, int D>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* ks, const void* vs,
                   const void* kn, const void* vn, const void* start, void* out, int B, int Hkv,
                   int T_len, int t_lim, int window, float scale, int cluster,
                   cudaStream_t stream) {
  return launch_cluster(
      fd_kernel<KV, REP, D>, dim3(cluster, Hkv, B), cluster, Fd<KV, REP, D>::SMEM, false, stream,
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(ck), static_cast<const KV*>(cv),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const __nv_bfloat16*>(kn), static_cast<const __nv_bfloat16*>(vn),
      static_cast<const int*>(start), static_cast<__nv_bfloat16*>(out), Hkv, T_len, t_lim, window,
      scale);
}

template <typename KV>
cudaError_t launch_shape(int rep, int d, const void* q, const void* ck, const void* cv,
                         const void* ks, const void* vs, const void* kn, const void* vn,
                         const void* start, void* out, int B, int Hkv, int T_len, int t_lim,
                         int window, float scale, int cluster, cudaStream_t stream) {
#define BD_FD_CASE(REP, D)                                                                \
  if (rep == REP && d == D)                                                               \
    return launch<KV, REP, D>(q, ck, cv, ks, vs, kn, vn, start, out, B, Hkv, T_len, t_lim,   \
                              window, scale, cluster, stream);
  BD_FD_CASE(1, 128) BD_FD_CASE(2, 128) BD_FD_CASE(4, 128) BD_FD_CASE(8, 128)
  BD_FD_CASE(1, 64) BD_FD_CASE(2, 64) BD_FD_CASE(4, 64) BD_FD_CASE(8, 64)
  BD_FD_CASE(1, 32) BD_FD_CASE(2, 32) BD_FD_CASE(4, 32) BD_FD_CASE(8, 32)
#undef BD_FD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D]; ck/cv: layer li of the stacked cache, [B, Hkv, T, D],
// 16-byte aligned; ks/vs: layer li of the [L, B, Hkv, T] f32 scales (int8
// cache) or null; kn/vn [B, Hkv, D]; start [B] int32; out [B, Hkv*rep, D].
// window <= 0 means none; t_lim bounds the rows read (attn_len, or T).
// q, kn, vn and out are bfloat16; int8_cache = 0 for a bfloat16 cache, 1 for
// int8 codes with scales. Clusters of 1 <= cluster <= 8 CTAs a (slot, kv
// head) (ops/decode_attention.py: attention_plan); a cluster the card cannot
// hold launches nothing and returns its error. Returns 0 once launched,
// else the CUDA error.
int bd_flash_decode(const void* q, const void* ck, const void* cv, const void* ks,
                    const void* vs, const void* kn, const void* vn, const void* start,
                    void* out, int int8_cache, int B, int Hkv, int rep, int T_len, int D,
                    int t_lim, int window, float scale, int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || !aligned16(ck) || !aligned16(cv) ||
      (int8_cache && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_cache)
    return launch_shape<int8_t>(rep, D, q, ck, cv, ks, vs, kn, vn, start, out, B, Hkv, T_len,
                                t_lim, window, scale, cluster, s);
  return launch_shape<__nv_bfloat16>(rep, D, q, ck, cv, ks, vs, kn, vn, start, out, B, Hkv, T_len,
                                     t_lim, window, scale, cluster, s);
}

}  // extern "C"
