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
// (query heads a kv head) is 1, 2, 4 or 8; at rep 8 and D = 128 the merge
// buffer sm_acc is 32 KB of the 48 KB static shared memory.
//
// Bound on this card: bytes. Each valid K and V row (D elements of the cache
// dtype, plus one f32 scale each for int8) must be read once from HBM at
// 3.35 TB/s; the arithmetic is 4*D flops a row and a head. Design: one block
// per (b, kv head), so each block streams two contiguous [T, D] planes; its
// 8 warps take interleaved runs of rows, a warp reads a whole row as one coalesced
// line (D/32 elements a lane) and keeps an online softmax in f32 for the
// block's rep = Hq/Hkv query heads, so one read of a K/V row serves every
// query head of the group. A warp reads runs of 4 consecutive rows, all
// loads issued before the scores are reduced, to keep more bytes in flight. Only rows in [lo, min(start, attn_len)) are
// read. The warps' (max, sum, acc) are merged in shared memory, then the
// block folds the fresh token and normalises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;  // as the TPU kernel: finite, so no inf - inf
constexpr int kRows = 4;  // consecutive cache rows a warp reads per iteration

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// EPL contiguous elements at p -> f32, with one vector load where it fits.
template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* o) {
  if constexpr (EPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (EPL == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}

template <int EPL>
__device__ __forceinline__ void load_row(const int8_t* p, float* o) {
  if constexpr (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    o[0] = c.x; o[1] = c.y; o[2] = c.z; o[3] = c.w;
  } else if constexpr (EPL == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    o[0] = c.x; o[1] = c.y;
  } else {
    o[0] = *p;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T: dtype of q, fresh k/v and out (bf16); KV: cache dtype (bf16, or int8
// with f32 scales).
template <typename T, typename KV, int REP, int EPL>
__global__ void __launch_bounds__(kThreads)
    fd_kernel(const T* __restrict__ q, const KV* __restrict__ ck, const KV* __restrict__ cv,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const T* __restrict__ kn, const T* __restrict__ vn,
              const int* __restrict__ start, T* __restrict__ out, int Hkv, int T_len,
              int t_lim, int window, float scale) {
  constexpr int D = EPL * 32;
  constexpr bool kQuant = sizeof(KV) == 1;
  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][D];
  __shared__ float sm_snew[REP];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int st = start[b];
  const int t_hi = min(st, t_lim);
  const int t_lo = window > 0 ? max(0, st - window + 1) : 0;
  const size_t plane = size_t(b) * Hkv + h;
  const KV* kp = ck + plane * T_len * D + lane * EPL;
  const KV* vp = cv + plane * T_len * D + lane * EPL;
  const float* ksp = kQuant ? ks + plane * T_len : nullptr;
  const float* vsp = kQuant ? vs + plane * T_len : nullptr;
  const size_t q0 = (plane * REP) * D + lane * EPL;  // query head h*REP + r

  float qr[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = to_f32(q[q0 + size_t(r) * D + e]);

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  // each warp takes runs of kRows consecutive rows: their K and V loads are
  // all in flight before the first score is reduced, and the online softmax
  // rescales once a run
  for (int t0 = t_lo + warp * kRows; t0 < t_hi; t0 += kWarps * kRows) {
    float kf[kRows][EPL], vf[kRows][EPL], ksc[kRows], vsc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int t = min(t0 + u, t_hi - 1);  // clamped rows are masked below
      load_row<EPL>(kp + size_t(t) * D, kf[u]);
      load_row<EPL>(vp + size_t(t) * D, vf[u]);
      ksc[u] = kQuant ? __ldg(ksp + t) : 1.f;
      vsc[u] = kQuant ? __ldg(vsp + t) : 1.f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float s[kRows];
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], kf[u][e], d);
        s[u] = warp_sum(d) * scale;
        if (kQuant) s[u] *= ksc[u];  // q.(s_t k_t) = s_t (q.k_t)
        if (t0 + u >= t_hi) s[u] = kNeg;
        m_new = fmaxf(m_new, s[u]);
      }
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const float p = t0 + u < t_hi ? expf(s[u] - m_new) : 0.f;
        l[r] += p;
        // the prob row enters the PV product in the cache's precision, as
        // on the TPU: bf16(p) for bf16, bf16(p * s_t) for int8 codes
        float pv;
        if constexpr (kQuant) {
          pv = round_bf16(p * vsc[u]);
        } else {
          pv = round_bf16(p);
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pv, vf[u][e], acc[r][e]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  // the fresh token's score for query head r, by warp r
  if (warp < REP) {
    const size_t n0 = plane * D + lane * EPL;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r != warp) continue;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], to_f32(kn[n0 + e]), d);
      d = warp_sum(d) * scale;
      if (lane == 0) sm_snew[r] = d;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < REP * D; idx += kThreads) {
    const int r = idx / D;
    const int dd = idx - r * D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][dd] * f;
    }
    const float sn = sm_snew[r];
    const float mf = fmaxf(mx, sn);
    const float alpha = expf(mx - mf);
    const float pn = expf(sn - mf);
    const float vnv = to_f32(vn[plane * D + dd]);
    out[(plane * REP + r) * D + dd] = from_f32<T>((a * alpha + pn * vnv) / (lsum * alpha + pn));
  }
}

template <typename T, typename KV, int REP, int EPL>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* ks,
                   const void* vs, const void* kn, const void* vn, const void* start,
                   void* out, int B, int Hkv, int T_len, int t_lim, int window, float scale,
                   cudaStream_t stream) {
  dim3 grid(Hkv, B);
  fd_kernel<T, KV, REP, EPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(ck), static_cast<const KV*>(cv),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const T*>(kn), static_cast<const T*>(vn), static_cast<const int*>(start),
      static_cast<T*>(out), Hkv, T_len, t_lim, window, scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_shape(int rep, int d, const void* q, const void* ck, const void* cv,
                         const void* ks, const void* vs, const void* kn, const void* vn,
                         const void* start, void* out, int B, int Hkv, int T_len, int t_lim,
                         int window, float scale, cudaStream_t stream) {
#define BD_FD_CASE(REP, EPL)                                                            \
  if (rep == REP && d == EPL * 32)                                                      \
    return launch<T, KV, REP, EPL>(q, ck, cv, ks, vs, kn, vn, start, out, B, Hkv, T_len, \
                                   t_lim, window, scale, stream);
  BD_FD_CASE(1, 4) BD_FD_CASE(2, 4) BD_FD_CASE(4, 4) BD_FD_CASE(8, 4)
  BD_FD_CASE(1, 2) BD_FD_CASE(2, 2) BD_FD_CASE(4, 2) BD_FD_CASE(8, 2)
  BD_FD_CASE(1, 1) BD_FD_CASE(2, 1) BD_FD_CASE(4, 1) BD_FD_CASE(8, 1)
#undef BD_FD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Hkv*rep, D]; ck/cv: layer li of the stacked cache, [B, Hkv, T, D];
// ks/vs: layer li of the [L, B, Hkv, T] f32 scales (int8 cache) or null;
// kn/vn [B, Hkv, D]; start [B] int32; out [B, Hkv*rep, D]. window <= 0 means
// none; t_lim bounds the rows read (attn_len, or T).
// q, kn, vn and out are bfloat16; int8_cache = 0 for a bfloat16 cache, 1 for
// int8 codes with scales. Returns cudaGetLastError() after the launch.
int bd_flash_decode(const void* q, const void* ck, const void* cv, const void* ks,
                    const void* vs, const void* kn, const void* vn, const void* start,
                    void* out, int int8_cache, int B, int Hkv, int rep, int T_len, int D,
                    int t_lim, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8_cache)
    return launch_shape<__nv_bfloat16, int8_t>(rep, D, q, ck, cv, ks, vs, kn, vn, start, out, B,
                                               Hkv, T_len, t_lim, window, scale, s);
  return launch_shape<__nv_bfloat16, __nv_bfloat16>(rep, D, q, ck, cv, ks, vs, kn, vn, start,
                                                    out, B, Hkv, T_len, t_lim, window, scale, s);
}

}  // extern "C"
