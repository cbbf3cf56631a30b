// Native host-side quantize+pack for sub-byte weights (the port's own copy
// of the JAX package's native/packlib.cpp).
//
// Packing is a host preprocessing step (checkpoint conversion), so this is
// plain multithreaded C++ called through ctypes (quant/native.py), with no
// device involved.
//
// Semantics match quant/packing.py's quantize_pack_linear exactly:
//   * per-(output feature, K-group) asymmetric min/max quantization,
//     scale = max(max-min, 1e-5) / (2^bits - 1),
//     zero  = clamp(-rint(min/scale), 0, 2^bits-1)   [rint = half-to-even]
//   * pair layout: code k_local = i*2R + 2r + b  ->  word (g, r),
//     bit-field i + b*pack/2  (R = G/pack)
//
// Built by quant/native.py at first use: g++ -O3 -shared -fPIC -std=c++17
// -pthread packlib.cpp, into the package's git-ignored _build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PackDims {
  int64_t K, N;
  int bits, group, pack, R;
};

// Quantize + pack one K-group column-strip [G, N] starting at row g*G.
// w is row-major [K, N]; qweight row-major [K/pack, N]; scales/szeros [K/G, N].
void pack_group(const float* w, int64_t g, const PackDims& d, int32_t* qweight,
                float* scales, float* szeros) {
  const int64_t G = d.group;
  const int max_int = (1 << d.bits) - 1;
  const int half = d.pack / 2;
  const int64_t row0 = g * G;
  std::vector<int32_t> codes(G);
  for (int64_t n = 0; n < d.N; ++n) {
    float mx = w[row0 * d.N + n], mn = mx;
    for (int64_t k = 1; k < G; ++k) {
      float v = w[(row0 + k) * d.N + n];
      mx = std::max(mx, v);
      mn = std::min(mn, v);
    }
    float scale = std::max(mx - mn, 1e-5f) / max_int;
    float zero = -std::nearbyintf(mn / scale);  // rint: half-to-even
    zero = std::min(std::max(zero, 0.0f), float(max_int));
    scales[g * d.N + n] = scale;
    szeros[g * d.N + n] = zero * scale;
    for (int64_t k = 0; k < G; ++k) {
      float q = std::nearbyintf(w[(row0 + k) * d.N + n] / scale) + zero;
      codes[k] = (int32_t)std::min(std::max(q, 0.0f), float(max_int));
    }
    // pair layout pack
    const int64_t words_per_group = G / d.pack;  // == R
    for (int64_t r = 0; r < words_per_group; ++r) {
      uint32_t word = 0;
      for (int i = 0; i < half; ++i) {
        int64_t k_lo = (int64_t)i * 2 * d.R + 2 * r;
        int64_t k_hi = k_lo + 1;
        word |= (uint32_t)codes[k_lo] << (d.bits * i);
        word |= (uint32_t)codes[k_hi] << (d.bits * (i + half));
      }
      qweight[(g * d.R + r) * d.N + n] = (int32_t)word;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int quantize_pack(const float* w, int64_t K, int64_t N, int bits, int group,
                  int32_t* qweight, float* scales, float* szeros, int n_threads) {
  if (K <= 0 || N <= 0) return 1;
  if (bits != 2 && bits != 4 && bits != 8) return 2;
  if (group <= 0) group = (int)K;
  if (K % group != 0) return 3;
  int pack = 32 / bits;
  if (group % pack != 0) return 4;
  PackDims d{K, N, bits, group, pack, group / pack};
  int64_t n_groups = K / group;

  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min<int>(n_threads, (int)n_groups));
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&]() {
      int64_t g;
      while ((g = next.fetch_add(1)) < n_groups) {
        pack_group(w, g, d, qweight, scales, szeros);
      }
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Unpack codes back to int32 [K, N] (for verification / conversion).
int unpack(const int32_t* qweight, int64_t K, int64_t N, int bits, int group,
           int32_t* codes_out) {
  if (group <= 0) group = (int)K;
  int pack = 32 / bits;
  if (K % group != 0 || group % pack != 0) return 1;
  int half = pack / 2;
  int64_t R = group / pack;
  uint32_t mask = (1u << bits) - 1;
  for (int64_t g = 0; g < K / group; ++g) {
    for (int64_t r = 0; r < R; ++r) {
      const int32_t* row = qweight + (g * R + r) * N;
      for (int i = 0; i < half; ++i) {
        int64_t k_lo = g * group + (int64_t)i * 2 * R + 2 * r;
        int32_t* lo = codes_out + k_lo * N;
        int32_t* hi = codes_out + (k_lo + 1) * N;
        for (int64_t n = 0; n < N; ++n) {
          uint32_t word = (uint32_t)row[n];
          lo[n] = (int32_t)((word >> (bits * i)) & mask);
          hi[n] = (int32_t)((word >> (bits * (i + half))) & mask);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
