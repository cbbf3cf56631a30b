// Building blocks of the port's streaming decode kernels (the A8 matmul at
// M <= 32 in quant_matmul_a8.cu, both phases of fused_mlp.cu): per-warp
// cp.async copies of column tiles of row-major 4-byte arrays into shared
// memory, programmatic dependent launch, and thread block clusters (the
// launch, its occupancy check, and a reduction over the cluster's CTAs
// through distributed shared memory).
//
// The decode kernels share one plan: a cluster of C CTAs owns a tile of
// output columns, CTA `rank` (= blockIdx.x; the grid's x extent is the
// cluster) walks K steps [rank*ng/C, (rank+1)*ng/C), and the C partial
// tiles are summed in rank order by the cluster itself: deterministic, no
// atomics, no second pass. Inside a CTA each warp owns COLS/8 of the
// columns and streams their words through a ring of its own, several
// groups ahead, waiting on its own copies only (cp.async.wait_group, then
// __syncwarp): no block barrier in the K loop, so the warps of an SM drift
// apart and keep its loads in flight.
// Inline code only; including it adds no symbol.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "hopper.cuh"

namespace bd {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the largest portable cluster

// ---- device: cp.async ------------------------------------------------------

// 16 bytes global -> shared; bytes past src_bytes (0..16) are zero-filled and
// not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp copies rows [0, rows) x columns [n0, n0 + WC) of a row-major
// array of 4-byte elements with N columns, starting at src (row 0), to dst,
// a row every ld elements. Columns past N are zero. vec: N % 4 == 0 and src
// 16-byte aligned, so 16-byte copies; else 4-byte ones. The lanes commit
// (cp_commit) themselves.
template <int WC>
__device__ __forceinline__ void warp_copy(uint32_t* dst, const void* src, int rows, int ld, int n0,
                                          int N, bool vec, int lane) {
  const uint32_t* s = static_cast<const uint32_t*>(src);
  constexpr int C4 = WC / 4;
  for (int i = lane; i < rows * C4; i += 32) {
    const int r = i / C4, c = (i - r * C4) * 4, n = n0 + c;
    uint32_t* d = dst + r * ld + c;
    const uint32_t* p = s + size_t(r) * N + n;
    if (vec) {
      const int ok = min(max(N - n, 0), 4);
      cp_async16(d, ok ? p : s, ok * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(d + j, n + j < N ? p + j : s, n + j < N ? 4 : 0);
    }
  }
}

// Zeros in rows [0, rows) x WC columns at dst, a row every ld elements (16-
// byte aligned): the half of a K step past K (K = 64 mod 128) that no copy
// reads. Plain shared stores, which the warp's lanes see after the
// __syncwarp that precedes every read of a ring slot, as they see the copies.
template <int WC>
__device__ __forceinline__ void warp_zero(uint32_t* dst, int rows, int ld, int lane) {
  constexpr int C4 = WC / 4;
  for (int i = lane; i < rows * C4; i += 32) {
    const int r = i / C4, c = (i - r * C4) * 4;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// for (i = first; i < total; i += step) use(i, load(i)), with the loads of
// U iterations issued before the first of their uses: U loads in flight a
// thread instead of one (a prologue that copies from L2 waits about one
// round trip rather than total / step of them).
template <int U, typename Load, typename Use>
__device__ __forceinline__ void pipelined(int first, int total, int step, Load load, Use use) {
  for (int base = first; base < total; base += U * step) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * step < total) v[u] = load(base + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * step < total) use(base + u * step, v[u]);
  }
}

// ---- device: programmatic dependent launch -----------------------------------

// Waits until the grids this one depends on have completed and their writes
// are visible (a no-op for a grid launched without the PDL attribute).
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the next grid in the stream, launched with the PDL attribute, start
// its blocks (it still waits in grid_dep_wait before reading this grid's
// results).
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---- host: cluster launch ---------------------------------------------------

// Launches `kernel` on `grid` with clusters of `cluster` CTAs along x (grid.x
// == cluster), blocks of `block` threads and `smem` bytes of dynamic shared
// memory; with `pdl` as a programmatic dependent of the stream's previous
// kernel. Refuses (returns an
// error, launches nothing) when the card cannot hold one such cluster:
// cudaOccupancyMaxActiveClusters of 0, or its own error for a size it does
// not take. The answer is cached per (kernel, cluster, smem), under a lock
// (ctypes releases the GIL, so two host threads may launch at once); a
// kernel's dynamic shared memory limit only grows (the largest size asked
// so far), so a cached size stays launchable. Clears the error state on
// failure, so a later cudaGetLastError() does not see it.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster_block(void (*kernel)(KArgs...), dim3 grid, int block, int cluster,
                                 size_t smem, bool pdl, cudaStream_t stream, Args... args) {
  static std::map<std::tuple<const void*, int, size_t>, cudaError_t> fits;
  static std::map<const void*, size_t> limit;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const auto key = std::make_tuple(fn, cluster, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  static std::mutex mu;
  std::unique_lock<std::mutex> lock(mu);
  auto it = fits.find(key);
  if (it == fits.end()) {
    cudaError_t err = cudaSuccess;
    if (smem > limit[fn]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess) limit[fn] = smem;
    }
    int n = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) cudaGetLastError();
    it = fits.emplace(key, err).first;
  }
  const cudaError_t fit = it->second;
  lock.unlock();
  if (fit != cudaSuccess) return fit;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// launch_cluster_block with the decode kernels' kThreads a block
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int cluster, size_t smem, bool pdl,
                           cudaStream_t stream, Args... args) {
  return launch_cluster_block(kernel, grid, kThreads, cluster, smem, pdl, stream, args...);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace bd
