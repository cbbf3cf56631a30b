// Hopper (sm_90a) building blocks of the port's prefill kernels
// (quant_matmul.cu, quant_matmul_a8.cu) and of B8's training attention
// (train_attention.cu): 2-D and 4-D tensor maps (bf16 and f32) and TMA
// loads that complete on a shared-memory mbarrier, the shared-memory matrix
// descriptors of a 128-byte-swizzled K-major tile and of an MN-major
// (transposed) one, warpgroup MMA (wgmma) at the widths and operand sources
// the kernels use (bf16, s8, and tf32 with the hi/lo split of 3xTF32),
// named and cluster barriers, and mbarrier arrivals and waits across the
// CTAs of a cluster. Inline code only; including it adds no symbol.
// The tensor-map encoder, cuTensorMapEncodeTiled, is looked up at run time
// through the CUDA runtime, so nothing links libcuda.
//
// Swizzled tile (as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B): rows of
// 128 bytes, 8-row atoms of 1024 bytes aligned to 1024; byte b of row r
// sits at r*128 + ((b/16) ^ (r%8))*16 + b%16. The descriptor of such a tile:
// start address, leading offset 16 B (unused for a K-major swizzled
// operand), stride 1024 B between 8-row atoms, layout 1 (128-byte swizzle).
// A k-step inside the 128-byte row adds its byte offset to the start
// address.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- host: 2-D tensor maps -------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiledFn(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Map of a row-major [rows, cols] array of `elem` bytes an element, loaded
// in boxes of box_rows x box_cols (the box may run past the array: TMA fills
// zeros there), 128-byte swizzled or dense in shared memory.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                       uint64_t rows, uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                       bool swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- device: mbarriers and TMA ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// init -> visible to the other threads and to the TMA unit
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete. A phase that never
// completes (a fault in the producer) traps after about 2^30 polls instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 30)) __trap();
  }
}

// box (c0 = column, c1 = row) of a 2-D tensor map -> shared memory, completing
// on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program: the compiler may not move
// their reads or writes across, so an accumulator that a wgmma in flight
// writes is not touched, and an A fragment that it reads is kept, until the
// wgmma_wait before the pin.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16, bf16, registers) * B (16 x N, bf16,
// K-major in shared memory, by descriptor); one warpgroup; D is added to
// only if scale_d. Register layouts, for the warp w = t/32 of thread t of
// the warpgroup and its lane l (row = 16w + l/4, q = l%4), as those of
// mma.sync m16n8k16:
//   A: a[0] = (row, k 2q, 2q+1), a[1] = (row+8, the same k),
//      a[2] = (row, k 2q+8, 2q+9), a[3] = (row+8, the same k);
//   D: d[4j .. 4j+3] = (row, 8j+2q), (row, 8j+2q+1), (row+8, 8j+2q),
//      (row+8, 8j+2q+1).
// s8: the same with A 64 x 32 and B 32 x N signed bytes (a[0] = four k
// 4q..4q+3 of row, a[2] = k 16+4q.., as mma.sync m16n8k32), s32 D.

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- B8's training attention (train_attention.cu) -----------------------------

// Map of a [B, S, H, D] bf16 array as a 4-D tensor (D innermost), loaded in
// boxes of `rows` rows of one (batch, head) by 64 columns, 128-byte
// swizzled: box (c0, h, r0, b) holds rows r0 .. r0 + rows - 1 of head h of
// batch b, columns c0 .. c0 + 63. Rows past S and columns past D are zeros,
// so a box never reads another batch's rows or another head's columns.
inline bool tensor_map_bshd(CUtensorMap* map, const void* base, uint64_t B, uint64_t S,
                            uint64_t H, uint64_t D, uint32_t rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {D, H, S, B};
  const cuuint64_t strides[3] = {D * 2, H * D * 2, S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same map over a [B, S, H, D] f32 array: boxes of `rows` rows by 32
// columns (128 bytes, the swizzle's span), so a D = 64 row is two boxes.
inline bool tensor_map_bshd_f32(CUtensorMap* map, const void* base, uint64_t B, uint64_t S,
                                uint64_t H, uint64_t D, uint32_t rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {D, H, S, B};
  const cuuint64_t strides[3] = {D * 4, H * D * 4, S * H * D * 4};
  const cuuint32_t box[4] = {32, 1, rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// one plain arrival (release: this thread's shared-memory writes before it
// are visible to the threads that wait on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Descriptor of an MN-major (transposed) 128-byte-swizzled operand, as TMA
// writes a box of 64 columns: K runs down the rows (128 bytes each), 8-row
// atoms 1024 bytes apart (stride offset), the N dimension along the row;
// `lbo` is the byte distance between 64-column blocks (leading offset),
// read only by an instruction wider than 64 in N. A k-step of 16 rows adds
// 2048 bytes to the start address.
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

#define BD_D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define BD_O32(d)                                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define BD_W32(d)                                                                                \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),            \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),    \
      "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),              \
      "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),              \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])

// D (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), both bf16 in shared
// memory, K-major, by descriptor; D layout as wgmma_bf16's. ACC false: D is
// written, not read (a fresh accumulator: no instruction before it may
// define D, so the compiler need not serialise the wgmmas around it).
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : BD_O32(d)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : BD_W32(d)
        : "l"(da), "l"(db), "r"(0));
}

// wgmma_ss_bf16 on the operands OFF16 * 16 bytes past those of descriptors
// da and db. The sums are made inside the instruction's asm block, so only
// the two base descriptors live in registers between products. A shared
// address fits the descriptor's 14-bit field in 16-byte units with room to
// spare, so the sum does not carry out of it.
template <bool ACC, int OFF16>
__device__ __forceinline__ void wgmma_ss_bf16_at(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %34, 0;\n"
        "add.s64 a, %32, %35;\nadd.s64 b, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
        ", a, b, p, 1, 1, 0, 0;\n}\n"
        : BD_O32(d)
        : "l"(da), "l"(db), "r"(1), "n"(OFF16));
  else
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %34, 0;\n"
        "add.s64 a, %32, %35;\nadd.s64 b, %33, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
        ", a, b, p, 1, 1, 0, 0;\n}\n"
        : BD_W32(d)
        : "l"(da), "l"(db), "r"(0), "n"(OFF16));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers, wgmma_bf16's layout) *
// B (16 x 64, bf16, MN-major in shared memory: mn_desc).
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BD_O32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, K-major and swizzled in shared
// memory: sw128_desc) * B (16 x 64, bf16, MN-major: mn_desc), on the
// operands OFFA16 * 16 and OFFB16 * 16 bytes past those of descriptors da
// and db (summed inside the asm block, as wgmma_ss_bf16_at).
template <int OFFA16, int OFFB16>
__device__ __forceinline__ void wgmma_ss_tb_at(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %34, 0;\n"
      "add.s64 a, %32, %35;\nadd.s64 b, %33, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BD_D32
      ", a, b, p, 1, 1, 0, 1;\n}\n"
      : BD_O32(d)
      : "l"(da), "l"(db), "r"(1), "n"(OFFA16), "n"(OFFB16));
}

// ---- f32 on the tensor cores: 3xTF32 ------------------------------------------
//
// x = hi + lo, hi = x rounded to tf32 and lo = x - hi (exact in f32), and a
// product a b taken as hi hi + hi lo + lo hi (lo lo, about 2^-22 relative,
// dropped): three tf32 wgmmas into one f32 accumulator keep about f32's
// accuracy, where one keeps about 2^-11. tf32 wgmma reads both operands
// K-major; it has no transposed form.

// hi = x rounded to tf32 (nearest, ties away: cvt.rna), lo = x - hi rounded
// the same way; the low 13 bits of both are cleared, so the tensor core reads
// the values meant whether it truncates its f32 inputs or rounds them.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xffffe000u;
}

// D (64 x 64, f32) (+)= A (64 x 8, tf32, registers) * B (8 x 64, tf32,
// K-major and 128-byte swizzled in shared memory: sw128_desc, on the operand
// OFF16 * 16 bytes past descriptor db, summed inside the asm block as
// wgmma_ss_bf16_at). A, for warp w of the warpgroup and lane l (row = 16w +
// l/4, q = l%4), as mma.sync m16n8k8's tf32 layout: a[0] = (row, k q),
// a[1] = (row + 8, q), a[2] = (row, q + 4), a[3] = (row + 8, q + 4); D as
// wgmma_bf16's. ACC false: D is written, not read.
template <bool ACC, int OFF16>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 b;\nsetp.ne.b32 p, %37, 0;\nadd.s64 b, %36, %38;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " BD_D32
        ", {%32, %33, %34, %35}, b, p, 1, 1;\n}\n"
        : BD_O32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OFF16));
  else
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 b;\nsetp.ne.b32 p, %37, 0;\nadd.s64 b, %36, %38;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " BD_D32
        ", {%32, %33, %34, %35}, b, p, 1, 1;\n}\n"
        : BD_W32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0), "n"(OFF16));
}

#undef BD_D32
#undef BD_O32
#undef BD_W32

#define BD_D16                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define BD_O16(d)                                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15])
#define BD_W16(d)                                                                                \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),            \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),    \
      "=f"(d[14]), "=f"(d[15])

// wgmma_ss_bf16_at at N = 32: D (64 x 32, f32) (+)= A (64 x 16) * B (16 x
// 32), both K-major and swizzled in shared memory; d[4j .. 4j+3] as
// wgmma_bf16's layout for j < 4.
template <bool ACC, int OFF16>
__device__ __forceinline__ void wgmma_ss_n32_at(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %18, 0;\n"
        "add.s64 a, %16, %19;\nadd.s64 b, %17, %19;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " BD_D16
        ", a, b, p, 1, 1, 0, 0;\n}\n"
        : BD_O16(d)
        : "l"(da), "l"(db), "r"(1), "n"(OFF16));
  else
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 a, b;\nsetp.ne.b32 p, %18, 0;\n"
        "add.s64 a, %16, %19;\nadd.s64 b, %17, %19;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " BD_D16
        ", a, b, p, 1, 1, 0, 0;\n}\n"
        : BD_W16(d)
        : "l"(da), "l"(db), "r"(0), "n"(OFF16));
}

// wgmma_tf32 at N = 32: D (64 x 32, f32) (+)= A (64 x 8, tf32, registers) *
// B (8 x 32, tf32, K-major and swizzled in shared memory)
template <bool ACC, int OFF16>
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (ACC)
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 b;\nsetp.ne.b32 p, %21, 0;\nadd.s64 b, %20, %22;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " BD_D16
        ", {%16, %17, %18, %19}, b, p, 1, 1;\n}\n"
        : BD_O16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(OFF16));
  else
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 b;\nsetp.ne.b32 p, %21, 0;\nadd.s64 b, %20, %22;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " BD_D16
        ", {%16, %17, %18, %19}, b, p, 1, 1;\n}\n"
        : BD_W16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0), "n"(OFF16));
}

#undef BD_D16
#undef BD_O16
#undef BD_W16

// Makes this thread's shared-memory writes by ordinary stores visible to
// the async proxy (a wgmma that reads them through a descriptor, once a
// barrier has ordered the threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier over the first `threads` threads of the block (id 1..15).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at named barrier `id` without waiting (its other `threads` minus
// these wait in named_sync); shared-memory writes before it are visible to
// them after.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Every thread of every CTA of the cluster arrives, then waits; shared
// memory written before is visible to the cluster's threads after.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- distributed shared memory: mbarriers between the CTAs of a cluster ------

// One arrival on the mbarrier at bar's offset in CTA `rank` of the cluster,
// releasing this thread's earlier memory accesses (its stores into that
// CTA's shared memory among them) at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// mbar_wait with acquire at cluster scope: what the arrivals of another CTA
// released is visible after it. Traps as mbar_wait does.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 30)) __trap();
  }
}

}  // namespace bd
