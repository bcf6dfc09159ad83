// Hopper building blocks shared by the two attention kernels
// (cross_attention.cu, vit_attention.cu): mbarriers, TMA tile loads, wgmma
// descriptors and the two bf16 wgmma shapes they use, the two passes of
// their row softmax, and the host-side encoding of a TMA tensor map. The
// row softmax (row_softmax.cu) uses the mbarriers and the 1-D bulk copies.
//
// Shared-memory tiles are rows of 64 bf16 (128 B) in the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), so a tile must start on a 1024-byte boundary.
// The same tile serves wgmma as a K-major operand (rows = M or N, the 64
// values of a row = K: Q and K tiles) and as an MN-major one (rows = K, the
// 64 values = N: V tiles). Register fragments follow the PTX ISA's wgmma
// layouts: warp w of a warpgroup owns rows 16w..16w+15; lane l holds row
// g = l / 4 and g + 8, columns 2 (l % 4) and 2 (l % 4) + 1 of every 8-column
// chunk. An accumulator of N columns is N / 2 floats a thread,
// d[4j + 2h + e] = (row g + 8h, column 8j + 2 (l % 4) + e); an A fragment
// of one 16-column slice is 4 registers of two bf16,
// a[2i + h] = (row g + 8h, columns 8i + 2 (l % 4) + {0, 1}).

#pragma once

#include <cuda.h>          // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// that never ends (a protocol fault) traps after 2^28 tries, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 28)) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy shared-memory accesses ordered before later async-proxy ones
// (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---------------------------------------------------- 1-D bulk copies
// Contiguous bytes without a tensor map: both addresses 16-byte aligned,
// the size a multiple of 16.

// global -> shared; completion is counted on the mbarrier as transaction
// bytes (arm it with mbar_expect_tx first)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, tracked by bulk groups (bulk_commit, bulk_wait*)
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N committed groups still read their shared source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N committed groups are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ----------------------------------------------------------------- wgmma

// Descriptor of a 128B-swizzled tile at shared address `addr` (1024-byte
// aligned, or advanced inside such a tile by whole 16-byte chunks):
// 8-row groups 1024 B apart (the stride byte offset). The leading byte
// offset is unused by these shapes (K-major: one k16 slice lies inside a
// 128-byte row; MN-major: N = 64 is one swizzle atom wide) and is set to
// 1024 B as well.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D32_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, K-major tile in shared memory)
//                     * B (16 x 64, K-major tile in shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 f32) (+)= A (64 x 16 bf16 in registers) * B (16 x 64 in shared
// memory; kTransB = 0: K-major, 1: MN-major)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2, uint32_t a3,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

#undef HOPPER_D32
#undef HOPPER_D32_LIST

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the multi-function unit, results below 2^-126 flushed to zero
// (exp2f adds instructions to keep them)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------- softmax of score rows
// Both kernels hold the scores of 64 query rows as N wgmma accumulators of
// 64 keys each, s[n] (the layout above), and compute the TPU kernels' p =
// bf16(exp(s - m) / l) in two passes: the exact row max m and row sum l
// first, then p. exp is exp2 of the score times log2(e), and / l is one
// reciprocal per row. A kernel applies its own scale and mask to s before
// these run.

constexpr float kLog2e = 1.4426950408889634f;

// One tile's update of the running row max m (in log2 units: max(s) *
// log2(e)) and of this thread's share l of the row sum, for rows g and
// g + 8 (h = 0, 1); the max is reduced over the quad of lanes holding a row.
template <int N>
__device__ __forceinline__ void row_stats_update(const float (&s)[N][32], float (&m)[2],
                                                 float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[n][4 * j + 2 * h], s[n][4 * j + 2 * h + 1]));
    }
    const float m_new = fmaxf(m[h], quad_max(mx) * kLog2e);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum += exp2_ftz(fmaf(s[n][4 * j + 2 * h], kLog2e, -m_new));
        sum += exp2_ftz(fmaf(s[n][4 * j + 2 * h + 1], kLog2e, -m_new));
      }
    }
    l[h] = l[h] * exp2_ftz(m[h] - m_new) + sum;
    m[h] = m_new;
  }
}

// 1 / l per row, from this thread's shares of the row sum
__device__ __forceinline__ void row_inv_sum(const float (&l)[2], float (&inv_l)[2]) {
  inv_l[0] = 1.0f / quad_sum(l[0]);
  inv_l[1] = 1.0f / quad_sum(l[1]);
}

// p = bf16(exp(s - m) * inv_l) for one 64-key accumulator s, packed as the
// wgmma A fragments of its 4 k16 slices of 4 registers (key chunk j in
// slice j / 2).
__device__ __forceinline__ void p_fragments(const float (&s)[32], const float (&m)[2],
                                            const float (&inv_l)[2], uint32_t (&p)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e0 = exp2_ftz(fmaf(s[4 * j + 2 * h], kLog2e, -m[h])) * inv_l[h];
      const float e1 = exp2_ftz(fmaf(s[4 * j + 2 * h + 1], kLog2e, -m[h])) * inv_l[h];
      p[(j >> 1) * 4 + (j & 1) * 2 + h] = pack_bf16(e0, e1);
    }
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry-point query, so the library needs no link to libcuda.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 tensor map with 128B swizzle. dims and box innermost first; strides
// in bytes for dims 1..rank-1. Out-of-bounds rows of a box read as zero.
// Returns false when the encoding is refused.
static inline bool make_bf16_map(CUtensorMap* map, const void* base, int rank,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
