// Row softmax over the ViT's attention scores, bf16 in and out.
//
// Replaces: facet_tpu/ops/pallas_softmax.py:softmax_pallas (kernel
// _softmax_kernel). Numerics follow that kernel: each bf16 score is widened
// to f32; the row max and the sum of exp(s - max) are taken in f32; each
// probability is exp(s - max) / sum; the result is rounded once to bf16.
// exp is exp2f((s - max) * log2(e)) on the multi-function unit (subnormal
// results kept), and the division is a product with the row's reciprocal:
// together a relative error under (|s - max| + 4) * 2^-23 against the
// twin's expf and division, far below a bf16 ulp (2^-8), so now and then a
// value rounds to the neighbouring bf16 (one ulp, the check's limit). expf
// and a division per element cost about 20 more instructions an element.
//
// What bounds it on an H100: bytes. At the engine's batch of 24 the
// (24, 16, 257, 257) bf16 scores are read once and the probabilities
// written once, 101.5 MB: 0.030 ms at 3.35 TB/s. Its ~5 f32 operations per
// element take about 0.002 ms. The TPU kernel staged four heads' (257, 257)
// blocks in VMEM.
//
// Design: the rows move between device and shared memory in whole 16-byte
// transfers. Eight rows of any width span 16 * cols bytes, so a group of
// 8k rows starts on a 16-byte boundary whenever the tensor's base does,
// however odd the width (a row of 257 bf16 is 514 B). A persistent grid of
// 256-thread blocks walks the groups (group g of block b: g = b, b + grid,
// ...). Each block keeps a ring of `stages` group buffers in shared memory:
// thread 0 fills a stage with one 1-D bulk copy (cp.async.bulk) that
// completes on the stage's mbarrier. Each warp computes its rows of the
// group from shared memory, one row at a time, with the row's values in
// registers (PER = ceil(cols / 32) a lane, exactly: only the last slot can
// fall past the row) and warp shuffles for the max and the sum, and writes
// the bf16 results back in place. Thread 0 then stores the group with one
// bulk copy to device memory, and refills the stage of the group stored
// kStoreLag groups before, once that store has read it. So stages - 3 loads
// and 3 stores are in flight while the block computes: at 257 columns,
// 8-row groups of 4,112 B in 8 stages, 5 groups (20 KB) requested ahead per
// block. (Refilling the stage of the group just stored, one store in
// flight, took 2.5% longer on the card.) Rows past the last
// whole group, and every row when the input or output base is not 16-byte
// aligned, take the same row code straight from device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 1024;        // 32 values a lane
constexpr int kGroupBytes = 8192;     // a group: 8k rows, about this many bytes
constexpr int kRingBytes = 40960;     // shared memory for a block's stages
constexpr int kMaxStages = 8;
constexpr int kStoreLag = 3;          // group stores left in flight before a refill

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The softmax of one row of `cols` values from src into dst, by one warp;
// src and dst may both be shared or device memory, and may be the same
// row: each lane writes only the values it has read.
template <int PER>
__device__ __forceinline__ void softmax_row(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                            int cols, int lane) {
  float x[PER];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    x[i] = (i < PER - 1 || c < cols) ? __bfloat162float(src[c]) : -INFINITY;
    m = fmaxf(m, x[i]);
  }
  m = warp_max(m);
  float l = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    x[i] = (i < PER - 1 || c < cols) ? exp2f((x[i] - m) * hopper::kLog2e) : 0.0f;
    l += x[i];
  }
  const float inv = 1.0f / warp_sum(l);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    if (i < PER - 1 || c < cols) dst[c] = __float2bfloat16_rn(x[i] * inv);
  }
}

// s, p: (rows, cols); rows [0, groups * group_rows) in whole groups through
// the ring, the rest row by row from device memory.
template <int PER>
__global__ void __launch_bounds__(kThreads)
row_softmax_kernel(const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ p,
                   long long rows, int cols, int group_rows, long long groups,
                   int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long group_elems = (long long)group_rows * cols;
  const uint32_t group_bytes = (uint32_t)(group_elems * 2);
  const long long mine =
      groups > blockIdx.x ? (groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t ring_addr = hopper::smem_addr(ring);

  // group k of this block into its stage (thread 0 only)
  auto load = [&](long long k) {
    const int st = (int)(k % stages);
    const uint32_t bar = hopper::smem_addr(&full[st]);
    hopper::mbar_expect_tx(bar, group_bytes);
    hopper::bulk_load(ring_addr + st * stage_bytes,
                      s + (blockIdx.x + k * gridDim.x) * group_elems, group_bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) hopper::mbar_init(hopper::smem_addr(&full[i]), 1);
    hopper::mbar_init_fence();
    for (long long k = 0; k < mine && k < stages; ++k) load(k);
  }
  __syncthreads();

  // the rows after the last whole group, while the first loads fly
  for (long long row = groups * group_rows + (long long)blockIdx.x * kWarps + warp;
       row < rows; row += (long long)gridDim.x * kWarps) {
    softmax_row<PER>(s + row * cols, p + row * cols, cols, lane);
  }

  for (long long k = 0; k < mine; ++k) {
    const int st = (int)(k % stages);
    auto* buf = reinterpret_cast<__nv_bfloat16*>(ring + st * stage_bytes);
    hopper::mbar_wait(hopper::smem_addr(&full[st]), (uint32_t)((k / stages) & 1));
    for (int r = warp; r < group_rows; r += kWarps) {
      softmax_row<PER>(buf + r * cols, buf + r * cols, cols, lane);
    }
    hopper::fence_proxy_async();       // the results, before the bulk store reads them
    __syncthreads();
    if (threadIdx.x == 0) {
      hopper::bulk_store(p + (blockIdx.x + k * gridDim.x) * group_elems,
                         ring_addr + st * stage_bytes, group_bytes);
      hopper::bulk_commit();
      // refill the stage of group k - lag once its store has read it
      const int lag = stages - 1 < kStoreLag ? stages - 1 : kStoreLag;
      if (k >= lag && k - lag + stages < mine) {
        if (lag == 1) hopper::bulk_wait_read<1>();
        else if (lag == 2) hopper::bulk_wait_read<2>();
        else hopper::bulk_wait_read<kStoreLag>();
        load(k - lag + stages);
      }
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<0>();
}

template <int PER>
int launch(const __nv_bfloat16* s, __nv_bfloat16* p, long long rows, int cols,
           cudaStream_t stream) {
  const int k = kGroupBytes / (16 * cols);
  const int group_rows = 8 * (k > 1 ? k : 1);
  const int stage_bytes = (group_rows * cols * 2 + 127) / 128 * 128;
  const int fit = kRingBytes / stage_bytes;
  const int stages = fit < 2 ? 2 : (fit > kMaxStages ? kMaxStages : fit);
  const int smem = stages * stage_bytes;
  const bool aligned = ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(p)) & 15) == 0;
  const long long groups = aligned ? rows / group_rows : 0;
  // the blocks the card holds at once at this width, asked once per width
  // (a grid of any size is correct; this one keeps every SM busy)
  static int slots_for[kMaxCols + 1];
  int& slots = slots_for[cols];
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_softmax_kernel<PER>,
                                                          kThreads, smem);
    }
    if (err != cudaSuccess) return (int)err;
    slots = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long work = groups > 0 ? groups : (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(work < slots ? work : slots);
  row_softmax_kernel<PER><<<blocks, kThreads, smem, stream>>>(
      s, p, rows, cols, group_rows, groups, stages, stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// s, p: (rows, cols) bf16 contiguous, cols <= 1024; p = softmax(s) over
// each row. Returns the launch's cudaError_t.
extern "C" int facet_row_softmax(const void* s, void* p, long long rows, int cols,
                                 void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* in = static_cast<const __nv_bfloat16*>(s);
  auto* out = static_cast<__nv_bfloat16*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((cols + 31) / 32) {
#define FACET_PER(n) \
  case n:            \
    return launch<n>(in, out, rows, cols, st);
    FACET_PER(1) FACET_PER(2) FACET_PER(3) FACET_PER(4) FACET_PER(5) FACET_PER(6)
    FACET_PER(7) FACET_PER(8) FACET_PER(9) FACET_PER(10) FACET_PER(11) FACET_PER(12)
    FACET_PER(13) FACET_PER(14) FACET_PER(15) FACET_PER(16) FACET_PER(17)
    FACET_PER(18) FACET_PER(19) FACET_PER(20) FACET_PER(21) FACET_PER(22)
    FACET_PER(23) FACET_PER(24) FACET_PER(25) FACET_PER(26) FACET_PER(27)
    FACET_PER(28) FACET_PER(29) FACET_PER(30) FACET_PER(31) FACET_PER(32)
#undef FACET_PER
  }
  return (int)cudaErrorInvalidValue;
}
