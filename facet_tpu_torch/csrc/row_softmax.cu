// Row softmax over the ViT's attention scores, bf16 in and out.
//
// Replaces: facet_tpu/ops/pallas_softmax.py:softmax_pallas (kernel
// _softmax_kernel). Numerics follow that kernel: each bf16 score is widened
// to f32; the row max and the sum of exp(s - max) are taken in f32; each
// probability is exp(s - max) / sum, a division as in the TPU kernel; the
// result is rounded once to bf16.
//
// What bounds it on an H100: bytes. At the engine's batch of 24 the
// (24, 16, 257, 257) bf16 scores are read once and the probabilities
// written once, 101.5 MB: 0.030 ms at 3.35 TB/s. Its ~5 f32 operations per
// element take about 0.002 ms. The TPU kernel staged four heads' (257, 257)
// blocks in VMEM; one row of 257 bf16 (514 B) is all a warp needs here.
//
// Design (first right version): one warp per row, the rows walked
// grid-stride. Each lane keeps its values of the row (columns lane,
// lane + 32, ...) in registers, so the row is read from device memory once;
// the max and the sum are warp shuffles. expf, not __expf, keeps the kernel
// at float rounding from the plain twin. A row of 257 bf16 is 514 bytes, so
// every other row starts off a 4-byte boundary: the loads are per element
// (coalesced across the warp), not vectorised.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 32;   // rows of up to 1024 values
constexpr long long kMaxBlocks = 8192;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// PER: values per lane, a power of two with 32 * PER >= cols
template <int PER>
__global__ void __launch_bounds__(kThreads)
row_softmax_kernel(const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ p,
                   long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += stride) {
    const __nv_bfloat16* src = s + row * cols;
    __nv_bfloat16* dst = p + row * cols;
    float x[PER];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      x[i] = c < cols ? __bfloat162float(src[c]) : -INFINITY;
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      x[i] = c < cols ? expf(x[i] - m) : 0.0f;
      l += x[i];
    }
    l = warp_sum(l);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < cols) dst[c] = __float2bfloat16_rn(x[i] / l);
    }
  }
}

template <int PER>
void launch(const __nv_bfloat16* s, __nv_bfloat16* p, long long rows, int cols,
            cudaStream_t stream) {
  const long long want = (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  row_softmax_kernel<PER><<<blocks, kThreads, 0, stream>>>(s, p, rows, cols);
}

}  // namespace

// s, p: (rows, cols) bf16 contiguous; p = softmax(s) over each row.
// Returns the launch's cudaError_t.
extern "C" int facet_row_softmax(const void* s, void* p, long long rows, int cols,
                                 void* stream) {
  if (rows <= 0 || cols <= 0 || cols > 32 * kMaxPerLane) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* in = static_cast<const __nv_bfloat16*>(s);
  auto* out = static_cast<__nv_bfloat16*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (cols + 31) / 32;
  if (per <= 1) launch<1>(in, out, rows, cols, st);
  else if (per <= 2) launch<2>(in, out, rows, cols, st);
  else if (per <= 4) launch<4>(in, out, rows, cols, st);
  else if (per <= 8) launch<8>(in, out, rows, cols, st);
  else if (per <= 16) launch<16>(in, out, rows, cols, st);
  else launch<32>(in, out, rows, cols, st);
  return (int)cudaGetLastError();
}
