// Gray-plane statistics: per image, the 256-bin histogram of the exact-cv2
// gray plane, and over cv2's reflect-101 border the Laplacian sum, the
// Laplacian sum of squares and the |Immerkaer| sum of 3x3 stencils.
//
// Replaces: facet_tpu/ops/pallas_stats.py:fused_gray_stats (kernel 5; the
// TPU kernel DMAs 128-row slabs of a padded copy of the plane into VMEM,
// builds the histogram by 256 compare-reduce passes and writes per-slab
// int32 partials, with lap^2 split into 20-bit halves).
//
// What bounds it on an H100: the bytes read, 4 B per pixel of int32 gray
// (6.3 MB per 1.5 MP image), and on smooth photos the contention of
// shared-memory histogram atomics on few bins.
//
// Design: tiles of kTileH x kTileW output pixels. A block stages a tile and
// its 1-pixel halo in shared memory, computing the reflect-101 border from
// indices (-1 -> 1, H -> H-2), so no padded copy of the plane is made. Each
// thread adds its pixels to its warp's own 256-bin shared histogram (eight
// copies, fewer collisions) and keeps int64 sums of lap, lap^2 and |imm|
// (|lap| <= 1020, lap^2 <= 1,040,400 and |imm| <= 2040 fit int32 per pixel;
// the sums need int64). A block walks several tiles of one image, then
// reduces its sums by warp shuffles and adds them, and its histogram, to the
// image's totals with integer atomics: 64-bit on the sums (two's complement
// keeps negative Laplacian sums exact), 32-bit on the histogram. Integer
// addition is order-free, so the results are exact and reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;

// reflect-101 for the one-pixel border, then clamped into the plane: only
// indices -1..n can reach a counted output; the clamp keeps the loads of
// the tile's unused rows and columns past the edge inside the image
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gray_stats_kernel(const int* __restrict__ gray, int* __restrict__ hist,
                  unsigned long long* __restrict__ sums, int height,
                  int width) {
  __shared__ int tile[kHaloH * kHaloW];
  __shared__ int whist[kWarps * 256];
  __shared__ long long wsums[kWarps][3];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* img = gray + (long long)b * height * width;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((height + kTileH - 1) / kTileH);

  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) whist[i] = 0;
  long long lap_sum = 0, lapsq_sum = 0, imm_sum = 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int y0 = (t / tiles_x) * kTileH;
    const int x0 = (t % tiles_x) * kTileW;
    __syncthreads();   // the previous tile's reads are done
    for (int i = threadIdx.x; i < kHaloH * kHaloW; i += kThreads) {
      const int r = i / kHaloW;
      const int c = i - r * kHaloW;
      const int gy = reflect101(y0 - 1 + r, height);
      const int gx = reflect101(x0 - 1 + c, width);
      tile[i] = __ldg(img + (long long)gy * width + gx);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW;
      const int c = i - r * kTileW;
      if (y0 + r >= height || x0 + c >= width) continue;
      const int* up = tile + r * kHaloW + c;      // row above, column c-1
      const int* mid = up + kHaloW;
      const int* dn = mid + kHaloW;
      const int center = mid[1];
      const int lap = up[1] + dn[1] + mid[0] + mid[2] - 4 * center;
      const int imm = up[0] - 2 * up[1] + up[2] - 2 * mid[0] + 4 * center
                      - 2 * mid[2] + dn[0] - 2 * dn[1] + dn[2];
      lap_sum += lap;
      lapsq_sum += lap * lap;
      imm_sum += imm < 0 ? -imm : imm;
      atomicAdd(&whist[warp * 256 + (center & 255)], 1);
    }
  }

  lap_sum = warp_sum(lap_sum);
  lapsq_sum = warp_sum(lapsq_sum);
  imm_sum = warp_sum(imm_sum);
  if (lane == 0) {
    wsums[warp][0] = lap_sum;
    wsums[warp][1] = lapsq_sum;
    wsums[warp][2] = imm_sum;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    long long v = 0;
    for (int w = 0; w < kWarps; ++w) v += wsums[w][threadIdx.x];
    atomicAdd(sums + (long long)b * 3 + threadIdx.x, (unsigned long long)v);
  }
  for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += whist[w * 256 + bin];
    if (v) atomicAdd(hist + b * 256 + bin, v);
  }
}

}  // namespace

// gray: (B, H, W) int32 in 0..255, contiguous, H and W >= 2. hist: (B, 256)
// int32 and sums: (B, 3) int64 [lap, lap^2, |imm|], both zeroed by the
// caller. blocks: blocks per image. Returns the cudaError_t of the launch.
extern "C" int facet_gray_stats(const void* gray, void* hist, void* sums,
                                int batch, int height, int width, int blocks,
                                void* stream) {
  gray_stats_kernel<<<dim3(blocks, batch), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gray), static_cast<int*>(hist),
      static_cast<unsigned long long*>(sums), height, width);
  return (int)cudaGetLastError();
}
