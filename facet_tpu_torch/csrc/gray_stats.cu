// Gray-plane statistics: per image, the 256-bin histogram of the exact-cv2
// gray plane, and over cv2's reflect-101 border the Laplacian sum, the
// Laplacian sum of squares and the |Immerkaer| sum of 3x3 stencils.
//
// Replaces: facet_tpu/ops/pallas_stats.py:fused_gray_stats (kernel 5; the
// TPU kernel DMAs 128-row slabs of a padded copy of the gray plane into
// VMEM, builds the histogram by 256 compare-reduce passes and writes
// per-slab int32 partials, with lap^2 split into 20-bit halves).
//
// Two inputs, one kernel template: uint8 RGB (B, H, W, 3), from which it
// makes cv2's gray (R*9798 + G*19235 + B*3735 + 2^14) >> 15 itself, so the
// stats prepass writes no gray plane (kBpp = 3, the engine's path); or an
// int32 gray plane (B, H, W) (kBpp = 4, the JAX function's signature).
//
// What bounds it on an H100: the bytes read, 3 B per pixel of RGB (113 MB
// at B = 24, 1024 x 1536: 0.034 ms), and close behind them the integer
// work, about 40 instructions a pixel in the compiled row loop (the gray,
// two stencils, three sums, a histogram add, the row bookkeeping). Measured
// (PERF.md) it runs at about half of the bytes bound, held by that
// work and not by the copies: twelve ring stages instead of eight changed
// nothing, and five or seven blocks per SM instead of six (fewer
// registers, or fewer warps) were slower.
//
// Design: a persistent grid of kBlocksPerSm blocks per SM walks units of
// (image, band of at most 512 columns, chunk of rows). One producer warp
// streams the unit's rows, with a one-row reflect-101 halo above and below,
// into a ring of kStages shared-memory slots by 1-D bulk copies (TMA,
// completion counted on an mbarrier), loads running ahead of compute across
// units. Each row is copied as the 16-byte-aligned span that covers it, so
// any row stride and base alignment takes the same path; the consumers
// read it from its offset in the slot. Four consumer warps each own 4
// adjacent columns per thread and walk down the chunk holding the 3x3
// window of gray values in registers: a staged row is read once, converted
// once (two dp4a per pixel), its two outer columns come from the
// neighbouring lanes by shuffles, and the slot is released at once.
// Reflect-101 on the left and right edges is a select on registers. Sums
// are kept per thread in 32 bits (a unit has at most 512 rows: 2,048
// pixels of lap^2 <= 1,040,400 fit in uint32) and folded into int64 at the
// end of each unit; the histogram goes to one 256-bin copy per warp (a
// warp whose threads each hold four equal pixels adds them as one). At the
// end of a unit the warps' copies and sums are added to the image's totals
// with integer atomics: exact, and the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;
using hopper::named_barrier;
using hopper::smem_addr;

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;            // and one producer warp
constexpr int kPix = 4;                              // columns a consumer thread owns
constexpr int kBandMax = kPix * kConsumers;          // 512 columns a band
constexpr int kStages = 8;
constexpr int kMaxRows = 512;                        // rows a unit (uint32 lap^2 sums)
constexpr int kBlocksPerSm = 6;

// A staged row: up to kBandMax + 2 pixels, 15 bytes of alignment on either
// side, and 16 bytes past them that the 4-byte loads may touch.
template <int kBpp>
__host__ __device__ constexpr int slot_bytes() {
  return (kBpp * (kBandMax + 2) + 30 + 15) / 16 * 16 + 16;
}

// cv2's weights split into bytes: w = 256 * hi + lo, for dp4a on R, G, B
constexpr unsigned kWeightHi = 38u | 75u << 8 | 14u << 16;
constexpr unsigned kWeightLo = 70u | 35u << 8 | 151u << 16;

struct Plan {
  const unsigned char* src;
  long long image_bytes;   // H * W * kBpp
  int height, width;
  int bands, band_w;       // band_w: columns a band, a multiple of 4
  int rows, chunks;        // rows a unit; units of rows an image
  int units;               // batch * chunks * bands
};

struct Unit {
  int b, x0, x1, y0, y1, sx0, sx1;   // [sx0, sx1): the staged columns
};

__device__ __forceinline__ Unit unit_of(const Plan& p, int u) {
  Unit t;
  const int band = u % p.bands;
  const int chunk = (u / p.bands) % p.chunks;
  t.b = u / (p.bands * p.chunks);
  t.x0 = band * p.band_w;
  t.x1 = min(t.x0 + p.band_w, p.width);
  t.y0 = chunk * p.rows;
  t.y1 = min(t.y0 + p.rows, p.height);
  t.sx0 = max(t.x0 - 1, 0);
  t.sx1 = min(t.x1 + 1, p.width);
  return t;
}

// cv2's reflect-101 of row -1 and row H
__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// first byte of staged row v (-1 <= v <= H) of unit t
template <int kBpp>
__device__ __forceinline__ const unsigned char* row_start(const Plan& p, const Unit& t,
                                                          int v) {
  const int y = reflect101(v, p.height);
  return p.src + t.b * p.image_bytes + ((long long)y * p.width + t.sx0) * kBpp;
}

// gray of the pixel whose R, G, B are bytes 0, 1, 2 of `px` (byte 3 has
// weight 0): hi * 256 + lo + 2^14, then >> 15
__device__ __forceinline__ int gray_of(unsigned px) {
  const unsigned hi = __dp4a(px, kWeightHi, 64u);
  return (int)(__dp4a(px, kWeightLo, hi << 8) >> 15);
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// the gray values of a thread's 4 pixels (g[1..4]) and of one more pixel,
// its edge (returned), from a staged row; `own` and `edge` are byte offsets
// in the slot
template <int kBpp>
__device__ __forceinline__ int load_row(const unsigned char* slot, int own, int edge,
                                        int (&g)[6]) {
  if constexpr (kBpp == 4) {
    const int* px = reinterpret_cast<const int*>(slot + own);
    g[1] = px[0];
    g[2] = px[1];
    g[3] = px[2];
    g[4] = px[3];
    return *reinterpret_cast<const int*>(slot + edge);
  } else {
    const unsigned char* w = slot + (own & ~3);
    const unsigned sh = (own & 3) * 8;
    const unsigned w0 = lds32(w), w1 = lds32(w + 4), w2 = lds32(w + 8), w3 = lds32(w + 12);
    const unsigned u0 = __funnelshift_r(w0, w1, sh);     // R0 G0 B0 R1
    const unsigned u1 = __funnelshift_r(w1, w2, sh);     // G1 B1 R2 G2
    const unsigned u2 = __funnelshift_r(w2, w3, sh);     // B2 R3 G3 B3
    g[1] = gray_of(u0);
    g[2] = gray_of(__byte_perm(u0, u1, 0x0543));
    g[3] = gray_of(__byte_perm(u1, u2, 0x0432));
    g[4] = gray_of(u2 >> 8);
    const unsigned char* e = slot + (edge & ~3);
    return gray_of(__funnelshift_r(lds32(e), lds32(e + 4), (edge & 3) * 8));
  }
}

// One output row of a thread's 4 columns: the stencils of `mid` against
// `up` and `dn` added to the sums, and the centres to the warp's
// histogram. kMasked: some of the columns lie past the band (bit j of
// `valid` clear) and are not counted. Where every thread of the warp has
// four equal centres (a smooth region), its four adds go as one:
// back-to-back adds to one shared address wait for each other.
template <bool kMasked>
__device__ __forceinline__ void add_row(const int (&up)[6], const int (&mid)[6],
                                        const int (&dn)[6], unsigned valid, int* hist,
                                        int& lap_sum, unsigned& lapsq_sum, int& imm_sum) {
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int i = j + 1;
    if (kMasked && !((valid >> j) & 1)) continue;
    const int center = mid[i];
    const int s4 = up[i] + dn[i] + mid[i - 1] + mid[i + 1];
    const int lap = s4 - 4 * center;
    const int imm = up[i - 1] + dn[i - 1] + up[i + 1] + dn[i + 1] - 2 * s4 + 4 * center;
    lap_sum += lap;
    lapsq_sum += (unsigned)(lap * lap);
    imm_sum += abs(imm);
  }
  if (!kMasked && __all_sync(0xffffffffu, mid[1] == mid[2] && mid[2] == mid[3] &&
                                              mid[3] == mid[4])) {
    atomicAdd(hist + (mid[1] & 255), kPix);
    return;
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!kMasked || ((valid >> j) & 1)) atomicAdd(hist + (mid[j + 1] & 255), 1);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int kBpp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gray_stats_kernel(Plan p, int* __restrict__ hist, unsigned long long* __restrict__ sums) {
  constexpr int kSlot = slot_bytes<kBpp>();
  __shared__ __align__(16) unsigned char slots[kStages * kSlot];
  __shared__ int whist[kConsumerWarps * 256];
  __shared__ __align__(8) unsigned long long bars[2 * kStages];   // full, then empty
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = smem_addr(bars + kStages);

  for (int i = threadIdx.x; i < kConsumerWarps * 256; i += kThreads) whist[i] = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: every staged row of every unit of this block, in order
    if (lane != 0) return;
    int k = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit t = unit_of(p, u);
      for (int v = t.y0 - 1; v <= t.y1; ++v, ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * s, (k / kStages - 1) & 1);
        const uintptr_t start = reinterpret_cast<uintptr_t>(row_start<kBpp>(p, t, v));
        const uintptr_t lo = start & ~uintptr_t(15);
        const uintptr_t hi = (start + (uintptr_t)(t.sx1 - t.sx0) * kBpp + 15) & ~uintptr_t(15);
        mbar_expect_tx(full0 + 8 * s, (uint32_t)(hi - lo));
        bulk_load(smem_addr(slots + s * kSlot), reinterpret_cast<const void*>(lo),
                  (uint32_t)(hi - lo), full0 + 8 * s);
      }
    }
    return;
  }

  int* my_hist = whist + warp * 256;
  unsigned k = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit t = unit_of(p, u);
    const int c = t.x0 + kPix * threadIdx.x;     // first of this thread's columns
    unsigned valid = 0;                          // bit j: column c + j is counted
#pragma unroll
    for (int j = 0; j < kPix; ++j) valid |= (c + j < t.x1 ? 1u : 0u) << j;
    const int own_px = c - t.sx0;
    // lane 0 reads the column left of its own, lane 31 the one right of
    // them; the other lanes get both from their neighbours
    const int edge_px = max(lane == 31 ? own_px + kPix : own_px - 1, 0);

    // a row's offset in its slot is its address mod 16, which 32-bit
    // arithmetic keeps
    const uint32_t unit_base =
        (uint32_t) reinterpret_cast<uintptr_t>(p.src + t.b * p.image_bytes + t.sx0 * kBpp);
    const uint32_t row_bytes = (uint32_t)p.width * kBpp;

    // one staged row -> the gray of columns c - 1 .. c + 4 (reflect-101 at
    // the image's left and right edges)
    auto next_row = [&](int v, int (&g)[6]) {
      const unsigned s = k % kStages;
      mbar_wait(full0 + 8 * s, (k / kStages) & 1);
      ++k;
      const int d = (int)((unit_base + (uint32_t)reflect101(v, p.height) * row_bytes) & 15);
      const int edge = load_row<kBpp>(slots + s * kSlot, d + own_px * kBpp,
                                      d + edge_px * kBpp, g);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      const int left = __shfl_up_sync(0xffffffffu, g[4], 1);
      const int right = __shfl_down_sync(0xffffffffu, g[1], 1);
      g[0] = lane == 0 ? edge : left;
      g[5] = lane == 31 ? edge : right;
      if (c == 0) g[0] = g[2];                   // column -1 is column 1
#pragma unroll
      for (int i = 2; i < 6; ++i) {
        if (c + i - 1 == p.width) g[i] = g[i - 2];   // column W is column W - 2
      }
    };

    int lap_sum = 0, imm_sum = 0;
    unsigned lapsq_sum = 0;
    // down the chunk, the three rows' registers taking turns as the row
    // above, the centre row and the row below (no copies); one loop for
    // warps whose threads' columns all count, one (the same for the whole
    // warp, so its shuffles and votes stay converged) for the band's last
    auto walk = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      int r0[6], r1[6], r2[6];
      next_row(t.y0 - 1, r0);
      next_row(t.y0, r1);
      for (int y = t.y0;;) {
        if (y == t.y1) break;
        next_row(++y, r2);
        add_row<kMasked>(r0, r1, r2, valid, my_hist, lap_sum, lapsq_sum, imm_sum);
        if (y == t.y1) break;
        next_row(++y, r0);
        add_row<kMasked>(r1, r2, r0, valid, my_hist, lap_sum, lapsq_sum, imm_sum);
        if (y == t.y1) break;
        next_row(++y, r1);
        add_row<kMasked>(r2, r0, r1, valid, my_hist, lap_sum, lapsq_sum, imm_sum);
      }
    };
    if (__all_sync(0xffffffffu, valid == (1u << kPix) - 1)) {
      walk(std::false_type{});
    } else {
      walk(std::true_type{});
    }

    // the unit's totals into image t.b's
    const long long l = warp_sum((long long)lap_sum);
    const long long q = warp_sum((long long)lapsq_sum);
    const long long m = warp_sum((long long)imm_sum);
    if (lane == 0) {
      unsigned long long* out = sums + (long long)t.b * 3;
      if (l) atomicAdd(out, (unsigned long long)l);   // two's complement: exact
      if (q) atomicAdd(out + 1, (unsigned long long)q);
      if (m) atomicAdd(out + 2, (unsigned long long)m);
    }
    named_barrier(1, kConsumers);    // every warp's histogram adds are done
    for (int bin = threadIdx.x; bin < 256; bin += kConsumers) {
      int v = 0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        v += whist[w * 256 + bin];
        whist[w * 256 + bin] = 0;
      }
      if (v) atomicAdd(hist + t.b * 256 + bin, v);
    }
    named_barrier(1, kConsumers);    // cleared before the next unit adds
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

// src: (B, H, W, 3) uint8 (bpp 3) or (B, H, W) int32 gray in 0..255 (bpp
// 4), contiguous, H and W >= 2. hist: (B, 256) int32 and sums: (B, 3) int64
// [lap, lap^2, |imm|], both zeroed by the caller. sm_count: the card's SMs.
// Returns the cudaError_t of the launch.
extern "C" int facet_gray_stats(const void* src, int bpp, void* hist, void* sums,
                                int batch, int height, int width, int sm_count,
                                void* stream) {
  Plan p;
  p.src = static_cast<const unsigned char*>(src);
  p.image_bytes = (long long)height * width * bpp;
  p.height = height;
  p.width = width;
  p.bands = ceil_div(width, kBandMax);
  p.band_w = (ceil_div(width, p.bands) + kPix - 1) / kPix * kPix;
  const int blocks = sm_count * kBlocksPerSm;
  // about one unit a block, with no unit over kMaxRows rows
  const long long band_rows = (long long)batch * p.bands * height;
  p.rows = (int)std::min<long long>(kMaxRows, std::max<long long>(1, (band_rows + blocks - 1) / blocks));
  p.chunks = ceil_div(height, p.rows);
  const long long units = (long long)batch * p.chunks * p.bands;
  if (units > 0x7fffffffLL || (bpp != 3 && bpp != 4)) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  const int grid = (int)std::min<long long>(units, blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* h = static_cast<int*>(hist);
  unsigned long long* s = static_cast<unsigned long long*>(sums);
  if (bpp == 3) {
    gray_stats_kernel<3><<<grid, kThreads, 0, st>>>(p, h, s);
  } else {
    gray_stats_kernel<4><<<grid, kThreads, 0, st>>>(p, h, s);
  }
  return (int)cudaGetLastError();
}
