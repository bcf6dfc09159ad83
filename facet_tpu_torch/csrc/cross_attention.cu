// Cross-attention softmax(Q K^T) V for TOPIQ's finest level, head dim 64.
//
// Replaces: facet_tpu/ops/pallas_attn.py:cross_attention_pallas (kernel
// _attn_kernel). Numerics follow that kernel: q, k, v rounded to bf16;
// scores accumulated in f32; the exact row max m and row sum l in f32; p
// normalized by the final l THEN rounded to bf16; P V accumulated in f32. q
// arrives pre-scaled by 1/sqrt(64). There is no mask. exp is taken as exp2
// of the score times log2(e), and p as exp(s - m) times one reciprocal of l
// per row: both move f32 rounding by about an ulp, which now and then flips
// one bf16 rounding of p (the relative-RMS limit of the tests measures it).
//
// What bounds it on an H100: tensor-core operations and exponentials. The
// function is 4 * Nq * Nk * 64 FLOP per (batch, head): 522 GFLOP at
// (24, 4, 9216, 2304), 0.53 ms at the bf16 peak. Normalizing p before
// rounding it needs l before any p exists, so an online (one-pass) softmax,
// which rounds exp(s - m_running) first, would change the result. This
// kernel therefore runs two passes: pass 1 computes Q K^T for m and l, pass
// 2 computes it again for p and P V. Its own floor is three products (783
// GFLOP, 0.79 ms) and two exponentials per score (4.1 G on the 16-a-clock
// multi-function units of 132 SMs, about 1.1 ms).
//
// Design:
//   - a prologue kernel converts K and V to bf16 once per launch into a
//     scratch tensor the wrapper allocates, (2, BH * Nk, 64);
//   - the main kernel runs one block per (b*h, 192-query tile): three
//     consumer warpgroups of 64 query rows and one producer warp. The
//     consumers convert their f32 Q rows to bf16 into 128B-swizzled shared
//     memory once. The producer's elected lane streams 128-key K tiles
//     (pass 1), then K and V tiles (pass 2), by TMA into a ring of four
//     stages guarded by full/empty mbarriers, so the next tiles are in
//     flight while the consumers compute;
//   - pass 1: S = Q K^T by wgmma (A and B from shared memory) into
//     registers; each row's running max and rescaled sum, reduced over the
//     quad of lanes that holds the row;
//   - pass 2: S again, p = bf16(exp(s - m) / l) formed in registers as
//     wgmma A fragments, O += P V by wgmma with V (MN-major) from shared
//     memory, issued per 64-key half so the first half's products overlap
//     the second half's exponentials; O (f32) written straight from the
//     accumulators.
// Each block reads its head's bf16 K twice and V once through L2: 3 * Nk *
// 128 B per block, 4.1 GB per launch at (24, 4, 9216, 2304)
// (facet_cross_attention_geometry reckons it for any shape).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;                       // head dim
constexpr int kWarpgroups = 3;               // consumer warpgroups
constexpr int kRowsPerWg = 64;
constexpr int kQT = kWarpgroups * kRowsPerWg;  // 192 query rows per block
constexpr int kKT = 128;                     // keys per stage
constexpr int kStages = 4;
constexpr int kConsumerWarps = kWarpgroups * 4;
constexpr int kThreads = kWarpgroups * 128 + 32;
constexpr int kTileBytes = kKT * kD * 2;     // one bf16 K or V tile, 16 KB
constexpr int kStageBytes = 2 * kTileBytes;  // K then V
constexpr int kQBytes = kQT * kD * 2;
constexpr size_t kSmemBytes =
    1024 + kQBytes + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

__global__ void to_bf16_kernel(const float4* __restrict__ k, const float4* __restrict__ v,
                               uint4* __restrict__ out, long long n8) {
  const float4* src = blockIdx.y == 0 ? k : v;
  uint4* dst = out + blockIdx.y * n8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = __ldg(src + 2 * i);
    const float4 b = __ldg(src + 2 * i + 1);
    dst[i] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                        pack_bf16(b.z, b.w));
  }
}

// The f32 scores of one 128-key tile for this thread, keys 64 n .. 64 n + 63
// in s[n] (accumulator layout of hopper.cuh).
__device__ __forceinline__ void scores(float (&s)[2][32], uint64_t desc_q, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {   // 16 dims = 32 B along the swizzled rows
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      wgmma_m64n64k16_ss(s[n], desc_q + 2 * kk, desc_sw128(k_tile + n * 64 * 128) + 2 * kk,
                         kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s[0]);
  fence_regs(s[1]);
}

__global__ void __launch_bounds__(kThreads, 1)
cross_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ q, float* __restrict__ o, int nq,
                       int nk) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the swizzled tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_smem = base;
  const uint32_t stage0 = base + kQBytes;
  const uint32_t full0 = stage0 + kStages * kStageBytes;
  const uint32_t empty0 = full0 + kStages * 8;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int n_tiles = nk / kKT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: K tiles for pass 1, then K and V tiles for pass 2
    if (lane == 0) {
      const int row0 = bh * nk;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const bool pass2 = it >= n_tiles;
        const int t = pass2 ? it - n_tiles : it;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, pass2 ? kStageBytes : kTileBytes);
        const uint32_t dst = stage0 + stage * kStageBytes;
        tma_load_2d(dst, &k_map, full, 0, row0 + t * kKT);
        if (pass2) tma_load_2d(dst + kTileBytes, &v_map, full, 0, row0 + t * kKT);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int g = (warp & 3) * 16 + (lane >> 2);   // this thread's rows g, g + 8
  const int c2 = 2 * (lane & 3);                 // and columns c2, c2 + 1 of a chunk
  const int wg_row0 = q0 + wg * kRowsPerWg;
  const bool wg_valid = wg_row0 < nq;            // nq is a multiple of 64

  // Q rows -> bf16, swizzled; rows past nq (a ragged last tile) are zero
  {
    const float4* qg =
        reinterpret_cast<const float4*>(q + ((long long)bh * nq + wg_row0) * kD);
    unsigned char* qs = smem + wg * kRowsPerWg * 128;
#pragma unroll
    for (int i = 0; i < kRowsPerWg * 8 / 128; ++i) {
      const int chunk = tid + 128 * i;       // 16-byte chunk of the bf16 tile
      const int r = chunk >> 3, c = chunk & 7;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (wg_valid) {
        const float4 a = __ldg(qg + 2 * chunk);
        const float4 b = __ldg(qg + 2 * chunk + 1);
        val = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                         pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(qs + r * 128 + ((c ^ (r & 7)) << 4)) = val;
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  const uint64_t desc_q = desc_sw128(q_smem + wg * kRowsPerWg * 128);

  float s[2][32];
  float m[2] = {-INFINITY, -INFINITY};   // in log2 units: max(s) * log2(e)
  float l[2] = {0.0f, 0.0f};             // this thread's share of the row sum
  int stage = 0;
  uint32_t phase = 0;

  // ---- pass 1: row max and row sum of exp
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full0 + 8 * stage, phase);
    scores(s, desc_q, stage0 + stage * kStageBytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    row_stats_update(s, m, l);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  float inv_l[2];
  row_inv_sum(l, inv_l);

  // ---- pass 2: P = bf16(exp(s - m) / l), O += P V
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t tile = stage0 + stage * kStageBytes;
    scores(s, desc_q, tile);
    // one 64-key half at a time: the first half's P V runs while the second
    // half's p is formed, and the scores die as p is packed (128 registers
    // with no spill; p for the whole tile at once spilled)
    const uint64_t desc_v = desc_sw128(tile + kTileBytes);
    uint32_t p[2][16];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      p_fragments(s[n], m, inv_l, p[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys = 16 rows of 128 B
        wgmma_m64n64k16_rs<1>(acc, p[n][4 * kk], p[n][4 * kk + 1], p[n][4 * kk + 2],
                              p[n][4 * kk + 3], desc_v + (4 * n + kk) * (16 * 128 >> 4), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p[0]);
    fence_regs(p[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (!wg_valid) return;
  float* og = o + ((long long)bh * nq + wg_row0) * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(og + (g + 8 * h) * kD + 8 * j + c2) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace

// q: (BH, nq, 64), k/v: (BH, nk, 64), o: (BH, nq, 64), all f32 contiguous;
// scratch: (2, BH * nk, 64) bf16 for the converted K and V. nq must be a
// multiple of 64, nk of 128. Returns the launches' cudaError_t.
extern "C" int facet_cross_attention(const void* q, const void* k, const void* v,
                                     void* o, void* scratch, int bh, int nq, int nk,
                                     int d, void* stream) {
  if (d != kD || nq <= 0 || nq % kRowsPerWg != 0 || nk <= 0 || nk % kKT != 0 ||
      bh <= 0 || bh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bh * nk;
  const long long n8 = rows * kD / 8;
  to_bf16_kernel<<<dim3(264, 2), 256, 0, st>>>(
      static_cast<const float4*>(k), static_cast<const float4*>(v),
      static_cast<uint4*>(scratch), n8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(scratch);
  CUtensorMap k_map, v_map;
  const cuuint64_t dims[2] = {(cuuint64_t)kD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {kD * 2};
  const cuuint32_t box[2] = {kD, kKT};
  if (!make_bf16_map(&k_map, kb, 2, dims, strides, box) ||
      !make_bf16_map(&v_map, kb + rows * kD, 2, dims, strides, box)) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(cross_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cross_attention_kernel<<<dim3((nq + kQT - 1) / kQT, bh), kThreads, kSmemBytes, st>>>(
      k_map, v_map, static_cast<const float*>(q), static_cast<float*>(o), nq, nk);
  return (int)cudaGetLastError();
}

// The main kernel's grid at (bh, nq, nk), reckoned from its tiling: its
// blocks, the blocks resident per SM (as the runtime reckons them), the
// bytes staged into shared memory (each block's bf16 Q rows once, its head's
// bf16 K twice and V once) and the bytes of those K and V copies, which
// read through L2.
extern "C" int facet_cross_attention_geometry(int bh, int nq, int nk, int* blocks,
                                              int* blocks_per_sm, long long* staged_bytes,
                                              long long* l2_bytes) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  *blocks = (nq + kQT - 1) / kQT * bh;
  *l2_bytes = (long long)*blocks * 3 * nk * kD * 2;
  *staged_bytes = *l2_bytes + (long long)*blocks * kQBytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cross_attention_kernel, kThreads, kSmemBytes);
}
