// Self-attention of the CLIP ViT (257 tokens, heads of 64), bf16.
//
// Replaces: JAX's Pallas TPU flash-attention kernel as
// facet_tpu/models/clip.py:_flash_attention calls it. At the engine's
// schedule the 257 tokens, padded to 384, form one key block, so that
// kernel's pallas_call runs _flash_attention_kernel_single_batch_single_step.
// Numerics follow that body:
//   - scores accumulated in f32 from the unscaled bf16 q and k, then
//     multiplied by `scale` in f32;
//   - keys at or past the sequence length excluded (the TPU kernel masks its
//     padding by segment ids; the masked exp is exactly 0);
//   - the row max, p = exp(s - max) and the row sum l in f32;
//   - p / l rounded to bf16 (normalized before the rounding);
//   - P V accumulated in f32 and rounded once to bf16.
// exp is taken as exp2 of the score times log2(e), and p / l as p times one
// reciprocal of l per row: both move f32 rounding by about an ulp.
//
// What bounds it on an H100: bytes. At the engine's batch of 24, q, k, v
// and the output, (24, 257, 16, 64) bf16 each, are 50.5 MB: 0.0151 ms at
// 3.35 TB/s, against 6.49 GFLOP of tensor-core work, 0.0066 ms at 989
// TFLOP/s. The scores (24 x 16 x 257 x 257 in f32, 102 MB) must not reach
// device memory.
//
// Design: one block of two warpgroups per (batch, head), so each head's K
// and V reach shared memory once per launch. Thread 0 issues TMA loads of
// all the head's 64-key K and V tiles straight from the (B, S, H, D) layout
// (a 4-D tensor map; keys >= S read as zeros, so no padding is written to
// device memory), one mbarrier per tile, so compute starts when the first
// tile lands. The warpgroups take the head's 64-row query tiles in turn
// (tiles 0, 2, 4 and 1, 3 at 257 tokens: the lone 257th row rides in tile 4
// over the K/V already staged). Each warpgroup loads its query tile by TMA
// into its own buffer, moves it into wgmma A fragments in registers, and
// issues the TMA for its next tile at once. Per query tile, over the key
// tiles:
//   1. S = Q K^T by wgmma (Q from registers, K from shared memory) into
//      registers, times `scale`, keys >= S set to -inf; the running row max
//      and rescaled sum, reduced over the quad of lanes holding a row;
//   2. S again, p = bf16(exp(s - m) / l) formed in registers as wgmma A
//      fragments, O += P V by wgmma with V (MN-major) from shared memory;
//      O rounded to bf16 and written for the rows < S.
// Shared memory is 1,152 + 8,192 * (2 * ceil(S / 64) + 2) bytes: 99,456 at
// 257 tokens (two blocks per SM), 132,224 at the 400-token maximum.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;            // head dim
constexpr int kT = 64;            // query rows and keys per tile
constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;
constexpr int kMaxSeq = 400;
constexpr int kMaxTiles = (kMaxSeq + kT - 1) / kT;
constexpr int kTileBytes = kT * kD * 2;        // 8 KB
constexpr int kBarriers = 2 * kMaxTiles + kWarpgroups;

__host__ __device__ constexpr size_t smem_bytes(int n_tiles) {
  return 1024 + (size_t)(2 * n_tiles + kWarpgroups) * kTileBytes + kBarriers * 8;
}

// S = Q K^T for key tile kt, times `scale`, keys >= seq set to -inf: Q in
// A fragments, the K tile in shared memory; c2 is this thread's first column
// of an 8-key chunk (accumulator layout of hopper.cuh)
__device__ __forceinline__ void scores(float (&s)[1][32], const uint32_t (&qa)[16],
                                       uint32_t k_tile, int kt, int c2, int seq,
                                       float scale) {
  const uint64_t desc = desc_sw128(k_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_m64n64k16_rs<0>(s[0], qa[4 * kk], qa[4 * kk + 1], qa[4 * kk + 2], qa[4 * kk + 3],
                          desc + 2 * kk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s[0]);
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kt * kT + 8 * j + c2 + (e & 1);
      s[0][4 * j + e] = col < seq ? s[0][4 * j + e] * scale : -INFINITY;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
vit_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     __nv_bfloat16* __restrict__ o, int seq, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int n_tiles = (seq + kT - 1) / kT;
  const uint32_t k0 = base;
  const uint32_t v0 = k0 + n_tiles * kTileBytes;
  const uint32_t q_buf0 = v0 + n_tiles * kTileBytes;
  const uint32_t kfull0 = q_buf0 + kWarpgroups * kTileBytes;
  const uint32_t vfull0 = kfull0 + kMaxTiles * 8;
  const uint32_t qfull0 = vfull0 + kMaxTiles * 8;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t q_buf = q_buf0 + wg * kTileBytes;
  const uint32_t qfull = qfull0 + 8 * wg;

  if (threadIdx.x == 0) {
    for (int i = 0; i < n_tiles; ++i) {
      mbar_init(kfull0 + 8 * i, 1);
      mbar_init(vfull0 + 8 * i, 1);
    }
    for (int w = 0; w < kWarpgroups; ++w) mbar_init(qfull0 + 8 * w, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && wg < n_tiles) {
    mbar_expect_tx(qfull, kTileBytes);
    tma_load_4d(q_buf, &q_map, qfull, 0, head, wg * kT, batch);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_tiles; ++i) {
      mbar_expect_tx(kfull0 + 8 * i, kTileBytes);
      tma_load_4d(k0 + i * kTileBytes, &k_map, kfull0 + 8 * i, 0, head, i * kT, batch);
    }
    for (int i = 0; i < n_tiles; ++i) {
      mbar_expect_tx(vfull0 + 8 * i, kTileBytes);
      tma_load_4d(v0 + i * kTileBytes, &v_map, vfull0 + 8 * i, 0, head, i * kT, batch);
    }
  }

  const int g = warp * 16 + (lane >> 2);   // this thread's rows g, g + 8
  const int c2 = 2 * (lane & 3);           // and columns c2, c2 + 1 of a chunk
  const long long row_stride = (long long)heads * kD;

  int it = 0;
  for (int qt = wg; qt < n_tiles; qt += kWarpgroups, ++it) {
    // the query tile -> A fragments (hopper.cuh), then the buffer is free
    mbar_wait(qfull, it & 1);
    uint32_t qa[16];
    {
      const unsigned char* qs = smem + (q_buf - base);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + 8 * (i & 1);
          const int chunk = 2 * kk + (i >> 1);
          qa[4 * kk + i] = *reinterpret_cast<const uint32_t*>(
              qs + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * c2);
        }
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0 && qt + kWarpgroups < n_tiles) {
      mbar_expect_tx(qfull, kTileBytes);
      tma_load_4d(q_buf, &q_map, qfull, 0, head, (qt + kWarpgroups) * kT, batch);
    }

    // ---- 1. row max and row sum of exp over all key tiles
    float s[1][32];
    float m[2] = {-INFINITY, -INFINITY};   // in log2 units: max(x) * log2(e)
    float l[2] = {0.0f, 0.0f};             // this thread's share of the row sum
    for (int kt = 0; kt < n_tiles; ++kt) {
      mbar_wait(kfull0 + 8 * kt, 0);
      scores(s, qa, k0 + kt * kTileBytes, kt, c2, seq, scale);
      row_stats_update(s, m, l);
    }
    float inv_l[2];
    row_inv_sum(l, inv_l);

    // ---- 2. p = bf16(exp(x - m) / l), O += P V
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      scores(s, qa, k0 + kt * kTileBytes, kt, c2, seq, scale);
      uint32_t p[16];
      p_fragments(s[0], m, inv_l, p);
      mbar_wait(vfull0 + 8 * kt, 0);
      const uint64_t desc_v = desc_sw128(v0 + kt * kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        wgmma_m64n64k16_rs<1>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                              desc_v + kk * (16 * 128 >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p);
    }

    // ---- O rows < seq -> (B, S, H, 64) bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = qt * kT + g + 8 * h;
      if (t < seq) {
        __nv_bfloat16* orow = o + ((long long)batch * seq + t) * row_stride + head * kD;
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          *reinterpret_cast<uint32_t*>(orow + 8 * j + c2) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// q, k, v, o: (batch, seq, heads, 64) bf16 contiguous, 16-byte aligned.
// o = softmax(q k^T * scale) v per (batch, head). Returns the launch's
// cudaError_t.
extern "C" int facet_vit_attention(const void* q, const void* k, const void* v, void* o,
                                   int batch, int seq, int heads, int d, float scale,
                                   void* stream) {
  if (d != kD || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      seq <= 0 || seq > kMaxSeq) {
    return (int)cudaErrorInvalidValue;
  }
  // dims innermost first: (64, heads, seq, batch); one box is a 64-token
  // tile of one head, 64 rows of 128 B
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {kD * 2, (cuuint64_t)heads * kD * 2,
                                 (cuuint64_t)seq * heads * kD * 2};
  const cuuint32_t box[4] = {kD, 1, kT, 1};
  CUtensorMap q_map, k_map, v_map;
  if (!make_bf16_map(&q_map, q, 4, dims, strides, box) ||
      !make_bf16_map(&k_map, k, 4, dims, strides, box) ||
      !make_bf16_map(&v_map, v, 4, dims, strides, box)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes((seq + kT - 1) / kT);
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  vit_attention_kernel<<<dim3(heads, batch), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), seq, heads, scale);
  return (int)cudaGetLastError();
}

// The kernel's grid at (batch, seq, heads), reckoned from its tiling: its
// blocks, the blocks resident per SM (as the runtime reckons them) and the
// bytes staged into shared memory (each head's K and V tiles once and each
// query tile once, zero-filled rows included).
extern "C" int facet_vit_attention_geometry(int batch, int seq, int heads, int* blocks,
                                            int* blocks_per_sm, long long* staged_bytes) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seq > kMaxSeq) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (seq + kT - 1) / kT;
  *blocks = batch * heads;
  *staged_bytes = (long long)*blocks * 3 * n_tiles * kTileBytes;
  const size_t smem = smem_bytes(n_tiles);
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            vit_attention_kernel, kThreads, smem);
}
