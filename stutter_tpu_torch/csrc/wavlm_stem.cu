// WavLM-Large's 7-conv layer-norm stem for Hopper (sm_90a): raw wave [B, T]
// -> frames [B, L, 512] bf16, unmasked.
//
// Replaces stutter_tpu/ops/wavlm_stem_pallas.py:_stem_kernel (the fused Pallas
// kernel behind wavlm_fused_stem). Layer i maps x_i [B, T_i, C_in] (channels
// last) to x_{i+1} [B, T_{i+1}, 512]:
//
//     acc[t][n] = sum_{j < k, c < C_in} x_i[s t + j][c] * W[n][c][j]     (f32)
//     h         = bf16(bf16(acc) + bf16(bias[n]))
//     z         = bf16(((h - mean_t) * rsqrt(var_t + 1e-5)) * scale[n] + lnb[n])
//     x_{i+1}   = bf16(gelu_tanh(z))
//
// with mean_t and var_t = mean((h - mean_t)^2) over the 512 channels of frame
// t in f32: the rounding points of _ln_gelu in the JAX kernel. Layer 0 is
// k10 s5 over the one-channel wave cast to bf16; layers 1-4 k3 s2; 5-6 k2 s2.
//
// What bounds it on this card. At the 3 s bucket (128 clips x 51,280 samples,
// frames 10,255 -> 160) the stem is ~2.0 TFLOP (layer 1 alone 1.03), ~2.0 ms
// at the bf16 tensor-core peak, while the per-layer intermediates are ~2.7 GB
// out and back in (~0.8 ms at 3.35 TB/s). A conv layer's weight is 1.5 MiB
// (k = 3) or 1 MiB (k = 2) and every block of output frames needs all of it:
// blocks of 64 rows would read ~32 GB of weights from L2 at 3 s (64 FLOP a
// byte), more than L2 delivers in the products' time.
//
// Why not the TPU's block. _stem_kernel computes all 7 layers for 16 output
// frames in VMEM: 1039 layer-0 frames x 512 channels (~1 MB) live, and every
// block re-reads all seven layers' weights (8.4 MB). A Hopper block has at
// most 227 KB of shared memory, so each layer is its own kernel and the bf16
// intermediates go through device memory.
//
// Layers 1-6 (stem_conv_kernel, stem_tiles_sm90.cuh):
// - Each conv is a GEMM on an overlapping strided view of x_i, with no im2col
//   copy: in [B, T, C] layout window t reads rows s t .. s t + k - 1, which
//   are k * 512 contiguous values, so A is [T_out, k * 512] with a row stride
//   of s * 512 values, and B is the weight, packed once on the host
//   (ops/wavlm_stem.py:pack_stem_weights) as K-major tiles of 256 output
//   channels x 64 taps-and-channels, each 32 KB contiguous and already in the
//   128-byte swizzle that wgmma reads.
// - A tile is 128 output frames of one clip: two consumer warpgroups of 64
//   rows, each running wgmma m64n256k16 with both operands in shared memory.
//   The layer norm needs whole 512-channel rows and the accumulators of 128 x
//   512 would not fit in the registers, so the tile's 512 channels run in
//   two passes of 256; h, rounded to bf16 by the contract, is stashed
//   (exact) in its frames' own place in y, which the epilogue overwrites.
// - Two CTAs along the frames form a cluster and share every weight tile:
//   each copies half of it from global memory with one bulk copy multicast
//   to both, so each L2 read of a weight tile feeds 2 x 128 = 256 output
//   rows (a quarter of the 64-row design's weight reads). A producer warp
//   keeps a 4-stage ring (48 KB a stage) full: the weight halves by the bulk
//   copies, the CTA's own A slice (64 channels of one tap for its 128
//   windows) by one tensor copy that takes every other row of x and applies
//   the swizzle (zeros past the clip's end). Full barriers count the bytes;
//   empty barriers count the releases of both CTAs' consumer warpgroups, so
//   a stage is refilled only when both CTAs are done with it. A tile whose
//   rows all lie past T_out still takes part in the copies and barriers and
//   stores nothing.
// - The CTAs are persistent, one an SM, and three epilogue warps finish a
//   tile (statistics, affine, GELU; a warp a row, 16-byte loads and stores
//   of whole rows) while the consumers run the next tile's products, so the
//   tensor cores do not wait for the epilogue.
// Layer 0 (stem_layer0_kernel): K = 10 and one input channel, so its rows are
// 20-byte windows at a 10-byte stride, too unaligned for the copy engines. A
// block of 32 frames stages its 165 samples in shared memory as bf16 and
// builds mma.sync m16n8k16 A fragments from there, zero-padded to K = 16; the
// frames go out through shared memory in 16-byte stores. It is bound by its
// 1.34 GB of output at 3 s, and by the layer norm's and the GELU's
// instructions, not by its products. Layer 0 is not computed inside layer
// 1's producer: each 128-frame tile of layer 1 would evaluate ~131 k layer-0
// values (257 frames x 512 channels, with 10 products, the layer norm and a
// tanh each), twice the layer's values, more issue slots than the round
// trip of its output saves.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stem_tiles_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 512;                     // channels of every layer's output
constexpr int kLayers = 7;
constexpr int kKernels[kLayers] = {10, 3, 3, 3, 3, 2, 2};
constexpr int kStrides[kLayers] = {5, 2, 2, 2, 2, 2, 2};

// layer 0
constexpr int kBM = 32;                     // output frames per block
constexpr int kMT = kBM / 16;               // m16 tiles per warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpN = kC / kWarps;         // 64 columns per warp
constexpr int kWStride = kC + 8;            // 1040-byte rows, conflict-free
constexpr int kL0Taps = 10;
constexpr int kL0Stride = 5;
constexpr int kL0Rows = 16;                 // layer 0's taps, zero-padded
constexpr int kL0Span = kL0Stride * (kBM - 1) + kL0Taps;  // 165 samples a block
constexpr int kL0Smem = (kL0Rows + kBM) * kWStride * 2;   // weights, then the staged frames

// layers 1-6
namespace conv {
constexpr int kStride = 2;
constexpr int kBM = 128;                    // output frames a tile
constexpr int kBN = 256;                    // channels a pass (two passes)
constexpr int kBK = 64;                     // contraction a stage: one 128-byte row
constexpr int kStages = 4;
constexpr int kCluster = 2;                 // CTAs along the frames sharing each weight tile
constexpr int kConsumers = 2;               // warpgroups of 64 rows
constexpr int kEpilogueWarps = 3;
constexpr int kThreads = 128 * kConsumers + 32 + 32 * kEpilogueWarps;  // and a producer warp
constexpr int kATile = kBM * kBK * 2;       // 16 KB
constexpr int kBTile = kBN * kBK * 2;       // 32 KB
constexpr int kStage = kATile + kBTile;
constexpr int kBarBytes = (2 * kStages + 2) * 8;  // the ring's, and the epilogue's
constexpr int kSmem = 1024 + kStages * kStage + kBarBytes;
static_assert(kATile % 1024 == 0 && kStage % 1024 == 0, "tiles start a swizzle period");
static_assert(kSmem <= 232448, "one CTA an SM");
static_assert(kC == 2 * kBN, "two passes of 256 channels");
}  // namespace conv

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<unsigned*>(&p);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2,
                                                  unsigned& r3, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of the warp's 8 n-tiles for k rows k0 .. k0 + 15 of a row-major
// [k][kWStride] tile: x4.trans over (k0..7, tile j), (k8..15, tile j), and the
// same for tile j + 1; lane l addresses row (l & 7) of matrix l >> 3.
__device__ __forceinline__ void load_b_frags(unsigned (&bfr)[8][2], const bf16* ws, int k0,
                                             int lane, int warp) {
  const int mat = lane >> 3;
  const int k = k0 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int n = warp * kWarpN + (2 * p + (mat >> 1)) * 8;
    ldmatrix_x4_trans(bfr[2 * p][0], bfr[2 * p][1], bfr[2 * p + 1][0], bfr[2 * p + 1][1],
                      ws + k * kWStride + n);
  }
}

// Row sums across the block. part[j] is this thread's partial sum of row
// 16 (j >> 1) + g + 8 (j & 1); returns each row's total in part, summed over
// the warps in order.
__device__ __forceinline__ void block_row_sums(float (&part)[2 * kMT], float* red, int warp,
                                               int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 2 * kMT; ++j) {
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 1);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 2);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2 * kMT; ++j) red[warp * kBM + 16 * (j >> 1) + g + 8 * (j & 1)] = part[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2 * kMT; ++j) {
    const int row = 16 * (j >> 1) + g + 8 * (j & 1);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kBM + row];
    part[j] = s;
  }
  __syncthreads();  // red is written again by the next reduction
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // PyTorch's tanh GELU, in its order of operations
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// acc[mi][ni][e]: row 16 mi + g + 8 (e >> 1), column 64 warp + 8 ni + 2 c4 + (e & 1)
// of the block's [32, 512] tile (the mma.sync C layout). Writes the finished
// frames t0 + row < T_out of clip b, through `staged` ([32][kWStride] bf16).
__device__ __forceinline__ void bias_ln_gelu_store(float (&acc)[kMT][8][4],
                                                   const float* __restrict__ vec,
                                                   bf16* __restrict__ y, int b, int t0,
                                                   int T_out, float* red, bf16* staged) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int col0 = warp * kWarpN + 2 * c4;

  float part[2 * kMT];
#pragma unroll
  for (int j = 0; j < 2 * kMT; ++j) part[j] = 0.f;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const float bias[2] = {bf16_round(vec[col0 + 8 * ni]), bf16_round(vec[col0 + 8 * ni + 1])};
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = bf16_round(bf16_round(acc[mi][ni][e]) + bias[e & 1]);
        acc[mi][ni][e] = h;
        part[2 * mi + (e >> 1)] += h;
      }
  }
  block_row_sums(part, red, warp, lane);
  float mean[2 * kMT];
#pragma unroll
  for (int j = 0; j < 2 * kMT; ++j) {
    mean[j] = part[j] * (1.f / kC);
    part[j] = 0.f;
  }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = acc[mi][ni][e] - mean[2 * mi + (e >> 1)];
        part[2 * mi + (e >> 1)] += d * d;
      }
  block_row_sums(part, red, warp, lane);
  float rstd[2 * kMT];
#pragma unroll
  for (int j = 0; j < 2 * kMT; ++j) rstd[j] = rsqrtf(part[j] * (1.f / kC) + 1e-5f);

  const float* scale = vec + kC;
  const float* shift = vec + 2 * kC;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = col0 + 8 * ni;
    const float sc[2] = {scale[col], scale[col + 1]};
    const float sh[2] = {shift[col], shift[col + 1]};
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * mi + half;
        float o[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float z = __fmul_rn(__fsub_rn(acc[mi][ni][2 * half + c], mean[j]), rstd[j]);
          z = __fadd_rn(__fmul_rn(z, sc[c]), sh[c]);
          o[c] = gelu_tanh(bf16_round(z));
        }
        *reinterpret_cast<__nv_bfloat162*>(staged + (16 * mi + g + 8 * half) * kWStride + col) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
  }
  __syncthreads();
  // 32 rows of 1024 bytes: 64 16-byte chunks a row, a warp two rows
#pragma unroll
  for (int i = 0; i < kBM * kC / 8 / kThreads; ++i) {
    const int e = tid + kThreads * i;
    const int r = e / (kC / 8), q = e % (kC / 8);
    if (t0 + r < T_out)
      *reinterpret_cast<uint4*>(y + ((long long)b * T_out + t0 + r) * kC + 8 * q) =
          *reinterpret_cast<const uint4*>(staged + r * kWStride + 8 * q);
  }
}

// Layers 1-6: k = kTaps, s = 2, C_in = 512. Persistent: the grid is as many
// clusters of conv::kCluster CTAs as fit on the card, and cluster c walks
// the units u = c, c + clusters, ... of (clip, pair of 128-frame tiles);
// CTA `rank` of a cluster takes tile 2 p + rank of pair p. x_map: the input
// frames, a [B][T_in][512] bf16 tensor map whose box is 64 channels of 128
// rows at a row stride of 2 (one tap of 128 windows); w: the layer's tiles,
// [2 passes][kTaps * 8 chunks][256][64] bf16, each in the 128-byte swizzle.
template <int kTaps>
__global__ void __launch_bounds__(conv::kThreads, 1) stem_conv_kernel(
    const __grid_constant__ CUtensorMap x_map, const bf16* __restrict__ w,
    const float* __restrict__ vec, bf16* __restrict__ y, int T_out, int pairs, int units) {
  constexpr int kStride = conv::kStride, kBM = conv::kBM, kBN = conv::kBN, kBK = conv::kBK;
  constexpr int kStages = conv::kStages, kCluster = conv::kCluster;
  constexpr int kConsumers = conv::kConsumers, kEpilogueWarps = conv::kEpilogueWarps;
  constexpr int kATile = conv::kATile, kBTile = conv::kBTile, kStage = conv::kStage;
  constexpr int kChunks = kTaps * kC / kBK;  // stages of one pass
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t h_full = bars + 16 * kStages, h_empty = h_full + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = sm90::cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);                       // the producer, and the bytes
      sm90::mbar_init(empty(s), kCluster * kConsumers);  // every consumer of the cluster
    }
    sm90::mbar_init(h_full, 128 * kConsumers);
    sm90::mbar_init(h_empty, 32 * kEpilogueWarps);
    sm90::fence_mbar_init();
  }
  sm90::cluster_sync();

  if (warp == 4 * kConsumers) {
    // The producer. Stage s of iteration it holds chunk it % kChunks of a
    // pass: this CTA's A slice (rows 2 t + tap of its 128 frames t, 64
    // channels) by a tensor copy, and its half of the weight tile, multicast
    // to both CTAs of the cluster.
    if (lane == 0) {
      int it = 0;
      for (int u = cluster; u < units; u += clusters) {
        const int b = u / pairs, t0 = kBM * (2 * (u % pairs) + (int)rank);
        for (int pass = 0; pass < 2; ++pass)
          for (int chunk = 0; chunk < kChunks; ++chunk, ++it) {
            const int s = it % kStages;
            sm90::mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
            const uint32_t a_dst = ring + s * kStage;
            const int k0 = chunk * kBK;
            sm90::mbar_arrive_expect_tx(full(s), kATile + kBTile);
            sm90::tma_load_3d(a_dst, &x_map, k0 % kC, kStride * t0 + k0 / kC, b, full(s));
            const bf16* src =
                w + ((long long)(pass * kChunks + chunk) * kBN + rank * (kBN / kCluster)) * kBK;
            sm90::bulk_copy_multicast(a_dst + kATile + rank * (kBTile / kCluster), src,
                                      kBTile / kCluster, full(s), (1u << kCluster) - 1);
          }
      }
    }
    __syncwarp();
  } else if (warp > 4 * kConsumers) {
    // The epilogue warps: a warp takes a row at a time, each lane 8
    // channels of either pass, and writes the finished frames while the
    // consumers run the next unit's products. The statistics are two-pass
    // (the mean, then the mean of squared deviations), in f32, summed by
    // each lane over its 16 channels and then across the warp.
    const int ew = warp - 4 * kConsumers - 1;
    float sc[16], sh[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = (i < 8 ? 0 : kBN - 8) + 8 * lane + i;
      sc[i] = vec[kC + col];
      sh[i] = vec[2 * kC + col];
    }
    int k = 0;
    for (int u = cluster; u < units; u += clusters, ++k) {
      const int b = u / pairs, t0 = kBM * (2 * (u % pairs) + (int)rank);
      sm90::mbar_wait(h_full, k & 1);
      for (int r = ew; r < kBM && t0 + r < T_out; r += kEpilogueWarps) {
        bf16* yr = y + ((long long)b * T_out + t0 + r) * kC;
        const uint4 lo = *reinterpret_cast<const uint4*>(yr + 8 * lane);  // the stashed h
        const uint4 hi = *reinterpret_cast<const uint4*>(yr + kBN + 8 * lane);
        const __nv_bfloat162* p0 = reinterpret_cast<const __nv_bfloat162*>(&lo);
        const __nv_bfloat162* p1 = reinterpret_cast<const __nv_bfloat162*>(&hi);
        float v[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[2 * i] = __low2float(p0[i]);
          v[2 * i + 1] = __high2float(p0[i]);
          v[8 + 2 * i] = __low2float(p1[i]);
          v[8 + 2 * i + 1] = __high2float(p1[i]);
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += v[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float mean = sum * (1.f / kC);
        float dev = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float d = v[i] - mean;
          dev += d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dev += __shfl_xor_sync(0xffffffffu, dev, o);
        const float rstd = rsqrtf(dev * (1.f / kC) + 1e-5f);
        uint4 out[2];
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float o[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * i + j;
            float z = __fmul_rn(__fsub_rn(v[e], mean), rstd);
            z = __fadd_rn(__fmul_rn(z, sc[e]), sh[e]);
            o[j] = gelu_tanh(bf16_round(z));
          }
          q[i] = __floats2bfloat162_rn(o[0], o[1]);
        }
        *reinterpret_cast<uint4*>(yr + 8 * lane) = out[0];
        *reinterpret_cast<uint4*>(yr + kBN + 8 * lane) = out[1];
      }
      sm90::mbar_arrive(h_empty);
    }
  } else {
    // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
    const int wg = tid >> 7, wq = warp & 3;
    const int grp = lane >> 2, tig = lane & 3;
    const int row0 = 64 * wg + 16 * wq + grp;  // this thread's rows: row0, row0 + 8
    // a warpgroup's release of a stage: one thread signals each CTA of the cluster
    const bool signals = (tid & 127) % 32 == 0 && (tid & 127) / 32 < kCluster;
    auto release = [&](int s) {
      if (signals) sm90::mbar_arrive_cluster(empty(s), (tid & 127) / 32);
    };
    float acc[128];
    int it = 0, k = 0;
    for (int u = cluster; u < units; u += clusters, ++k) {
      const int b = u / pairs, t0 = kBM * (2 * (u % pairs) + (int)rank);
      for (int pass = 0; pass < 2; ++pass) {
        for (int c = 0; c < kChunks; ++c, ++it) {
          const int s = it % kStages;
          sm90::mbar_wait(full(s), (it / kStages) & 1);
          const uint32_t stage = ring + s * kStage;
          const uint64_t a_desc = sm90::swizzled_desc(stage + wg * (64 * 128));
          const uint64_t b_desc = sm90::swizzled_desc(stage + kATile);
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)  // a k-step is 16 values: 32 bytes along the rows
            sm90::wgmma_m64n256k16_ss(acc, a_desc + 2 * kk, b_desc + 2 * kk, c > 0 || kk > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the previous stage's products are done
          sm90::fence_regs(acc);
          if (c > 0) release((it - 1) % kStages);
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release((it - 1) % kStages);

        // h = bf16(bf16(acc) + bf16(bias)), stashed (exact) in its frames'
        // own place in y for the epilogue warps, which may still be reading
        // the previous tile's until they release it
        if (pass == 1) sm90::mbar_wait(h_empty, (k & 1) ^ 1);
#pragma unroll
        for (int nt = 0; nt < 32; ++nt) {
          const int col = kBN * pass + 8 * nt + 2 * tig;
          const float bias[2] = {bf16_round(vec[col]), bf16_round(vec[col + 1])};
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(
                bf16_round(acc[4 * nt + 2 * a]) + bias[0],
                bf16_round(acc[4 * nt + 2 * a + 1]) + bias[1]);
            const int r = row0 + 8 * a;
            if (t0 + r < T_out)
              *reinterpret_cast<__nv_bfloat162*>(y + ((long long)b * T_out + t0 + r) * kC + col) =
                  h;
          }
        }
        if (pass == 1) sm90::mbar_arrive(h_full);
      }
    }
  }
  sm90::cluster_sync();  // no CTA leaves while its peer may still signal its barriers
}

// Layer 0: k10 s5 over the one-channel wave (f32, cast to bf16 here).
// Dynamic shared memory: kL0Smem bytes.
__global__ void __launch_bounds__(kThreads, 2) stem_layer0_kernel(
    const float* __restrict__ wave, const bf16* __restrict__ w0, const float* __restrict__ vec,
    bf16* __restrict__ y, int T, int T_out) {
  extern __shared__ __align__(16) bf16 l0_smem[];
  bf16* wsm = l0_smem;                      // [kL0Rows][kWStride]
  bf16* staged = wsm + kL0Rows * kWStride;  // [kBM][kWStride]
  __shared__ bf16 xs[kL0Span];
  __shared__ float red[kWarps * kBM];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;

  for (int e = tid; e < kL0Rows * kC / 8; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    *reinterpret_cast<uint4*>(wsm + r * kWStride + c * 8) =
        *reinterpret_cast<const uint4*>(w0 + r * kC + c * 8);
  }
  const long long s0 = (long long)kL0Stride * t0;
  const float* wb = wave + (long long)b * T;
  for (int e = tid; e < kL0Span; e += kThreads)
    xs[e] = __float2bfloat16_rn(s0 + e < T ? wb[s0 + e] : 0.f);
  __syncthreads();

  // A[r][k] = xs[5 r + k] for k < 10, else 0 (rows past T_out read zeros or
  // samples of this clip and are not stored)
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto a_at = [&](int r, int k) { return k < kL0Taps ? xs[kL0Stride * r + k] : zero; };
  unsigned bfr[8][2];
  load_b_frags(bfr, wsm, 0, lane, warp);
  float acc[kMT][8][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    const int r = 16 * mi + g;
    const int k = 2 * c4;
    const unsigned af[4] = {pack_bf16(a_at(r, k), a_at(r, k + 1)),
                            pack_bf16(a_at(r + 8, k), a_at(r + 8, k + 1)),
                            pack_bf16(a_at(r, k + 8), a_at(r, k + 9)),
                            pack_bf16(a_at(r + 8, k + 8), a_at(r + 8, k + 9))};
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      mma_bf16(acc[mi][ni], af, bfr[ni]);
    }
  }
  bias_ln_gelu_store(acc, vec, y, b, t0, T_out, red, staged);
}

// cuTensorMapEncodeTiled from the driver, looked up once through the runtime
// (the library links no driver library); null if the driver lacks it.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  }
  return fn;
}

template <int kTaps>
int launch_conv(const bf16* x, const bf16* w, const float* vec, bf16* y, int B, int T_in,
                int T_out, cudaStream_t stream) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // x as [B][T_in][512]; the box: 64 channels of 128 rows taken every other row
  alignas(64) CUtensorMap x_map;
  const cuuint64_t dims[3] = {(cuuint64_t)kC, (cuuint64_t)T_in, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)kC * 2, (cuuint64_t)T_in * kC * 2};
  const cuuint32_t box[3] = {conv::kBK, conv::kStride * conv::kBM, 1};
  const cuuint32_t steps[3] = {1, conv::kStride, 1};
  const CUresult made = encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x),
                               dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (made != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  auto kernel = stem_conv_kernel<kTaps>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, conv::kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(conv::kCluster);
  config.blockDim = dim3(conv::kThreads);
  config.dynamicSmemBytes = conv::kSmem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = conv::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int resident = 0;  // clusters the card holds at once
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (T_out + conv::kBM - 1) / conv::kBM;
  const int pairs = (tiles + conv::kCluster - 1) / conv::kCluster;
  const long long units = (long long)B * pairs;
  if (units > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  config.gridDim = dim3(conv::kCluster * (unsigned)std::min<long long>(units, resident));
  err = cudaLaunchKernelEx(&config, kernel, x_map, w, vec, y, T_out, pairs, (int)units);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// wave: [B, T] f32; weights: bf16 [16 + 4 * 1536 + 2 * 1024, 512], layer by
// layer: layer 0's tap-major [16, 512] matrix (its 10 taps, zero-padded), then
// each conv layer's k * 512 rows holding its wgmma tiles ([2 passes of 256
// output channels][k * 8 chunks of 64 of the tap-major contraction][256][64],
// K-major, 16-byte groups of a row swizzled by the row's index mod 8: see
// ops/wavlm_stem.py:pack_stem_weights); table: f32 [7, 3, 512] (conv bias, LN scale, LN bias);
// buf0: bf16 [B, T_0, 512] and buf1: bf16 [B, T_1, 512] for the intermediate
// layers (layers 0, 2, 4 write buf0; 1, 3, 5 buf1); out: bf16 [B, T_6, 512].
// All contiguous and 16-byte aligned; T >= 400. Launches the 7 layers on
// `stream` in order and returns the first nonzero cudaGetLastError() (0 on
// success).
extern "C" int wavlm_fused_stem(const void* wave, const void* weights, const void* table,
                                void* buf0, void* buf1, void* out, int B, int T,
                                void* stream) {
  if (B <= 0 || B > 65535 || T < 400) return (int)cudaErrorInvalidValue;
  int lengths[kLayers];
  int L = T;
  for (int i = 0; i < kLayers; ++i) {
    L = (L - kKernels[i]) / kStrides[i] + 1;
    lengths[i] = L;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* w = static_cast<const bf16*>(weights);
  const float* vec = static_cast<const float*>(table);
  bf16* src = static_cast<bf16*>(buf0);
  bf16* spare = static_cast<bf16*>(buf1);

  int rc = (int)cudaFuncSetAttribute(stem_layer0_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kL0Smem);
  if (rc != 0) return rc;
  const dim3 grid0((lengths[0] + kBM - 1) / kBM, B);
  stem_layer0_kernel<<<grid0, kThreads, kL0Smem, s>>>(static_cast<const float*>(wave), w, vec, src,
                                                      T, lengths[0]);
  rc = (int)cudaGetLastError();
  long long row = kL0Rows;
  for (int i = 1; i < kLayers && rc == 0; ++i) {
    bf16* dst = i == kLayers - 1 ? static_cast<bf16*>(out) : spare;
    const bf16* wi = w + row * kC;
    const float* vi = vec + (long long)i * 3 * kC;
    rc = kKernels[i] == 3
             ? launch_conv<3>(src, wi, vi, dst, B, lengths[i - 1], lengths[i], s)
             : launch_conv<2>(src, wi, vi, dst, B, lengths[i - 1], lengths[i], s);
    row += (long long)kKernels[i] * kC;
    spare = src;
    src = dst;
  }
  return rc;
}
