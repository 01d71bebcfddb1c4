// Flash-attention forward tiles written for Hopper before its wgmma tiles
// (attention_tiles_sm90.cuh, which every bf16 forward of the port runs on),
// and the pieces that other bf16 kernels build on. What uses what:
// - the f32 forward kernel below (scalar FMAs: the tensor cores would round
//   f32 to TF32) is the f32 path of the WavLM gated attention
//   (wavlm_attention.cu, policy GatedBias below) and of flash_mha and
//   flash_mha_bias (flash_mha.cu, policies KeyPadding and FullBias);
// - the mma.sync m16n8k16 helpers, the 32-row / 32-key tile constants and
//   the GatedBias policy are used by the WavLM backward
//   (wavlm_attention_bwd.cu); GatedBias is also the base of the bf16 gated
//   forward's GatedBiasRing (wavlm_attention.cu). The probes (attn_probes.cu)
//   run on attention_tiles_sm90.cuh.
// For one (clip b, head h, query row i):
//
//     p[j]   = score(i, j, q[i] . k[j])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled, head_dim 64 (the f32 kernel also 120: KeyPadding for
// wav2vec2 XLS-R), and `score` a compile-time policy that adds
// whatever the caller's logits carry beyond q . k: WavLM's gate * bias + mask
// (GatedBias below), Whisper's key padding (KeyPadding in flash_mha.cu), or a
// materialised bias (FullBias in flash_mha.cu). A policy is a struct with a
// `Params` struct passed by value to the kernel, a constructor (params, b, h,
// rows[2], H, L) for the two query rows a thread owns, and
// `float operator()(int a, int kj, float s)` for row a and key kj < L.
// Scores, softmax and both sums are f32. Given a non-null `row_stats`
// ([2, B, H, L] f32), a kernel also writes each query row's score max
// (plane 0) and the log of its sum of exp(score - max) (plane 1), which the
// WavLM backward (wavlm_attention_bwd.cu) recomputes the probabilities from;
// the two stay apart because a fully padded row scores -1e9 everywhere,
// where max + log(sum) would round back to the max. The bf16 tiles of
// attention_tiles_sm90.cuh write the same two planes.
//
// Design of the f32 kernel:
// - One thread block per (clip, 32-row query tile, head), with the clip index
//   fastest in the grid.
// - K and V go through shared memory in 32-key tiles; the softmax is online
//   (running max and sum per row), so a tile's scores live only in registers
//   whatever L is, and the policy's additive terms are formed there.
// - The ragged edge (L not a multiple of 32) is masked here: padded query
//   rows are computed on zeros and not stored, keys past L score -inf. The
//   caller never pads L.
// - At head_dim 120 a key tile is 16 keys, so that the tiles stay within the
//   48 KB of static shared memory (32 keys of 120 floats for K and V would
//   not).
// - q, k, v and out may be any [B, H, L, d] view whose last dimension is
//   contiguous (the models pass their [B, L, H, 64] projections transposed),
//   so no copy is made to reach a head-major layout.
//
// Each .cu that includes this header includes it once; everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 32;  // query rows per block
constexpr int kBlockK = 32;  // keys per shared-memory tile

// ---------------------------------------------------------------------------
// f32: scalar FMAs. Thread t owns query rows 2*(t/8) + {0, 1} of the tile,
// score columns (t%8) + 8*m of each key tile (m < 4) and output columns
// (t%8) + 8*n (n < 8). The 8 lanes that share a row are adjacent in one warp,
// so row maxima and sums reduce with three xor shuffles.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;

template <class Score, int kHd>
__global__ void __launch_bounds__(kF32Threads) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const typename Score::Params params,
    float* __restrict__ out, float* __restrict__ row_stats, int B, int H, int L,
    long long stride_b, long long stride_h, long long stride_l) {
  static_assert(kHd % 8 == 0, "a thread owns output columns tx + 8 n");
  constexpr int kKeys = kHd > kHeadDim ? 16 : kBlockK;  // keys a shared-memory tile
  constexpr int kCols = kHd / 8;  // output columns a thread, per row
  __shared__ float qs[kBlockQ][kHd + 1];
  __shared__ float ks[kKeys][kHd + 1];
  __shared__ float vs[kKeys][kHd];
  __shared__ float ps[kBlockQ][kKeys + 1];

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const long long base = b * stride_b + h * stride_h;

  // Stage the query tile; rows past L read as zeros.
  for (int e = tid; e < kBlockQ * kHd; e += kF32Threads) {
    const int r = e / kHd, c = e % kHd;
    const int qi = q0 + r;
    qs[r][c] = qi < L ? q[base + qi * stride_l + c] : 0.f;
  }

  const int rows[2] = {q0 + 2 * ty, q0 + 2 * ty + 1};
  const Score score(params, b, h, rows, H, L);

  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};
  float acc[2][kCols];
  for (int a = 0; a < 2; ++a)
    for (int n = 0; n < kCols; ++n) acc[a][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int e = tid; e < kKeys * kHd; e += kF32Threads) {
      const int r = e / kHd, c = e % kHd;
      const int kj = k0 + r;
      const bool ok = kj < L;
      const long long off = base + kj * stride_l + c;
      ks[r][c] = ok ? k[off] : 0.f;
      vs[r][c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float s[2][kKeys / 8];
    for (int a = 0; a < 2; ++a)
      for (int m = 0; m < kKeys / 8; ++m) s[a][m] = 0.f;
#pragma unroll 16
    for (int c = 0; c < kHd; ++c) {
      const float q_a = qs[2 * ty][c];
      const float q_b = qs[2 * ty + 1][c];
#pragma unroll
      for (int m = 0; m < kKeys / 8; ++m) {
        const float kv = ks[tx + 8 * m][c];
        s[0][m] = fmaf(q_a, kv, s[0][m]);
        s[1][m] = fmaf(q_b, kv, s[1][m]);
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int m = 0; m < kKeys / 8; ++m) {
        const int kj = k0 + tx + 8 * m;
        s[a][m] = kj < L ? score(a, kj, s[a][m]) : -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[a][m]);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
      // Key 0 lies in the first tile and every policy keeps a key < L
      // finite, so the running max is finite from then on.
      const float new_max = fmaxf(row_max[a], tile_max);
      const float rescale = expf(row_max[a] - new_max);
      float tile_sum = 0.f;
#pragma unroll
      for (int m = 0; m < kKeys / 8; ++m) {
        const float p = expf(s[a][m] - new_max);
        ps[2 * ty + a][tx + 8 * m] = p;
        tile_sum += p;
      }
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 4);
      row_sum[a] = row_sum[a] * rescale + tile_sum;
      row_max[a] = new_max;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[a][n] *= rescale;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kKeys; ++j) {
      const float p_a = ps[2 * ty][j];
      const float p_b = ps[2 * ty + 1][j];
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        const float vv = vs[j][tx + 8 * n];
        acc[0][n] = fmaf(p_a, vv, acc[0][n]);
        acc[1][n] = fmaf(p_b, vv, acc[1][n]);
      }
    }
  }

  for (int a = 0; a < 2; ++a) {
    const int qi = rows[a];
    if (qi >= L) continue;
    const float inv = 1.f / row_sum[a];
    float* dst = out + base + qi * stride_l;
#pragma unroll
    for (int n = 0; n < kCols; ++n) dst[tx + 8 * n] = acc[a][n] * inv;
    if (row_stats != nullptr && tx == 0) {
      const long long r = ((long long)b * H + h) * L + qi;
      row_stats[r] = row_max[a];
      row_stats[(long long)B * H * L + r] = logf(row_sum[a]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync m16n8k16, for the backward: two warps of 16
// query rows a 32-row tile. In the fragment layouts of the PTX ISA, lane
// l = 4*grp + tig holds score/output rows grp and grp + 8 of its warp's 16, at
// columns 2*tig and 2*tig + 1 of each 8-wide n-tile; the 4 lanes of a row
// reduce with xor 1, 2.
// ---------------------------------------------------------------------------

constexpr int kBf16Warps = kBlockQ / 16;
constexpr int kBf16Threads = 32 * kBf16Warps;
constexpr int kPad = 8;  // bf16 per smem row: 144-byte rows, conflict-free fragment loads

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of v for one 16-key k-step and one 8-wide n-tile of the head
// dimension, from v stored [key][d]: the transposing load gives lane
// 4*grp + tig the pairs (key 2*tig, 2*tig+1; d grp) of keys 0-7 and 8-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// WavLM's score policy: gate * bias + mask, with bias [H, L, L] shared by the
// batch, gate [B, H, L] and mask [B, L] (0 or -1e9), all f32. Its members are
// public: GatedBiasRing (wavlm_attention.cu) reads the gate and mask row.
struct GatedBias {
  struct Params {
    const float* bias;  // [H, L, L]
    const float* gate;  // [B, H, L]
    const float* mask;  // [B, L]
  };
  const float* bias_row[2];
  float g[2];
  const float* mask_row;

  __device__ GatedBias(const Params& p, int b, int h, const int (&rows)[2], int H, int L) {
    for (int a = 0; a < 2; ++a) {
      const bool ok = rows[a] < L;  // padded query rows read row 0 and are not stored
      g[a] = ok ? p.gate[((long long)b * H + h) * L + rows[a]] : 0.f;
      bias_row[a] = p.bias + ((long long)h * L + (ok ? rows[a] : 0)) * L;
    }
    mask_row = p.mask + (long long)b * L;
  }

  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    return s + g[a] * bias_row[a][kj] + mask_row[kj];
  }
};

// The f32 kernel at head_dim kHd on `stream`: q, k, v and out share the
// strides (stride_b, stride_h, stride_l) in elements, with a unit head-dim
// stride; row_stats: [2, B, H, L] f32 or null. Returns cudaGetLastError() (0
// on success).
template <class Score, int kHd = kHeadDim>
int launch_attention_f32(const void* q, const void* k, const void* v,
                         const typename Score::Params& params, void* out, int B, int H, int L,
                         long long stride_b, long long stride_h, long long stride_l,
                         cudaStream_t stream, float* row_stats = nullptr) {
  const long long q_tiles = (L + kBlockQ - 1) / kBlockQ;
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  attention_f32_kernel<Score, kHd><<<dim3(B, (unsigned)q_tiles, H), kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      params, static_cast<float*>(out), row_stats, B, H, L, stride_b, stride_h, stride_l);
  return (int)cudaGetLastError();
}

}  // namespace
