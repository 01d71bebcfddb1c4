// Flash-attention forward tiles for Hopper (sm_90a), shared by the WavLM
// attention (wavlm_attention.cu) and the Whisper encoder's attention
// (flash_mha.cu). For one (clip b, head h, query row i):
//
//     p[j]   = score(i, j, q[i] . k[j])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled, head_dim 64, and `score` a compile-time policy that adds
// whatever the caller's logits carry beyond q . k: WavLM's gate * bias + mask
// (GatedBias below), Whisper's key padding (KeyPadding in flash_mha.cu),
// whose kernel then loads no bias and no gate, or a materialised bias
// (FullBias in flash_mha.cu). A policy is a
// struct with a `Params` struct passed by value to the kernel, a constructor
// (params, b, h, rows[2], H, L) for the two query rows a thread owns, and
// `float operator()(int a, int kj, float s)` for row a and key kj < L.
// Scores, softmax and both sums are f32; the output is stored in the input
// type. Given a non-null `row_stats` ([2, B, H, L] f32), a kernel also writes
// each query row's score max (plane 0) and the log of its sum of
// exp(score - max) (plane 1), which the WavLM backward
// (wavlm_attention_bwd.cu) recomputes the probabilities from; the two stay
// apart because a fully padded row scores -1e9 everywhere, where
// max + log(sum) would round back to the max.
//
// Design (what bounds it and why, per caller, is in the .cu files):
// - One thread block per (clip, 32-row query tile, head), with the clip index
//   fastest in the grid.
// - K and V go through shared memory in 32-key tiles; the softmax is online
//   (running max and sum per row), so a tile's scores live only in registers
//   whatever L is, and the policy's additive terms are formed there.
// - The ragged edge (L not a multiple of 32) is masked here: padded query
//   rows are computed on zeros and not stored, keys past L score -inf. The
//   caller never pads L.
// - q, k, v and out may be any [B, H, L, 64] view whose last dimension is
//   contiguous (the models pass their [B, L, H, 64] projections transposed),
//   so no copy is made to reach a head-major layout.
//
// bf16: both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate), two warps of 16 query rows each. The probabilities are
// rounded to bf16 for the second product, as the Pallas kernels round them
// to v's dtype; the row sums stay f32. Rows are loaded as 16-byte vectors,
// so the wrappers require 16-byte aligned rows.
// f32: scalar f32 FMAs (the tensor cores would round to TF32), each thread
// two query rows.
// Not yet: wgmma, TMA or cp.async staging, and overlap of a tile's loads with
// the previous tile's products.
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

template <class Score>
__global__ void __launch_bounds__(kF32Threads) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const typename Score::Params params,
    float* __restrict__ out, float* __restrict__ row_stats, int B, int H, int L,
    long long stride_b, long long stride_h, long long stride_l) {
  __shared__ float qs[kBlockQ][kHeadDim + 1];
  __shared__ float ks[kBlockK][kHeadDim + 1];
  __shared__ float vs[kBlockK][kHeadDim];
  __shared__ float ps[kBlockQ][kBlockK + 1];

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const long long base = b * stride_b + h * stride_h;

  // Stage the query tile; rows past L read as zeros.
  for (int e = tid; e < kBlockQ * kHeadDim; e += kF32Threads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const int qi = q0 + r;
    qs[r][c] = qi < L ? q[base + qi * stride_l + c] : 0.f;
  }

  const int rows[2] = {q0 + 2 * ty, q0 + 2 * ty + 1};
  const Score score(params, b, h, rows, H, L);

  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};
  float acc[2][8];
  for (int a = 0; a < 2; ++a)
    for (int n = 0; n < 8; ++n) acc[a][n] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int e = tid; e < kBlockK * kHeadDim; e += kF32Threads) {
      const int r = e / kHeadDim, c = e % kHeadDim;
      const int kj = k0 + r;
      const bool ok = kj < L;
      const long long off = base + kj * stride_l + c;
      ks[r][c] = ok ? k[off] : 0.f;
      vs[r][c] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float s[2][4];
    for (int a = 0; a < 2; ++a)
      for (int m = 0; m < 4; ++m) s[a][m] = 0.f;
#pragma unroll 16
    for (int c = 0; c < kHeadDim; ++c) {
      const float q_a = qs[2 * ty][c];
      const float q_b = qs[2 * ty + 1][c];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float kv = ks[tx + 8 * m][c];
        s[0][m] = fmaf(q_a, kv, s[0][m]);
        s[1][m] = fmaf(q_b, kv, s[1][m]);
      }
    }

#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
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
      for (int m = 0; m < 4; ++m) {
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
      for (int n = 0; n < 8; ++n) acc[a][n] *= rescale;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float p_a = ps[2 * ty][j];
      const float p_b = ps[2 * ty + 1][j];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
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
    for (int n = 0; n < 8; ++n) dst[tx + 8 * n] = acc[a][n] * inv;
    if (row_stats != nullptr && tx == 0) {
      const long long r = ((long long)b * H + h) * L + qi;
      row_stats[r] = row_max[a];
      row_stats[(long long)B * H * L + r] = logf(row_sum[a]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16. Warp w owns query rows 16*w .. 16*w + 15 of the
// tile. In the fragment layouts of the PTX ISA, lane l = 4*grp + tig holds
// score/output rows grp and grp + 8 of its warp's 16, at columns 2*tig and
// 2*tig + 1 of each 8-wide n-tile; the 4 lanes of a row reduce with xor 1, 2.
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

template <class Score>
__global__ void __launch_bounds__(kBf16Threads) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const typename Score::Params params,
    __nv_bfloat16* __restrict__ out, float* __restrict__ row_stats, int B, int H,
    int L, long long stride_b, long long stride_h, long long stride_l) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][kHeadDim + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][kHeadDim + kPad];
  constexpr int kChunks = kHeadDim / 8;  // 16-byte vectors per row

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  const long long base = b * stride_b + h * stride_h;

  // Stage the query tile (rows past L are zeros), then keep this warp's rows
  // in registers as A fragments for the four 16-wide k-steps over d.
  for (int e = tid; e < kBlockQ * kChunks; e += kBf16Threads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < L) val = *reinterpret_cast<const uint4*>(q + base + (q0 + r) * stride_l + c);
    *reinterpret_cast<uint4*>(&qs[r][c]) = val;
  }
  __syncthreads();
  const int r_lo = 16 * warp + grp;  // this lane's rows: r_lo and r_lo + 8
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * tig;
    qa[kk][0] = ld_pair(&qs[r_lo][c]);
    qa[kk][1] = ld_pair(&qs[r_lo + 8][c]);
    qa[kk][2] = ld_pair(&qs[r_lo][c + 8]);
    qa[kk][3] = ld_pair(&qs[r_lo + 8][c + 8]);
  }

  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  const Score score(params, b, h, rows, H, L);

  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};  // this lane's share; the quad sums at the end
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done with ks/vs
    for (int e = tid; e < kBlockK * kChunks; e += kBf16Threads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < L) {
        const long long off = base + (k0 + r) * stride_l + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    __syncthreads();

    // s = q . k^T for 4 n-tiles of 8 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* krow = &ks[8 * nt + grp][16 * kk + 2 * tig];
        mma_16816(s[nt], qa[kk], ld_pair(krow), ld_pair(krow + 8));
      }
    }

    // scores -> unnormalised probabilities; element i of n-tile nt is row
    // r_lo + 8*(i/2), key k0 + 8*nt + 2*tig + i%2
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = k0 + 8 * nt + 2 * tig + j;
          float& x = s[nt][2 * a + j];
          x = kj < L ? score(a, kj, x) : -CUDART_INF_F;
          tile_max = fmaxf(tile_max, x);
        }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      // Key 0 lies in the first tile and every policy keeps a key < L
      // finite, so the running max is finite from then on.
      const float new_max = fmaxf(row_max[a], tile_max);
      const float rescale = expf(row_max[a] - new_max);
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * a + j];
          x = expf(x - new_max);
          part += x;
        }
      row_sum[a] = row_sum[a] * rescale + part;
      row_max[a] = new_max;
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        o[n][2 * a] *= rescale;
        o[n][2 * a + 1] *= rescale;
      }
    }

    // out += p . v: the score accumulators of n-tiles 2*kk, 2*kk+1 are the A
    // fragment of k-step kk (16 keys)
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int lane = tid & 31;
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[16 * kk + (lane & 15)][8 * n]);
        mma_16816(o[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 1);
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 2);
    const int qi = rows[a];
    if (qi >= L) continue;
    const float inv = 1.f / row_sum[a];
    __nv_bfloat16* dst = out + base + qi * stride_l + 2 * tig;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * a] * inv, o[n][2 * a + 1] * inv);
    if (row_stats != nullptr && tig == 0) {
      const long long r = ((long long)b * H + h) * L + qi;
      row_stats[r] = row_max[a];
      row_stats[(long long)B * H * L + r] = logf(row_sum[a]);
    }
  }
}

// WavLM's score policy: gate * bias + mask, with bias [H, L, L] shared by the
// batch, gate [B, H, L] and mask [B, L] (0 or -1e9), all f32. Its members are
// public: the probe kernels (attn_probes.cu) round the three terms apart.
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

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out share the strides
// (stride_b, stride_h, stride_l) in elements, with a unit head-dim stride
// (for bf16: 16-byte aligned rows); row_stats: [2, B, H, L] f32 or null.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
template <class Score>
int launch_attention(const void* q, const void* k, const void* v,
                     const typename Score::Params& params, void* out, int B, int H,
                     int L, long long stride_b, long long stride_h, long long stride_l,
                     int dtype, cudaStream_t stream, float* row_stats = nullptr) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, (L + kBlockQ - 1) / kBlockQ, H);
  if (dtype == 0) {
    attention_f32_kernel<Score><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), params, static_cast<float*>(out), row_stats, B, H, L,
        stride_b, stride_h, stride_l);
  } else if (dtype == 1) {
    attention_bf16_kernel<Score><<<grid, kBf16Threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), params, static_cast<__nv_bfloat16*>(out),
        row_stats, B, H, L, stride_b, stride_h, stride_l);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
