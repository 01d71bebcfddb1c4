// Backward of the gated relative-position-bias attention (WavLM), for Hopper
// (sm_90a).
//
// Replaces stutter_tpu/ops/wavlm_attention_vjp.py:_bwd_short_kernel (via
// _attention_short_bwd) and :_bwd_dqkv_kernel plus :_bwd_dbias_kernel (via
// _attention_long_bwd); one set of kernels per dtype serves every length, as
// the forward does. For one (clip b, head h), with q pre-scaled, the
// forward's scores p = q k^T + gate * bias + mask and a = softmax_rows(p):
//
//     D     = sum_d do * out                 (a [B, H, L] f32 input, taken by the wrapper)
//     dp    = a * (do v^T - D)
//     dq    = dp k        dk = dp^T q        dv = a^T do
//     dgate = sum_j dp * bias                dbias[h] = sum_b gate * dp
//
// The probabilities are recomputed in f32 from the row statistics the forward
// kernel wrote (attention_tiles.cuh: each row's max and log-sum), never
// stored as [B, H, L, L].
//
// What the TPU kernels carried across their sequential grid cannot carry
// across blocks here, so the work is split three ways, each block owning its
// outputs outright (no atomics, a deterministic result):
// - dq_kernel: one block per (clip, 32-row query tile, head) loops over the
//   key tiles and accumulates dq and dgate in registers;
// - dkv_kernel: one block per (clip, 32-key tile, head) loops over the query
//   tiles; it computes the transposed tiles k q^T and v do^T directly, so
//   their accumulators are the A operands of dk += dp^T q and dv += a^T do;
// - dbias_kernel: one block per (key tile, query tile, head) loops over the
//   clips and sums gate * dp, in the clip order, as the Pallas kernels do.
// Each recomputes the scores and do v^T of its tile: ~9 tile products
// against the forward's 2, traded, as on the TPU, for never writing the
// [B, H, L, L] chain to device memory.
//
// What bounds it on this card: at the 3 s bucket (L = 160) a (clip, head)
// pair is ~50 KB of q, k, v, do and outputs in bf16 against ~30 MFLOP across
// the three kernels, so the work is memory- and latency-bound, as the forward
// is; the bias tile is re-read per clip from L2.
//
// bf16: every product on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate), two warps of 16 rows each, with the fragment layouts of
// attention_tiles.cuh. dp and a are rounded to bf16 before the three
// products, as _bwd_short_kernel rounds dpc; dgate and dbias take the f32 dp.
// f32: scalar f32 FMAs (tensor cores would round to TF32), 128 threads, each
// two rows by four columns of a 32 x 32 tile.
// The ragged L edge is masked here: rows and keys past L compute on zeros and
// are neither used nor stored. A fully padded clip (every key at -1e9) gets
// the uniform softmax the plain version gives, because the statistics keep
// the max and the log-sum apart.
// Not yet: wgmma, TMA or cp.async staging, overlapped tile loads.

#include "attention_tiles.cuh"

namespace {

constexpr int kTile = 32;  // rows and keys per tile (== kBlockQ == kBlockK)
constexpr int kBwdBf16Threads = 64;
constexpr int kBwdF32Threads = 128;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // [H, L, L]
  const float* gate;   // [B, H, L]
  const float* mask;   // [B, L]
  const void* dout;    // like q
  const float* stats;  // [2, B, H, L]: row max, log row sum
  const float* dsum;   // [B, H, L]
  void* dq;
  void* dk;
  void* dv;
  float* dgate;  // [B, H, L]
  float* dbias;  // [H, L, L]
  int B, H, L;
  long long sb, sh, sl;
};

// Per-row values the probabilities need: row index r of [B, H, L].
struct RowStats {
  float m, logl, d, g;
  __device__ void load(const BwdArgs& a, int b, int h, int i) {
    if (i < a.L) {
      const long long r = ((long long)b * a.H + h) * a.L + i;
      m = a.stats[r];
      logl = a.stats[(long long)a.B * a.H * a.L + r];
      d = a.dsum[r];
      g = a.gate[r];
    } else {
      m = logl = d = g = 0.f;
    }
  }
  // probability and dp for one score (without gate * bias + mask) and do.v
  __device__ __forceinline__ void p_dp(float s, float bias, float mask, float dov,
                                       float& p, float& dp) const {
    p = expf(((s + g * bias + mask) - m) - logl);
    dp = p * (dov - d);
  }
};

// ---------------------------------------------------------------------------
// bf16 helpers (mma.sync m16n8k16). Warp w owns rows 16*w .. 16*w + 15 of a
// 32-row tile; lane l = 4*grp + tig holds accumulator rows grp and grp + 8
// at columns 2*tig, 2*tig + 1 of each 8-wide n-tile.
// ---------------------------------------------------------------------------

using Bf16Tile = __nv_bfloat16[kTile][kHeadDim + kPad];

__device__ __forceinline__ void load_tile_bf16(Bf16Tile& dst, const __nv_bfloat16* src,
                                               long long base, int r0, int L,
                                               long long sl, int tid) {
  constexpr int kChunks = kHeadDim / 8;  // 16-byte vectors per row
  for (int e = tid; e < kTile * kChunks; e += kBwdBf16Threads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + base + (r0 + r) * sl + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragments of rows r_lo, r_lo + 8 over the four 16-wide k-steps of d
__device__ __forceinline__ void load_a_frags(uint32_t (&fa)[4][4], const Bf16Tile& t,
                                             int r_lo, int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = 16 * kk + 2 * tig;
    fa[kk][0] = ld_pair(&t[r_lo][c]);
    fa[kk][1] = ld_pair(&t[r_lo + 8][c]);
    fa[kk][2] = ld_pair(&t[r_lo][c + 8]);
    fa[kk][3] = ld_pair(&t[r_lo + 8][c + 8]);
  }
}

// acc[16 x 32] = (this warp's 16 rows) . (the tile's 32 rows)^T over d
__device__ __forceinline__ void rows_dot_tile(float (&acc)[4][4], const uint32_t (&fa)[4][4],
                                              const Bf16Tile& t, int grp, int tig) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* row = &t[8 * nt + grp][16 * kk + 2 * tig];
      mma_16816(acc[nt], fa[kk], ld_pair(row), ld_pair(row + 8));
    }
  }
}

// o[16 x 64] += bf16(x[16 x 32]) . tile[32 x 64]: the accumulators of
// n-tiles 2*kk, 2*kk+1 are the A fragment of k-step kk (16 tile rows)
__device__ __forceinline__ void acc_times_tile(float (&o)[kHeadDim / 8][4],
                                               const float (&x)[4][4], const Bf16Tile& t,
                                               int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t xa[4] = {
        pack_bf16(x[2 * kk][0], x[2 * kk][1]), pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &t[16 * kk + (lane & 15)][8 * n]);
      mma_16816(o[n], xa, b0, b1);
    }
  }
}

__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst_base, long long base,
                                                const int (&rows)[2], int L, long long sl,
                                                int tig, const float (&o)[kHeadDim / 8][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (rows[a] >= L) continue;
    __nv_bfloat16* dst = dst_base + base + rows[a] * sl + 2 * tig;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * a], o[n][2 * a + 1]);
  }
}

__global__ void __launch_bounds__(kBwdBf16Threads) dq_bf16_kernel(const BwdArgs a) {
  __shared__ __align__(16) Bf16Tile qs, dos, ks, vs;
  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int L = a.L;
  const long long base = b * a.sb + h * a.sh;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);
  const auto* dout = static_cast<const __nv_bfloat16*>(a.dout);

  load_tile_bf16(qs, q, base, q0, L, a.sl, tid);
  load_tile_bf16(dos, dout, base, q0, L, a.sl, tid);
  __syncthreads();
  const int r_lo = 16 * warp + grp;
  uint32_t qa[4][4], doa[4][4];
  load_a_frags(qa, qs, r_lo, tig);
  load_a_frags(doa, dos, r_lo, tig);

  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  RowStats st[2];
  const float* bias_row[2];
  for (int r = 0; r < 2; ++r) {
    st[r].load(a, b, h, rows[r]);
    bias_row[r] = a.bias + ((long long)h * L + (rows[r] < L ? rows[r] : 0)) * L;
  }
  const float* mask_row = a.mask + (long long)b * L;

  float dq[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;
  float dg[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with ks/vs
    load_tile_bf16(ks, k, base, k0, L, a.sl, tid);
    load_tile_bf16(vs, v, base, k0, L, a.sl, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot_tile(s, qa, ks, grp, tig);
    rows_dot_tile(dp, doa, vs, grp, tig);
    // element i of n-tile nt: row r_lo + 8*(i/2), key k0 + 8*nt + 2*tig + i%2
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, kj = k0 + 8 * nt + 2 * tig + (i & 1);
        float p = 0.f, dpv = 0.f;
        if (kj < L) {
          const float bv = bias_row[r][kj];
          st[r].p_dp(s[nt][i], bv, mask_row[kj], dp[nt][i], p, dpv);
          dg[r] = fmaf(dpv, bv, dg[r]);
        }
        dp[nt][i] = dpv;
      }
    acc_times_tile(dq, dp, ks, lane);  // dq += bf16(dp) . k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 1);
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 2);
    if (rows[r] < L && tig == 0) a.dgate[((long long)b * a.H + h) * L + rows[r]] = dg[r];
  }
  store_rows_bf16(static_cast<__nv_bfloat16*>(a.dq), base, rows, L, a.sl, tig, dq);
}

__global__ void __launch_bounds__(kBwdBf16Threads) dkv_bf16_kernel(const BwdArgs a) {
  __shared__ __align__(16) Bf16Tile ks, vs, qs, dos;
  __shared__ float bias_s[kTile][kTile + 1];  // [query row][key] of the tile pair
  __shared__ RowStats row_s[kTile];
  const int b = blockIdx.x, k0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int L = a.L;
  const long long base = b * a.sb + h * a.sh;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);
  const auto* dout = static_cast<const __nv_bfloat16*>(a.dout);

  load_tile_bf16(ks, k, base, k0, L, a.sl, tid);
  load_tile_bf16(vs, v, base, k0, L, a.sl, tid);
  __syncthreads();
  const int j_lo = 16 * warp + grp;  // this lane's keys: j_lo and j_lo + 8 of the tile
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, ks, j_lo, tig);
  load_a_frags(va, vs, j_lo, tig);
  const int keys[2] = {k0 + j_lo, k0 + j_lo + 8};
  float mk[2];
  for (int r = 0; r < 2; ++r) mk[r] = keys[r] < L ? a.mask[(long long)b * L + keys[r]] : 0.f;

  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16(qs, q, base, i0, L, a.sl, tid);
    load_tile_bf16(dos, dout, base, i0, L, a.sl, tid);
    for (int e = tid; e < kTile * kTile; e += kBwdBf16Threads) {
      const int r = e / kTile, c = e % kTile;
      bias_s[r][c] = (i0 + r < L && k0 + c < L)
                         ? a.bias[((long long)h * L + i0 + r) * L + k0 + c] : 0.f;
    }
    if (tid < kTile) row_s[tid].load(a, b, h, i0 + tid);
    __syncthreads();
    float st[4][4], dpt[4][4];  // k q^T and v do^T: rows are keys, columns query rows
    rows_dot_tile(st, ka, qs, grp, tig);
    rows_dot_tile(dpt, va, dos, grp, tig);
    // element i of n-tile nt: key j_lo + 8*(i/2), query row i0 + 8*nt + 2*tig + i%2
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, qi = 8 * nt + 2 * tig + (i & 1);
        float p = 0.f, dpv = 0.f;
        if (keys[r] < L && i0 + qi < L)
          row_s[qi].p_dp(st[nt][i], bias_s[qi][j_lo + 8 * r], mk[r], dpt[nt][i], p, dpv);
        st[nt][i] = p;
        dpt[nt][i] = dpv;
      }
    acc_times_tile(dv, st, dos, lane);  // dv += bf16(a)^T . do
    acc_times_tile(dk, dpt, qs, lane);  // dk += bf16(dp)^T . q
  }
  store_rows_bf16(static_cast<__nv_bfloat16*>(a.dk), base, keys, L, a.sl, tig, dk);
  store_rows_bf16(static_cast<__nv_bfloat16*>(a.dv), base, keys, L, a.sl, tig, dv);
}

__global__ void __launch_bounds__(kBwdBf16Threads) dbias_bf16_kernel(const BwdArgs a) {
  __shared__ __align__(16) Bf16Tile qs, dos, ks, vs;
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int L = a.L;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);
  const auto* dout = static_cast<const __nv_bfloat16*>(a.dout);
  const int r_lo = 16 * warp + grp;
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};

  float bv[4][4], acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, kj = k0 + 8 * nt + 2 * tig + (i & 1);
      bv[nt][i] = (rows[r] < L && kj < L) ? a.bias[((long long)h * L + rows[r]) * L + kj] : 0.f;
      acc[nt][i] = 0.f;
    }

  for (int b = 0; b < a.B; ++b) {
    const long long base = b * a.sb + h * a.sh;
    __syncthreads();  // the previous clip's readers are done
    load_tile_bf16(qs, q, base, q0, L, a.sl, tid);
    load_tile_bf16(dos, dout, base, q0, L, a.sl, tid);
    load_tile_bf16(ks, k, base, k0, L, a.sl, tid);
    load_tile_bf16(vs, v, base, k0, L, a.sl, tid);
    __syncthreads();
    uint32_t qa[4][4], doa[4][4];
    load_a_frags(qa, qs, r_lo, tig);
    load_a_frags(doa, dos, r_lo, tig);
    RowStats st[2];
    st[0].load(a, b, h, rows[0]);
    st[1].load(a, b, h, rows[1]);
    const float* mask_row = a.mask + (long long)b * L;
    float s[4][4], dp[4][4];
    rows_dot_tile(s, qa, ks, grp, tig);
    rows_dot_tile(dp, doa, vs, grp, tig);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, kj = k0 + 8 * nt + 2 * tig + (i & 1);
        if (rows[r] < L && kj < L) {
          float p, dpv;
          st[r].p_dp(s[nt][i], bv[nt][i], mask_row[kj], dp[nt][i], p, dpv);
          acc[nt][i] = fmaf(st[r].g, dpv, acc[nt][i]);
        }
      }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, kj = k0 + 8 * nt + 2 * tig + (i & 1);
      if (rows[r] < L && kj < L) a.dbias[((long long)h * L + rows[r]) * L + kj] = acc[nt][i];
    }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs. In a 32 x 32 tile of scores thread t owns rows
// 2*(t/8) + {0, 1} and columns (t%8) + 8*m (m < 4); in a 32 x 64 tile of
// outputs, rows 2*(t/8) + {0, 1} and columns (t%8) + 8*n (n < 8). The 8
// lanes that share a row are adjacent in one warp.
// ---------------------------------------------------------------------------

using F32Tile = float[kTile][kHeadDim + 1];

__device__ __forceinline__ void load_tile_f32(F32Tile& dst, const float* src, long long base,
                                              int r0, int L, long long sl, int tid) {
  for (int e = tid; e < kTile * kHeadDim; e += kBwdF32Threads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    dst[r][c] = r0 + r < L ? src[base + (r0 + r) * sl + c] : 0.f;
  }
}

// s = q . k and da = do . v for this thread's 2 x 4 elements, summed over d
// in the forward kernel's order
__device__ __forceinline__ void tile_dots_f32(float (&s)[2][4], float (&da)[2][4],
                                              const F32Tile& qs, const F32Tile& dos,
                                              const F32Tile& ks, const F32Tile& vs,
                                              int ty, int tx) {
  for (int r = 0; r < 2; ++r)
    for (int m = 0; m < 4; ++m) s[r][m] = da[r][m] = 0.f;
#pragma unroll 16
  for (int c = 0; c < kHeadDim; ++c) {
    const float q_a = qs[2 * ty][c], q_b = qs[2 * ty + 1][c];
    const float o_a = dos[2 * ty][c], o_b = dos[2 * ty + 1][c];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float kv = ks[tx + 8 * m][c], vv = vs[tx + 8 * m][c];
      s[0][m] = fmaf(q_a, kv, s[0][m]);
      s[1][m] = fmaf(q_b, kv, s[1][m]);
      da[0][m] = fmaf(o_a, vv, da[0][m]);
      da[1][m] = fmaf(o_b, vv, da[1][m]);
    }
  }
}

__device__ __forceinline__ void store_rows_f32(float* dst_base, long long base, int r0,
                                               int L, long long sl, int ty, int tx,
                                               const float (&o)[2][8]) {
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 2 * ty + r;
    if (row >= L) continue;
    float* dst = dst_base + base + row * sl;
#pragma unroll
    for (int n = 0; n < 8; ++n) dst[tx + 8 * n] = o[r][n];
  }
}

__global__ void __launch_bounds__(kBwdF32Threads) dq_f32_kernel(const BwdArgs a) {
  __shared__ F32Tile qs, dos, ks, vs;
  __shared__ float dps[kTile][kTile + 1];
  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int L = a.L;
  const long long base = b * a.sb + h * a.sh;
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);

  load_tile_f32(qs, static_cast<const float*>(a.q), base, q0, L, a.sl, tid);
  load_tile_f32(dos, static_cast<const float*>(a.dout), base, q0, L, a.sl, tid);
  const int rows[2] = {q0 + 2 * ty, q0 + 2 * ty + 1};
  RowStats st[2];
  const float* bias_row[2];
  for (int r = 0; r < 2; ++r) {
    st[r].load(a, b, h, rows[r]);
    bias_row[r] = a.bias + ((long long)h * L + (rows[r] < L ? rows[r] : 0)) * L;
  }
  const float* mask_row = a.mask + (long long)b * L;
  float dq[2][8] = {};
  float dg[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/dps
    load_tile_f32(ks, k, base, k0, L, a.sl, tid);
    load_tile_f32(vs, v, base, k0, L, a.sl, tid);
    __syncthreads();
    float s[2][4], da[2][4];
    tile_dots_f32(s, da, qs, dos, ks, vs, ty, tx);
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kj = k0 + tx + 8 * m;
        float p = 0.f, dpv = 0.f;
        if (kj < L) {
          const float bv = bias_row[r][kj];
          st[r].p_dp(s[r][m], bv, mask_row[kj], da[r][m], p, dpv);
          dg[r] = fmaf(dpv, bv, dg[r]);
        }
        dps[2 * ty + r][tx + 8 * m] = dpv;
      }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float p_a = dps[2 * ty][j], p_b = dps[2 * ty + 1][j];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float kv = ks[j][tx + 8 * n];
        dq[0][n] = fmaf(p_a, kv, dq[0][n]);
        dq[1][n] = fmaf(p_b, kv, dq[1][n]);
      }
    }
  }

  for (int r = 0; r < 2; ++r) {
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 1);
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 2);
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 4);
    if (rows[r] < L && tx == 0) a.dgate[((long long)b * a.H + h) * L + rows[r]] = dg[r];
  }
  store_rows_f32(static_cast<float*>(a.dq), base, q0, L, a.sl, ty, tx, dq);
}

__global__ void __launch_bounds__(kBwdF32Threads) dkv_f32_kernel(const BwdArgs a) {
  __shared__ F32Tile ks, vs, qs, dos;
  __shared__ float ps[kTile][kTile + 1], dps[kTile][kTile + 1];  // [query row][key]
  const int b = blockIdx.x, k0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int L = a.L;
  const long long base = b * a.sb + h * a.sh;
  const auto* q = static_cast<const float*>(a.q);
  const auto* dout = static_cast<const float*>(a.dout);

  load_tile_f32(ks, static_cast<const float*>(a.k), base, k0, L, a.sl, tid);
  load_tile_f32(vs, static_cast<const float*>(a.v), base, k0, L, a.sl, tid);
  const float* mask_row = a.mask + (long long)b * L;
  float dk[2][8] = {}, dv[2][8] = {};  // keys k0 + 2*ty + r

  for (int i0 = 0; i0 < L; i0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with qs/dos/ps/dps
    load_tile_f32(qs, q, base, i0, L, a.sl, tid);
    load_tile_f32(dos, dout, base, i0, L, a.sl, tid);
    __syncthreads();
    float s[2][4], da[2][4];  // query rows i0 + 2*ty + r, keys k0 + tx + 8*m
    tile_dots_f32(s, da, qs, dos, ks, vs, ty, tx);
    for (int r = 0; r < 2; ++r) {
      const int qi = i0 + 2 * ty + r;
      RowStats st;
      st.load(a, b, h, qi);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kj = k0 + tx + 8 * m;
        float p = 0.f, dpv = 0.f;
        if (qi < L && kj < L)
          st.p_dp(s[r][m], a.bias[((long long)h * L + qi) * L + kj], mask_row[kj],
                  da[r][m], p, dpv);
        ps[2 * ty + r][tx + 8 * m] = p;
        dps[2 * ty + r][tx + 8 * m] = dpv;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const float p_a = ps[i][2 * ty], p_b = ps[i][2 * ty + 1];
      const float d_a = dps[i][2 * ty], d_b = dps[i][2 * ty + 1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float qv = qs[i][tx + 8 * n], ov = dos[i][tx + 8 * n];
        dk[0][n] = fmaf(d_a, qv, dk[0][n]);
        dk[1][n] = fmaf(d_b, qv, dk[1][n]);
        dv[0][n] = fmaf(p_a, ov, dv[0][n]);
        dv[1][n] = fmaf(p_b, ov, dv[1][n]);
      }
    }
  }
  store_rows_f32(static_cast<float*>(a.dk), base, k0, L, a.sl, ty, tx, dk);
  store_rows_f32(static_cast<float*>(a.dv), base, k0, L, a.sl, ty, tx, dv);
}

__global__ void __launch_bounds__(kBwdF32Threads) dbias_f32_kernel(const BwdArgs a) {
  __shared__ F32Tile qs, dos, ks, vs;
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int L = a.L;
  const int rows[2] = {q0 + 2 * ty, q0 + 2 * ty + 1};
  float bv[2][4], acc[2][4];
  for (int r = 0; r < 2; ++r)
    for (int m = 0; m < 4; ++m) {
      const int kj = k0 + tx + 8 * m;
      bv[r][m] = (rows[r] < L && kj < L) ? a.bias[((long long)h * L + rows[r]) * L + kj] : 0.f;
      acc[r][m] = 0.f;
    }

  for (int b = 0; b < a.B; ++b) {
    const long long base = b * a.sb + h * a.sh;
    __syncthreads();  // the previous clip's readers are done
    load_tile_f32(qs, static_cast<const float*>(a.q), base, q0, L, a.sl, tid);
    load_tile_f32(dos, static_cast<const float*>(a.dout), base, q0, L, a.sl, tid);
    load_tile_f32(ks, static_cast<const float*>(a.k), base, k0, L, a.sl, tid);
    load_tile_f32(vs, static_cast<const float*>(a.v), base, k0, L, a.sl, tid);
    __syncthreads();
    float s[2][4], da[2][4];
    tile_dots_f32(s, da, qs, dos, ks, vs, ty, tx);
    const float* mask_row = a.mask + (long long)b * L;
    for (int r = 0; r < 2; ++r) {
      RowStats st;
      st.load(a, b, h, rows[r]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kj = k0 + tx + 8 * m;
        if (rows[r] < L && kj < L) {
          float p, dpv;
          st.p_dp(s[r][m], bv[r][m], mask_row[kj], da[r][m], p, dpv);
          acc[r][m] = fmaf(st.g, dpv, acc[r][m]);
        }
      }
    }
  }

  for (int r = 0; r < 2; ++r)
    for (int m = 0; m < 4; ++m) {
      const int kj = k0 + tx + 8 * m;
      if (rows[r] < L && kj < L) a.dbias[((long long)h * L + rows[r]) * L + kj] = acc[r][m];
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq, dk and dv share the
// strides (stride_b, stride_h, stride_l) in elements, with a unit head-dim
// stride (for bf16: 16-byte aligned rows); bias [H, L, L], gate [B, H, L],
// mask [B, L], stats [2, B, H, L] (the forward's), dsum [B, H, L], dgate
// [B, H, L] and dbias [H, L, L] are contiguous f32. Launches the three
// kernels on `stream` and returns the first launch error (0 on success).
extern "C" int wavlm_gated_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* gate,
    const void* mask, const void* dout, const void* stats, const void* dsum, void* dq,
    void* dk, void* dv, void* dgate, void* dbias, int B, int H, int L, long long stride_b,
    long long stride_h, long long stride_l, int dtype, void* stream) {
  const int tiles = (L + kTile - 1) / kTile;
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdArgs args{q, k, v, static_cast<const float*>(bias),
                     static_cast<const float*>(gate), static_cast<const float*>(mask), dout,
                     static_cast<const float*>(stats), static_cast<const float*>(dsum), dq,
                     dk, dv, static_cast<float*>(dgate), static_cast<float*>(dbias), B, H, L,
                     stride_b, stride_h, stride_l};
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 per_clip(B, tiles, H), per_pair(tiles, tiles, H);
  int rc;
  if (dtype == 0) {
    dq_f32_kernel<<<per_clip, kBwdF32Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dkv_f32_kernel<<<per_clip, kBwdF32Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dbias_f32_kernel<<<per_pair, kBwdF32Threads, 0, s>>>(args);
  } else if (dtype == 1) {
    dq_bf16_kernel<<<per_clip, kBwdBf16Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dkv_bf16_kernel<<<per_clip, kBwdBf16Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dbias_bf16_kernel<<<per_pair, kBwdBf16Threads, 0, s>>>(args);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
