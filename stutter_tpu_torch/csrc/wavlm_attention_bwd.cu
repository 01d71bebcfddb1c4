// Backward of the gated relative-position-bias attention (WavLM), for Hopper
// (sm_90a).
//
// Replaces stutter_tpu/ops/wavlm_attention_vjp.py:_bwd_short_kernel (via
// _attention_short_bwd) and :_bwd_dqkv_kernel plus :_bwd_dbias_kernel (via
// _attention_long_bwd); one set of kernels per dtype serves every length, as
// the forward does. For one (clip b, head h), with q pre-scaled, the
// forward's scores p = q k^T + gate * bias + mask and a = softmax_rows(p):
//
//     D     = sum_d do * out                 (per query row, f32)
//     dp    = a * (do v^T - D)
//     dq    = dp k        dk = dp^T q        dv = a^T do
//     dgate = sum_j dp * bias                dbias[h] = sum_b gate * dp
//
// The probabilities are recomputed in f32 from the row statistics the forward
// kernel wrote (each row's max and log-sum, kept apart), never stored as
// [B, H, L, L].
//
// What the TPU kernels carried across their sequential grid cannot carry
// across blocks here, so the work is split three ways, each block owning its
// outputs outright (no atomics: two calls give the same bits):
// - dq: one block per (clip, head, 64 query rows) walks the key tiles and
//   accumulates dq and dgate; it first computes D for its rows from do and
//   out and writes it to a [B, H, L] buffer for the two kernels after it;
// - dkv: one block per (clip, head, 64 keys) walks the query tiles; it
//   computes the transposed tiles k q^T and v do^T, so that their
//   accumulators are the A operands of dk += dp^T q and dv += a^T do;
// - dbias: one block per (head, 64 x 64 tile, group of clips) walks its
//   clips in order and sums gate * dp; with more than one group the groups'
//   partial planes go to a [groups, H, L, L] scratch that a last kernel adds
//   up in group order.
// Each recomputes the scores and do v^T of its tiles: 9 tile products
// against the 5 the math needs, traded, as on the TPU, for never writing the
// [B, H, L, L] chain to device memory.
//
// What bounds it on this card: at the fine-tune CLI's 3 s batch (32 x 16 x
// 160) the call moves ~88 MB (q, k, v, do, out, dq, dk, dv in bf16; the
// [H, L, L] bias and dbias, gate, statistics, dgate in f32): 0.026 ms at
// 3.35 TB/s, against 8.4 GFLOP of the 5 products (0.009 ms at the bf16
// peak); a block there walks only three tiles, so each kernel's fixed
// latency (the first copies, the A operands' loads, the epilogue) is what
// the blocks on an SM must hide. At 4 x 16 x 1008 the 9 products (42 GFLOP
// run, 0.042 ms at the peak) and the softmax's instructions beside them
// take over, as in the forward. Measured (PERF.md), each kernel copies its
// tiles from L2 at ~3 TB/s: the dq kernel re-reads K, V and the f32 bias tile
// for every 64 query rows (~150 MB at 32 x 16 x 160 in ~0.05 ms), with one
// tile in flight under the products of the one before. Blocks that walk
// several units of work (the ring running on across them) measured within
// 2.4 % and were not kept.
//
// bf16 (the fine-tune CLI's path) runs on the Hopper tiles of
// attention_tiles_sm90.cuh: one warpgroup a block, wgmma m64n64k16 with f32
// accumulators; the block's own 64 rows (q and do, or k and v) stay in
// registers as A operands for the whole kernel, the tiles it walks ride a
// ring of three 34 KB stages in dynamic shared memory filled by cp.async
// one tile ahead of the products (two blocks an SM), with the forward's
// ring discipline: one commit group a tile, one __syncthreads() a tile after
// a proxy fence. The accumulators of p and dp, rounded to bf16 as the Pallas
// kernels round them, are the A operands of the second products straight from
// registers; a staged q or do tile is the K-major B operand of one product
// and the MN-major B operand of the other. The f32 bias tile and the per-row
// values (max, log-sum, D, gate) ride the ring beside them, in 16-byte copies
// where L % 4 == 0 and the bases are aligned, else element by element; the
// dq kernel keeps the clip's mask row in the bias tile's padding columns, as
// the forward does. In the dk+dv kernel a key reads the bias down a column of
// the staged tile, so that tile's rows are 68 floats apart: the 32 lanes of a
// read then fall in 32 banks. The dbias kernel's operands all change from
// clip to clip, so both its products read A and B from shared memory.
// p = 2^((x - max) log2 e - log-sum log2 e): x - max first, so that a
// fully padded clip (every key at -1e9) gets the uniform softmax the plain
// version gives. dp and p are rounded to bf16 before the three products, as
// _bwd_short_kernel rounds dpc; dgate and dbias take the f32 dp.
// f32: D in a small kernel of its own, then scalar f32 FMAs (tensor cores
// would round to TF32), 128 threads, each two rows by four columns of a
// 32 x 32 tile.
// The ragged L edge is masked here: rows and keys past L compute on zeros,
// score -inf in the tiles that reach L, and are neither used nor stored.

#include "attention_tiles.cuh"
#include "attention_tiles_sm90.cuh"

namespace {

constexpr int kTile = 32;  // f32: rows and keys per tile (== kBlockQ == kBlockK)
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
  const void* out;     // like q: the forward's output
  float* dsum;         // [B, H, L]: D, written first, read by the kernels after
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
// bf16 on the Hopper tiles. In a warpgroup, warp w owns rows 16 w .. 16 w + 15
// of the block's 64; lane 4 * grp + tig holds rows grp and grp + 8 of them
// at columns 2 * tig, 2 * tig + 1 of each 8-wide n-tile: element
// 4 * nt + 2 * a + j of an accumulator is row grp + 8 a, column
// 8 nt + 2 tig + j.
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;
constexpr int kThreads = 128;
constexpr int kKv = sm90::kKvTileBytes;           // one 64 x 64 bf16 tile
constexpr int kRowPitch = sm90::kBiasPitch;       // 72 floats: bias read along rows
constexpr int kColPitch = sm90::kTileK + 4;       // 68 floats: bias read down columns
constexpr int kRowValues = 4 * 64 * 4;            // max, log-sum, D, gate of 64 rows
// dq: K, V, the bias tile [query][key] (the mask in its padding columns)
constexpr int kDqStage = 2 * kKv + 64 * kRowPitch * 4;
// dkv: q, do, the bias tile [query][key], the query rows' values
constexpr int kDkvStage = 2 * kKv + 64 * kColPitch * 4 + kRowValues;
// dbias: q, do, k, v, the query rows' values and the keys' mask
constexpr int kDbiasStage = 4 * kKv + 2048;
static_assert(kDqStage % 1024 == 0 && kDkvStage % 1024 == 0 && kDbiasStage % 1024 == 0,
              "every bf16 tile starts a swizzle period");
static_assert(kRowValues + 64 * 4 <= 2048, "the dbias stage's row values and mask fit");
constexpr int kSmem = kStages * 34816 + 1024;  // the ring plus the slack to align it
static_assert(kDqStage == 34816 && kDkvStage == 34816 && kDbiasStage == 34816,
              "the three kernels share the ring's shape");

// The ring, 1024-byte aligned, in the block's dynamic shared memory.
__device__ __forceinline__ uint32_t ring_base(const uint8_t* smem) {
  return (sm90::smem_u32(smem) + 1023u) & ~1023u;
}

// (clip, head, tile) of a block in kOrder (sm90::GridOrder).
template <int kOrder>
__device__ __forceinline__ void block_coords(int B, int H, int n_tiles, int& b, int& h,
                                             int& tile) {
  if constexpr (kOrder == sm90::kClipFastest) {
    const int ht = blockIdx.x / B;
    b = blockIdx.x - ht * B;
    h = ht / n_tiles;
    tile = ht - h * n_tiles;
  } else {
    const int bh = blockIdx.x / n_tiles;
    tile = blockIdx.x - bh * n_tiles;
    b = bh / H;
    h = bh - b * H;
  }
}

// Copies rows r0 .. r0 + 63 of a [L, 64] bf16 operand (zeros past L) into
// an 8 KB tile in the 128-byte swizzle: chunk tid & 7 of rows
// tid / 8 + 16 i (the step keeps the row's phase).
__device__ __forceinline__ void copy_rows_bf16(uint32_t dst, const __nv_bfloat16* src, int r0,
                                               int L, long long sl, int tid) {
  const int r = tid >> 3, c = tid & 7;
  const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + r + 16 * i;
    const bool ok = row < L;
    sm90::cp_async_16(dst + off + 2048 * i, ok ? src + row * sl + 8 * c : src, ok);
  }
}

// Copies the 64 x 64 tile at (r0, c0) of an [L, L] f32 plane (zeros past L)
// to rows kPitch floats apart.
template <int kPitch>
__device__ __forceinline__ void copy_plane_tile(uint32_t dst, const float* plane, int r0, int c0,
                                                int L, int vec, int tid, uint64_t policy) {
  if (vec == 16) {
    const int r = tid >> 4, c = tid & 15;
    const bool col_ok = c0 + 4 * c < L;  // L % 4 == 0: a chunk is whole or nothing
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r + 8 * i;
      const bool ok = col_ok && r0 + row < L;
      sm90::cp_async_16_hint(dst + (row * kPitch + 4 * c) * 4,
                             ok ? plane + (long long)(r0 + row) * L + c0 + 4 * c : plane, ok,
                             policy);
    }
  } else {
    for (int e = tid; e < 64 * 64; e += kThreads) {
      const int r = e >> 6, c = e & 63;
      const bool ok = r0 + r < L && c0 + c < L;
      sm90::cp_async_4_hint(dst + (r * kPitch + c) * 4,
                            plane + (ok ? (long long)(r0 + r) * L + c0 + c : 0), ok, policy);
    }
  }
}

// Copies entries r0 .. r0 + 63 of an f32 vector (zeros past L) to 64
// consecutive floats, or, with kPitch > 0, the four floats c .. c + 3 of
// every 4 to the padding columns of rows kPitch floats apart (entry e at
// row e / 8, column 64 + e % 8).
template <int kPitch = 0>
__device__ __forceinline__ void copy_vec64(uint32_t dst, const float* src, int r0, int L,
                                           int vec, int tid) {
  if (vec == 16) {
    if (tid < 16) {
      const bool ok = r0 + 4 * tid < L;
      const int at = kPitch ? (tid >> 1) * kPitch + 64 + 4 * (tid & 1) : 4 * tid;
      sm90::cp_async_16(dst + at * 4, ok ? src + r0 + 4 * tid : src, ok);
    }
  } else if (tid < 64) {
    const bool ok = r0 + tid < L;
    const int at = kPitch ? (tid >> 3) * kPitch + 64 + (tid & 7) : tid;
    sm90::cp_async_4(dst + at * 4, src + (ok ? r0 + tid : 0), ok);
  }
}

// This warp's 16 rows of a [L, 64] bf16 operand (rows[0], rows[1] = rows[0]
// + 8 for this lane) as the A fragments of the four 16-wide k-steps over d;
// rows past L are zeros.
__device__ __forceinline__ void load_a_frags(uint32_t (&fa)[4][4], const __nv_bfloat16* src,
                                             const int (&rows)[2], int L, long long sl,
                                             int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1];
      fa[kk][i] = row < L ? *reinterpret_cast<const uint32_t*>(
                                src + row * sl + 16 * kk + 2 * tig + 8 * (i >> 1))
                          : 0u;
    }
}

// The accumulators of n-tiles 2 kk, 2 kk + 1 as the A fragments of k-step kk
// (16 columns), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&fa)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fa[kk][i] = sm90::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Rows of bf16 accumulators (rows past L are not stored).
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const int (&rows)[2], int L,
                                           long long sl, int tig, const float (&x)[32]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (rows[a] >= L) continue;
    __nv_bfloat16* row = dst + rows[a] * sl + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) =
          __floats2bfloat162_rn(x[4 * nt + 2 * a], x[4 * nt + 2 * a + 1]);
  }
}

// The probability of score x in a row of max m, given -log-sum * log2 e.
__device__ __forceinline__ float prob(float x, float m, float neg_logl2) {
  return sm90::ex2(fmaf(x - m, sm90::kLog2e, neg_logl2));
}

// dq and dgate of 64 query rows, and D of those rows.
template <int kOrder>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bwd_dq_bf16_kernel(const BwdArgs a, int n_tiles, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = ring_base(smem_raw);
  const uint8_t* ring_ptr = smem_raw + (ring - sm90::smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, grp = (tid & 31) >> 2, tig = tid & 3;
  int b, h, tile;
  block_coords<kOrder>(a.B, a.H, n_tiles, b, h, tile);
  const int L = a.L, q0 = 64 * tile;
  const long long base = b * a.sb + h * a.sh;
  const auto* k = static_cast<const __nv_bfloat16*>(a.k) + base;
  const auto* v = static_cast<const __nv_bfloat16*>(a.v) + base;
  const float* plane = a.bias + (long long)h * L * L;
  const float* mask_row = a.mask + (long long)b * L;
  const uint64_t policy = sm90::l2_policy<sm90::L2Hint::kEvictNormal>();  // read by every clip

  int load_t = 0, load_stage = 0;  // the next key tile to copy, and its stage
  auto load_next = [&]() {
    if (load_t < n_tiles) {
      const uint32_t stage = ring + load_stage * kDqStage;
      const int k0 = 64 * load_t;
      copy_rows_bf16(stage, k, k0, L, a.sl, tid);
      copy_rows_bf16(stage + kKv, v, k0, L, a.sl, tid);
      copy_plane_tile<kRowPitch>(stage + 2 * kKv, plane, q0, k0, L, vec, tid, policy);
      copy_vec64<kRowPitch>(stage + 2 * kKv, mask_row, k0, L, vec, tid);
    }
    sm90::cp_async_commit();
    ++load_t;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next();

  const int r_lo = 16 * warp + grp;
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  uint32_t qa[4][4], doa[4][4], oa[4][4];
  load_a_frags(qa, static_cast<const __nv_bfloat16*>(a.q) + base, rows, L, a.sl, tig);
  load_a_frags(doa, static_cast<const __nv_bfloat16*>(a.dout) + base, rows, L, a.sl, tig);
  load_a_frags(oa, static_cast<const __nv_bfloat16*>(a.out) + base, rows, L, a.sl, tig);
  // D = sum_d do * out of this lane's rows (fragment i holds row i & 1)
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 pair's halves, widened exactly to f32
      const float d_lo = __uint_as_float(doa[kk][i] << 16);
      const float d_hi = __uint_as_float(doa[kk][i] & 0xFFFF0000u);
      const float o_lo = __uint_as_float(oa[kk][i] << 16);
      const float o_hi = __uint_as_float(oa[kk][i] & 0xFFFF0000u);
      dsum[i & 1] = fmaf(d_lo, o_lo, fmaf(d_hi, o_hi, dsum[i & 1]));
    }
  float m[2], neg_logl2[2], g[2];
  const long long bhl = ((long long)b * a.H + h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    const bool ok = rows[r] < L;  // padded rows compute on zeros and are not stored
    m[r] = ok ? a.stats[bhl + rows[r]] : 0.f;
    neg_logl2[r] = ok ? -a.stats[(long long)a.B * a.H * L + bhl + rows[r]] * sm90::kLog2e : 0.f;
    g[r] = ok ? a.gate[bhl + rows[r]] : 0.f;
    if (ok && tig == 0) a.dsum[bhl + rows[r]] = dsum[r];
  }

  float s[32], dp[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  uint32_t dsa[4][4];
  float dg[2] = {0.f, 0.f};

  // s = q . k^T and dp = do . v^T for the K and V tiles of `stage`, one group.
  auto issue_scores = [&](int stage) {
    const uint64_t kd = sm90::swizzled_desc(ring + stage * kDqStage);
    const uint64_t vd = sm90::swizzled_desc(ring + stage * kDqStage + kKv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 of d: 32 bytes along the rows
      sm90::wgmma_m64n64k16<0>(s, qa[kk], kd + (32 >> 4) * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<0>(dp, doa[kk], vd + (32 >> 4) * kk, kk > 0);
    sm90::wgmma_commit();
  };
  // dq += bf16(dp) . k for the K tile of `stage`, one group.
  auto issue_dq = [&](int stage) {
    const uint64_t kd = sm90::swizzled_desc(ring + stage * kDqStage);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 keys: 16 rows of 128 bytes
      sm90::wgmma_m64n64k16<1>(dq, dsa[kk], kd + (2048 >> 4) * kk, 1);
    sm90::wgmma_commit();
  };
  // The scores and do . v^T of key tile t (in `stage`) -> dp (f32) in s,
  // dgate += dp * bias, and dp in bf16 as the A operand of dq's product.
  auto grads_tile = [&](int t, int stage) {
    const int k0 = 64 * t;
    const float* bias_tile =
        reinterpret_cast<const float*>(ring_ptr + stage * kDqStage + 2 * kKv);
    const float* tile_row = bias_tile + r_lo * kRowPitch + 2 * tig;
    const bool edge = k0 + 64 > L;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 key =
          *reinterpret_cast<const float2*>(bias_tile + nt * kRowPitch + 64 + 2 * tig);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bias = *reinterpret_cast<const float2*>(tile_row + 8 * r * kRowPitch + 8 * nt);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * nt + 2 * r + j;
          const float bj = j ? bias.y : bias.x;
          float x = (s[e] + g[r] * bj) + (j ? key.y : key.x);
          if (edge && k0 + 8 * nt + 2 * tig + j >= L) x = -CUDART_INF_F;
          const float d = prob(x, m[r], neg_logl2[r]) * (dp[e] - dsum[r]);
          dg[r] = fmaf(d, bj, dg[r]);
          s[e] = d;
        }
      }
    }
    pack_a(dsa, s);
  };

  // Tile 0's products, alone: nothing to overlap them with yet.
  sm90::cp_async_wait<kStages - 2>();
  sm90::fence_proxy_async();
  __syncthreads();
  sm90::wgmma_fence();
  issue_scores(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  grads_tile(0, 0);

  int stage = 0;  // of tile j
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    // tile j + 1 has landed, and every thread is past the products of tile j - 1
    sm90::cp_async_wait<kStages - 3>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next();  // tile j + kStages - 1, into the stage tile j - 1 leaves
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
    issue_scores(next);
    issue_dq(stage);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::fence_regs(dq);
    grads_tile(j + 1, next);
    stage = next;
  }
  sm90::fence_regs(dq);
  sm90::wgmma_fence();
  issue_dq(stage);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dq);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 1);
    dg[r] += __shfl_xor_sync(0xffffffffu, dg[r], 2);
    if (rows[r] < L && tig == 0) a.dgate[bhl + rows[r]] = dg[r];
  }
  store_rows(static_cast<__nv_bfloat16*>(a.dq) + base, rows, L, a.sl, tig, dq);
}

// dk and dv of 64 keys.
template <int kOrder>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bwd_dkv_bf16_kernel(const BwdArgs a, int n_tiles, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = ring_base(smem_raw);
  const uint8_t* ring_ptr = smem_raw + (ring - sm90::smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, grp = (tid & 31) >> 2, tig = tid & 3;
  int b, h, tile;
  block_coords<kOrder>(a.B, a.H, n_tiles, b, h, tile);
  const int L = a.L, k0 = 64 * tile;
  const long long base = b * a.sb + h * a.sh;
  const auto* q = static_cast<const __nv_bfloat16*>(a.q) + base;
  const auto* dout = static_cast<const __nv_bfloat16*>(a.dout) + base;
  const float* plane = a.bias + (long long)h * L * L;
  const long long bhl = ((long long)b * a.H + h) * L;
  const float* row_vecs[4] = {a.stats + bhl, a.stats + (long long)a.B * a.H * L + bhl,
                              a.dsum + bhl, a.gate + bhl};
  const uint64_t policy = sm90::l2_policy<sm90::L2Hint::kEvictNormal>();

  int load_t = 0, load_stage = 0;  // the next query tile to copy, and its stage
  auto load_next = [&]() {
    if (load_t < n_tiles) {
      const uint32_t stage = ring + load_stage * kDkvStage;
      const int i0 = 64 * load_t;
      copy_rows_bf16(stage, q, i0, L, a.sl, tid);
      copy_rows_bf16(stage + kKv, dout, i0, L, a.sl, tid);
      copy_plane_tile<kColPitch>(stage + 2 * kKv, plane, i0, k0, L, vec, tid, policy);
      const uint32_t values = stage + 2 * kKv + 64 * kColPitch * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) copy_vec64(values + 256 * i, row_vecs[i], i0, L, vec, tid);
    }
    sm90::cp_async_commit();
    ++load_t;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next();

  const int j_lo = 16 * warp + grp;  // this lane's keys: j_lo and j_lo + 8 of the block's
  const int keys[2] = {k0 + j_lo, k0 + j_lo + 8};
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, static_cast<const __nv_bfloat16*>(a.k) + base, keys, L, a.sl, tig);
  load_a_frags(va, static_cast<const __nv_bfloat16*>(a.v) + base, keys, L, a.sl, tig);
  float mk[2];  // the keys' mask; keys past L score -inf
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mk[r] = keys[r] < L ? a.mask[(long long)b * L + keys[r]] : -CUDART_INF_F;

  float s[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[4][4], dsa[4][4];

  // s^T = k . q^T and dp^T = v . do^T for the q and do tiles of `stage`.
  auto issue_scores = [&](int stage) {
    const uint64_t qd = sm90::swizzled_desc(ring + stage * kDkvStage);
    const uint64_t dod = sm90::swizzled_desc(ring + stage * kDkvStage + kKv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<0>(s, ka[kk], qd + (32 >> 4) * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<0>(dp, va[kk], dod + (32 >> 4) * kk, kk > 0);
    sm90::wgmma_commit();
  };
  // dv += bf16(p^T) . do and dk += bf16(dp^T) . q for the tiles of `stage`.
  auto issue_grads = [&](int stage) {
    const uint64_t qd = sm90::swizzled_desc(ring + stage * kDkvStage);
    const uint64_t dod = sm90::swizzled_desc(ring + stage * kDkvStage + kKv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_m64n64k16<1>(dv, pa[kk], dod + (2048 >> 4) * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_m64n64k16<1>(dk, dsa[kk], qd + (2048 >> 4) * kk, 1);
    sm90::wgmma_commit();
  };
  // s^T, dp^T of query tile t (in `stage`) -> p^T and dp^T in bf16.
  auto grads_tile = [&](int t, int stage) {
    const int i0 = 64 * t;
    const float* bias_tile =
        reinterpret_cast<const float*>(ring_ptr + stage * kDkvStage + 2 * kKv);
    const float* values = bias_tile + 64 * kColPitch;
    const bool edge = i0 + 64 > L;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * tig;  // this lane's query rows col, col + 1 of the tile
      const float2 mx = *reinterpret_cast<const float2*>(values + col);
      const float2 lg = *reinterpret_cast<const float2*>(values + 64 + col);
      const float2 dd = *reinterpret_cast<const float2*>(values + 128 + col);
      const float2 gg = *reinterpret_cast<const float2*>(values + 192 + col);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float mi = j ? mx.y : mx.x, gi = j ? gg.y : gg.x, di = j ? dd.y : dd.x;
        const float neg_logl2 = -(j ? lg.y : lg.x) * sm90::kLog2e;
        const bool past = edge && i0 + col + j >= L;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * nt + 2 * r + j;
          // bias[h][query][key]: down column j_lo + 8 r of the staged tile
          const float bias = bias_tile[(col + j) * kColPitch + j_lo + 8 * r];
          float x = (s[e] + gi * bias) + mk[r];
          if (past) x = -CUDART_INF_F;
          const float p = prob(x, mi, neg_logl2);
          s[e] = p;
          dp[e] = p * (dp[e] - di);
        }
      }
    }
    pack_a(pa, s);
    pack_a(dsa, dp);
  };

  sm90::cp_async_wait<kStages - 2>();
  sm90::fence_proxy_async();
  __syncthreads();
  sm90::wgmma_fence();
  issue_scores(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  grads_tile(0, 0);

  int stage = 0;  // of tile j
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int next = stage + 1 == kStages ? 0 : stage + 1;
    sm90::cp_async_wait<kStages - 3>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::wgmma_fence();
    issue_scores(next);
    issue_grads(stage);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    grads_tile(j + 1, next);
    stage = next;
  }
  sm90::fence_regs(dk);
  sm90::fence_regs(dv);
  sm90::wgmma_fence();
  issue_grads(stage);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dk);
  sm90::fence_regs(dv);

  store_rows(static_cast<__nv_bfloat16*>(a.dk) + base, keys, L, a.sl, tig, dk);
  store_rows(static_cast<__nv_bfloat16*>(a.dv) + base, keys, L, a.sl, tig, dv);
}

// sum_b gate * dp of one 64 x 64 tile of one head over one group of clips,
// into dst ([groups, H, L, L]; dbias itself with one group).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bwd_dbias_bf16_kernel(const BwdArgs a, int n_tiles, int groups, int vec, float* dst) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = ring_base(smem_raw);
  const uint8_t* ring_ptr = smem_raw + (ring - sm90::smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, grp = (tid & 31) >> 2, tig = tid & 3;
  const int B = a.B, H = a.H, L = a.L;
  int rest = blockIdx.x;
  const int group = rest % groups;
  rest /= groups;
  const int k_tile = rest % n_tiles;
  rest /= n_tiles;
  const int q_tile = rest % n_tiles;
  const int h = rest / n_tiles;
  const int q0 = 64 * q_tile, k0 = 64 * k_tile;
  const int per_group = (B + groups - 1) / groups;
  const int b0 = group * per_group, n_clips = min(B, b0 + per_group) - b0;
  const long long BHL = (long long)B * H * L;

  int load_c = 0, load_stage = 0;  // the next clip to copy, and its stage
  auto load_next = [&]() {
    if (load_c < n_clips) {
      const uint32_t stage = ring + load_stage * kDbiasStage;
      const int b = b0 + load_c;
      const long long base = b * a.sb + h * a.sh;
      copy_rows_bf16(stage, static_cast<const __nv_bfloat16*>(a.q) + base, q0, L, a.sl, tid);
      copy_rows_bf16(stage + kKv, static_cast<const __nv_bfloat16*>(a.dout) + base, q0, L, a.sl,
                     tid);
      copy_rows_bf16(stage + 2 * kKv, static_cast<const __nv_bfloat16*>(a.k) + base, k0, L,
                     a.sl, tid);
      copy_rows_bf16(stage + 3 * kKv, static_cast<const __nv_bfloat16*>(a.v) + base, k0, L,
                     a.sl, tid);
      const long long bhl = ((long long)b * H + h) * L;
      const uint32_t values = stage + 4 * kKv;
      copy_vec64(values, a.stats + bhl, q0, L, vec, tid);
      copy_vec64(values + 256, a.stats + BHL + bhl, q0, L, vec, tid);
      copy_vec64(values + 512, a.dsum + bhl, q0, L, vec, tid);
      copy_vec64(values + 768, a.gate + bhl, q0, L, vec, tid);
      copy_vec64(values + 1024, a.mask + (long long)b * L, k0, L, vec, tid);
    }
    sm90::cp_async_commit();
    ++load_c;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next();

  const int r_lo = 16 * warp + grp;
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  const float* plane = a.bias + (long long)h * L * L;
  float bias[32], acc[32], s[32], dp[32];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e >> 1], key = k0 + 8 * nt + 2 * tig + (e & 1);
      bias[4 * nt + e] = row < L && key < L ? plane[(long long)row * L + key] : 0.f;
      acc[4 * nt + e] = 0.f;
    }
  const bool edge = k0 + 64 > L;

  int stage = 0;
  for (int c = 0; c < n_clips; ++c) {
    // clip c has landed, and every thread is past clip c - 1's reads
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next();  // clip c + kStages - 1, into the stage clip c - 1 leaves
    const uint32_t st = ring + stage * kDbiasStage;
    const uint64_t qd = sm90::swizzled_desc(st), dod = sm90::swizzled_desc(st + kKv);
    const uint64_t kd = sm90::swizzled_desc(st + 2 * kKv), vd = sm90::swizzled_desc(st + 3 * kKv);
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16_ss<0>(s, qd + (32 >> 4) * kk, kd + (32 >> 4) * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16_ss<0>(dp, dod + (32 >> 4) * kk, vd + (32 >> 4) * kk, kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    const float* values = reinterpret_cast<const float*>(ring_ptr + stage * kDbiasStage + 4 * kKv);
    float m[2], neg_logl2[2], dsum[2], g[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = values[r_lo + 8 * r];
      neg_logl2[r] = -values[64 + r_lo + 8 * r] * sm90::kLog2e;
      dsum[r] = values[128 + r_lo + 8 * r];
      g[r] = values[192 + r_lo + 8 * r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 key = *reinterpret_cast<const float2*>(values + 256 + 8 * nt + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * nt + e;
        float x = (s[i] + g[r] * bias[i]) + ((e & 1) ? key.y : key.x);
        if (edge && k0 + 8 * nt + 2 * tig + (e & 1) >= L) x = -CUDART_INF_F;
        const float d = prob(x, m[r], neg_logl2[r]) * (dp[i] - dsum[r]);
        acc[i] = fmaf(g[r], d, acc[i]);
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }

  float* out = dst + ((long long)group * H + h) * L * L;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e >> 1], key = k0 + 8 * nt + 2 * tig + (e & 1);
      if (row < L && key < L) out[(long long)row * L + key] = acc[4 * nt + e];
    }
}

// dbias = the groups' partial planes added in group order.
__global__ void dbias_sum_kernel(const float* __restrict__ parts, float* __restrict__ dbias,
                                 long long n, int groups) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = parts[i];
    for (int g = 1; g < groups; ++g) sum += parts[g * n + i];
    dbias[i] = sum;
  }
}

// D = sum_d do * out for the f32 kernels: 16 lanes a row, 8 rows a block.
__global__ void __launch_bounds__(128) dsum_f32_kernel(const BwdArgs a) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 4);
  const int lane = threadIdx.x & 15;
  const long long n = (long long)a.B * a.H * a.L;
  float sum = 0.f;
  if (row < n) {
    const long long bh = row / a.L;
    const long long base = (bh / a.H) * a.sb + (bh % a.H) * a.sh + (row % a.L) * a.sl;
    const float* dout = static_cast<const float*>(a.dout) + base;
    const float* out = static_cast<const float*>(a.out) + base;
#pragma unroll
    for (int i = 0; i < kHeadDim / 16; ++i)
      sum = fmaf(dout[lane + 16 * i], out[lane + 16 * i], sum);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n && lane == 0) a.dsum[row] = sum;
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

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, out, dq, dk and dv share
// the strides (stride_b, stride_h, stride_l) in elements, with a unit
// head-dim stride (for bf16: 16-byte aligned rows); bias [H, L, L], gate
// [B, H, L], mask [B, L], stats [2, B, H, L] (the forward's), dsum [B, H, L]
// (D, filled here), dgate [B, H, L] and dbias [H, L, L] are contiguous f32.
// Read by the bf16 path only: dbias_groups, a [clip_groups, H, L, L] f32
// scratch (null with one group); clip_groups, how many groups of
// ceil(B / clip_groups) clips the dbias kernel sums apart (none empty);
// vec, 16 when the rows of bias, mask, gate, stats and dsum may be copied as
// 16-byte vectors (L % 4 == 0 and 16-byte aligned bases), else 4;
// grid_order, sm90::GridOrder of the dq and dk+dv kernels. Launches the
// kernels on `stream` and returns the first CUDA error (0 on success).
extern "C" int wavlm_gated_relpos_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* gate,
    const void* mask, const void* dout, const void* stats, const void* out, void* dsum,
    void* dq, void* dk, void* dv, void* dgate, void* dbias, void* dbias_groups, int B, int H,
    int L, int clip_groups, int vec, int grid_order, long long stride_b, long long stride_h,
    long long stride_l, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const BwdArgs args{q, k, v, static_cast<const float*>(bias),
                     static_cast<const float*>(gate), static_cast<const float*>(mask), dout,
                     static_cast<const float*>(stats), out, static_cast<float*>(dsum), dq, dk,
                     dv, static_cast<float*>(dgate), static_cast<float*>(dbias), B, H, L,
                     stride_b, stride_h, stride_l};
  const auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    const int tiles = (L + kTile - 1) / kTile;
    if (H > 65535 || tiles > 65535) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)B * H * L;
    dsum_f32_kernel<<<(unsigned)((rows + 7) / 8), 128, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    const dim3 per_clip(B, tiles, H), per_pair(tiles, tiles, H);
    dq_f32_kernel<<<per_clip, kBwdF32Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dkv_f32_kernel<<<per_clip, kBwdF32Threads, 0, s>>>(args);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    dbias_f32_kernel<<<per_pair, kBwdF32Threads, 0, s>>>(args);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (vec != 16 && vec != 4) || clip_groups < 1 || clip_groups > B ||
      (grid_order != sm90::kQueryTileFastest && grid_order != sm90::kClipFastest))
    return (int)cudaErrorInvalidValue;
  const int per_group = (B + clip_groups - 1) / clip_groups;
  if ((clip_groups - 1) * per_group >= B || (clip_groups > 1 && dbias_groups == nullptr))
    return (int)cudaErrorInvalidValue;  // an empty group, or nowhere to put the groups' sums
  if (vec == 16) {
    const void* rows16[] = {bias, mask, gate, stats, dsum};
    if (L % 4 != 0) return (int)cudaErrorMisalignedAddress;
    for (const void* p : rows16)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  const long long n_tiles = (L + 63) / 64;
  const long long per_clip = n_tiles * B * H;
  const long long per_tile = n_tiles * n_tiles * H * clip_groups;
  if (per_clip > 0x7FFFFFFFLL || per_tile > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  void (*dq_kernel)(BwdArgs, int, int) = bwd_dq_bf16_kernel<sm90::kQueryTileFastest>;
  void (*dkv_kernel)(BwdArgs, int, int) = bwd_dkv_bf16_kernel<sm90::kQueryTileFastest>;
  if (grid_order == sm90::kClipFastest) {
    dq_kernel = bwd_dq_bf16_kernel<sm90::kClipFastest>;
    dkv_kernel = bwd_dkv_bf16_kernel<sm90::kClipFastest>;
  }
  const void* kernels[] = {reinterpret_cast<const void*>(dq_kernel),
                           reinterpret_cast<const void*>(dkv_kernel),
                           reinterpret_cast<const void*>(bwd_dbias_bf16_kernel)};
  for (const void* kernel : kernels) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return (int)attr;
  }
  dq_kernel<<<(unsigned)per_clip, kThreads, kSmem, s>>>(args, (int)n_tiles, vec);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  dkv_kernel<<<(unsigned)per_clip, kThreads, kSmem, s>>>(args, (int)n_tiles, vec);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  float* sums = clip_groups > 1 ? static_cast<float*>(dbias_groups) : args.dbias;
  bwd_dbias_bf16_kernel<<<(unsigned)per_tile, kThreads, kSmem, s>>>(args, (int)n_tiles,
                                                                      clip_groups, vec, sums);
  if ((rc = (int)cudaGetLastError()) != 0 || clip_groups == 1) return rc;
  const long long n = (long long)H * L * L;
  const long long blocks = (n + 255) / 256;
  dbias_sum_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0, s>>>(sums, args.dbias,
                                                                             n, clip_groups);
  return (int)cudaGetLastError();
}
