// The two A/B probes of WavLM's long attention kernel, for Hopper (sm_90a),
// on the wgmma tiles of attention_tiles_sm90.cuh that the incumbent (row 2,
// wavlm_attention.cu's GatedBiasRing) runs on, so that a probe's time against
// the incumbent's measures its arithmetic and not a difference of tiles.
// Both compute row 2's function (softmax(q . k^T + gate * bias + mask) . v,
// q pre-scaled, head_dim 64, bf16 in and out) with another arithmetic.
//
// 1. int8 operands. Replaces scripts/attn_int8_probe.py:_int8_kernel (its
//    pallas_call at :100). q and k are quantised per row (absmax over d), v
//    per column (absmax over the clip's L keys), to symmetric int8 with scale
//    max(absmax, 1e-8) / 127; s = (qq . kq^T as int32) * sq * sk; the
//    softmax is f32 over the whole row; a = e / r is quantised with the fixed
//    scale 127 (round(a * 127), in [0, 127]); out = (aq . vq as int32) / 127
//    * sv. The operands' quantisation divides with IEEE division and rounds
//    half to even (the build has no fast math), so the int8 q, k and v equal
//    the plain version's bit for bit.
//    - A prologue kernel (quantize_kv_kernel)
//      quantises k per row and v per column once per (clip, head): kq
//      [B, H, L, 64] and sk [B, H, L], and vq transposed, [B, H, 64, Lp] with
//      Lp = L rounded up to the key tile (64) and zeros past L, and sv
//      [B, H, 64]. The Pallas kernel redoes this in every query block.
//    - The main kernel (attn_int8_kernel) quantises its 64 query rows into
//      registers, where they stay as the A operand of q . k^T for the whole
//      kernel (the quad of lanes that holds a row takes its absmax with two
//      shuffles). Both products are wgmma.mma_async m64n64k32 .s32.s8.s8:
//      kq's 64-byte rows are the K-major B operand of q . k^T, and the
//      transposed vq is already K-major for aq . vq (8-bit wgmma takes no
//      transposed operand); both int8 tiles use the 64-byte swizzle (a row
//      fills it) and its own descriptors. The fixed 127 scale needs each
//      row's sum before the second product, so there are two passes over the
//      keys: the row max and sum (online), then the probabilities and both
//      products.
//    - The fragment order. The s32 accumulators of q . k^T are the int8 A
//      fragment of aq . vq only if each lane's four adjacent bytes of the
//      fragment are the probabilities of four adjacent keys. The accumulator
//      gives lane tig of a quad the columns 8 nt + 2 tig + j (n-tile nt < 8,
//      j < 2); the m64nNk32 A fragment wants keys 4 tig .. 4 tig + 3 (+ 16,
//      + 32) of a 64-key tile. So the K tile is staged with its rows
//      permuted: row c = 8 nt + 2 tig + j of the tile in shared memory holds
//      key
//          sigma(c) = 16 (nt / 2) + 4 tig + 2 (nt % 2) + j,
//      and register 2 h + a of k-step kk (row grp + 8 a, keys 32 kk + 16 h +
//      4 tig ..) packs the bytes of n-tiles 4 kk + 2 h and 4 kk + 2 h + 1.
//      It is the mma.sync m16n8k32 permutation carried over eight
//      n-tiles: the wgmma A and D layouts are those of mma.sync per warp.
//      ops/attn_probes.py:key_permutation writes it in Python. The bias,
//      mask and sk of a column are read at its key sigma(c): keys 16 q4 +
//      4 tig .. + 3 are one float4 (q4 = nt / 2), and with the bias tile's
//      rows padded to 80 floats the quarter-warps' 16-byte reads fall in
//      distinct banks; the tile's mask and sk rows lie in its padding.
//    - Conversions run at a quarter of the FMA rate on this card, as the
//      exponential does, so the chain takes none: the int32 score is made a
//      float by adding it to the bits of 1.5 * 2^23 and subtracting that
//      (exact: |s| <= 64 * 127^2 < 2^22), and round(127 a) is the low byte
//      of the float 127 a + 1.5 * 2^23. Per score the f32 chain is that,
//      two FMULs for the scales, the gated bias (FFMA, FADD), and the
//      exponential (FFMA, MUFU.EX2, as in the incumbent); the first pass adds
//      the max and the sum, the second the scaled rounding.
//
// 2. softmax variants. Replaces scripts/attn_softmax_variants_probe.py's
//    make_kernel (its pallas_call at :98), one kernel templated on
//    <postnorm, bf16chain>:
//    A (false, false): f32 chain, a = bf16(e / r), then a . v;
//    B (true, false):  bf16(e) . v on the unnormalised e, divided by r after;
//    C (false, true):  the chain in bf16, rounded after every operation as
//                      the probe computes it: bf16(s); bf16(g) * bf16(bias);
//                      each add; p - max; exp; r summed in f32 over the bf16
//                      e; a = bf16(e * bf16(1 / r));
//    D (true, true):   B and C.
//    - B and D take one online pass, the incumbent's loop: q . k_{j+1} and
//      p_j . v_j issued under one wait, the probabilities relative to the
//      running max, the output rescaled when a row's max moves, divided by
//      r at the end. So their e is rounded relative to the running max
//      rather than the final one.
//    - A and C normalise before the second product, so they need each row's
//      sum first: two passes over the keys. The first streams K, the bias
//      tile and the mask (its ring stages carry no V) and forms the scores
//      and the online max and sum only; the second forms a and both
//      products. They read the bias plane twice: at L = 1504 a pass reads
//      144.8 MB of plane, ~3x the 50 MB L2, so the clip goes fastest in the
//      grid (the incumbent's long-bucket order), and the B blocks of one
//      64-row slab read it together.
//    - C and D run the chain on packed bf16 pairs (__nv_bfloat162) wherever
//      one packed instruction rounds where the plain version rounds:
//      bf16(s) and bf16(bias) by F2FP, bf16(g) * bf16(bias) by __hmul2_rn (a
//      product of two bf16 is exact in f32, so one rounding is the plain
//      version's), each add by __hadd2_rn, the max by __hmax2, p - max by
//      __hsub2_rn, and a = e * bf16(1 / r) by __hmul2_rn. The _rn forms
//      keep the compiler from contracting g * bias + s into one HFMA2,
//      which rounds once where the probe rounds twice (with plain __hmul2
//      it did, and C's output moved 1.1e-5 to 1.9e-5 in cosine from the
//      plain version's, over its 1e-5 bar). The exponential is the
//      probe's bf16(exp(x)) of an f32 exp, the f32 chain's: MUFU.EX2 of
//      x * log2 e in f32, so that the two chains differ only in the packed
//      arithmetic (expf, the plain version's own exp, took 17.1 instead of
//      11.2 instructions a score in C's second pass for the same cosine,
//      ~3e-7; a bf16x2 ex2 would take x * log2 e in bf16, off by more than
//      the bars allow). Each pair is unpacked for it and its sum.
//    - The f32 chain (A, B) is the incumbent's: (s + g * bias) + mask, then
//      ex2(s * log2 e - max * log2 e) (FFMA, MUFU.EX2); A scales e by 1 / r
//      (one FMUL) where the probe divides (its e is not exp's to the last
//      bit either: ex2.approx).
//
// Tiles: one warpgroup a block (64 query rows, 128 threads), two blocks an
// SM; K, V (or their int8 tiles) and the 64 x 64 f32 bias tile with the mask
// (and sk) in its padding ride a ring of three stages, filled with 16-byte
// cp.async (4-byte copies of the bias, mask and sk where L % 4 != 0) one
// tile ahead of the products; wgmma reads the B operands from the ring and q
// from registers; the probabilities go from the score accumulators to the A
// fragments of the second product in registers. Stages: bf16 K + V + bias
// 34 KB, int8 kq + vq + bias 28 KB. The grid is one-dimensional with the
// clip fastest under (head, query tile). The tiles' shared kernel
// (attention_bf16_kernel) is not instantiated: its policies form one f32
// score at a time in one online pass, and the probes need two passes,
// packed pairs and int8 products. So they own their loops and take the
// header's copies, descriptors, wgmma wrappers and ring discipline, and
// GatedBiasRing's staging of the bias tile and mask row.
//
// What bounds them on this card, at the probes' shapes (B = 25, L = 1504 and
// B = 30, L = 1008; H = 16): the 4 B H L^2 d products take ~0.23 ms at the
// bf16 peak at 1504 (half that at the int8 rate), the bytes (q, k, v, out
// once, the [H, L, L] bias, the gate and mask) ~0.14 ms, and one MUFU.EX2
// a score on 16 lanes an SM ~0.23 ms a pass. None of these is reached: as
// measured (PERF.md, section 6), the time moves by ~0.022 ms per
// SASS instruction a score between variants of one pass structure, so the
// chain's issue is ~20 % of B's time and most of the rest is latency with
// 8 warps an SM; the two-pass kernels pay it twice.
//
// Both kernels take contiguous [B, H, L, 64] bf16 q, k, v (the probes' layout)
// and any L: query rows past L are computed on zeros and not stored, keys
// past L score -inf.

#include "attention_tiles_sm90.cuh"

namespace {

using sm90::kD;
using sm90::kTileK;

constexpr int kThreads = 128;  // one warpgroup: 64 query rows a block
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;
constexpr int kQuantThreads = 256;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

struct ProbeParams {
  const float* bias;  // [H, L, L]
  const float* gate;  // [B, H, L]
  const float* mask;  // [B, L]
};

using sm90::fence_regs;
__device__ __forceinline__ void fence_regs(int (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// d (+)= a . b for a 64 x 32 s8 A in registers (per warp the mma.sync
// m16n8k32 A layout: register 2 h + a holds row grp + 8 a, columns
// 16 h + 4 tig .. + 3) and a 32 x 64 K-major s8 B in shared memory.
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate)
      : "memory");
}

// Descriptor of a 64-byte-swizzled K-major tile of 64-byte rows at `addr`
// (tile base 512-byte aligned; addr may be advanced along a row): groups of 8
// rows lie 512 bytes apart.
__device__ __forceinline__ uint64_t swizzled64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{512 >> 4} << 32) | (uint64_t{2} << 62);
}

// Offset of 16-byte chunk ch (< 4) of row r in a 64-byte-swizzled tile.
__device__ __forceinline__ uint32_t swizzle64(int r, int ch) {
  return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4);
}

// The key held by row c of a staged int8 K tile (see the note at the top).
__device__ __forceinline__ int key_of_row(int c) {
  const int nt = c >> 3, tig = (c >> 1) & 3, j = c & 1;
  return 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + j;
}

__device__ __forceinline__ float quad_max(float m) {
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The block's (clip, head, first query row): the clip fastest in the grid.
struct BlockPos {
  int b, h, q0;
  __device__ BlockPos(int B, int n_q_tiles) {
    const int ht = blockIdx.x / B;
    b = blockIdx.x - ht * B;
    h = ht / n_q_tiles;
    q0 = (ht - h * n_q_tiles) * 64;
  }
};

// Starts the copies of one key tile's f32 bias (rows q0 .., keys k0 .. of
// the [L, L] plane, zeros outside it) into `dst` at a pitch of kPitch floats,
// and of the tile's 64 keys of each of kKeyRows [L] key rows (row0, then
// row1; zeros past L) into the padding columns: key c of key row i at flat
// index 64 i + c of the padding, row (64 i + c) / (kPitch - 64), column
// 64 + (64 i + c) % (kPitch - 64). vec 16: 16-byte copies (L % 4 == 0,
// 16-byte aligned rows), else 4-byte.
template <int kPitch, int kKeyRows>
__device__ __forceinline__ void copy_bias_tile(uint32_t dst, const float* plane,
                                               const float* row0, const float* row1, int q0,
                                               int k0, int L, int vec) {
  constexpr int kSpare = kPitch - kTileK;
  static_assert(kSpare % 4 == 0 && 64 * kKeyRows <= 8 * kSpare && 64 * kKeyRows <= kThreads,
                "the key rows fit the first 8 rows' padding, a thread a key");
  const int tid = threadIdx.x;
  if (vec == 16) {
    const int bias_r = tid >> 4, bias_c = tid & 15;
    const bool col_ok = k0 + 4 * bias_c < L;  // L % 4 == 0: a chunk is whole or nothing
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = bias_r + 8 * i;
      const bool ok = col_ok && q0 + r < L;
      sm90::cp_async_16(dst + (r * kPitch + 4 * bias_c) * 4,
                        plane + (ok ? (long long)(q0 + r) * L + k0 + 4 * bias_c : 0), ok);
    }
    if (tid < 16 * kKeyRows) {
      const int m = tid & 15, flat = 4 * tid;
      const bool ok = k0 + 4 * m < L;
      sm90::cp_async_16(dst + ((flat / kSpare) * kPitch + kTileK + flat % kSpare) * 4,
                        (tid < 16 ? row0 : row1) + (ok ? k0 + 4 * m : 0), ok);
    }
  } else {
    for (int e = tid; e < 64 * kTileK; e += kThreads) {
      const int r = e / kTileK, c = e % kTileK;
      const bool ok = q0 + r < L && k0 + c < L;
      sm90::cp_async_4(dst + (r * kPitch + c) * 4,
                       plane + (ok ? (long long)(q0 + r) * L + k0 + c : 0), ok);
    }
    if (tid < 64 * kKeyRows) {
      const int c = tid & 63;
      const bool ok = k0 + c < L;
      sm90::cp_async_4(dst + ((tid / kSpare) * kPitch + kTileK + tid % kSpare) * 4,
                       (tid < 64 ? row0 : row1) + (ok ? k0 + c : 0), ok);
    }
  }
}

// ---------------------------------------------------------------------------
// The int8 probe
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// Symmetric int8 of one 64-wide bf16 row (16-byte aligned): writes the 64
// values to dst and returns the scale max(absmax, 1e-8) / 127.
__device__ float quantize_row(const __nv_bfloat16* __restrict__ row, int8_t* dst) {
  float x[kD];
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < kD; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[c + i] = __bfloat162float(e[i]);
      m = fmaxf(m, fabsf(x[c + i]));
    }
  }
  const float scale = fmaxf(m, 1e-8f) / 127.f;
#pragma unroll
  for (int c = 0; c < kD; c += 4)
    *reinterpret_cast<uint32_t*>(dst + c) =
        pack_s8(__float2int_rn(x[c] / scale), __float2int_rn(x[c + 1] / scale),
                __float2int_rn(x[c + 2] / scale), __float2int_rn(x[c + 3] / scale));
  return scale;
}

// One block per (clip, head): v's column scales, v quantised and transposed,
// then k per row.
__global__ void __launch_bounds__(kQuantThreads) quantize_kv_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    int8_t* __restrict__ kq, float* __restrict__ sk, int8_t* __restrict__ vqt,
    float* __restrict__ sv, int L, int Lp) {
  __shared__ float part[kQuantThreads / kD][kD];
  __shared__ float scale[kD];
  const long long bh = blockIdx.x;
  const __nv_bfloat16* kb = k + bh * L * kD;
  const __nv_bfloat16* vb = v + bh * L * kD;
  const int t = threadIdx.x, col = t % kD, grp = t / kD;
  constexpr int kGroups = kQuantThreads / kD;

  float m = 0.f;
  for (int l = grp; l < L; l += kGroups)
    m = fmaxf(m, fabsf(__bfloat162float(vb[(long long)l * kD + col])));
  part[grp][col] = m;
  __syncthreads();
  if (t < kD) {
    m = part[0][t];
    for (int g = 1; g < kGroups; ++g) m = fmaxf(m, part[g][t]);
    scale[t] = fmaxf(m, 1e-8f) / 127.f;
    sv[bh * kD + t] = scale[t];
  }
  __syncthreads();

  int8_t* vt = vqt + bh * kD * Lp;
  for (long long e = t; e < (long long)kD * Lp; e += kQuantThreads) {
    const int d = (int)(e / Lp), l = (int)(e % Lp);
    vt[e] = l < L ? (int8_t)__float2int_rn(__bfloat162float(vb[(long long)l * kD + d]) / scale[d])
                  : (int8_t)0;
  }
  for (int l = t; l < L; l += kQuantThreads)
    sk[bh * L + l] = quantize_row(kb + (long long)l * kD, kq + (bh * L + l) * kD);
}

// The int8 ring stage: kq tile (rows permuted), vq tile, then the f32 bias
// tile at a pitch of 80 floats whose padding columns 64..79 hold the mask
// (rows 0..3) and sk (rows 4..7): chunk m (keys 4 m .. 4 m + 3) of either
// at row m / 4 (+ 4), column 64 + 4 (m % 4).
constexpr int kS8TileBytes = kTileK * kD;  // 4 KB
constexpr int kS8Pitch = 80;
constexpr int kS8StageBytes = 2 * kS8TileBytes + 64 * kS8Pitch * 4;  // 28 KB
static_assert(kS8StageBytes % 1024 == 0, "every int8 tile starts a swizzle period");
constexpr int kS8Smem = kStages * kS8StageBytes + 1024;

// One block per (clip, head, 64 query rows), clip fastest. bias_vec: 16 when
// the bias, mask and sk rows may be copied as 16-byte vectors, else 4.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) attn_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ sk, const int8_t* __restrict__ vqt,
    const float* __restrict__ sv, const ProbeParams params, __nv_bfloat16* __restrict__ out,
    int B, int H, int L, int Lp, int n_q_tiles, int bias_vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - sm90::smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  const BlockPos pos(B, n_q_tiles);
  const int b = pos.b, h = pos.h, q0 = pos.q0;
  const long long bh = (long long)b * H + h;
  const int n_tiles = (L + kTileK - 1) / kTileK;
  const int r_lo = 16 * warp + grp;  // this lane's rows of the block: r_lo, r_lo + 8
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  float g[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) g[a] = rows[a] < L ? params.gate[bh * L + rows[a]] : 0.f;
  const float* plane = params.bias + (long long)h * L * L;
  const float* mask_row = params.mask + (long long)b * L;
  const float* sk_row = sk + bh * L;

  // copies of one key tile: kq rows key_of_row(c) into rows c, vq, bias
  int load_t = 0, load_stage = 0;
  auto load_next = [&](bool with_v) {
    if (load_t < n_tiles) {
      const uint32_t stage = ring + load_stage * kS8StageBytes;
      const int k0 = load_t * kTileK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (tid >> 2) + 32 * i, ch = tid & 3;
        const int key = k0 + key_of_row(r);
        const bool ok = key < L;
        sm90::cp_async_16(stage + swizzle64(r, ch), kq + (bh * L + (ok ? key : 0)) * kD + 16 * ch,
                          ok);
        if (with_v)
          sm90::cp_async_16(stage + kS8TileBytes + swizzle64(r, ch),
                            vqt + (bh * kD + r) * Lp + k0 + 16 * ch, true);
      }
      copy_bias_tile<kS8Pitch, 2>(stage + 2 * kS8TileBytes, plane, mask_row, sk_row, q0, k0, L,
                                  bias_vec);
    }
    sm90::cp_async_commit();
    ++load_t;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next(false);

  // The query rows quantised into the A fragments of the two k-steps over d.
  uint32_t qa[2][4];
  float sq[2];
  {
    float x[2][2][2][4];  // [row a][k-step kk][half][4 columns]
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint2 u = make_uint2(0u, 0u);
          if (rows[a] < L)
            u = *reinterpret_cast<const uint2*>(q + (bh * L + rows[a]) * kD + 32 * kk + 16 * hf +
                                                4 * tig);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[a][kk][hf][i] = __bfloat162float(e[i]);
            m[a] = fmaxf(m[a], fabsf(x[a][kk][hf][i]));
          }
        }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      sq[a] = fmaxf(quad_max(m[a]), 1e-8f) / 127.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float(&xs)[4] = x[a][kk][hf];
          qa[kk][2 * hf + a] =
              pack_s8(__float2int_rn(xs[0] / sq[a]), __float2int_rn(xs[1] / sq[a]),
                      __float2int_rn(xs[2] / sq[a]), __float2int_rn(xs[3] / sq[a]));
        }
    }
  }

  int s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0;
  float p[32];  // the scores of a tile, then its probabilities

  auto issue_qk = [&](int stage) {
    const uint64_t desc = swizzled64_desc(ring + stage * kS8StageBytes);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)  // a k-step is 32 of d: 32 bytes along the rows
      wgmma_s8_m64n64k32(s, qa[kk], desc + (32 >> 4) * kk, kk > 0);
    sm90::wgmma_commit();
  };
  uint32_t pa[2][4];
  auto issue_av = [&](int stage) {
    const uint64_t desc = swizzled64_desc(ring + stage * kS8StageBytes + kS8TileBytes);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)  // a k-step is 32 keys: 32 bytes along vq's rows
      wgmma_s8_m64n64k32(o, pa[kk], desc + (32 >> 4) * kk, 1);
    sm90::wgmma_commit();
  };

  // p = (s * sq) * sk + gate * bias + mask for key tile t, -inf past L;
  // element 4 nt + 2 a + j is row r_lo + 8 a, key k0 + 16 (nt / 2) + 4 tig +
  // 2 (nt % 2) + j.
  auto scores = [&](int t, int stage) {
    const int k0 = t * kTileK;
    const float* tile =
        reinterpret_cast<const float*>(ring_ptr + stage * kS8StageBytes + 2 * kS8TileBytes);
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const float4 mask4 = *reinterpret_cast<const float4*>(tile + q4 * kS8Pitch + kTileK + 4 * tig);
      const float4 sk4 =
          *reinterpret_cast<const float4*>(tile + (4 + q4) * kS8Pitch + kTileK + 4 * tig);
      const float mk[4] = {mask4.x, mask4.y, mask4.z, mask4.w};
      const float kk4[4] = {sk4.x, sk4.y, sk4.z, sk4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float4 b4 = *reinterpret_cast<const float4*>(tile + (r_lo + 8 * a) * kS8Pitch +
                                                           16 * q4 + 4 * tig);
        const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * (2 * q4 + (i >> 1)) + 2 * a + (i & 1);
          const float sf = __int_as_float(s[e] + kMagicBits) - kMagic;  // exact
          p[e] = (sf * sq[a]) * kk4[i] + g[a] * bs[i] + mk[i];
        }
      }
    }
    if (k0 + kTileK > L) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int nt = e >> 2;
        const int kj = k0 + 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + (e & 1);
        if (kj >= L) p[e] = -CUDART_INF_F;
      }
    }
  };

  auto tile_max = [&](int a) {
    float m = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) m = fmaxf(m, fmaxf(p[4 * nt + 2 * a], p[4 * nt + 2 * a + 1]));
    return quad_max(m);
  };

  // pass 1: each row's max and sum of exp(p - max), online
  float row_max2[2] = {-CUDART_INF_F, -CUDART_INF_F};  // max * log2 e
  float row_sum[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    sm90::cp_async_wait<kStages - 2>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next(false);
    sm90::wgmma_fence();
    issue_qk(stage);
    sm90::wgmma_wait<0>();
    fence_regs(s);
    scores(t, stage);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float max2 = fmaxf(row_max2[a], tile_max(a) * sm90::kLog2e);
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) part += sm90::ex2(fmaf(p[4 * nt + 2 * a + j], sm90::kLog2e, -max2));
      row_sum[a] = row_sum[a] * sm90::ex2(row_max2[a] - max2) + part;
      row_max2[a] = max2;
    }
  }
  float scale127[2];  // 127 / r
#pragma unroll
  for (int a = 0; a < 2; ++a) scale127[a] = 127.f / quad_sum(row_sum[a]);

  // pass 2: aq = round(127 e / r), out += aq . vq
  sm90::cp_async_wait<0>();
  __syncthreads();  // every thread is past pass 1's last tile
  load_t = 0;
  load_stage = 0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next(true);

  // the probabilities of p as the int8 A fragments of aq . vq (the note at
  // the top): register 2 h + a of k-step kk packs n-tiles 4 kk + 2 h, + 1
  auto probs = [&]() {
    int bytes[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int a = (e >> 1) & 1;
      const float x = sm90::ex2(fmaf(p[e], sm90::kLog2e, -row_max2[a]));
      bytes[e] = __float_as_int(fmaf(x, scale127[a], kMagic));  // low byte: round(127 e / r)
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int e0 = 4 * (4 * kk + 2 * hf) + 2 * a, e1 = e0 + 4;
          pa[kk][2 * hf + a] = __byte_perm(__byte_perm(bytes[e0], bytes[e0 + 1], 0x0040),
                                           __byte_perm(bytes[e1], bytes[e1 + 1], 0x0040), 0x5410);
        }
  };

  sm90::cp_async_wait<kStages - 2>();
  sm90::fence_proxy_async();
  __syncthreads();
  sm90::wgmma_fence();
  issue_qk(0);
  sm90::wgmma_wait<0>();
  fence_regs(s);
  scores(0, 0);
  probs();
  int stage = 0;
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int next_stage = stage + 1 == kStages ? 0 : stage + 1;
    sm90::cp_async_wait<kStages - 3>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next(true);
    fence_regs(s);
    fence_regs(o);
    sm90::wgmma_fence();
    issue_qk(next_stage);
    issue_av(stage);
    sm90::wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    scores(j + 1, next_stage);
    probs();
    stage = next_stage;
  }
  fence_regs(o);
  sm90::wgmma_fence();
  issue_av(stage);
  sm90::wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qi = rows[a];
    if (qi >= L) continue;  // padded query rows were computed on zeros
    __nv_bfloat16* dst = out + (bh * L + qi) * kD + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) = __floats2bfloat162_rn(
          ((float)o[4 * nt + 2 * a] * (1.f / 127.f)) * sv[bh * kD + c],
          ((float)o[4 * nt + 2 * a + 1] * (1.f / 127.f)) * sv[bh * kD + c + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The softmax variants
// ---------------------------------------------------------------------------

// The bf16 ring stage: K, V (128-byte swizzle), the f32 bias tile at a pitch
// of 72 floats with the mask row in the padding columns of its first 8 rows
// (key c at row c / 8, column 64 + c % 8), as GatedBiasRing stages them.
constexpr int kBfPitch = sm90::kBiasPitch;  // 72
constexpr int kBfStageBytes = 2 * sm90::kKvTileBytes + 64 * kBfPitch * 4;  // 34 KB
static_assert(kBfStageBytes % 1024 == 0, "every K and V tile starts a swizzle period");
constexpr int kBfSmem = kStages * kBfStageBytes + 1024;

template <bool kPostnorm, bool kBf16Chain>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) softmax_variant_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const ProbeParams params,
    __nv_bfloat16* __restrict__ out, int B, int H, int L, int n_q_tiles, int bias_vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - sm90::smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  const BlockPos pos(B, n_q_tiles);
  const int b = pos.b, h = pos.h, q0 = pos.q0;
  const long long bh = (long long)b * H + h;
  const long long base = bh * L * kD;
  const int n_tiles = (L + kTileK - 1) / kTileK;
  const int r_lo = 16 * warp + grp;
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  float g[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) g[a] = rows[a] < L ? params.gate[bh * L + rows[a]] : 0.f;
  const float* plane = params.bias + (long long)h * L * L;
  const float* mask_row = params.mask + (long long)b * L;

  // copies of one key tile (GatedBiasRing's on attention_tiles_sm90.cuh)
  const int kv_r = tid >> 3, kv_c = tid & 7;
  const uint32_t kv_dst = kv_r * 128 + ((kv_c ^ (kv_r & 7)) << 4);
  int load_t = 0, load_stage = 0;
  auto load_next = [&](bool with_v) {
    if (load_t < n_tiles) {
      const uint32_t stage = ring + load_stage * kBfStageBytes;
      const int k0 = load_t * kTileK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = k0 + kv_r + 16 * i;
        const bool ok = r < L;
        const long long off = base + (long long)(ok ? r : 0) * kD + kv_c * 8;
        sm90::cp_async_16(stage + kv_dst + 128 * 16 * i, k + off, ok);
        if (with_v) sm90::cp_async_16(stage + sm90::kKvTileBytes + kv_dst + 128 * 16 * i, v + off, ok);
      }
      copy_bias_tile<kBfPitch, 1>(stage + 2 * sm90::kKvTileBytes, plane, mask_row, nullptr, q0,
                                  k0, L, bias_vec);
    }
    sm90::cp_async_commit();
    ++load_t;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };

  // the two-pass variants' first pass copies no V
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next(kPostnorm);

  uint32_t qa[4][4];  // this warp's rows as the A fragments of the k-steps over d
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1];
      const int col = 16 * kk + 2 * tig + 8 * (i >> 1);
      qa[kk][i] = row < L ? *reinterpret_cast<const uint32_t*>(q + base + (long long)row * kD + col)
                          : 0u;
    }

  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t pa[4][4];  // the probabilities as the A fragments of p . v

  auto issue_qk = [&](int stage) {
    const uint64_t desc = sm90::swizzled_desc(ring + stage * kBfStageBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n64k16<0>(s, qa[kk], desc + (32 >> 4) * kk, kk > 0);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    const uint64_t desc = sm90::swizzled_desc(ring + stage * kBfStageBytes + sm90::kKvTileBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_m64n64k16<1>(o, pa[kk], desc + (2048 >> 4) * kk, 1);
    sm90::wgmma_commit();
  };

  // Per row: the running max (A, B: times log2 e; C, D: a bf16 value) and
  // this lane's share of the sum, which the quad adds up.
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};
  float inv[2];      // A: 1 / r
  __nv_bfloat162 inv2[2];  // C: bf16(1 / r)
  __nv_bfloat162 g2[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) g2[a] = __float2bfloat162_rn(g[a]);

  // f32 chain: the logits of tile t in s, -inf past L
  auto logits_f32 = [&](int t, int stage) {
    const int k0 = t * kTileK;
    const float* bias_tile =
        reinterpret_cast<const float*>(ring_ptr + stage * kBfStageBytes + 2 * sm90::kKvTileBytes);
    const float* tile = bias_tile + r_lo * kBfPitch + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 key = *reinterpret_cast<const float2*>(bias_tile + nt * kBfPitch + kTileK + 2 * tig);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float2 bias = *reinterpret_cast<const float2*>(tile + 8 * a * kBfPitch + 8 * nt);
        s[4 * nt + 2 * a] = (s[4 * nt + 2 * a] + g[a] * bias.x) + key.x;
        s[4 * nt + 2 * a + 1] = (s[4 * nt + 2 * a + 1] + g[a] * bias.y) + key.y;
      }
    }
    if (k0 + kTileK > L) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (k0 + 8 * (e >> 2) + 2 * tig + (e & 1) >= L) s[e] = -CUDART_INF_F;
    }
  };

  // bf16 chain: the logits of tile t as pairs, p2[nt][a] = keys 8 nt + 2 tig,
  // + 1 of row a: bf16(bf16(bf16(s) + bf16(bf16(g) * bf16(bias))) + bf16(mask))
  __nv_bfloat162 p2[8][2];
  auto logits_bf16 = [&](int t, int stage) {
    const int k0 = t * kTileK;
    const float* bias_tile =
        reinterpret_cast<const float*>(ring_ptr + stage * kBfStageBytes + 2 * sm90::kKvTileBytes);
    const float* tile = bias_tile + r_lo * kBfPitch + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 key = *reinterpret_cast<const float2*>(bias_tile + nt * kBfPitch + kTileK + 2 * tig);
      const __nv_bfloat162 key2 = __floats2bfloat162_rn(key.x, key.y);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float2 bias = *reinterpret_cast<const float2*>(tile + 8 * a * kBfPitch + 8 * nt);
        const __nv_bfloat162 gb = __hmul2_rn(g2[a], __floats2bfloat162_rn(bias.x, bias.y));
        const __nv_bfloat162 s2 = __floats2bfloat162_rn(s[4 * nt + 2 * a], s[4 * nt + 2 * a + 1]);
        p2[nt][a] = __hadd2_rn(__hadd2_rn(s2, gb), key2);
      }
    }
    if (k0 + kTileK > L) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kj = k0 + 8 * nt + 2 * tig;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float2 f = __bfloat1622float2(p2[nt][a]);
          p2[nt][a] = __floats2bfloat162_rn(kj < L ? f.x : -CUDART_INF_F,
                                            kj + 1 < L ? f.y : -CUDART_INF_F);
        }
      }
    }
  };

  // The softmax of tile t against the row max (updated first when
  // `online`), summing e into row_sum (rescaled as the max moves when
  // `online`); `emit`: the probabilities into pa (normalised unless
  // kPostnorm). Returns the factors the output accumulator takes.
  auto softmax_tile = [&](int t, int stage, bool online, bool emit, float (&rescale)[2]) {
    if constexpr (!kBf16Chain) {
      logits_f32(t, stage);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        rescale[a] = 1.f;
        if (online) {
          float m = -CUDART_INF_F;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) m = fmaxf(m, fmaxf(s[4 * nt + 2 * a], s[4 * nt + 2 * a + 1]));
          const float max2 = fmaxf(row_max[a], quad_max(m) * sm90::kLog2e);
          rescale[a] = sm90::ex2(row_max[a] - max2);
          row_max[a] = max2;
        }
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[4 * nt + 2 * a + j];
            const float e = sm90::ex2(fmaf(x, sm90::kLog2e, -row_max[a]));
            if (online) part += e;
            if (emit) x = kPostnorm ? e : e * inv[a];
          }
        if (online) row_sum[a] = row_sum[a] * rescale[a] + part;
      }
      if (emit) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[kk][i] = sm90::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    } else {
      logits_bf16(t, stage);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        rescale[a] = 1.f;
        if (online) {
          __nv_bfloat162 m2 = p2[0][a];
#pragma unroll
          for (int nt = 1; nt < 8; ++nt) m2 = __hmax2(m2, p2[nt][a]);
          const float new_max =
              fmaxf(row_max[a], quad_max(fmaxf(__low2float(m2), __high2float(m2))));
          rescale[a] = sm90::ex2((row_max[a] - new_max) * sm90::kLog2e);
          row_max[a] = new_max;
        }
        const __nv_bfloat162 max2 = __float2bfloat162_rn(row_max[a]);  // exact: a bf16 value
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 x = __bfloat1622float2(__hsub2_rn(p2[nt][a], max2));
          const __nv_bfloat162 e2 = __floats2bfloat162_rn(sm90::ex2(x.x * sm90::kLog2e),
                                                          sm90::ex2(x.y * sm90::kLog2e));
          if (online) part += __low2float(e2) + __high2float(e2);
          if (emit) p2[nt][a] = kPostnorm ? e2 : __hmul2_rn(e2, inv2[a]);
        }
        if (online) row_sum[a] = row_sum[a] * rescale[a] + part;
      }
      if (emit) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[kk][i] = bits(p2[2 * kk + (i >> 1)][i & 1]);
      }
    }
  };

  float rescale[2];
  if constexpr (!kPostnorm) {  // pass 1: each row's max and sum
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      sm90::cp_async_wait<kStages - 2>();
      sm90::fence_proxy_async();
      __syncthreads();
      load_next(false);
      sm90::wgmma_fence();
      issue_qk(stage);
      sm90::wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(t, stage, true, false, rescale);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float r = quad_sum(row_sum[a]);
      inv[a] = 1.f / r;
      inv2[a] = __float2bfloat162_rn(1.f / r);
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // every thread is past pass 1's last tile
    load_t = 0;
    load_stage = 0;
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) load_next(true);
  }

  // the online pass (B, D) or the second pass (A, C)
  sm90::cp_async_wait<kStages - 2>();
  sm90::fence_proxy_async();
  __syncthreads();
  sm90::wgmma_fence();
  issue_qk(0);
  sm90::wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(0, 0, kPostnorm, true, rescale);  // o is zero: the factors are not needed
  int stage = 0;
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int next_stage = stage + 1 == kStages ? 0 : stage + 1;
    sm90::cp_async_wait<kStages - 3>();
    sm90::fence_proxy_async();
    __syncthreads();
    load_next(true);
    fence_regs(s);
    fence_regs(o);
    sm90::wgmma_fence();
    issue_qk(next_stage);
    issue_pv(stage);
    sm90::wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    softmax_tile(j + 1, next_stage, kPostnorm, true, rescale);
    if constexpr (kPostnorm) {
      if (__any_sync(0xffffffffu, rescale[0] != 1.f || rescale[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] *= rescale[(e >> 1) & 1];
      }
    }
    stage = next_stage;
  }
  fence_regs(o);
  sm90::wgmma_fence();
  issue_pv(stage);
  sm90::wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float r = kPostnorm ? quad_sum(row_sum[a]) : 1.f;
    const int qi = rows[a];
    if (qi >= L) continue;
    __nv_bfloat16* dst = out + base + (long long)qi * kD + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float x0 = o[4 * nt + 2 * a], x1 = o[4 * nt + 2 * a + 1];
      if constexpr (kPostnorm) {
        x0 = x0 / r;
        x1 = x1 / r;
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

// 16 when the bias plane's, the mask's (and sk's) rows may be copied as
// 16-byte vectors, else 4.
int bias_vec_for(int L, const void* bias, const void* mask, const void* sk) {
  const bool aligned = reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sk) % 16 == 0;
  return L % 4 == 0 && aligned ? 16 : 4;
}

template <bool kPostnorm, bool kBf16Chain>
int launch_variant(unsigned blocks, cudaStream_t stream, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v, const ProbeParams& params,
                   __nv_bfloat16* out, int B, int H, int L, int n_q_tiles, int bias_vec) {
  auto kernel = softmax_variant_kernel<kPostnorm, kBf16Chain>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBfSmem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<blocks, kThreads, kBfSmem, stream>>>(q, k, v, params, out, B, H, L, n_q_tiles,
                                                 bias_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// k, v: contiguous [B, H, L, 64] bf16 (BH = B * H). Writes kq [BH, L, 64]
// int8, sk [BH, L] f32, vqt [BH, 64, Lp] int8 (Lp a multiple of 64 >= L,
// zeros past L) and sv [BH, 64] f32. Returns cudaGetLastError().
extern "C" int attn_int8_quantize_kv(const void* k, const void* v, void* kq, void* sk,
                                     void* vqt, void* sv, int BH, int L, int Lp,
                                     void* stream) {
  if (BH <= 0 || L <= 0 || Lp < L || Lp % kTileK) return (int)cudaErrorInvalidValue;
  quantize_kv_kernel<<<BH, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<int8_t*>(kq), static_cast<float*>(sk), static_cast<int8_t*>(vqt),
      static_cast<float*>(sv), L, Lp);
  return (int)cudaGetLastError();
}

// q: contiguous [B, H, L, 64] bf16; kq, sk, vqt, sv as attn_int8_quantize_kv
// writes them (Lp a multiple of 64); bias [H, L, L], gate [B, H, L], mask
// [B, L] contiguous f32; out: contiguous [B, H, L, 64] bf16. Returns
// cudaGetLastError().
extern "C" int attn_int8(const void* q, const void* kq, const void* sk, const void* vqt,
                         const void* sv, const void* bias, const void* gate, const void* mask,
                         void* out, int B, int H, int L, int Lp, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || Lp < L || Lp % kTileK) return (int)cudaErrorInvalidValue;
  const long long n_q_tiles = (L + 63) / 64, blocks = n_q_tiles * B * H;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ProbeParams params{static_cast<const float*>(bias), static_cast<const float*>(gate),
                           static_cast<const float*>(mask)};
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kS8Smem);
  if (attr != cudaSuccess) return (int)attr;
  attn_int8_kernel<<<(unsigned)blocks, kThreads, kS8Smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(sk), static_cast<const int8_t*>(vqt),
      static_cast<const float*>(sv), params, static_cast<__nv_bfloat16*>(out), B, H, L, Lp,
      (int)n_q_tiles, bias_vec_for(L, bias, mask, sk));
  return (int)cudaGetLastError();
}

// q, k, v, out: contiguous [B, H, L, 64] bf16; bias, gate, mask as attn_int8
// takes them; postnorm and bf16chain select the variant (0 or 1 each).
// Returns cudaGetLastError().
extern "C" int attn_softmax_variant(const void* q, const void* k, const void* v,
                                    const void* bias, const void* gate, const void* mask,
                                    void* out, int B, int H, int L, int postnorm,
                                    int bf16chain, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long n_q_tiles = (L + 63) / 64, blocks = n_q_tiles * B * H;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ProbeParams params{static_cast<const float*>(bias), static_cast<const float*>(gate),
                           static_cast<const float*>(mask)};
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = bias_vec_for(L, bias, mask, bias);
  const unsigned n = (unsigned)blocks;
  const int nq = (int)n_q_tiles;
  if (postnorm && bf16chain) return launch_variant<true, true>(n, s, qb, kb, vb, params, ob, B, H, L, nq, vec);
  if (postnorm) return launch_variant<true, false>(n, s, qb, kb, vb, params, ob, B, H, L, nq, vec);
  if (bf16chain) return launch_variant<false, true>(n, s, qb, kb, vb, params, ob, B, H, L, nq, vec);
  return launch_variant<false, false>(n, s, qb, kb, vb, params, ob, B, H, L, nq, vec);
}
