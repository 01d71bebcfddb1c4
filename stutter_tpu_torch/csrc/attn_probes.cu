// The two A/B probes of WavLM's long attention kernel, for Hopper (sm_90a).
// Both compute row 2's function (softmax(q . k^T + gate * bias + mask) . v,
// q pre-scaled, head_dim 64, bf16 in and out) with another arithmetic.
//
// 1. int8 operands. Replaces scripts/attn_int8_probe.py:_int8_kernel (its
//    pallas_call at :100). q and k are quantised per row (absmax over d), v
//    per column (absmax over the clip's L keys), to symmetric int8 with scale
//    max(absmax, 1e-8) / 127; s = (qq . kq^T as int32) * sq * sk; the
//    softmax is f32 over the whole row; a = e / r is quantised with the fixed
//    scale 127 (round(a * 127), in [0, 127]); out = (aq . vq as int32) / 127
//    * sv. Quantisation divides with IEEE division and rounds half to even
//    (rintf semantics, __float2int_rn; the build has no fast math), so the
//    int8 operands equal the plain version's bit for bit.
//    - A prologue kernel (quantize_kv_kernel) quantises k per row and v per
//      column once per (clip, head): kq [B, H, L, 64] and sk [B, H, L], and
//      vq transposed, [B, H, 64, Lp] with Lp = L rounded up to 32 and zeros
//      past L, and sv [B, H, 64]. The Pallas kernel redoes this in every
//      query block; here the main kernel reads the int8 operands.
//    - The main kernel (attn_int8_kernel) quantises its query tile itself,
//      with the prologue's device function. Both products run on the tensor
//      cores as mma.sync m16n8k32 s8 . s8 -> s32. The fixed 127 scale needs
//      each row's sum before the second product, so it takes two passes over
//      the keys: the row max and sum (online), then the probabilities and
//      both products.
//    - The score accumulators of the first product are the A fragment of
//      the second only if each lane's four adjacent key columns are four
//      adjacent keys. So n-tile nt of a 32-key tile holds keys
//      16 (nt / 2) + 4 (c / 2) + 2 (nt % 2) + c % 2 in its columns c: then
//      lane tig holds keys 4 tig .. 4 tig + 3 (and 16 more), and v's B
//      fragment is four contiguous bytes of the transposed vq.
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
//    A and C normalise before the second product, so they need each row's
//    sum first: two passes over the keys (the first forms the scores and the
//    online max and sum only). B and D take one online pass, rescaling the
//    accumulators as the running max moves, so their e is rounded relative
//    to the running max rather than the final one. The tiles are those of
//    attention_tiles.cuh (bf16 mma.sync m16n8k16, 32-row query tiles, 32-key
//    tiles through shared memory) with its GatedBias terms.
//
// What bounds them on this card, at the probes' shapes (B = 25, L = 1504 and
// B = 30, L = 1008; H = 16): like row 2, the 4 B H L^2 d products
// (~0.23 ms in bf16 at 1504, half of it at the int8 rate) against
// ~0.23 ms of bytes (q, k, v, out once, the [H, L, L] bias and the gate),
// so neither bounds the work by much; what limits these kernels in practice
// is the per-element softmax and quantisation chain on the CUDA cores,
// which the probes were written to vary. Two-pass variants read the bias
// twice.
//
// Both kernels take contiguous [B, H, L, 64] bf16 q, k, v (the probes' layout)
// and any L: query rows past L are computed on zeros and not stored, keys
// past L score -inf.

#include "attention_tiles.cuh"

namespace {

constexpr int kRow8 = kHeadDim + 16;      // int8 smem row: 80 bytes, 16-byte aligned
constexpr int kVtRow = kBlockK + 16;      // transposed v tile row: 48 bytes
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The max of row a (0: r_lo, 1: r_lo + 8) of one key tile's score fragments,
// over the four lanes of the quad that holds the row.
__device__ __forceinline__ float tile_row_max(const float (&p)[kBlockK / 8][4], int a) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) m = fmaxf(m, fmaxf(p[nt][2 * a], p[nt][2 * a + 1]));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  return fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
}

// Symmetric int8 of one 64-wide bf16 row (16-byte aligned): writes the 64
// values to dst and returns the scale max(absmax, 1e-8) / 127.
__device__ float quantize_row(const __nv_bfloat16* __restrict__ row, int8_t* dst) {
  float x[kHeadDim];
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < kHeadDim; c += 8) {
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
  for (int c = 0; c < kHeadDim; c += 4)
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
  __shared__ float part[kQuantThreads / kHeadDim][kHeadDim];
  __shared__ float scale[kHeadDim];
  const long long bh = blockIdx.x;
  const __nv_bfloat16* kb = k + bh * L * kHeadDim;
  const __nv_bfloat16* vb = v + bh * L * kHeadDim;
  const int t = threadIdx.x, col = t % kHeadDim, grp = t / kHeadDim;
  constexpr int kGroups = kQuantThreads / kHeadDim;

  float m = 0.f;
  for (int l = grp; l < L; l += kGroups)
    m = fmaxf(m, fabsf(__bfloat162float(vb[(long long)l * kHeadDim + col])));
  part[grp][col] = m;
  __syncthreads();
  if (t < kHeadDim) {
    m = part[0][t];
    for (int g = 1; g < kGroups; ++g) m = fmaxf(m, part[g][t]);
    scale[t] = fmaxf(m, 1e-8f) / 127.f;
    sv[bh * kHeadDim + t] = scale[t];
  }
  __syncthreads();

  int8_t* vt = vqt + bh * kHeadDim * Lp;
  for (long long e = t; e < (long long)kHeadDim * Lp; e += kQuantThreads) {
    const int d = (int)(e / Lp), l = (int)(e % Lp);
    vt[e] = l < L ? (int8_t)__float2int_rn(
                        __bfloat162float(vb[(long long)l * kHeadDim + d]) / scale[d])
                  : (int8_t)0;
  }
  for (int l = t; l < L; l += kQuantThreads)
    sk[bh * L + l] = quantize_row(kb + (long long)l * kHeadDim, kq + (bh * L + l) * kHeadDim);
}

__global__ void __launch_bounds__(kBf16Threads) attn_int8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ sk, const int8_t* __restrict__ vqt,
    const float* __restrict__ sv, const GatedBias::Params params,
    __nv_bfloat16* __restrict__ out, int B, int H, int L, int Lp) {
  __shared__ __align__(16) int8_t qs[kBlockQ][kRow8];
  __shared__ __align__(16) int8_t ks[kBlockK][kRow8];
  __shared__ __align__(16) int8_t vts[kHeadDim][kVtRow];
  __shared__ float sq_s[kBlockQ];
  __shared__ float sk_s[kBlockK];
  __shared__ float sv_s[kHeadDim];

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  const long long bh = (long long)b * H + h;

  if (tid < kBlockQ) {  // quantise the query tile, one row a thread
    const int qi = q0 + tid;
    if (qi < L) {
      sq_s[tid] = quantize_row(q + (bh * L + qi) * kHeadDim, &qs[tid][0]);
    } else {
      for (int c = 0; c < kHeadDim; c += 16)
        *reinterpret_cast<uint4*>(&qs[tid][c]) = make_uint4(0u, 0u, 0u, 0u);
      sq_s[tid] = 0.f;
    }
  }
  if (tid < kHeadDim) sv_s[tid] = sv[bh * kHeadDim + tid];
  __syncthreads();

  const int r_lo = 16 * warp + grp;  // this lane's rows: r_lo and r_lo + 8
  uint32_t qa[2][4];                 // A fragments for the two 32-wide k-steps over d
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int c = 32 * kk + 4 * tig;
    qa[kk][0] = ld32(&qs[r_lo][c]);
    qa[kk][1] = ld32(&qs[r_lo + 8][c]);
    qa[kk][2] = ld32(&qs[r_lo][c + 16]);
    qa[kk][3] = ld32(&qs[r_lo + 8][c + 16]);
  }
  const float sq_row[2] = {sq_s[r_lo], sq_s[r_lo + 8]};
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  const GatedBias score(params, b, h, rows, H, L);

  // element i of n-tile nt: row r_lo + 8 (i / 2), local key key_of(nt, i % 2)
  auto key_of = [&](int nt, int j) { return 16 * (nt >> 1) + 4 * tig + 2 * (nt & 1) + j; };

  auto load_k = [&](int k0) {
    for (int e = tid; e < kBlockK * (kHeadDim / 16); e += kBf16Threads) {
      const int r = e / (kHeadDim / 16), c = (e % (kHeadDim / 16)) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < L) val = *reinterpret_cast<const uint4*>(kq + (bh * L + k0 + r) * kHeadDim + c);
      *reinterpret_cast<uint4*>(&ks[r][c]) = val;
    }
    if (tid < kBlockK) sk_s[tid] = k0 + tid < L ? sk[bh * L + k0 + tid] : 0.f;
  };

  // p = (qq . kq^T) * sq * sk + gate * bias + mask for one key tile; -inf past L
  auto scores = [&](int k0, float (&p)[kBlockK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      int acc[4] = {0, 0, 0, 0};
      const int row = 16 * (nt >> 1) + 4 * (grp >> 1) + 2 * (nt & 1) + (grp & 1);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_s8(acc, qa[kk], ld32(&ks[row][32 * kk + 4 * tig]),
               ld32(&ks[row][32 * kk + 16 + 4 * tig]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = i >> 1, local = key_of(nt, i & 1), kj = k0 + local;
        p[nt][i] = kj < L ? score(a, kj, ((float)acc[i] * sq_row[a]) * sk_s[local])
                          : -CUDART_INF_F;
      }
    }
  };

  // pass 1: each row's max and sum of exp(p - max), online
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    float p[kBlockK / 8][4];
    scores(k0, p);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float new_max = fmaxf(row_max[a], tile_row_max(p, a));  // finite: key 0 is in tile 0
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt)
        part += expf(p[nt][2 * a] - new_max) + expf(p[nt][2 * a + 1] - new_max);
      row_sum[a] = row_sum[a] * expf(row_max[a] - new_max) + part;
      row_max[a] = new_max;
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 1);
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 2);
  }

  // pass 2: aq = round(127 e / r), out += aq . vq
  int o[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
    for (int i = 0; i < 4; ++i) o[n][i] = 0;
  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    load_k(k0);
    for (int e = tid; e < kHeadDim * (kBlockK / 16); e += kBf16Threads) {
      const int d = e / (kBlockK / 16), c = (e % (kBlockK / 16)) * 16;
      *reinterpret_cast<uint4*>(&vts[d][c]) =
          *reinterpret_cast<const uint4*>(vqt + (bh * kHeadDim + d) * Lp + k0 + c);
    }
    __syncthreads();
    float p[kBlockK / 8][4];
    scores(k0, p);
    int aq[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = i >> 1;
        aq[nt][i] = __float2int_rn((expf(p[nt][i] - row_max[a]) / row_sum[a]) * 127.f);
      }
    const uint32_t pa[4] = {pack_s8(aq[0][0], aq[0][1], aq[1][0], aq[1][1]),
                            pack_s8(aq[0][2], aq[0][3], aq[1][2], aq[1][3]),
                            pack_s8(aq[2][0], aq[2][1], aq[3][0], aq[3][1]),
                            pack_s8(aq[2][2], aq[2][3], aq[3][2], aq[3][3])};
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      mma_s8(o[n], pa, ld32(&vts[8 * n + grp][4 * tig]), ld32(&vts[8 * n + grp][16 + 4 * tig]));
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qi = rows[a];
    if (qi >= L) continue;
    __nv_bfloat16* dst = out + (bh * L + qi) * kHeadDim + 2 * tig;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int c = 8 * n + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          ((float)o[n][2 * a] * (1.f / 127.f)) * sv_s[c],
          ((float)o[n][2 * a + 1] * (1.f / 127.f)) * sv_s[c + 1]);
    }
  }
}

template <bool kPostnorm, bool kBf16Chain>
__global__ void __launch_bounds__(kBf16Threads) softmax_variant_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const GatedBias::Params params,
    __nv_bfloat16* __restrict__ out, int B, int H, int L) {
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
  const int lane = tid & 31;
  const long long base = ((long long)b * H + h) * L * kHeadDim;

  for (int e = tid; e < kBlockQ * kChunks; e += kBf16Threads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < L) val = *reinterpret_cast<const uint4*>(q + base + (q0 + r) * kHeadDim + c);
    *reinterpret_cast<uint4*>(&qs[r][c]) = val;
  }
  __syncthreads();
  const int r_lo = 16 * warp + grp;
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
  const GatedBias score(params, b, h, rows, H, L);

  auto load_tile = [&](int k0, bool with_v) {
    for (int e = tid; e < kBlockK * kChunks; e += kBf16Threads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < L) {
        const long long off = base + (k0 + r) * kHeadDim + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        if (with_v) vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      if (with_v) *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
  };

  // the logits of one key tile (element i of n-tile nt: row r_lo + 8 (i / 2),
  // key k0 + 8 nt + 2 tig + i % 2), -inf past L
  auto logits = [&](int k0, float (&p)[kBlockK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      for (int i = 0; i < 4; ++i) p[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* krow = &ks[8 * nt + grp][16 * kk + 2 * tig];
        mma_16816(p[nt], qa[kk], ld_pair(krow), ld_pair(krow + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = i >> 1, kj = k0 + 8 * nt + 2 * tig + (i & 1);
        float& x = p[nt][i];
        if (kj >= L) {
          x = -CUDART_INF_F;
        } else if constexpr (kBf16Chain) {
          const float gb = bf16r(bf16r(score.g[a]) * bf16r(score.bias_row[a][kj]));
          x = bf16r(bf16r(bf16r(x) + gb) + bf16r(score.mask_row[kj]));
        } else {
          x = score(a, kj, x);
        }
      }
    }
  };

  auto expo = [](float p, float m) {
    if constexpr (kBf16Chain) return bf16r(expf(bf16r(p - m)));
    else return expf(p - m);
  };

  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};  // this lane's share until the quad sums it
  float o[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  float inv[2] = {0.f, 0.f};
  if constexpr (!kPostnorm) {  // pass 1: each row's max and sum
    for (int k0 = 0; k0 < L; k0 += kBlockK) {
      __syncthreads();
      load_tile(k0, false);
      __syncthreads();
      float p[kBlockK / 8][4];
      logits(k0, p);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float new_max = fmaxf(row_max[a], tile_row_max(p, a));
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt)
          part += expo(p[nt][2 * a], new_max) + expo(p[nt][2 * a + 1], new_max);
        row_sum[a] = row_sum[a] * expf(row_max[a] - new_max) + part;
        row_max[a] = new_max;
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 1);
      row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 2);
      inv[a] = bf16r(1.f / row_sum[a]);  // C's bf16(1 / r)
    }
  }

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    load_tile(k0, true);
    __syncthreads();
    float p[kBlockK / 8][4];
    logits(k0, p);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if constexpr (kPostnorm) {  // online: unnormalised e, rescaled as the max moves
        const float new_max = fmaxf(row_max[a], tile_row_max(p, a));
        const float rescale = expf(row_max[a] - new_max);
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = p[nt][2 * a + j];
            x = expo(x, new_max);
            part += x;
          }
        row_sum[a] = row_sum[a] * rescale + part;
        row_max[a] = new_max;
#pragma unroll
        for (int n = 0; n < kHeadDim / 8; ++n) {
          o[n][2 * a] *= rescale;
          o[n][2 * a + 1] *= rescale;
        }
      } else {  // normalised before the product
#pragma unroll
        for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = p[nt][2 * a + j];
            const float e = expo(x, row_max[a]);
            x = kBf16Chain ? e * inv[a] : e / row_sum[a];
          }
      }
    }
    // out += bf16(p) . v, as the tiles take it
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
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
    if constexpr (kPostnorm) {
      row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 1);
      row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 2);
    }
    const int qi = rows[a];
    if (qi >= L) continue;
    __nv_bfloat16* dst = out + base + qi * kHeadDim + 2 * tig;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      float x0 = o[n][2 * a], x1 = o[n][2 * a + 1];
      if constexpr (kPostnorm) {
        x0 = x0 / row_sum[a];
        x1 = x1 / row_sum[a];
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <bool kPostnorm, bool kBf16Chain>
void launch_variant(dim3 grid, cudaStream_t stream, const __nv_bfloat16* q,
                    const __nv_bfloat16* k, const __nv_bfloat16* v,
                    const GatedBias::Params& params, __nv_bfloat16* out, int B, int H, int L) {
  softmax_variant_kernel<kPostnorm, kBf16Chain>
      <<<grid, kBf16Threads, 0, stream>>>(q, k, v, params, out, B, H, L);
}

}  // namespace

// k, v: contiguous [B, H, L, 64] bf16 (BH = B * H). Writes kq [BH, L, 64]
// int8, sk [BH, L] f32, vqt [BH, 64, Lp] int8 (Lp a multiple of 32 >= L,
// zeros past L) and sv [BH, 64] f32. Returns cudaGetLastError().
extern "C" int attn_int8_quantize_kv(const void* k, const void* v, void* kq, void* sk,
                                     void* vqt, void* sv, int BH, int L, int Lp,
                                     void* stream) {
  if (BH <= 0 || L <= 0 || Lp < L || Lp % kBlockK) return (int)cudaErrorInvalidValue;
  quantize_kv_kernel<<<BH, kQuantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<int8_t*>(kq), static_cast<float*>(sk), static_cast<int8_t*>(vqt),
      static_cast<float*>(sv), L, Lp);
  return (int)cudaGetLastError();
}

// q: contiguous [B, H, L, 64] bf16; kq, sk, vqt, sv as attn_int8_quantize_kv
// writes them; bias [H, L, L], gate [B, H, L], mask [B, L] contiguous f32;
// out: contiguous [B, H, L, 64] bf16. Returns cudaGetLastError().
extern "C" int attn_int8(const void* q, const void* kq, const void* sk, const void* vqt,
                         const void* sv, const void* bias, const void* gate, const void* mask,
                         void* out, int B, int H, int L, int Lp, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535 || Lp < L || Lp % kBlockK)
    return (int)cudaErrorInvalidValue;
  const GatedBias::Params params{static_cast<const float*>(bias),
                                 static_cast<const float*>(gate),
                                 static_cast<const float*>(mask)};
  const dim3 grid(B, (L + kBlockQ - 1) / kBlockQ, H);
  attn_int8_kernel<<<grid, kBf16Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(sk), static_cast<const int8_t*>(vqt),
      static_cast<const float*>(sv), params, static_cast<__nv_bfloat16*>(out), B, H, L, Lp);
  return (int)cudaGetLastError();
}

// q, k, v, out: contiguous [B, H, L, 64] bf16; bias, gate, mask as attn_int8
// takes them; postnorm and bf16chain select the variant (0 or 1 each).
// Returns cudaGetLastError().
extern "C" int attn_softmax_variant(const void* q, const void* k, const void* v,
                                    const void* bias, const void* gate, const void* mask,
                                    void* out, int B, int H, int L, int postnorm,
                                    int bf16chain, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || H > 65535) return (int)cudaErrorInvalidValue;
  const GatedBias::Params params{static_cast<const float*>(bias),
                                 static_cast<const float*>(gate),
                                 static_cast<const float*>(mask)};
  const dim3 grid(B, (L + kBlockQ - 1) / kBlockQ, H);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (postnorm && bf16chain) launch_variant<true, true>(grid, s, qb, kb, vb, params, ob, B, H, L);
  else if (postnorm) launch_variant<true, false>(grid, s, qb, kb, vb, params, ob, B, H, L);
  else if (bf16chain) launch_variant<false, true>(grid, s, qb, kb, vb, params, ob, B, H, L);
  else launch_variant<false, false>(grid, s, qb, kb, vb, params, ob, B, H, L);
  return (int)cudaGetLastError();
}
