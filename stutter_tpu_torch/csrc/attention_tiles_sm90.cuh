// bf16 flash-attention forward tiles designed for Hopper (sm_90a): 64-row
// wgmma tiles fed by an asynchronous shared-memory ring. Every bf16 attention
// forward of the port runs on them: flash_mha.cu's flash_mha and
// flash_mha_bias (policies KeyPadding and FullBias; they replace
// stutter_tpu/models/attention.py:flash_mha and :flash_mha_bias) and
// wavlm_attention.cu's gated relative-position-bias attention (policy
// GatedBiasRing; it replaces stutter_tpu/ops/wavlm_attention_pallas.py's two
// forward kernels). wavlm_attention_bwd.cu builds the bf16 backward of the
// gated attention from its primitives (copies, descriptors, wgmma, the ring's
// discipline), and so does attn_probes.cu the two A/B probes (its own
// kernels for the int8 probe and the softmax variants: two passes, int8
// wgmma, a packed bf16 chain). The f32 paths keep the tiles of
// attention_tiles.cuh. For one (clip b, head h, query row i), with q
// pre-scaled and head_dim 64:
//
//     p[j]   = score(i, j, q[i] . k[j])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// `score` is a compile-time policy (see "Policies" below), so that a kernel
// whose logits carry more than q . k instantiates the same tiles.
//
// What bounds the work on this card, and what the design does about it:
//
// - Without a bias (Whisper's encoder, 16 x 20 x 1500 x 64) the work is
//   4 L^2 d operations on 4 L d elements per (clip, head): far above the
//   ~295 operations a byte at which the tensor cores are the limit. Only
//   wgmma reaches their rate, so both products are wgmma.mma_async
//   m64n64k16: one warpgroup (4 warps) owns 64 query rows. q stays in
//   registers as the A operand of q . k^T for the whole kernel, so that a
//   product reads only its B operand from shared memory (with both operands
//   there, an m64n64k16 every 32 cycles would ask 128 bytes a cycle of it,
//   all it has). The probabilities, rounded to bf16 as the Pallas kernels
//   round them to v's dtype, are the A operand of p . v straight from the
//   score accumulators: the two register layouts agree, so nothing is
//   staged. K is the K-major B operand and V the MN-major one ([key][d] as
//   it lies in memory, transposed by the descriptor), both in the 128-byte
//   swizzle, which a 64 x bf16 row fills exactly. Beside the tensor cores
//   the softmax needs one ex2 an element, and an SM has 16 special-function
//   lanes: at head_dim 64 the exponentials take as long as the products
//   (~256 cycles per 64 x 64 tile each), which is why the kernel ends up
//   bound by the softmax's instruction issue and not by the tensor cores.
//   (The probes of attn_probes.cu, on these tiles, later measured the time
//   moving by only ~0.022 ms per instruction a score at 25 x 16 x 1504: the
//   issue is ~20 % of it, and most of the rest latency; PERF.md.)
// - K and V tiles of 64 keys (and a policy's bias tile) go through a ring of
//   kStages stages in dynamic shared memory, filled with 16-byte cp.async
//   (zero-filled past L) kStages - 2 tiles ahead of the products, one commit
//   group a tile, by all threads: 4 copies a thread and tile for K and V
//   from pointers that advance by a tile, so a producer warp would save
//   nothing; the swizzle is applied to the destination address. TMA was not
//   taken: the tensor maps would have to be rebuilt on the host for every
//   call from the views' strides, and the per-row bias copies (row pitch
//   L x 4 bytes, 16-byte aligned only when L % 4 == 0) would still need
//   cp.async. One __syncthreads() a tile orders the ring: it publishes the
//   tile that landed (after a proxy fence: wgmma reads shared memory through
//   the async proxy) and retires the tile whose products were waited for.
//   A ring ordered by mbarriers instead, which lets the two warpgroups drift
//   a tile apart, measured no faster and was not kept.
// - The softmax is off the tensor cores' critical path across warpgroups,
//   not inside one: in iteration j a warpgroup issues q . k_{j+1}^T and
//   p_j . v_j together (8 wgmma, one wait), then turns the scores into
//   p_{j+1}; meanwhile the SM's other warpgroups (two a block, two blocks an
//   SM where the ring is small enough) have their products in the tensor
//   cores. Waiting for the scores only and leaving p_j . v_j in flight under
//   the same warpgroup's softmax measured no faster (the compiler also
//   hoists such a wait above the softmax unless it is pinned), so the loop
//   keeps the single wait. What the softmax costs is instructions, so they
//   are few: probabilities are ex2(s * log2 e - max * log2 e), one FFMA and
//   one MUFU an element, against a scaled max that the rescaling uses too, so
//   that the two stay consistent whatever the product rounds to (equal
//   scores get equal probabilities even at -1e9, which a fully padded row
//   needs); the output accumulator is rescaled only when a row's max moved
//   in the warp, which after the first tiles is rare; keys are masked only
//   in the tiles that reach a policy's edge or L.
// - With a streamed bias the policy's [L, L] f32 plane rides the same ring:
//   a 64 x 64 tile per warpgroup, added to the scores from shared memory
//   (rows padded to 72 floats: the 8-byte reads of a quarter-warp then fall
//   in distinct banks). Its copies take the policy's L2 hint: evict-first
//   for flash_mha_bias's ab ([B, H, L, L], 1.74 GB at 12 x 16 x 1504 x 64,
//   each element read once, so it should not push K and V out), which then
//   runs at the rate of its ab copies alone; the gated kernel's plane is per
//   head and read by every clip, so it keeps the normal policy (evict-last
//   measured within 1 % of it) and the grid order (below) makes the clips'
//   reads of a slab meet in L2. A policy may
//   also stream a [L] row per clip (the gated kernel's key mask): its 64
//   floats a stage lie in the padding columns of the bias tile's first 8
//   rows, so they cost no shared memory and are read as broadcasts.
// - The grid is one-dimensional, so no dimension is limited to 65,535, in
//   one of two orders (the launcher's kOrder): the query tile fastest, so that
//   the blocks of one (clip, head) run together and share K and V in L2
//   (flash_mha, flash_mha_bias, and the gated kernel while its bias plane
//   fits in L2), or the clip fastest under (head, query tile), so that the
//   B blocks that read one slab of a larger shared bias plane run together
//   (the gated kernel's long buckets; PERF.md has both orders' times).
//
// Statistics (running max and sum per row) and both accumulators are f32;
// keys past L score -inf, a policy's padded keys -1e9 (the head of
// attention_tiles.cuh states the rules; these tiles keep them). Given a
// [2, B, H, L] f32 buffer, the epilogue of a policy with kRowStats also
// writes each query row's score max and the log of its sum of
// exp(score - max), as attention_tiles.cuh states them, for the WavLM
// backward. The ragged edge is masked here: nothing is padded by the caller.
// q, k, v and out may be any [B, H, L, 64] view with a contiguous head
// dimension and 16-byte aligned rows.
//
// Policies. A policy is a struct with
//   struct Params                      passed by value to the kernel;
//   static constexpr bool kStreamsBias whether a [L, L] f32 plane per
//                                      (b, h) rides the ring;
//   static constexpr bool kRowStats    whether the kernel writes the row
//                                      statistics when given a buffer;
//   Policy(params, b, h, rows, H, L)   for the two query rows a thread owns
//                                      (rows[1] = rows[0] + 8);
//   int edge_from() const              keys below it (and below L) need no
//                                      call of edge();
//   float edge(a, kj, s) const         the score of row a and key kj < L in
//                                      a tile that reaches edge_from();
// and, if kStreamsBias,
//   static constexpr L2Hint kBiasL2    the L2 policy of the plane's copies;
//   static constexpr bool kStreamsKeyRow
//                                      whether a [L] f32 row per b rides too;
//   const float* bias_plane() const    row i of the plane at + i * L;
//   const float* key_row() const       (if kStreamsKeyRow) that row;
//   float biased(a, kj, s, bias, key) const
//                                      applied to every score; key is the
//                                      key row at kj, or 0 without one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace sm90 {

constexpr int kD = 64;                          // head_dim: one 128-byte swizzled row
constexpr int kTileK = 64;                      // keys a ring stage (wgmma N of q . k^T)
constexpr int kKvTileBytes = kTileK * kD * 2;   // one K or V tile
constexpr int kBiasPitch = kTileK + 8;          // floats per staged bias row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// L2 policy of a streamed bias's copies
enum class L2Hint { kEvictFirst, kEvictNormal };

// Grid orders, a template parameter of the kernel (a run-time one cost
// flash_mha 1-2 %): blockIdx.x = (b * H + h) * n_q_tiles + tile, or
// (h * n_q_tiles + tile) * B + b.
enum GridOrder : int { kQueryTileFastest = 0, kClipFastest = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; `ok` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// The same with an L2 cache policy.
__device__ __forceinline__ void cp_async_16_hint(uint32_t dst, const void* src, bool ok,
                                                 uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_4_hint(uint32_t dst, const void* src, bool ok,
                                                uint64_t policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

template <L2Hint kHint>
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t policy;
  if constexpr (kHint == L2Hint::kEvictFirst)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Publishes this thread's landed cp.async writes to the async proxy, through
// which wgmma reads shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the point where an asynchronous product is issued or waited for.
__device__ __forceinline__ void fence_regs(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile of 128-byte
// rows whose first row starts at `addr` (the tile base is 1024-byte
// aligned; addr may be advanced inside it): groups of 8 rows lie 1024 bytes
// apart (the stride offset); the leading offset is unused at these extents.
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (+)= a . b for a 64 x 16 bf16 A in registers (the mma.sync m16n8k16 A
// layout per warp) and a 16 x 64 B in shared memory: K-major ([n][k] rows,
// kTransB 0) or MN-major ([k][n] rows, kTransB 1). accumulate 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate),
        "n"(kTransB)
      : "memory");
}

// d (+)= a . b with both operands in shared memory: a 64 x 16 K-major A
// ([m][k] rows) and a B as above.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate), "n"(kTransB)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <class Score, int kWgs>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kKvTileBytes + (Score::kStreamsBias ? 64 * kWgs * kBiasPitch * 4 : 0);
}

// Dynamic shared memory of a block: the ring plus the slack to align it.
template <class Score, int kWgs, int kStages>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<Score, kWgs>() + 1024;
}

// One block per (clip, head, tile of 64 * kWgs query rows), in kOrder
// (GridOrder above). In a warpgroup, warp w owns rows
// 16 w .. 16 w + 15 of its 64; lane 4 * grp + tig holds rows grp and grp + 8
// of them at columns 2 * tig, 2 * tig + 1 of each 8-wide n-tile (element
// 4 * nt + 2 * a + j of an accumulator is row grp + 8 a, column
// 8 nt + 2 tig + j), so a row's four lanes reduce with xor 1, 2.
// bias_vec: 16 when the policy's bias rows (and key row) can be copied as
// 16-byte vectors (L % 4 == 0 and 16-byte aligned bases), else 4.
// row_stats: [2, B, H, L] f32 to fill, or null.
template <class Score, int kWgs, int kStages, int kMinBlocks, int kOrder>
__global__ void __launch_bounds__(128 * kWgs, kMinBlocks) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const typename Score::Params params,
    __nv_bfloat16* __restrict__ out, float* __restrict__ row_stats, int B, int H, int L,
    int n_q_tiles, int bias_vec, long long stride_b, long long stride_h, long long stride_l) {
  static_assert(kStages >= 3, "a tile must be in flight while two are in use");
  constexpr int kThreads = 128 * kWgs;
  constexpr int kRows = 64 * kWgs;
  constexpr int kStageBytes = stage_bytes<Score, kWgs>();
  static_assert(kStageBytes % 1024 == 0, "every K and V tile starts a swizzle period");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int grp = (tid & 31) >> 2;
  const int tig = tid & 3;
  int b, h, q_tile;
  if constexpr (kOrder == kClipFastest) {
    const int ht = blockIdx.x / B;
    b = blockIdx.x - ht * B;
    h = ht / n_q_tiles;
    q_tile = ht - h * n_q_tiles;
  } else {
    const int bh = blockIdx.x / n_q_tiles;
    q_tile = blockIdx.x - bh * n_q_tiles;
    b = bh / H;
    h = bh - b * H;
  }
  const int q0 = q_tile * kRows;
  const long long base = b * stride_b + h * stride_h;
  const int n_tiles = (L + kTileK - 1) / kTileK;

  const int r_lo = 64 * wg + 16 * warp + grp;  // this lane's rows of the block: r_lo, r_lo + 8
  const int rows[2] = {q0 + r_lo, q0 + r_lo + 8};
  const Score score(params, b, h, rows, H, L);
  const int edge_from = min(L, score.edge_from());

  // Each thread's share of a tile's copies stays the same from tile to tile:
  // 16-byte chunk kv_c of K and V rows kv_r + kKvRowStep * i, to the swizzled
  // offset kv_dst (+ 128 * kKvRowStep * i: the step keeps the row's phase).
  constexpr int kKvRowStep = kThreads / 8;
  constexpr int kKvCopies = kTileK / kKvRowStep;
  const int kv_r = tid >> 3, kv_c = tid & 7;
  const uint32_t kv_dst = kv_r * 128 + ((kv_c ^ (kv_r & 7)) << 4);
  const __nv_bfloat16* k_next = k + base + kv_r * stride_l + kv_c * 8;
  const __nv_bfloat16* v_next = v + base + kv_r * stride_l + kv_c * 8;
  const long long kv_row_step = kKvRowStep * stride_l;
  // and, of a streamed bias, chunk bias_c (4 floats) of rows bias_r + kBiasRowStep * i
  constexpr int kBiasRowStep = kThreads / 16;
  constexpr int kBiasCopies = kRows / kBiasRowStep;
  const int bias_r = tid >> 4, bias_c = tid & 15;
  // and, of a policy's key row, chunk tid (tid < 16) into the padding
  // columns of bias row tid / 2: key c of a tile lies at row c / 8, column
  // kTileK + c % 8
  uint64_t policy = 0;
  const float* plane = nullptr;
  const float* bias_next = nullptr;
  const float* key_row = nullptr;
  const float* key_next = nullptr;
  if constexpr (Score::kStreamsBias) {
    policy = l2_policy<Score::kBiasL2>();
    plane = score.bias_plane();
    bias_next = plane + (long long)(q0 + bias_r) * L + 4 * bias_c;
    if constexpr (Score::kStreamsKeyRow) {
      key_row = score.key_row();
      key_next = key_row + 4 * tid;
    }
  }
  int load_t = 0, load_stage = 0;  // the next tile to copy, and its stage

  // Starts the copies of the next key tile into its stage (none past the
  // last tile) and commits them as one group, so that groups count tiles.
  auto load_next = [&]() {
    if (load_t < n_tiles) {
      const uint32_t stage = ring + load_stage * kStageBytes;
      const int k0 = load_t * kTileK;
#pragma unroll
      for (int i = 0; i < kKvCopies; ++i) {
        const bool ok = k0 + kv_r + kKvRowStep * i < L;
        const uint32_t dst = stage + kv_dst + 128 * kKvRowStep * i;
        cp_async_16(dst, ok ? k_next + i * kv_row_step : k, ok);
        cp_async_16(dst + kKvTileBytes, ok ? v_next + i * kv_row_step : v, ok);
      }
      k_next += kTileK * stride_l;
      v_next += kTileK * stride_l;
      if constexpr (Score::kStreamsBias) {
        const uint32_t bias_stage = stage + 2 * kKvTileBytes;
        if (bias_vec == 16) {
          const bool col_ok = k0 + 4 * bias_c < L;  // L % 4 == 0: a chunk is whole or nothing
#pragma unroll
          for (int i = 0; i < kBiasCopies; ++i) {
            const int r = bias_r + kBiasRowStep * i;
            const bool ok = col_ok && q0 + r < L;
            cp_async_16_hint(bias_stage + (r * kBiasPitch + 4 * bias_c) * 4,
                             ok ? bias_next + (long long)(kBiasRowStep * i) * L : plane, ok,
                             policy);
          }
          bias_next += kTileK;
          if constexpr (Score::kStreamsKeyRow) {
            if (tid < kTileK / 4) {
              const bool ok = k0 + 4 * tid < L;
              cp_async_16(bias_stage + ((tid >> 1) * kBiasPitch + kTileK + 4 * (tid & 1)) * 4,
                          ok ? key_next : key_row, ok);
            }
            key_next += kTileK;
          }
        } else {
          for (int e = tid; e < kRows * kTileK; e += kThreads) {
            const int r = e / kTileK, c = e % kTileK;
            const bool ok = q0 + r < L && k0 + c < L;
            const float* src = plane + (ok ? (long long)(q0 + r) * L + k0 + c : 0);
            cp_async_4_hint(bias_stage + (r * kBiasPitch + c) * 4, src, ok, policy);
          }
          if constexpr (Score::kStreamsKeyRow) {
            if (tid < kTileK) {
              const bool ok = k0 + tid < L;
              cp_async_4(bias_stage + ((tid >> 3) * kBiasPitch + kTileK + (tid & 7)) * 4,
                         key_row + (ok ? k0 + tid : 0), ok);
            }
          }
        }
      }
    }
    cp_async_commit();
    ++load_t;
    load_stage = load_stage + 1 == kStages ? 0 : load_stage + 1;
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_next();

  // This warp's 16 query rows as the A fragments of the four 16-wide k-steps
  // over d; rows past L are zeros.
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1];
      const int col = 16 * kk + 2 * tig + 8 * (i >> 1);
      qa[kk][i] = row < L ? *reinterpret_cast<const uint32_t*>(q + base + row * stride_l + col)
                          : 0u;
    }

  // Per row: the running max of the scores, that max times log2 e (what the
  // probabilities and the rescaling are taken against, so that the two stay
  // consistent whatever the product rounds to) and this lane's share of the
  // sum; the quad sums at the end.
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_max2[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};
  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t p[4][4];

  // s = q . k^T for the K tile of `stage`, issued and committed as one group.
  auto issue_qk = [&](int stage) {
    const uint64_t desc = swizzled_desc(ring + stage * kStageBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 of d: 32 bytes along the rows
      wgmma_m64n64k16<0>(s, qa[kk], desc + (32 >> 4) * kk, kk > 0);
    wgmma_commit();
  };

  // o += p . v for the V tile of `stage`, issued and committed as one group.
  auto issue_pv = [&](int stage) {
    const uint64_t desc = swizzled_desc(ring + stage * kStageBytes + kKvTileBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // a k-step is 16 keys: 16 rows of 128 bytes
      wgmma_m64n64k16<1>(o, p[kk], desc + (2048 >> 4) * kk, 1);
    wgmma_commit();
  };

  // Scores of key tile t (in `stage`) -> unnormalised probabilities in s;
  // updates the rows' statistics and gives the factors the output
  // accumulator takes.
  auto softmax_tile = [&](int t, int stage, float (&rescale)[2]) {
    const int k0 = t * kTileK;
    if constexpr (Score::kStreamsBias) {
      const float* bias_tile =
          reinterpret_cast<const float*>(ring_ptr + stage * kStageBytes + 2 * kKvTileBytes);
      const float* tile = bias_tile + r_lo * kBiasPitch + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float2 key = make_float2(0.f, 0.f);
        if constexpr (Score::kStreamsKeyRow)
          key = *reinterpret_cast<const float2*>(bias_tile + nt * kBiasPitch + kTileK + 2 * tig);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float2 bias =
              *reinterpret_cast<const float2*>(tile + 8 * a * kBiasPitch + 8 * nt);
          const int kj = k0 + 8 * nt + 2 * tig;
          s[4 * nt + 2 * a] = score.biased(a, kj, s[4 * nt + 2 * a], bias.x, key.x);
          s[4 * nt + 2 * a + 1] =
              score.biased(a, kj + 1, s[4 * nt + 2 * a + 1], bias.y, key.y);
        }
      }
    }
    if (k0 + kTileK > edge_from) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * nt + 2 * tig + (e & 1);
          s[4 * nt + e] = kj < L ? score.edge(e >> 1, kj, s[4 * nt + e]) : -CUDART_INF_F;
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        tile_max = fmaxf(tile_max, fmaxf(s[4 * nt + 2 * a], s[4 * nt + 2 * a + 1]));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      // Key 0 lies in the first tile and every policy keeps a key < L
      // finite, so the running max is finite from then on.
      row_max[a] = fmaxf(row_max[a], tile_max);
      const float max2 = row_max[a] * kLog2e;
      rescale[a] = ex2(row_max2[a] - max2);
      row_max2[a] = max2;
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * nt + 2 * a + j];
          // one rounding, exact where x is the max even at -1e9: equal
          // scores get equal probabilities, which is what a padded row needs
          x = ex2(fmaf(x, kLog2e, -max2));
          part += x;
        }
      row_sum[a] = row_sum[a] * rescale[a] + part;
    }
  };

  // The probabilities of s as the A fragments of p . v: the accumulators of
  // n-tiles 2 kk, 2 kk + 1 are k-step kk (16 keys).
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  float rescale[2];

  // Tile 0's scores, alone: nothing to overlap them with yet.
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
  wgmma_fence();
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(0, 0, rescale);  // o is zero: the factors are not needed
  pack_p();

  int stage = 0;  // of tile j
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int next_stage = stage + 1 == kStages ? 0 : stage + 1;
    // Tile j + 1 has landed (groups are committed up to tile j + kStages - 2),
    // and every thread is past the products that read tile j - 1.
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    __syncthreads();
    load_next();  // tile j + kStages - 1, into the stage tile j - 1 leaves
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    issue_qk(next_stage);
    issue_pv(stage);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    softmax_tile(j + 1, next_stage, rescale);
    // most tiles leave every row's max where it was
    if (__any_sync(0xffffffffu, rescale[0] != 1.f || rescale[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * nt + e] *= rescale[e >> 1];
    }
    pack_p();
    stage = next_stage;
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv(stage);  // the last tile's V landed with its K
  wgmma_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 1);
    row_sum[a] += __shfl_xor_sync(0xffffffffu, row_sum[a], 2);
    const int qi = rows[a];
    if (qi >= L) continue;  // padded query rows were computed on zeros
    const float inv = 1.f / row_sum[a];
    __nv_bfloat16* dst = out + base + qi * stride_l + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
          __floats2bfloat162_rn(o[4 * nt + 2 * a] * inv, o[4 * nt + 2 * a + 1] * inv);
    if constexpr (Score::kRowStats) {
      if (row_stats != nullptr && tig == 0) {
        const long long r = ((long long)b * H + h) * L + qi;
        row_stats[r] = row_max[a];
        // The probabilities were taken against row_max2, row_max * log2 e
        // rounded, so the sum carries a factor 2^(row_max * log2 e -
        // row_max2), whose exponent fmaf gives exactly (up to 64 in a -1e9
        // row); it is taken out of the log here.
        row_stats[(long long)B * H * L + r] =
            (log2f(row_sum[a]) - fmaf(row_max[a], kLog2e, -row_max2[a])) * kLn2;
      }
    }
  }
}

// Launches the bf16 tiles on `stream`: q, k, v and out share the strides
// (in elements; unit head-dim stride, 16-byte aligned rows); row_stats is a
// [2, B, H, L] f32 buffer or null. Returns the first CUDA error (0 on
// success): a refused attribute or launch is reported, never worked around.
template <class Score, int kWgs, int kStages, int kMinBlocks, int kOrder>
int launch_attention_bf16(const void* q, const void* k, const void* v,
                          const typename Score::Params& params, void* out, float* row_stats,
                          int B, int H, int L, int bias_vec, long long stride_b,
                          long long stride_h, long long stride_l, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long n_q_tiles = (L + 64 * kWgs - 1) / (64 * kWgs);
  const long long blocks = n_q_tiles * B * H;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto kernel = attention_bf16_kernel<Score, kWgs, kStages, kMinBlocks, kOrder>;
  constexpr int kSmem = smem_bytes<Score, kWgs, kStages>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)blocks, 128 * kWgs, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), params, static_cast<__nv_bfloat16*>(out), row_stats,
      B, H, L, (int)n_q_tiles, bias_vec, stride_b, stride_h, stride_l);
  return (int)cudaGetLastError();
}

}  // namespace sm90
