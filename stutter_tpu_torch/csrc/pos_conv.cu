// The positional conv of WavLM and wav2vec2 XLS-R for Hopper (sm_90a), with
// its epilogue and the residual add: hidden [B, L, D] bf16 -> hidden +
// pos_conv(hidden) [B, L, D] bf16, in one kernel.
//
// Replaces no TPU kernel: the JAX package's positional conv
// (stutter_tpu/models/wavlm.py:pos_conv_embedding) is XLA's
// conv_general_dilated. It was added because the library's grouped conv was
// the slowest work on the card: cuDNN ran XLS-R 2B's 1920 channels in 16
// groups of 120 at ~6 TFLOP/s (implicit_convolve_sgemm), about half of the
// encoder's device time, and WavLM-Large's 16 groups of 64 at ~50 TFLOP/s.
//
// For clip b, output frame l, group g of Cg (kCg) channels and output channel
// n of the group (c = g Cg + n), with the SamePad conv's 128 taps:
//
//     y   = sum_{t < 128, i < Cg} x[b, l + t - 64, g Cg + i] * W[c, i, t]   (f32)
//     out = bf16(f32(x[b, l, c]) + f32(bf16(gelu_erf(y + bias[c]))))
//
// frames outside [0, L) read as zero. The rounding is the plain path's
// (hidden + bf16(gelu(f32(conv) + bias))), except that y is not rounded to
// bf16 before the bias as cuDNN's bf16 output is.
//
// What bounds it on this card. The work is 2 L D Cg 128 operations a clip
// (59 MFLOP a frame at D = 1920, 16.8 at 1024) on 4 bytes of activations a
// channel and frame: ~14,700 (~4,100) operations a byte of activations, so
// the tensor cores are the bound, and only wgmma reaches their rate. Every
// output frame of a group needs the group's whole weight set (3.7 MB at Cg =
// 120, 1 MB at 64), so the weight bytes read from L2 are what a tile height
// buys down: at 256 frames a tile, 256 operations a weight byte, ~3.9 TB/s
// of L2 reads at the tensor peak (the L2 gives ~5.5).
//
// The design: an implicit GEMM for each (clip, group, tile of 256 frames),
// M = frames, N = the group's Cg output channels (wgmma m64n120k16 or
// m64n64k16), K = 128 taps x Cg input channels, with both operands in shared
// memory.
// - The input is staged once a tile, as a slab of the 256 + 127 frames the
//   tile's taps read (zeros outside [0, L), by the copies' zero fill) and the
//   group's Cg channels, in 8-channel chunks: chunk k holds its frames as
//   consecutive 16-byte rows. The A operand of tap t is that slab shifted by
//   t rows. A 128-byte swizzle would break at a shift that is not a multiple
//   of 8 rows, so the slab is unswizzled: wgmma's non-swizzled K-major layout
//   reads 8 x 16-byte core matrices whose 8 rows lie at the stride offset
//   apart in groups and 16 bytes apart inside one; with a stride offset of
//   128 bytes, row m of a chunk lies at 16 m for every m, so a shift by t
//   rows is a start address 16 t bytes on. A 128-byte core matrix is 128
//   contiguous bytes whatever its start, so its reads meet no bank conflict.
// - A k-step (16 values of K) pairs two taps of one chunk: K values 0-7 are
//   the chunk's channels at tap 2p, 8-15 the same channels at tap 2p + 1,
//   whose core matrix is the same rows one row on: a leading offset of 16
//   bytes. So Cg = 120 needs no padding to a multiple of 16 channels: 64 tap
//   pairs x 15 chunks = 960 k-steps of useful products (512 at Cg = 64).
// - The weights are packed by the caller (ops/pos_conv.py:
//   pack_pos_conv_weights, one copy on the card) in the same k-step order, each k-step's B tile
//   ([2 taps][Cg][8 channels], non-swizzled K-major: leading offset 16 Cg
//   bytes, stride offset 128) contiguous, so a stage of k-steps is one bulk
//   copy. A producer warp keeps a 4-stage ring of ~31 KB stages full; two
//   consumer warpgroups own two 64-row sub-tiles each (sub-tile s of the
//   tile to warpgroup s % 2), and both read each weight stage, which is
//   released when both have waited for its products.
// - A sub-tile whose frames all lie at or past L computes nothing, and a
//   sub-tile's tap pairs that read only frames at or past L are skipped (they
//   add exactly 0); the block stops streaming weights after the last tap pair
//   any of its sub-tiles needs. Short clips (WavLM's 3 s bucket, L = 160) thus
//   run 3 of their tile's 4 sub-tiles.
// - The epilogue adds the bias, the erf GELU and the residual, whose frames
//   are the slab's own rows 64 on, and stores bf16 pairs straight from the
//   accumulators. The grid walks the tiles fastest, then the clips, then the
//   groups, so that the blocks running together share a group's weights in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stem_tiles_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTaps = 128;
constexpr int kPad = kTaps / 2;           // SamePad: frame l reads l - 64 .. l + 63
constexpr int kPairs = kTaps / 2;         // two taps a k-step
constexpr int kSubTiles = 4;              // 64-row sub-tiles a tile
constexpr int kBM = 64 * kSubTiles;       // output frames a tile
constexpr int kSlabRows = kBM + kTaps - 1;
constexpr int kPitch = kSlabRows * 16;    // bytes of one 8-channel chunk of the slab
constexpr int kRing = 4;
constexpr int kConsumers = 2;             // warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // and a producer warp

template <int kCg>
struct Shape {
  static_assert(kCg == 64 || kCg == 120, "the kernel is instantiated at 64 and 120 channels a group");
  static constexpr int kChunks = kCg / 8;
  static constexpr int kSteps = kPairs * kChunks;         // k-steps of a tile
  static constexpr int kStepBytes = 2 * kCg * 16;         // one k-step's weight tile
  static constexpr int kStageSteps = kCg == 120 ? 8 : 16;
  static constexpr int kStageBytes = kStageSteps * kStepBytes;
  static constexpr int kAcc = kCg / 2;                    // accumulators a thread and sub-tile
  static constexpr int kSlabBytes = kChunks * kPitch;
  static constexpr int kSmem = kRing * kStageBytes + kSlabBytes + 2 * kRing * 8;
  static_assert(kSteps % kStageSteps == 0, "whole stages");
  static_assert(kSmem <= 232448, "one CTA an SM");
};

// A non-swizzled K-major shared-memory descriptor: 8 x 16-byte core matrices,
// the next one along K `lbo` bytes on, the next 8 rows `sbo` bytes on.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// `bytes` contiguous bytes from global memory to this CTA's shared memory at
// `dst`, completing on the barrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d (+)= a . b for a 64 x 16 K-major A and a 120 x 16 K-major B, both in
// shared memory. accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n120k16_ss(float (&d)[60], uint64_t a_desc,
                                                    uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
      "%60, %61, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate)
      : "memory");
}

template <int kCg>
__device__ __forceinline__ void mma(float (&d)[kCg / 2], uint64_t a_desc, uint64_t b_desc) {
  if constexpr (kCg == 120)
    wgmma_m64n120k16_ss(d, a_desc, b_desc, 1);
  else
    sm90::wgmma_m64n64k16_ss<0>(d, a_desc, b_desc, 1);
}

__device__ __forceinline__ float gelu_erf(float y) {
  return 0.5f * y * (1.0f + erff(y * 0.7071067811865476f));
}

// The tap pairs that sub-tile rows from r0 on need: pairs p >= the result
// read only frames at or past L.
__device__ __forceinline__ int pairs_needed(int r0, int L) {
  return max(0, min(kPairs, (L - r0 + kPad + 1) / 2));
}

// One block per (group g, clip b, tile of kBM frames), the tile fastest:
// blockIdx.x = (g * B + b) * n_tiles + tile. x, out: [B, L, G * kCg] bf16;
// w: the packed weights, [G][kSteps][2][kCg][8] bf16; bias: [G * kCg] f32.
template <int kCg>
__global__ void __launch_bounds__(kThreads, 1) pos_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
    bf16* __restrict__ out, int B, int L, int D, int n_tiles) {
  using S = Shape<kCg>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = sm90::smem_u32(smem_raw);
  const uint32_t slab = ring + kRing * S::kStageBytes;
  const uint32_t bars = slab + S::kSlabBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kRing + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x % n_tiles;
  const int gb = blockIdx.x / n_tiles;
  const int b = gb % B, g = gb / B;
  const int l0 = tile * kBM;
  // the stages this tile needs: through the last tap pair of its first sub-tile
  const int stages =
      (pairs_needed(l0, L) * S::kChunks + S::kStageSteps - 1) / S::kStageSteps;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      sm90::mbar_init(full(s), 1);            // the producer, and the bytes
      sm90::mbar_init(empty(s), kConsumers);  // one thread of each consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // The producer: stage it of the ring holds k-steps it * kStageSteps ...
    if (lane == 0) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(w) +
                           static_cast<long long>(g) * S::kSteps * S::kStepBytes;
      for (int it = 0; it < stages; ++it) {
        const int s = it % kRing;
        sm90::mbar_wait(empty(s), ((it / kRing) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), S::kStageBytes);
        bulk_copy(ring + s * S::kStageBytes, src + static_cast<long long>(it) * S::kStageBytes,
                  S::kStageBytes, full(s));
      }
    }
    return;
  }

  // The consumers. First the slab: row r of chunk k is frame l0 - 64 + r,
  // channels g kCg + 8 k .. + 7, zero outside [0, L).
  const bf16* xb = x + static_cast<long long>(b) * L * D + g * kCg;
  for (int i = tid; i < kSlabRows * S::kChunks; i += 128 * kConsumers) {
    const int r = i / S::kChunks, k = i - r * S::kChunks;
    const int l = l0 - kPad + r;
    const bool ok = l >= 0 && l < L;
    sm90::cp_async_16(slab + k * kPitch + r * 16,
                      ok ? xb + static_cast<long long>(l) * D + 8 * k : xb, ok);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();  // wgmma reads the slab through the async proxy
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");

  const int wg = warp >> 2, wq = warp & 3, grp = lane >> 2, tig = lane & 3;
  // This warpgroup's sub-tiles wg and wg + 2 (rows 64 s .. 64 s + 63 of the
  // tile), each with the stages it reads: through its last needed tap pair
  // (k-steps past it in that stage read zero rows and add exactly 0), none
  // where its rows all lie at or past L.
  // Both are broadcast from lane 0 so that the compiler sees them uniform
  // across the warp: a branch around a wgmma it cannot prove uniform
  // serialises the products.
  int stage_end[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r0 = l0 + 64 * (wg + 2 * u);
    stage_end[u] = __shfl_sync(0xffffffffu,
                               r0 < L ? (pairs_needed(r0, L) * S::kChunks + S::kStageSteps - 1) /
                                            S::kStageSteps
                                      : 0,
                               0);
  }
  const uint64_t a_desc0 = plain_desc(slab + 64 * wg * 16, 16, 128);
  const uint64_t a_desc1 = plain_desc(slab + 64 * (wg + 2) * 16, 16, 128);
  float acc0[S::kAcc], acc1[S::kAcc];
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc0[i] = acc1[i] = 0.f;
  const bool signals = (tid & 127) == 0;

  // a stage's products for one sub-tile: k-step it * kStageSteps + j is
  // tap pair p, chunk k: A from chunk k's rows 2 p on, B the stage's j-th tile
  auto products = [&](float (&acc)[S::kAcc], uint64_t a_desc, uint64_t b_desc, int it) {
#pragma unroll
    for (int j = 0; j < S::kStageSteps; ++j) {
      const int step = it * S::kStageSteps + j;
      const int p = step / S::kChunks, k = step - p * S::kChunks;
      const uint64_t a_off = static_cast<uint64_t>(k * (kPitch / 16) + 2 * p);  // 16-byte units
      mma<kCg>(acc, a_desc + a_off, b_desc + static_cast<uint64_t>(j * (S::kStepBytes / 16)));
    }
  };

  for (int it = 0; it < stages; ++it) {
    const int s = it % kRing;
    sm90::mbar_wait(full(s), (it / kRing) & 1);
    const uint64_t b_desc = plain_desc(ring + s * S::kStageBytes, 16 * kCg, 128);
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    sm90::wgmma_fence();
    if (it < stage_end[0]) products(acc0, a_desc0, b_desc, it);
    if (it < stage_end[1]) products(acc1, a_desc1, b_desc, it);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous stage's products are done
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    if (it > 0 && signals) sm90::mbar_arrive(empty((it - 1) % kRing));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc0);
  sm90::fence_regs(acc1);

  // The epilogue: element 4 nt + 2 a + j of a sub-tile's accumulator is row
  // 16 wq + grp + 8 a of its 64, channel 8 nt + 2 tig + j of the group; the
  // residual is the slab's row 64 on.
  const float* bias_g = bias + g * kCg;
  bf16* out_b = out + static_cast<long long>(b) * L * D + g * kCg;
  const uint8_t* slab_ptr = smem_raw + kRing * S::kStageBytes;
  auto finish = [&](const float (&acc)[S::kAcc], int st) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int m = 64 * st + 16 * wq + grp + 8 * a;  // row of the tile
      const int l = l0 + m;
      if (l >= L) continue;
      const uint8_t* res = slab_ptr + (m + kPad) * 16 + 4 * tig;
#pragma unroll
      for (int nt = 0; nt < kCg / 8; ++nt) {
        const int n = 8 * nt + 2 * tig;
        const float2 bb = *reinterpret_cast<const float2*>(bias_g + n);
        const float2 xr =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + nt * kPitch));
        const float g0 =
            __bfloat162float(__float2bfloat16_rn(gelu_erf(acc[4 * nt + 2 * a] + bb.x)));
        const float g1 =
            __bfloat162float(__float2bfloat16_rn(gelu_erf(acc[4 * nt + 2 * a + 1] + bb.y)));
        *reinterpret_cast<__nv_bfloat162*>(out_b + static_cast<long long>(l) * D + n) =
            __floats2bfloat162_rn(xr.x + g0, xr.y + g1);
      }
    }
  };
  if (stage_end[0] > 0) finish(acc0, wg);
  if (stage_end[1] > 0) finish(acc1, wg + 2);
}

template <int kCg>
int launch(const bf16* x, const bf16* w, const float* bias, bf16* out, int B, int L, int G,
           cudaStream_t stream) {
  using S = Shape<kCg>;
  auto kernel = pos_conv_kernel<kCg>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (L + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(n_tiles) * B * G;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, S::kSmem, stream>>>(x, w, bias, out, B, L, G * kCg,
                                                            n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, L, D] bf16 (padded frames already zero), the input and the residual;
// weights: [G][64 tap pairs * D / (8 G) chunks][2][D / G][8] bf16 from
// ops/pos_conv.py:pack_pos_conv_weights; bias: [D] f32; out: [B, L, D] bf16,
// not x. All contiguous and 16-byte aligned. D / G must be 64 or 120. Returns
// cudaGetLastError() after the launch on `stream` (0 on success).
extern "C" int pos_conv_residual(const void* x, const void* weights, const void* bias, void* out,
                                 int B, int L, int D, int G, void* stream) {
  if (B <= 0 || L <= 0 || G <= 0 || D % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(weights);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  switch (D / G) {
    case 120:
      return launch<120>(xp, wp, bp, op, B, L, G, s);
    case 64:
      return launch<64>(xp, wp, bp, op, B, L, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
