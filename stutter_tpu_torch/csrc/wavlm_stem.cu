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
// out and back in (~1.6 ms at 3.35 TB/s). The plain stem takes ~58 ms, most
// of it the separate elementwise passes of bias, layer norm and GELU over
// [B, 512, T]; here they happen in registers, once per element.
//
// Why not the TPU's block. _stem_kernel computes all 7 layers for 16 output
// frames in VMEM: 1039 layer-0 frames x 512 channels (~1 MB) live, and every
// block re-reads all seven layers' weights (8.4 MB). A Hopper block has at
// most 227 KB of shared memory, so each layer is its own kernel and the bf16
// intermediates go through device memory.
//
// Design.
// - Each conv of layers 1-6 is a GEMM on an overlapping strided view of x_i,
//   with no im2col copy: in [B, T, C] layout window t reads rows s t ..
//   s t + k - 1, which are k * 512 contiguous values, so A is [T_out, k * 512]
//   with a row stride of s * 512 values, and B is the tap-major
//   [k * 512, 512] weight (W^T, packed once on the host).
// - A block owns 64 output frames of one clip and all 512 channels, because
//   the layer norm needs whole rows; tiles never span two clips (grid: frame
//   tiles x clips). 8 warps each own 64 columns of all 64 rows: 4 x 8
//   mma.sync m16n8k16 tiles, 128 f32 accumulators a thread.
// - The K loop streams 32-deep slices of A (64 x 32) and B (32 x 512) through
//   a 4-stage cp.async ring; rows are padded by 16 bytes so that ldmatrix
//   reads them without bank conflicts. Rows past T_out are zero-filled and
//   not stored.
// - The epilogue rounds, adds the bias, reduces each row's sum and then its
//   sum of squares across the quad (shuffles) and the 8 warps (shared memory,
//   in a fixed order), normalises, applies GELU and stores bf16 pairs.
// - Layer 0 has K = 10 and one input channel: its rows are 20-byte windows at
//   a 10-byte stride, too unaligned for cp.async. A block stages its 325
//   samples in shared memory as bf16 and builds the A fragments from there,
//   zero-padded to K = 16: one mma k-step, then the same epilogue.
// Not yet: wgmma and TMA, computing layer 0 inside layer 1's kernel (its
// output is the largest intermediate, 1.34 GB at the 3 s bucket), and staging
// the output through shared memory for 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 512;                     // channels of every layer's output
constexpr int kBM = 64;                     // output frames per block
constexpr int kBK = 32;                     // contraction slice per stage
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpN = kC / kWarps;         // 64 columns per warp
constexpr int kAStride = kBK + 8;           // 80-byte rows
constexpr int kWStride = kC + 8;            // 1040-byte rows
constexpr int kAStage = kBM * kAStride;     // bf16 elements
constexpr int kWStage = kBK * kWStride;
constexpr int kConvSmem = kStages * (kAStage + kWStage) * 2 + kWarps * kBM * 4;
constexpr int kStride = 2;                  // layers 1-6
constexpr int kL0Taps = 10;
constexpr int kL0Stride = 5;
constexpr int kL0Rows = 16;                 // layer 0's taps, zero-padded
constexpr int kL0Span = kL0Stride * (kBM - 1) + kL0Taps;  // 325 samples a block
constexpr int kLayers = 7;
constexpr int kKernels[kLayers] = {10, 3, 3, 3, 3, 2, 2};
constexpr int kStrides[kLayers] = {5, 2, 2, 2, 2, 2, 2};

static_assert(kBM * kBK / 8 == kThreads, "one 16-byte A chunk per thread per stage");
static_assert((kBK * kC / 8) % kThreads == 0, "whole B chunks per thread per stage");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<unsigned*>(&p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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
// row_of(j) = 16 (j >> 1) + g + 8 (j & 1); returns each row's total in part.
__device__ __forceinline__ void block_row_sums(float (&part)[8], float* red, int warp, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 1);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 2);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp * kBM + 16 * (j >> 1) + g + 8 * (j & 1)] = part[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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
// of the block's [64, 512] tile (the mma.sync C layout). Writes the finished
// frames t0 + row < T_out of clip b.
__device__ __forceinline__ void bias_ln_gelu_store(float (&acc)[4][8][4],
                                                   const float* __restrict__ vec,
                                                   bf16* __restrict__ y, int b, int t0,
                                                   int T_out, float* red) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int col0 = warp * kWarpN + 2 * c4;

  float part[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) part[j] = 0.f;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const float bias[2] = {bf16_round(vec[col0 + 8 * ni]), bf16_round(vec[col0 + 8 * ni + 1])};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = bf16_round(bf16_round(acc[mi][ni][e]) + bias[e & 1]);
        acc[mi][ni][e] = h;
        part[2 * mi + (e >> 1)] += h;
      }
  }
  block_row_sums(part, red, warp, lane);
  float mean[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = part[j] * (1.f / kC);
    part[j] = 0.f;
  }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = acc[mi][ni][e] - mean[2 * mi + (e >> 1)];
        part[2 * mi + (e >> 1)] += d * d;
      }
  block_row_sums(part, red, warp, lane);
  float rstd[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) rstd[j] = rsqrtf(part[j] * (1.f / kC) + 1e-5f);

  const float* scale = vec + kC;
  const float* shift = vec + 2 * kC;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = col0 + 8 * ni;
    const float sc[2] = {scale[col], scale[col + 1]};
    const float sh[2] = {shift[col], shift[col + 1]};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * mi + half;
        const int t = t0 + 16 * mi + g + 8 * half;
        bf16 o[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float z = __fmul_rn(__fsub_rn(acc[mi][ni][2 * half + c], mean[j]), rstd[j]);
          z = __fadd_rn(__fmul_rn(z, sc[c]), sh[c]);
          o[c] = __float2bfloat16_rn(gelu_tanh(bf16_round(z)));
        }
        if (t < T_out) {
          __nv_bfloat162 v;
          v.x = o[0];
          v.y = o[1];
          *reinterpret_cast<__nv_bfloat162*>(y + ((long long)b * T_out + t) * kC + col) = v;
        }
      }
  }
}

// Layers 1-6: k = kTaps, s = 2, C_in = 512. Grid (frame tiles, clips).
template <int kTaps>
__global__ void __launch_bounds__(kThreads, 1) stem_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ vec,
    bf16* __restrict__ y, int T_in, int T_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* wsm = as + kStages * kAStage;
  float* red = reinterpret_cast<float*>(wsm + kStages * kWStage);

  constexpr int kChunks = kTaps * kC / kBK;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this thread's A chunk: row a_row of the tile, 16 bytes at a_chunk
  const int a_row = tid >> 2, a_chunk = tid & 3;
  const bool a_ok = t0 + a_row < T_out;
  const bf16* a_src = x + ((long long)b * T_in + (a_ok ? kStride * (t0 + a_row) : 0)) * kC +
                      a_chunk * 8;

  auto load_stage = [&](int stage, int chunk) {
    const int k0 = chunk * kBK;
    cp_async16(as + stage * kAStage + a_row * kAStride + a_chunk * 8, a_src + k0, a_ok);
    const bf16* src = w + (long long)k0 * kC;
    bf16* dst = wsm + stage * kWStage;
#pragma unroll
    for (int i = 0; i < kBK * kC / 8 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e >> 6, c = e & 63;
      cp_async16(dst + r * kWStride + c * 8, src + r * kC + c * 8, true);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kChunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < kChunks; ++kc) {
    cp_async_wait<kStages - 2>();  // slice kc has landed (this thread's copies)
    __syncthreads();               // ... everyone's; slice kc - 1's readers are done
    const int next = kc + kStages - 1;
    if (next < kChunks) load_stage(next % kStages, next);
    cp_async_commit();
    const bf16* at = as + (kc % kStages) * kAStage;
    const bf16* wt = wsm + (kc % kStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[4][4], bfr[8][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], at + (16 * mi + (lane & 15)) * kAStride + kk + (lane >> 4) * 8);
      load_b_frags(bfr, wt, kk, lane, warp);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();
  bias_ln_gelu_store(acc, vec, y, b, t0, T_out, red);
}

// Layer 0: k10 s5 over the one-channel wave (f32, cast to bf16 here).
__global__ void __launch_bounds__(kThreads, 1) stem_layer0_kernel(
    const float* __restrict__ wave, const bf16* __restrict__ w0, const float* __restrict__ vec,
    bf16* __restrict__ y, int T, int T_out) {
  __shared__ __align__(16) bf16 wsm[kL0Rows * kWStride];
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
  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
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
  bias_ln_gelu_store(acc, vec, y, b, t0, T_out, red);
}

template <int kTaps>
int launch_conv(const bf16* x, const bf16* w, const float* vec, bf16* y, int B, int T_in,
                int T_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_conv_kernel<kTaps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_out + kBM - 1) / kBM, B);
  stem_conv_kernel<kTaps><<<grid, kThreads, kConvSmem, stream>>>(x, w, vec, y, T_in, T_out);
  return (int)cudaGetLastError();
}

}  // namespace

// wave: [B, T] f32; weights: bf16 [16 + 4 * 1536 + 2 * 1024, 512], each
// layer's tap-major [k * C_in, 512] matrix in order (layer 0's 10 rows padded
// with zeros to 16); table: f32 [7, 3, 512] (conv bias, LN scale, LN bias);
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

  const dim3 grid0((lengths[0] + kBM - 1) / kBM, B);
  stem_layer0_kernel<<<grid0, kThreads, 0, s>>>(static_cast<const float*>(wave), w, vec, src, T,
                                                lengths[0]);
  int rc = (int)cudaGetLastError();
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
