// The encoders' last-axis layer norm for Hopper (sm_90a), optionally with the
// residual add in front of it, over a bf16 [rows, D] tensor:
//
//     norm only:  out = LN(x)
//     fused:      s = bf16(f32(x) + f32(delta)),  out = LN(s)   (s written too)
//
// with LN the plain path's arithmetic (ops/layer_norm.py:layer_norm_reference,
// models/common.py:layer_norm): f32 statistics over the bf16 row in two
// passes, mean = sum(v) * (1/D), var = sum((v - mean)^2) * (1/D), then
// ((v - mean) * rsqrt(var + eps)) * scale + bias in f32, each product and sum
// rounded on its own (no fused multiply-add, as the plain path's separate
// element-wise kernels round), scale and bias upcast from bf16, and one
// rounding to bf16. Only the order of the f32 sums differs from PyTorch's
// reduction kernels, so an output may differ from the plain path's by one
// bf16 ulp, rarely.
//
// Replaces no TPU kernel: XLA fused the JAX package's norm (and the add in
// front of it) into the neighbouring work. It was added because the port's
// plain norm is eleven launches over the whole tensor (an f32 copy, two
// reductions, a square, five broadcast ops and a cast back), ~68 bytes an
// element, and it held a third of the card's time in every extraction cell.
//
// What bounds it on this card: bytes. The work is ~10 operations an element
// on 4 bytes (x read, out written) or 8 bytes fused (x and delta read, s and
// out written): far below the ~295 operations a byte at which the tensor
// cores would be the limit, so the least time is the bytes at 3.35 TB/s.
//
// The design: one warp holds one row in registers, 8 rows a block. A lane
// reads 4 bf16 (8 bytes) at a time, the warp's 32 lanes 256 contiguous bytes,
// D / 128 loads a lane, all issued before the first is used (every width the
// models use is a multiple of 128: 512, 1024, 1280 and 1920 = 15 x 128, so no
// lane has a ragged edge). The row's sum and then its sum of squared
// deviations come from the registers and a butterfly of warp shuffles, which
// leaves every lane the same bits; so nothing but x (and delta) is read and
// nothing but out (and s) is written. Scale and bias are read per row from
// the L1, where the block's other rows find them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;                 // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;                   // bf16 a lane reads at a time (8 bytes)

__device__ __forceinline__ void unpack(uint2 raw, float* v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(p[0]);
  const float2 b = __bfloat1622float2(p[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ uint2 pack(const float* v) {
  uint2 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
  p[0] = __floats2bfloat162_rn(v[0], v[1]);
  p[1] = __floats2bfloat162_rn(v[2], v[3]);
  return raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <int kD, bool kFused>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                      const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                      bf16* __restrict__ sum, bf16* __restrict__ out, long long rows, float eps) {
  static_assert(kD % (32 * kVec) == 0, "whole 4-wide loads in every lane");
  constexpr int kLoads = kD / (32 * kVec);
  constexpr float kInvD = 1.0f / kD;  // the reduction's factor, as PyTorch's mean takes it
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * kD + lane * kVec;

  uint2 raw[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
    raw[i] = *reinterpret_cast<const uint2*>(x + base + i * 32 * kVec);
  float v[kLoads * kVec];
  if constexpr (kFused) {
    uint2 draw[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      draw[i] = *reinterpret_cast<const uint2*>(delta + base + i * 32 * kVec);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float a[kVec], b[kVec];
      unpack(raw[i], a);
      unpack(draw[i], b);
#pragma unroll
      for (int j = 0; j < kVec; ++j) a[j] = __fadd_rn(a[j], b[j]);
      const uint2 s = pack(a);  // the residual stream, rounded as PyTorch's bf16 add
      *reinterpret_cast<uint2*>(sum + base + i * 32 * kVec) = s;
      unpack(s, v + i * kVec);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) unpack(raw[i], v + i * kVec);
  }

  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kLoads * kVec; ++k) acc = __fadd_rn(acc, v[k]);
  const float mean = __fmul_rn(warp_sum(acc), kInvD);
  acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kLoads * kVec; ++k) {
    v[k] = __fsub_rn(v[k], mean);
    acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  }
  const float var = __fmul_rn(warp_sum(acc), kInvD);
  const float r = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = lane * kVec + i * 32 * kVec;
    float g[kVec], b[kVec], o[kVec];
    unpack(*reinterpret_cast<const uint2*>(scale + c), g);
    unpack(*reinterpret_cast<const uint2*>(bias + c), b);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i * kVec + j], r), g[j]), b[j]);
    *reinterpret_cast<uint2*>(out + base + i * 32 * kVec) = pack(o);
  }
}

template <int kD>
int launch(const bf16* x, const bf16* delta, const bf16* scale, const bf16* bias, bf16* sum,
           bf16* out, long long rows, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (delta)
    layer_norm_kernel<kD, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(x, delta, scale, bias, sum, out, rows, eps);
  else
    layer_norm_kernel<kD, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(x, delta, scale, bias, sum, out, rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [rows, D] bf16; delta: [rows, D] bf16 or null (norm only); scale, bias:
// [D] bf16; sum: [rows, D] bf16, written with x + delta when delta is given
// (else unused); out: [rows, D] bf16. All contiguous, 16-byte aligned, none
// overlapping. D must be 512, 1024, 1280 or 1920; rows > 0. Returns
// cudaGetLastError() after the launch on `stream` (0 on success).
extern "C" int layer_norm_bf16(const void* x, const void* delta, const void* scale,
                               const void* bias, void* sum, void* out, long long rows, int D,
                               float eps, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* dp = static_cast<const bf16*>(delta);
  const bf16* gp = static_cast<const bf16*>(scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  bf16* sp = static_cast<bf16*>(sum);
  bf16* op = static_cast<bf16*>(out);
  switch (D) {
    case 512:
      return launch<512>(xp, dp, gp, bp, sp, op, rows, eps, s);
    case 1024:
      return launch<1024>(xp, dp, gp, bp, sp, op, rows, eps, s);
    case 1280:
      return launch<1280>(xp, dp, gp, bp, sp, op, rows, eps, s);
    case 1920:
      return launch<1920>(xp, dp, gp, bp, sp, op, rows, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
