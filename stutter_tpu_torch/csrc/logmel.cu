// Whisper log-mel frontend (framing, Hann window, real FFT, power, mel,
// log10, then the per-clip floor and affine) for Hopper (sm_90a).
//
// Replaces stutter_tpu/ops/logmel_pallas.py:_logmel_kernel (the fused Pallas
// kernel behind whisper_log_mel_pallas). For clip b and frame t < 3000 of the
// wave x [B, 480000], centre-padded by reflection (200 samples each side, the
// edge sample not repeated: torch.stft's padding), it computes
//
//     X[k]      = sum_n w[n] xp[160 t + n] e^(-2 pi i k n / 400)   (k <= 200)
//     mel[m]    = sum_k |X[k]|^2 fb[k][m]                 (nonzero taps only)
//     v[m][t]   = log10(max(mel[m], 1e-10))
//     out[m][t] = (max(v[m][t], max_clip(v) - 8) + 4) / 4
//
// into out [B, n_mels, 3000] f32, the Whisper input features. The window w,
// the twiddles e^(-2 pi i m / 400) and the slaney bank's nonzero taps are f32
// tables made on the host in float64 and rounded once (ops/logmel.py).
//
// What bounds it on this card. A frame needs ~10 k f32 operations (the
// 400-point real FFT ~8.6 k, the power, ~400 mel taps, the log): 0.5 GFLOP
// at 16 clips, 7 us at the card's 67 TFLOP/s of f32 outside the tensor cores,
// against 30.7 MB of samples in and 15.4 MB (80 mels) of features out, 14 us
// at 3.35 TB/s: it is bound by bytes. The tensor cores are off limits: quiet
// frames rely on the cancellation of a full-f32 sum (the JAX package runs
// its products at Precision.HIGHEST), which bf16 or TF32 operands lose. So
// every product is an f32 FMA (no fast math either: it would change log10f).
//
// What the design does about that.
// - One block per (tile of 16 frames, clip): 16 consecutive frames at hop
//   160 read one contiguous run of 2,800 samples, staged in shared memory
//   with 16-byte cp.async (the Pallas kernel's framing trick); the first and
//   last tiles reflect their samples past the clip's ends while staging, so
//   the padded wave is never written. 3,008 blocks of 8 warps at 16 clips,
//   up to 6 blocks an SM (38 KB of shared memory each: the powers replace
//   the spectrum's real parts, the mel tile the samples), so one block's
//   copies overlap the others' arithmetic.
// - Each warp owns two frames and takes them through every step with only
//   __syncwarp between the steps. The 400-point real FFT is a 200-point
//   complex FFT of z[n] = (w x)[2n] + i (w x)[2n + 1], in three Stockham
//   stages of radix 8, 5 and 5 (25, 40 and 40 butterflies a frame; the
//   radix-8 stage reads the staged samples and the window directly), in
//   shared memory as separate real and imaginary rows padded one float every
//   32 so that the radix-8 stage's stride-8 stores spread over the banks;
//   then the real-split step X[k] = E[k] + e^(-2 pi i k / 400) O[k] and the
//   power of the 201 bins.
// - The mel bank multiplies only its nonzero taps: each filter is a run of
//   consecutive bins, so a lane sums its filter's run (each bin lies in at
//   most two filters). log10 of the [n_mels, 16] tile goes through shared
//   memory so that each mel row is written as 16 consecutive frames, and
//   the block writes its maximum to block_max [B, 188].
// - A second, small kernel reads a clip's 188 block maxima, and floors and
//   scales the clip's features in place with 16-byte accesses. A max is
//   order-free, so the result does not depend on the blocks' order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;          // 201
constexpr int kSamples = 480000;              // one 30 s clip
constexpr int kPad = kNFFT / 2;               // reflected samples at each end
constexpr int kFrames = kSamples / kHop;      // 3000
constexpr int kTileF = 16;                    // frames per block
constexpr int kTiles = (kFrames + kTileF - 1) / kTileF;  // 188
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFramesPerWarp = kTileF / kWarps;  // 2
constexpr int kSpan = kHop * (kTileF - 1) + kNFFT;  // 2,800 samples per tile
constexpr int kPitch = 208;                   // floats per padded row of 200 (or 201) values
constexpr int kMaxMels = 128;
constexpr int kMelPitch = kTileF + 1;
constexpr int kSmemFloats = kSpan + 2 * kTileF * kPitch + kWarps;
constexpr int kPowerIters = (2 * kBins + 31) / 32;  // a warp's bins of its two frames

static_assert(kMaxMels * kMelPitch <= kSpan, "the mel tile reuses the samples' space");
constexpr int kFinalThreads = 256;
constexpr int kFinalPerThread = 4;            // float4s per thread

static_assert(kFramesPerWarp == 2, "a warp's butterfly loops are written for two frames");
static_assert(kSpan % 4 == 0 && kHop % 4 == 0 && kPad % 4 == 0, "16-byte staging");
static_assert(199 + 199 / 32 < kPitch, "a padded row holds 200 values");
static_assert((kFrames * 4) % 16 == 0, "a clip's mel rows keep 16-byte alignment");

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

struct cf {
  float x, y;
};

__device__ __forceinline__ cf operator+(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf operator-(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf scale(float s, cf a) { return {s * a.x, s * a.y}; }

// v * e^(-i theta) for w = (cos theta, sin theta)
__device__ __forceinline__ cf twiddle(cf v, float2 w) {
  return {fmaf(v.x, w.x, v.y * w.y), fmaf(v.y, w.x, -(v.x * w.y))};
}

// forward 4-point DFT in place: (a0, a1, a2, a3) -> (y0, y1, y2, y3)
__device__ __forceinline__ void fft4(cf& a0, cf& a1, cf& a2, cf& a3) {
  const cf t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = a1 - a3;
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = {t1.x + t3.y, t1.y - t3.x};  // t1 - i t3
  a3 = {t1.x - t3.y, t1.y + t3.x};  // t1 + i t3
}

// forward 8-point DFT in place; h = cos(pi / 4)
__device__ __forceinline__ void fft8(cf (&v)[8], float h) {
  fft4(v[0], v[2], v[4], v[6]);
  fft4(v[1], v[3], v[5], v[7]);
  const cf c[4] = {v[1],
                   {(v[3].x + v[3].y) * h, (v[3].y - v[3].x) * h},   // * e^(-i pi / 4)
                   {v[5].y, -v[5].x},                                // * -i
                   {(v[7].y - v[7].x) * h, -(v[7].x + v[7].y) * h}};  // * e^(-3 i pi / 4)
  const cf a[4] = {v[0], v[2], v[4], v[6]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = a[k] + c[k];
    v[k + 4] = a[k] - c[k];
  }
}

// forward 5-point DFT in place; (c1, s1) and (c2, s2) are the cosine and
// sine of 2 pi / 5 and 4 pi / 5
__device__ __forceinline__ void fft5(cf (&v)[5], float c1, float s1, float c2, float s2) {
  const cf a1 = v[1] + v[4], b1 = v[1] - v[4], a2 = v[2] + v[3], b2 = v[2] - v[3];
  const cf t1 = v[0] + scale(c1, a1) + scale(c2, a2);
  const cf t2 = v[0] + scale(c2, a1) + scale(c1, a2);
  const cf u1 = scale(s1, b1) + scale(s2, b2);
  const cf u2 = scale(s2, b1) - scale(s1, b2);
  v[0] = v[0] + a1 + a2;
  v[1] = {t1.x + u1.y, t1.y - u1.x};  // t1 - i u1
  v[4] = {t1.x - u1.y, t1.y + u1.x};
  v[2] = {t2.x + u2.y, t2.y - u2.x};
  v[3] = {t2.x - u2.y, t2.y + u2.x};
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Index into the clip of sample s of the centre-padded wave (s = padded
// index - 200), reflected at both ends without repeating the edge sample.
// Past the padded wave's end (only the last tile's frames >= 3000 read
// there) it stays inside the clip.
__device__ __forceinline__ int reflect(int s) {
  if (s < 0) s = -s;
  return s < kSamples ? s : 2 * (kSamples - 1) - s;
}

// One Stockham radix-5 stage over the warp's two frames (40 butterflies
// each): inputs at j + 40 r, twiddled by tw[kTwStep * r * (j % kNs)], outputs
// at (j / kNs) * 5 kNs + j % kNs + kNs r. In place: every lane reads its
// butterflies before any lane writes.
template <int kNs, int kTwStep>
__device__ __forceinline__ void radix5_stage(float* const (&re)[2], float* const (&im)[2],
                                             const float2* __restrict__ tw, int lane, float c1,
                                             float s1, float c2, float s2) {
  cf v[3][5];
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int j = lane + 32 * it;
    if (j < 80) {
      const int fr = j >= 40, jj = j - 40 * fr;
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int idx = padded(jj + 40 * r);
        v[it][r] = {re[fr][idx], im[fr][idx]};
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int j = lane + 32 * it;
    if (j < 80) {
      const int fr = j >= 40, jj = j - 40 * fr;
      const int q = jj % kNs;
#pragma unroll
      for (int r = 1; r < 5; ++r) v[it][r] = twiddle(v[it][r], __ldg(tw + kTwStep * r * q));
      fft5(v[it], c1, s1, c2, s2);
      const int base = (jj / kNs) * 5 * kNs + q;
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int idx = padded(base + kNs * r);
        re[fr][idx] = v[it][r].x;
        im[fr][idx] = v[it][r].y;
      }
    }
  }
  __syncwarp();
}

// Grid (188 frame tiles, B clips).
__global__ void __launch_bounds__(kThreads) whisper_log_mel_kernel(
    const float* __restrict__ x, const float* __restrict__ window,
    const float2* __restrict__ tw, const float* __restrict__ taps,
    const int* __restrict__ tap_index, float* __restrict__ out, float* __restrict__ block_max,
    int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [kSpan] samples of the tile
  float* zre = xs + kSpan;                    // [kTileF][kPitch] real parts
  float* zim = zre + kTileF * kPitch;         // [kTileF][kPitch] imaginary parts
  float* red = zim + kTileF * kPitch;         // [kWarps]
  float* melt = xs;  // [n_mels][kMelPitch] log10 mel, once every warp is past the samples

  const int tile = blockIdx.x, b = blockIdx.y;
  const int f0 = tile * kTileF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* xb = x + (long long)b * kSamples;

  // Stage samples s0 .. s0 + kSpan - 1 of the clip (s0 = 160 f0 - 200):
  // whole 16-byte chunks inside the clip by cp.async, the rest reflected.
  {
    const int s0 = kHop * f0 - kPad;
    for (int e = tid; e < kSpan / 4; e += kThreads) {
      const int s = s0 + 4 * e;
      if (s >= 0 && s + 3 < kSamples) {
        cp_async_16(xs + 4 * e, xb + s);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) xs[4 * e + q] = xb[reflect(s + q)];
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  const float h = __ldg(&tw[50].x);  // cos(pi / 4)
  const float c1 = __ldg(&tw[80].x), s1 = __ldg(&tw[80].y);    // 2 pi / 5
  const float c2 = __ldg(&tw[160].x), s2 = __ldg(&tw[160].y);  // 4 pi / 5
  const int fl0 = kFramesPerWarp * warp;  // this warp's first frame of the tile
  float* const re[2] = {zre + fl0 * kPitch, zre + (fl0 + 1) * kPitch};
  float* const im[2] = {zim + fl0 * kPitch, zim + (fl0 + 1) * kPitch};

  // Stage 1, radix 8 (kNs 1): butterfly j of a frame takes z[j + 25 r] from
  // the staged samples and the window and writes its outputs to 8 j + r.
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int j = lane + 32 * it;
    if (j < 50) {
      const int fr = j >= 25, jj = j - 25 * fr;
      const float* xf = xs + kHop * (fl0 + fr);
      cf v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = 2 * (jj + 25 * r);
        const float2 s = *reinterpret_cast<const float2*>(xf + n);
        const float2 w = __ldg(reinterpret_cast<const float2*>(window + n));
        v[r] = {s.x * w.x, s.y * w.y};
      }
      fft8(v, h);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int idx = padded(8 * jj + r);
        re[fr][idx] = v[r].x;
        im[fr][idx] = v[r].y;
      }
    }
  }
  __syncthreads();  // every warp is past the samples: their space takes the mel tile
  // Stages 2 and 3, radix 5 (kNs 8 and 40): twiddles e^(-2 pi i q r / (5 kNs)),
  // that is tw[400 q r / (5 kNs)]. The output is Z[k] in natural order.
  radix5_stage<8, 10>(re, im, tw, lane, c1, s1, c2, s2);
  radix5_stage<40, 2>(re, im, tw, lane, c1, s1, c2, s2);

  // Real split and power: with a = Z[k mod 200] and b = conj(Z[(200 - k) mod
  // 200]), E = (a + b) / 2, O = (a - b) / 2i and X[k] = E + e^(-2 pi i k / 400) O.
  // The powers replace the real parts, once every lane has read its Z.
  float power[kPowerIters];
#pragma unroll
  for (int it = 0; it < kPowerIters; ++it) {
    const int idx = lane + 32 * it;
    if (idx < 2 * kBins) {
      const int fr = idx >= kBins, k = idx - kBins * fr;
      const int ka = padded(k == kBins - 1 ? 0 : k), kb = padded(k == 0 ? 0 : kBins - 1 - k);
      const float ar = re[fr][ka], ai = im[fr][ka], br = re[fr][kb], bi = im[fr][kb];
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float orr = 0.5f * (ai + bi), oi = -0.5f * (ar - br);
      const float2 w = __ldg(tw + k);
      const float xr = er + fmaf(w.x, orr, w.y * oi);
      const float xi = ei + fmaf(w.x, oi, -(w.y * orr));
      power[it] = fmaf(xr, xr, xi * xi);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kPowerIters; ++it) {
    const int idx = lane + 32 * it;
    if (idx < 2 * kBins) {
      const int fr = idx >= kBins;
      re[fr][idx - kBins * fr] = power[it];
    }
  }
  __syncwarp();

  // Mel filter m: taps[tap_index[m] .. tap_index[m + 1]) over bins from
  // tap_index[n_mels + 1 + m] on.
#pragma unroll
  for (int fr = 0; fr < kFramesPerWarp; ++fr) {
    const float* p = re[fr];
    for (int m = lane; m < n_mels; m += 32) {
      const int o0 = __ldg(tap_index + m), o1 = __ldg(tap_index + m + 1);
      const float* pk = p + __ldg(tap_index + n_mels + 1 + m) - o0;
      float s = 0.f;
      for (int o = o0; o < o1; ++o) s = fmaf(pk[o], __ldg(taps + o), s);
      melt[m * kMelPitch + fl0 + fr] = log10f(fmaxf(s, 1e-10f));
    }
  }
  __syncthreads();

  // The tile's frames of each mel row, 16 consecutive floats, and its max.
  const int valid = min(kTileF, kFrames - f0);
  float mx = -CUDART_INF_F;
  for (int e = tid; e < n_mels * kTileF; e += kThreads) {
    const int m = e / kTileF, i = e % kTileF;
    if (i < valid) {
      const float v = melt[m * kMelPitch + i];
      out[((long long)b * n_mels + m) * kFrames + f0 + i] = v;
      mx = fmaxf(mx, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
    block_max[(long long)b * kTiles + tile] = mx;
  }
}

// Grid (chunks of a clip's features, B clips): each block takes the clip's
// max over its 188 tiles, then floors and scales its chunk in place.
__global__ void __launch_bounds__(kFinalThreads) floor_affine_kernel(
    float* __restrict__ out, const float* __restrict__ block_max, int n_vec) {
  __shared__ float red[kFinalThreads / 32];
  const int b = blockIdx.y, tid = threadIdx.x;
  float mx = -CUDART_INF_F;
  for (int i = tid; i < kTiles; i += kFinalThreads)
    mx = fmaxf(mx, block_max[(long long)b * kTiles + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kFinalThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  const float floor_v = mx - 8.f;

  float4* o = reinterpret_cast<float4*>(out) + (long long)b * n_vec;
  const int i0 = blockIdx.x * kFinalThreads * kFinalPerThread + tid;
#pragma unroll
  for (int u = 0; u < kFinalPerThread; ++u) {
    const int i = i0 + u * kFinalThreads;
    if (i < n_vec) {
      float4 v = o[i];
      v.x = (fmaxf(v.x, floor_v) + 4.f) / 4.f;
      v.y = (fmaxf(v.y, floor_v) + 4.f) / 4.f;
      v.z = (fmaxf(v.z, floor_v) + 4.f) / 4.f;
      v.w = (fmaxf(v.w, floor_v) + 4.f) / 4.f;
      o[i] = v;
    }
  }
}

}  // namespace

// x: [B, 480000] f32 waves, contiguous and 16-byte aligned; window: [400] f32;
// twiddles: [400, 2] f32 (cos, sin of 2 pi m / 400); taps: f32, the mel
// bank's nonzero weights filter by filter; tap_index: int32 [2 n_mels + 1],
// each filter's first tap (n_mels + 1 offsets into taps) then its first bin
// (n_mels); out: [B, n_mels, 3000] f32; block_max: [B, 188] f32 scratch.
// 1 <= n_mels <= 128. Launches the log-mel kernel and the floor-affine kernel
// on `stream` and returns the first nonzero cudaGetLastError() (0 on
// success).
extern "C" int whisper_log_mel(const void* x, const void* window, const void* twiddles,
                               const void* taps, const void* tap_index, void* out,
                               void* block_max, int B, int n_mels, void* stream) {
  if (B <= 0 || B > 65535 || n_mels <= 0 || n_mels > kMaxMels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kBytes = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(whisper_log_mel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  whisper_log_mel_kernel<<<dim3(kTiles, B), kThreads, kBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<const float*>(taps),
      static_cast<const int*>(tap_index), static_cast<float*>(out),
      static_cast<float*>(block_max), n_mels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_vec = n_mels * kFrames / 4;
  constexpr int kPerBlock = kFinalThreads * kFinalPerThread;
  const int chunks = (n_vec + kPerBlock - 1) / kPerBlock;
  floor_affine_kernel<<<dim3(chunks, B), kFinalThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(block_max), n_vec);
  return (int)cudaGetLastError();
}
