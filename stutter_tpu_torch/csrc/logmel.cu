// Whisper log-mel frontend (framing, windowed DFT, power, mel, log10) for
// Hopper (sm_90a).
//
// Replaces stutter_tpu/ops/logmel_pallas.py:_logmel_kernel (the fused Pallas
// kernel behind whisper_log_mel_pallas). For clip b and frame t < 3000 of the
// reflect-padded wave x [B, 480400] it computes
//
//     re[k]  = sum_n x[160 t + n] * basis[n][k]          (k < 201, n < 400)
//     im[k]  = sum_n x[160 t + n] * basis[n][201 + k]
//     out[t][m] = log10(max(sum_k (re[k]^2 + im[k]^2) * mel[k][m], 1e-10))
//
// with basis [400, 402] the Hann-windowed cos/sin DFT basis and mel
// [201, n_mels] the slaney filter bank, both float32 made on the host in
// float64 (ops/logmel.py) and passed in: they are not recomputed here. The
// output is [B, 3000, n_mels] f32; the per-clip max - 8 floor, the (x + 4) / 4
// affine and the transpose need every block's output, so they run after the
// kernel as plain tensor ops, as in the JAX package.
//
// What bounds it on this card. One clip is ~1.06 GFLOP of f32 multiply-adds
// (0.96 for the DFT, 3000 frames x 400 x 402; 0.10 for the mel product at
// 80 mels) over 1.9 MB of samples: ~550 FLOP per byte, so it is bound by
// FMA issue and shared-memory reads,
// not by device memory. The tensor cores are off limits: quiet frames rely on
// the cancellation of a full-f32 sum (the JAX package runs both products at
// Precision.HIGHEST), which bf16 or TF32 operands lose. So every product is a
// scalar f32 FMA (no fast math either: it would change log10f).
//
// What the design does about that.
// - One block per (tile of 64 frames, clip). 64 consecutive frames at hop 160
//   read only 160 * 63 + 400 = 10,480 consecutive samples, so the tile's
//   frames are staged once in shared memory as one contiguous run (the
//   framing trick of the Pallas kernel), not as 64 x 400 copies.
// - The TPU kernel holds the whole [400, 402] basis (643 KB) in VMEM; a block
//   here has at most 227 KB of shared memory. So the DFT walks 7 tiles of 32
//   frequency bins, and each tile streams its cos and sin columns through
//   shared memory in chunks of 80 basis rows (20 KB).
// - Warp w owns frames 8w..8w+7 of the tile and lane l owns bin l of the
//   tile: a thread keeps 8 re and 8 im sums in registers, reads the frame
//   samples as warp-wide broadcast float4s and the basis as conflict-free
//   rows, so each 16 shared-memory wavefronts feed 64 warp FMAs.
// - After each bin tile the 64 x 32 powers go through shared memory into the
//   tile's [64, n_mels] mel sums, which stay in registers across all 7 tiles
//   (each thread 8 frames x up to 4 mel columns). Only log10 of the mel image
//   is written to device memory: the [3000, 402] spectrum never is.
// Not yet: the tensor cores in a split-precision scheme (3xTF32) that would
// keep f32 accuracy, and cp.async staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBins = kNFFT / 2 + 1;          // 201
constexpr int kBasisCols = 2 * kBins;         // 402
constexpr int kFrames = 3000;                 // 480,000 samples / hop
constexpr int kPaddedLen = 480000 + kNFFT;    // reflect-padded samples per clip
constexpr int kTileF = 64;                    // frames per block
constexpr int kTileB = 32;                    // bins per tile (one per lane)
constexpr int kBinTiles = (kBins + kTileB - 1) / kTileB;  // 7
constexpr int kChunk = 80;                    // basis rows per staged chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFramesPerWarp = kTileF / kWarps;  // 8
constexpr int kSpan = kHop * (kTileF - 1) + kNFFT;  // 10,480 samples per tile

static_assert(kNFFT % kChunk == 0 && kChunk % 4 == 0, "chunks of whole float4 steps");
static_assert(kSpan % 4 == 0 && kPaddedLen % 4 == 0 && kHop % 4 == 0, "float4 staging");

template <int kMelChunks>
constexpr int smem_floats() {
  return kSpan + 2 * kChunk * kTileB + kTileF * (kTileB + 1) + kTileB * 32 * kMelChunks;
}

template <int kMelChunks>
__global__ void __launch_bounds__(kThreads) whisper_log_mel_kernel(
    const float* __restrict__ x, const float* __restrict__ basis,
    const float* __restrict__ mel, float* __restrict__ out, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [kSpan]
  float* bcos = xs + kSpan;                      // [kChunk][kTileB]
  float* bsin = bcos + kChunk * kTileB;          // [kChunk][kTileB]
  float* ps = bsin + kChunk * kTileB;            // [kTileF][kTileB + 1]
  float* melc = ps + kTileF * (kTileB + 1);      // [kTileB][32 * kMelChunks]
  constexpr int kMelW = 32 * kMelChunks;

  const int f0 = blockIdx.x * kTileF;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Stage the tile's samples; past the clip's end (last tile only) zeros,
  // which feed only frames >= 3000, never stored.
  {
    const long long start = (long long)b * kPaddedLen + (long long)kHop * f0;
    const long long limit = (long long)(b + 1) * kPaddedLen;
    for (int e = tid; e < kSpan / 4; e += kThreads) {
      const long long g = start + 4LL * e;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < limit) v = *reinterpret_cast<const float4*>(x + g);
      *reinterpret_cast<float4*>(xs + 4 * e) = v;
    }
  }

  float macc[kFramesPerWarp][kMelChunks];
#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kMelChunks; ++c) macc[i][c] = 0.f;

  const float* xw = xs + kHop * kFramesPerWarp * warp;  // this warp's first frame

  for (int tile = 0; tile < kBinTiles; ++tile) {
    const int bin0 = tile * kTileB;
    float re[kFramesPerWarp], im[kFramesPerWarp];
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i) re[i] = im[i] = 0.f;

    for (int n0 = 0; n0 < kNFFT; n0 += kChunk) {
      __syncthreads();  // xs is staged; the last chunk's readers are done
      for (int e = tid; e < kChunk * kTileB; e += kThreads) {
        const int r = e / kTileB, c = e % kTileB;
        const int k = bin0 + c;
        const float* row = basis + (long long)(n0 + r) * kBasisCols;
        bcos[e] = k < kBins ? row[k] : 0.f;
        bsin[e] = k < kBins ? row[kBins + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int n = 0; n < kChunk; n += 4) {
        float c[4], s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = bcos[(n + j) * kTileB + lane];
          s[j] = bsin[(n + j) * kTileB + lane];
        }
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xw + kHop * i + n0 + n);
          re[i] = fmaf(v.x, c[0], re[i]);
          im[i] = fmaf(v.x, s[0], im[i]);
          re[i] = fmaf(v.y, c[1], re[i]);
          im[i] = fmaf(v.y, s[1], im[i]);
          re[i] = fmaf(v.z, c[2], re[i]);
          im[i] = fmaf(v.z, s[2], im[i]);
          re[i] = fmaf(v.w, c[3], re[i]);
          im[i] = fmaf(v.w, s[3], im[i]);
        }
      }
    }

    // Power of this bin tile (bins past 200 have zero basis, so zero power),
    // and the tile's rows of the mel matrix.
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i)
      ps[(kFramesPerWarp * warp + i) * (kTileB + 1) + lane] = re[i] * re[i] + im[i] * im[i];
    for (int e = tid; e < kTileB * kMelW; e += kThreads) {
      const int j = e / kMelW, m = e % kMelW;
      const int k = bin0 + j;
      melc[e] = (k < kBins && m < n_mels) ? mel[(long long)k * n_mels + m] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTileB; ++j) {
      float mv[kMelChunks];
#pragma unroll
      for (int c = 0; c < kMelChunks; ++c) mv[c] = melc[j * kMelW + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        const float p = ps[(kFramesPerWarp * warp + i) * (kTileB + 1) + j];
#pragma unroll
        for (int c = 0; c < kMelChunks; ++c) macc[i][c] = fmaf(p, mv[c], macc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerWarp; ++i) {
    const int t = f0 + kFramesPerWarp * warp + i;
    if (t >= kFrames) continue;
    float* dst = out + ((long long)b * kFrames + t) * n_mels;
#pragma unroll
    for (int c = 0; c < kMelChunks; ++c) {
      const int m = lane + 32 * c;
      if (m < n_mels) dst[m] = log10f(fmaxf(macc[i][c], 1e-10f));
    }
  }
}

template <int kMelChunks>
int launch(const float* x, const float* basis, const float* mel, float* out, int B,
           int n_mels, cudaStream_t stream) {
  const int bytes = smem_floats<kMelChunks>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(whisper_log_mel_kernel<kMelChunks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((kFrames + kTileF - 1) / kTileF, B);
  whisper_log_mel_kernel<kMelChunks><<<grid, kThreads, bytes, stream>>>(x, basis, mel, out,
                                                                       n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, 480400] f32, the reflect-padded 30 s waves, contiguous and 16-byte
// aligned; basis: [400, 402] f32; mel: [201, n_mels] f32 (1 <= n_mels <= 128);
// out: [B, 3000, n_mels] f32. All contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int whisper_log_mel(const void* x, const void* basis, const void* mel, void* out,
                               int B, int n_mels, void* stream) {
  if (B <= 0 || B > 65535 || n_mels <= 0 || n_mels > 128) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(basis);
  const float* mf = static_cast<const float*>(mel);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mels <= 96) return launch<3>(xf, bf, mf, of, B, n_mels, s);
  return launch<4>(xf, bf, mf, of, B, n_mels, s);
}
