// Flash attention with optional key padding (the Whisper encoder's
// self-attention at head_dim 64, wav2vec2 XLS-R's at head_dim 120), and with
// a materialised additive bias (WavLM's escape hatch for its long buckets,
// head_dim 64), for Hopper (sm_90a).
//
// flash_mha replaces stutter_tpu/models/attention.py:flash_mha, which wraps
// the Pallas TPU flash attention (jax.experimental.pallas.ops.tpu.
// flash_attention, non-causal, sm_scale 1, key padding through segment ids).
// For one (clip b, head h, query row i):
//
//     p[j]   = q[i] . k[j]            (+ -1e9 where j >= kv_valid[b])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled and kv_valid [B] int32, or a null pointer when every key
// is valid (the Whisper encoder passes none). A padded key gets the -1e9 that
// the einsum path adds (models/attention.py:mha_self), not -inf, so a clip
// with kv_valid = 0 still gives a finite row (the mean of its v).
//
// flash_mha_bias replaces stutter_tpu/models/attention.py:flash_mha_bias,
// the same Pallas flash attention given an additive bias `ab`:
//
//     p[j]   = q[i] . k[j] + ab[b,h,i,j]
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with ab [B, H, L, L] f32 (WavLM folds gate * bias and the key mask into
// it). The TPU function pads L to its 512 block with ab = -1e9 past L; here
// the tiles' ragged-edge masking (keys past L score -inf) gives the same
// result with no padding.
//
// bf16 (the fast and turbo presets) runs on the wgmma tiles of
// attention_tiles_sm90.cuh with the KeyPadding and FullBias policies below;
// f32 (the fidelity preset) keeps the scalar-FMA kernel of
// attention_tiles.cuh with the same policies, because the tensor cores
// would round f32 to TF32.
//
// What bounds them on this card. At the Whisper encoder's shape (L = 1500,
// H = 20, d = 64) one (clip, head) reads q, k, v and writes out, 768 KB in
// bf16, for 4 L^2 d = 576 MFLOP: ~750 FLOP per byte, above the ~295 at which
// the tensor cores rather than device memory are the limit. So the bf16 path
// is bound by operations: both products are wgmma, and beside them the
// softmax's one ex2 an element takes the SM's 16 special-function lanes as
// long as the products take its tensor cores, so the kernel runs two blocks
// of two warpgroups an SM and lets one warpgroup's softmax run under the
// others' products. The [B, H, L, L] scores (2.9 GB in f32 at B = 16), which
// the plain version writes and reads several times, never reach device
// memory. L = 1500 is not a multiple of any tile: the ragged last query and
// key tiles are masked in the kernel, and nothing is padded.
// At head_dim 120 (wav2vec2 XLS-R 2B, 16 heads of 120 at L = 1008 and
// 1504) the products per (clip, head) grow by 120 / 64 on the same softmax,
// so the kernel is nearer the tensor cores' bound; its ring stage doubles to
// 32 KB (K and V in two 64-column panels each), so it runs one block of two
// warpgroups an SM (attention_tiles_sm90.cuh, "head_dim 120").
// flash_mha_bias is bound by bytes, ab itself: at WavLM's 30 s bucket
// (12 x 16 x 1504 x 64, bf16) it is 1.74 GB against 74 MB of q, k, v and
// out, and the 4 L^2 d products are 0.11 ms of tensor-core time, so the
// least time is reading ab once (~0.54 ms at 3.35 TB/s). Its tiles stream
// through the same shared-memory ring as K and V, two key tiles ahead of
// their use, with an evict-first L2 policy, and are added to the scores
// from shared memory. The f32 paths are bound by scalar FMA issue.

#include "attention_tiles.cuh"
#include "attention_tiles_sm90.cuh"

namespace {

// Serves both tile sets: operator() is the f32 tiles' score, the rest the
// bf16 tiles' interface (attention_tiles_sm90.cuh, "Policies").
struct KeyPadding {
  struct Params {
    const int* kv_valid;  // [B] true key counts, or null: every key is valid
  };
  static constexpr bool kStreamsBias = false;
  static constexpr bool kRowStats = false;
  int valid;

  __device__ KeyPadding(const Params& p, int b, int h, const int (&rows)[2], int H, int L)
      : valid(p.kv_valid ? p.kv_valid[b] : L) {}

  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    return kj < valid ? s : s + -1e9f;
  }
  __device__ __forceinline__ int edge_from() const { return valid; }
  __device__ __forceinline__ float edge(int a, int kj, float s) const {
    return (*this)(a, kj, s);
  }
};

struct FullBias {
  struct Params {
    const float* ab;  // [B, H, L, L]
  };
  static constexpr bool kStreamsBias = true;
  static constexpr bool kRowStats = false;
  static constexpr sm90::L2Hint kBiasL2 = sm90::L2Hint::kEvictFirst;  // each element read once
  static constexpr bool kStreamsKeyRow = false;
  const float* plane;  // ab[b, h]
  int L;

  __device__ FullBias(const Params& p, int b, int h, const int (&rows)[2], int H, int L)
      : plane(p.ab + ((long long)b * H + h) * L * L), L(L), rows_{rows[0], rows[1]} {}

  // padded query rows read row 0 and are not stored
  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    return s + plane[(long long)(rows_[a] < L ? rows_[a] : 0) * L + kj];
  }
  __device__ __forceinline__ const float* bias_plane() const { return plane; }
  __device__ __forceinline__ float biased(int a, int kj, float s, float bias, float) const {
    return s + bias;
  }
  __device__ __forceinline__ int edge_from() const { return L; }
  __device__ __forceinline__ float edge(int a, int kj, float s) const { return s; }

 private:
  int rows_[2];
};

// The bf16 tiles' shapes, settled on the card (PERF.md has the numbers). Without a
// bias: two warpgroups a block, a ring of four 16 KB stages, two blocks an SM
// (122 registers), so four warpgroups' softmaxes and products interleave.
// With the streamed ab a stage is 52 KB and four of them fill the SM's shared
// memory: one block an SM, two key tiles of ab in flight beside the two in
// use. At head_dim 120 a stage is 32 KB and a thread holds 60 output
// accumulators and eight k-steps of q: one block an SM, four stages.
constexpr int kWarpgroups = 2;
constexpr int kStages = 4;
constexpr int kBlocksPerSmPlain = 2;
constexpr int kBlocksPerSmBias = 1;
constexpr int kBlocksPerSmWide = 1;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out: [B, H, L, head_dim]
// views (head_dim 64 or 120) sharing the strides (stride_b, stride_h,
// stride_l) in elements, with a unit head-dim stride (for bf16: 16-byte
// aligned rows); kv_valid: [B] int32 or null. Launches on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int flash_mha(const void* q, const void* k, const void* v, const void* kv_valid,
                         void* out, int B, int H, int L, int head_dim, long long stride_b,
                         long long stride_h, long long stride_l, int dtype, void* stream) {
  const KeyPadding::Params params{static_cast<const int*>(kv_valid)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (head_dim == sm90::kD) {
    if (dtype == 0)
      return launch_attention_f32<KeyPadding>(q, k, v, params, out, B, H, L, stride_b,
                                              stride_h, stride_l, s);
    return sm90::launch_attention_bf16<KeyPadding, sm90::kD, kWarpgroups, kStages,
                                       kBlocksPerSmPlain, sm90::kQueryTileFastest>(
        q, k, v, params, out, nullptr, B, H, L, 0, stride_b, stride_h, stride_l, s);
  }
  if (head_dim == 120) {
    if (dtype == 0)
      return launch_attention_f32<KeyPadding, 120>(q, k, v, params, out, B, H, L, stride_b,
                                                   stride_h, stride_l, s);
    return sm90::launch_attention_bf16<KeyPadding, 120, kWarpgroups, kStages, kBlocksPerSmWide,
                                       sm90::kQueryTileFastest>(
        q, k, v, params, out, nullptr, B, H, L, 0, stride_b, stride_h, stride_l, s);
  }
  return (int)cudaErrorInvalidValue;
}

// flash_mha's layout and dtypes at head_dim 64, with ab a contiguous
// [B, H, L, L] f32 additive bias in place of kv_valid. ab_vec: 16 when ab's rows may be
// copied as 16-byte vectors (L % 4 == 0 and ab 16-byte aligned), else 4;
// read by the bf16 path only.
extern "C" int flash_mha_bias(const void* q, const void* k, const void* v, const void* ab,
                              void* out, int B, int H, int L, int ab_vec, long long stride_b,
                              long long stride_h, long long stride_l, int dtype,
                              void* stream) {
  const FullBias::Params params{static_cast<const float*>(ab)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_attention_f32<FullBias>(q, k, v, params, out, B, H, L, stride_b, stride_h,
                                          stride_l, s);
  if (dtype != 1 || (ab_vec != 16 && ab_vec != 4)) return (int)cudaErrorInvalidValue;
  if (ab_vec == 16 && (L % 4 != 0 || reinterpret_cast<uintptr_t>(ab) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  return sm90::launch_attention_bf16<FullBias, sm90::kD, kWarpgroups, kStages,
                                     kBlocksPerSmBias, sm90::kQueryTileFastest>(
      q, k, v, params, out, nullptr, B, H, L, ab_vec, stride_b, stride_h, stride_l, s);
}
