// Flash attention with optional key padding (the Whisper encoder's
// self-attention), and with a materialised additive bias (WavLM's escape
// hatch for its long buckets), for Hopper (sm_90a).
//
// Replaces stutter_tpu/models/attention.py:flash_mha, which wraps the Pallas
// TPU flash attention (jax.experimental.pallas.ops.tpu.flash_attention,
// non-causal, sm_scale 1, key padding through segment ids). For one (clip b,
// head h, query row i):
//
//     p[j]   = q[i] . k[j]            (+ -1e9 where j >= kv_valid[b])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled and kv_valid [B] int32, or a null pointer when every key
// is valid (the Whisper encoder passes none). A padded key gets the -1e9 that
// the einsum path adds (models/attention.py:mha_self), not -inf, so a clip
// with kv_valid = 0 still gives a finite row (the mean of its v). The tiles
// are those of attention_tiles.cuh with the KeyPadding score policy below,
// which loads no bias and no gate.
//
// What bounds it on this card. At the Whisper encoder's shape (L = 1500,
// H = 20, d = 64) one (clip, head) reads q, k, v and writes out, 768 KB in
// bf16, for 4 L^2 d = 576 MFLOP: ~750 FLOP per byte, above the ~295 at which
// the tensor cores rather than device memory are the limit. So the bf16 path
// runs both products on the tensor cores (mma.sync), and the [B, H, L, L]
// scores (2.9 GB in f32 at B = 16), which the plain version writes and reads
// several times, never reach device memory. The f32 path (the fidelity
// preset) is bound by scalar FMA issue: the tensor cores would round to TF32.
// L = 1500 is not a multiple of any tile: the ragged last query and key
// tiles are masked in the kernel, and nothing is padded.
//
// flash_mha_bias replaces stutter_tpu/models/attention.py:flash_mha_bias,
// the same Pallas flash attention given an additive bias `ab`:
//
//     p[j]   = q[i] . k[j] + ab[b,h,i,j]
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with ab [B, H, L, L] f32 (WavLM folds gate * bias and the key mask into
// it). The tiles are the same, with the FullBias policy below. The TPU
// function pads L to its 512 block with ab = -1e9 past L; here the tiles'
// ragged-edge masking (keys past L score -inf) gives the same result with
// no padding. What bounds it: ab itself. At WavLM's 30 s bucket
// (12 x 16 x 1504 x 64, bf16) it is 1.74 GB against 74 MB of q, k, v and
// out, and the 4 L^2 d products are 0.11 ms of tensor-core time, so the
// kernel is bound by reading ab once (~0.54 ms at 3.35 TB/s). Each thread
// reads its two rows' ab values for the current key tile; the four lanes
// of a row read 32 contiguous bytes, one sector, per 8-key n-tile.

#include "attention_tiles.cuh"

namespace {

struct KeyPadding {
  struct Params {
    const int* kv_valid;  // [B] true key counts, or null: every key is valid
  };
  int valid;

  __device__ KeyPadding(const Params& p, int b, int h, const int (&rows)[2], int H, int L)
      : valid(p.kv_valid ? p.kv_valid[b] : L) {}

  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    return kj < valid ? s : s + -1e9f;
  }
};

struct FullBias {
  struct Params {
    const float* ab;  // [B, H, L, L]
  };
  const float* ab_row[2];

  __device__ FullBias(const Params& p, int b, int h, const int (&rows)[2], int H, int L) {
    for (int a = 0; a < 2; ++a) {
      const int r = rows[a] < L ? rows[a] : 0;  // padded query rows are not stored
      ab_row[a] = p.ab + (((long long)b * H + h) * L + r) * L;
    }
  }

  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    return s + ab_row[a][kj];
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out: [B, H, L, 64] views
// sharing the strides (stride_b, stride_h, stride_l) in elements, with a unit
// head-dim stride (for bf16: 16-byte aligned rows); kv_valid: [B] int32 or
// null. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_mha(const void* q, const void* k, const void* v, const void* kv_valid,
                         void* out, int B, int H, int L, long long stride_b,
                         long long stride_h, long long stride_l, int dtype, void* stream) {
  const KeyPadding::Params params{static_cast<const int*>(kv_valid)};
  return launch_attention<KeyPadding>(q, k, v, params, out, B, H, L, stride_b, stride_h,
                                      stride_l, dtype, static_cast<cudaStream_t>(stream));
}

// flash_mha's layout and dtypes, with ab a contiguous [B, H, L, L] f32
// additive bias in place of kv_valid.
extern "C" int flash_mha_bias(const void* q, const void* k, const void* v, const void* ab,
                              void* out, int B, int H, int L, long long stride_b,
                              long long stride_h, long long stride_l, int dtype,
                              void* stream) {
  const FullBias::Params params{static_cast<const float*>(ab)};
  return launch_attention<FullBias>(q, k, v, params, out, B, H, L, stride_b, stride_h,
                                    stride_l, dtype, static_cast<cudaStream_t>(stream));
}
