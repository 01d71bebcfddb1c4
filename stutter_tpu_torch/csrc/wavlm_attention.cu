// Gated relative-position-bias attention forward (WavLM), for Hopper (sm_90a).
//
// Replaces stutter_tpu/ops/wavlm_attention_pallas.py:_attn_kernel (the short
// whole-row kernel) and :_attn_long_kernel (the q-blocked long kernel). One
// kernel per dtype serves every sequence length, because the reason for the
// TPU's split (a 16 MB scoped-VMEM ceiling on the [L, L] row temporaries) has
// no counterpart here. For one (clip b, head h, query row i) it computes
//
//     p[j]   = (q[i] . k[j] + gate[b,h,i] * bias[h,i,j]) + mask[b,j]
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled by head_dim^-0.5, bias [H, L, L] f32 shared by the batch,
// gate [B, H, L] f32 and mask [B, L] f32 (0 for a valid key, -1e9 for a
// padded one; any values are taken, no prefix length is inferred). Given a
// [2, B, H, L] buffer (the training forward), the kernel also writes each
// row's softmax statistics for wavlm_attention_bwd.cu.
//
// bf16 (the fast and turbo presets) runs on the wgmma tiles of
// attention_tiles_sm90.cuh with the GatedBiasRing policy below: the bias
// plane's 64 x 64 tiles and the clip's mask row ride the shared-memory ring
// beside K and V. f32 (the fidelity preset) keeps the scalar-FMA kernel of
// attention_tiles.cuh with GatedBias, because the tensor cores would round
// f32 to TF32.
//
// What bounds it on this card, per bucket (bf16, H = 16, d = 64):
// - 3 s (B = 128, L = 160): one (clip, head) reads q, k, v and writes out,
//   80 KB, for 6.6 MFLOP: ~80 operations a byte, under the ~295 at which the
//   tensor cores would be the limit, so the least time is the bytes (0.05 ms
//   for 171 MB). A block here runs only three key tiles, so what it costs is
//   mostly its fixed latency (the first tiles' copies, q's loads, the
//   epilogue), which other blocks on the SM hide: blocks are one warpgroup
//   (64 query rows; 160 of 192 rows busy where 128-row blocks keep 160 of
//   256) with a ring of three 34 KB stages, two blocks an SM. The 1.6 MB
//   bias plane stays in L2, so the query tile goes fastest in the grid: the
//   blocks in flight read every head of a few clips, whole rows of the
//   [B, L, H, 64] projections. The [B, H, L, L] scores, which the plain
//   version writes and reads several times, never reach device memory.
// - 30 s (B = 12, L = 1504): 111 GFLOP on 74 MB of q, k, v, out and the
//   145 MB plane: the products' 0.11 ms at the bf16 peak bound it, and in
//   practice, as for flash_mha, the softmax's instruction issue does: per
//   score one FFMA and one FADD for gate * bias + mask beside the ex2 and its
//   FFMA. The plane is 3x the 50 MB L2 and each of its slabs is read by all
//   B clips, so above 16 MB of plane (ops/wavlm_attention.py picks the
//   order) the clip goes fastest under (head, query tile): the B blocks of
//   one 64-row slab (385 KB) run together and the slab comes from device
//   memory about once, not once per clip; its copies keep L2's normal
//   policy (not flash_mha_bias's evict-first).
// PERF.md has the times of both orders and of 128-row blocks at every bucket.

#include "attention_tiles.cuh"
#include "attention_tiles_sm90.cuh"

namespace {

// GatedBias on the bf16 wgmma tiles (attention_tiles_sm90.cuh, "Policies"):
// bias[h] is the streamed plane, the clip's mask the streamed key row, and
// the score is (s + g * bias) + mask, the plain version's order.
struct GatedBiasRing : GatedBias {
  static constexpr bool kStreamsBias = true;
  static constexpr bool kRowStats = true;
  static constexpr sm90::L2Hint kBiasL2 = sm90::L2Hint::kEvictNormal;  // read by every clip
  static constexpr bool kStreamsKeyRow = true;
  const float* plane;  // bias[h]
  int L;

  __device__ GatedBiasRing(const Params& p, int b, int h, const int (&rows)[2], int H, int L)
      : GatedBias(p, b, h, rows, H, L), plane(p.bias + (long long)h * L * L), L(L) {}

  __device__ __forceinline__ const float* bias_plane() const { return plane; }
  __device__ __forceinline__ const float* key_row() const { return mask_row; }
  __device__ __forceinline__ float biased(int a, int kj, float s, float bias, float key) const {
    return (s + g[a] * bias) + key;
  }
  __device__ __forceinline__ int edge_from() const { return L; }
  __device__ __forceinline__ float edge(int a, int kj, float s) const { return s; }
};

// The bf16 block shape: one warpgroup (64 query rows), a ring of three 34 KB
// stages (K, V and the 64 x 64 bias tile), two blocks an SM. Two warpgroups
// a block (128 rows, four 52 KB stages, one block an SM, as flash_mha_bias)
// measured 16-34 % slower at every bucket (PERF.md).
constexpr int kWarpgroups = 1;
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;

template <int kOrder>
int launch_bf16(const void* q, const void* k, const void* v, const GatedBias::Params& params,
                void* out, float* row_stats, int B, int H, int L, int bias_vec,
                long long stride_b, long long stride_h, long long stride_l, cudaStream_t s) {
  return sm90::launch_attention_bf16<GatedBiasRing, sm90::kD, kWarpgroups, kStages,
                                     kBlocksPerSm, kOrder>(
      q, k, v, params, out, row_stats, B, H, L, bias_vec, stride_b, stride_h, stride_l, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out share the strides
// (stride_b, stride_h, stride_l) in elements, with a unit head-dim stride (for
// bf16: 16-byte aligned rows); bias [H, L, L], gate [B, H, L] and mask [B, L]
// are contiguous f32; row_stats is a [2, B, H, L] f32 buffer to fill, or null
// (extraction). Read by the bf16 path only: bias_vec, 16 when bias and mask
// rows may be copied as 16-byte vectors (L % 4 == 0 and both 16-byte
// aligned), else 4; grid_order, sm90::GridOrder. Launches on `stream` and
// returns the first CUDA error (0 on success).
extern "C" int wavlm_gated_relpos_attention(
    const void* q, const void* k, const void* v, const void* bias, const void* gate,
    const void* mask, void* out, void* row_stats, int B, int H, int L, int bias_vec,
    int grid_order, long long stride_b, long long stride_h, long long stride_l, int dtype,
    void* stream) {
  const GatedBias::Params params{static_cast<const float*>(bias),
                                 static_cast<const float*>(gate),
                                 static_cast<const float*>(mask)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(row_stats);
  if (dtype == 0)
    return launch_attention_f32<GatedBias>(q, k, v, params, out, B, H, L, stride_b, stride_h,
                                           stride_l, s, stats);
  if (dtype != 1 || (bias_vec != 16 && bias_vec != 4)) return (int)cudaErrorInvalidValue;
  if (bias_vec == 16 && (L % 4 != 0 || reinterpret_cast<uintptr_t>(bias) % 16 != 0 ||
                         reinterpret_cast<uintptr_t>(mask) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (grid_order == sm90::kQueryTileFastest)
    return launch_bf16<sm90::kQueryTileFastest>(q, k, v, params, out, stats, B, H, L, bias_vec,
                                                stride_b, stride_h, stride_l, s);
  if (grid_order == sm90::kClipFastest)
    return launch_bf16<sm90::kClipFastest>(q, k, v, params, out, stats, B, H, L, bias_vec,
                                           stride_b, stride_h, stride_l, s);
  return (int)cudaErrorInvalidValue;
}
