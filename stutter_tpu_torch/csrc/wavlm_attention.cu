// Gated relative-position-bias attention forward (WavLM), for Hopper (sm_90a).
//
// Replaces stutter_tpu/ops/wavlm_attention_pallas.py:_attn_kernel (the short
// whole-row kernel) and :_attn_long_kernel (the q-blocked long kernel). One
// kernel per dtype serves every sequence length, because the reason for the
// TPU's split (a 16 MB scoped-VMEM ceiling on the [L, L] row temporaries) has
// no counterpart here. For one (clip b, head h, query row i) it computes
//
//     p[j]   = q[i] . k[j] + gate[b,h,i] * bias[h,i,j] + mask[b,j]
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with q pre-scaled by head_dim^-0.5, bias [H, L, L] f32 shared by the batch,
// gate [B, H, L] f32 and mask [B, L] f32 (0 for a valid key, -1e9 for a
// padded one). The tiles are those of attention_tiles.cuh, with its
// GatedBias score policy. The training forward also has the kernel
// write each row's softmax statistics for wavlm_attention_bwd.cu.
//
// What bounds it on this card. At the 3 s bucket (L = 160, d = 64) one
// (clip, head) reads q, k, v and writes out, 80 KB in bf16, for 6.6 MFLOP:
// about 80 FLOP per byte, far under the ~295 at which the tensor cores rather
// than device memory would be the limit. The work is memory- and
// latency-bound, not bound by the tensor cores, and what matters is never
// writing the [B, H, L, L] scores (210 MB per layer in f32 at B = 128) to
// device memory, which is what the plain PyTorch version does several times.
//
// What the design does about that, beyond the shared tiles: the clip index
// is fastest in the grid, so blocks in flight share (head, query tile) and
// the bias rows they read (145 MB in all at L = 1504, more than the 50 MB L2)
// are fetched from device memory about once per head and tile, not once per
// clip; gate * bias + mask is formed in registers as the scores are.

#include "attention_tiles.cuh"

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out share the strides
// (stride_b, stride_h, stride_l) in elements, with a unit head-dim stride (for
// bf16: 16-byte aligned rows); bias [H, L, L], gate [B, H, L] and mask [B, L]
// are contiguous f32; row_stats is a [2, B, H, L] f32 buffer to fill, or null
// (extraction). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int wavlm_gated_relpos_attention(
    const void* q, const void* k, const void* v, const void* bias,
    const void* gate, const void* mask, void* out, void* row_stats, int B, int H, int L,
    long long stride_b, long long stride_h, long long stride_l, int dtype,
    void* stream) {
  const GatedBias::Params params{static_cast<const float*>(bias),
                                 static_cast<const float*>(gate),
                                 static_cast<const float*>(mask)};
  return launch_attention<GatedBias>(q, k, v, params, out, B, H, L, stride_b, stride_h,
                                     stride_l, dtype, static_cast<cudaStream_t>(stream),
                                     static_cast<float*>(row_stats));
}
