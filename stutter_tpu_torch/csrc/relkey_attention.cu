// Self-attention with a clamped relative-key term, for Hopper (sm_90a): the
// attention of w2v-BERT 2.0's Conformer layers (HF Wav2Vec2BertSelfAttention,
// position_embeddings_type "relative_key"), which the JAX package lacks. For
// one (clip b, head h, query row i), with q pre-scaled by head_dim^-1/2:
//
//     p[j]   = q[i] . k[j] + T[i, clamp(j - i, -64, 8) + 64]
//              (+ -1e9 where j >= kv_valid[b])
//     out[i] = sum_j softmax_j(p)[j] * v[j]
//
// with T = q . E^T, E the layer's 73 x 64 learned distance embeddings, so
// that T holds 73 terms a query row: HF's einsum of q with the [L, L, 64]
// embeddings of the clamped distances, divided by sqrt(64), as the caller's
// one [B L H, 64] x [64, 80] product before the launch (E padded to 80 rows)
// (ops/relkey_attention.py). kv_valid is [B] int32, or null when every key is
// valid; a padded key gets -1e9, as flash_mha's KeyPadding gives it.
//
// What bounds it on this card: the same as flash_mha's (flash_mha.cu): at
// w2v-BERT's 30 s bucket (8 x 16 x 1499 x 64) one (clip, head) does
// 4 L^2 d operations on 4 L d bf16 elements, ~750 operations a byte, far
// above the ~295 at which the tensor cores are the limit; T adds 2 L 73 d
// operations and its 73 terms a row. The term depends on q, so it is neither
// a bias plane shared by the batch (the gated kernel's) nor a key mask, and
// written out as scores it is [B, H, L, L] (1.2 GB of f32 a layer at that
// bucket). Here nothing of [L, L] is made: the bf16 path runs on the wgmma
// tiles of attention_tiles_sm90.cuh with the RelKeyTable policy below, a
// per-row table that does not ride the ring. Only the three key tiles around
// a 64-row warpgroup's diagonal hold unclamped terms; they gather them from
// T (L1 and L2: a 160-byte row, read by the row's four lanes), and every
// other tile adds the row's first or last term, folded into its max and the
// exponent's offset at no cost an element. f32 (the fidelity preset) keeps
// the scalar-FMA kernel of attention_tiles.cuh with the same policy, which
// adds the term to every score.

#include "attention_tiles.cuh"
#include "attention_tiles_sm90.cuh"

namespace {

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Serves both tile sets: operator() is the f32 tiles' score, the rest the
// bf16 tiles' interface (attention_tiles_sm90.cuh, "Policies"), with the row
// table. Elem is T's type: q's.
template <class Elem>
struct RelKeyTable {
  struct Params {
    const int* kv_valid;  // [B] true key counts, or null: every key is valid
    const Elem* table;    // T at (b, h, i, r): + b sb + h sh + i sl + r
    long long sb, sh, sl;
  };
  static constexpr bool kStreamsBias = false;
  static constexpr bool kRowStats = false;
  static constexpr bool kRowTable = true;
  static constexpr int kLeft = 64, kRight = 8;
  const Elem* row_[2];
  int i_[2];
  int valid;

  // padded query rows (i >= L) read row L - 1 and are not stored
  __device__ RelKeyTable(const Params& p, int b, int h, const int (&rows)[2], int H, int L)
      : valid(p.kv_valid ? p.kv_valid[b] : L) {
    for (int a = 0; a < 2; ++a) {
      i_[a] = rows[a];
      row_[a] = p.table + b * p.sb + h * p.sh + min(rows[a], L - 1) * p.sl;
    }
  }

  __device__ __forceinline__ int term(int a, int kj) const {
    return min(max(kj - i_[a], -kLeft), kRight) + kLeft;
  }
  __device__ __forceinline__ float table(int a, int r) const { return as_float(row_[a][r]); }
  __device__ __forceinline__ float operator()(int a, int kj, float s) const {
    const float t = s + table(a, term(a, kj));
    return kj < valid ? t : t + -1e9f;
  }
  __device__ __forceinline__ int edge_from() const { return valid; }
  __device__ __forceinline__ float edge(int a, int kj, float s) const {
    return kj < valid ? s : s + -1e9f;
  }
};

// flash_mha's shapes without a bias (flash_mha.cu): two warpgroups a block, a
// ring of four 16 KB stages, two blocks an SM.
constexpr int kWarpgroups = 2;
constexpr int kStages = 4;
constexpr int kBlocksPerSm = 2;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out: [B, H, L, 64] views
// sharing the strides (stride_b, stride_h, stride_l) in elements, with a unit
// head-dim stride (for bf16: 16-byte aligned rows); table: T in q's dtype at
// (b, h, i, r) + b t_stride_b + h t_stride_h + i t_stride_l + r, r < 73;
// kv_valid: [B] int32 or null. Launches on `stream` and returns the first
// CUDA error (0 on success).
extern "C" int relkey_attention(const void* q, const void* k, const void* v, const void* table,
                                const void* kv_valid, void* out, int B, int H, int L,
                                long long stride_b, long long stride_h, long long stride_l,
                                long long t_stride_b, long long t_stride_h,
                                long long t_stride_l, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* valid = static_cast<const int*>(kv_valid);
  if (dtype == 0) {
    const RelKeyTable<float>::Params params{valid, static_cast<const float*>(table), t_stride_b,
                                            t_stride_h, t_stride_l};
    return launch_attention_f32<RelKeyTable<float>>(q, k, v, params, out, B, H, L, stride_b,
                                                    stride_h, stride_l, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const RelKeyTable<__nv_bfloat16>::Params params{
      valid, static_cast<const __nv_bfloat16*>(table), t_stride_b, t_stride_h, t_stride_l};
  return sm90::launch_attention_bf16<RelKeyTable<__nv_bfloat16>, sm90::kD, kWarpgroups, kStages,
                                     kBlocksPerSm, sm90::kQueryTileFastest>(
      q, k, v, params, out, nullptr, B, H, L, 0, stride_b, stride_h, stride_l, s);
}
