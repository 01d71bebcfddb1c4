"""Self-attention with a clamped relative-key term: w2v-BERT 2.0's attention core.

HF's ``Wav2Vec2BertSelfAttention`` with ``position_embeddings_type``
"relative_key" adds to each score q_i . k_j the term q_i . E[d + 64], with d
the distance j - i clamped to [-64, 8] and E the layer's 73 learned distance
embeddings, and scales the sum by head_dim^-1/2. For q pre-scaled::

    T   = q @ E^T                                     [B, H, L, 73]
    out = softmax_rows(q @ k^T + T[i, clamp(j - i, -64, 8) + 64]
                       [+ -1e9 where key j >= kv_valid[b]]) @ v

The JAX package has no counterpart. ``relkey_attention`` launches the
hand-written CUDA kernel (``csrc/relkey_attention.cu``) at head_dim 64:
bf16 on the wgmma tiles of ``csrc/attention_tiles_sm90.cuh`` with a per-row
table policy, f32 on the scalar tiles of ``csrc/attention_tiles.cuh``. T is
one [B L H, 64] x [64, 80] product before the launch (E padded to 80 rows),
in q's dtype; nothing of size [L, L] is made. Each launch counts in
``relkey_attention.launches``. ``relkey_attention_reference`` is the plain
version (f32 throughout, the [B, H, L, L] scores materialised, rounded once
to q's dtype), which the CPU path and the tests use; ``relkey_self_attention``
sends CUDA tensors to the kernel and CPU tensors to the plain version.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops._attention import DTYPE_CODES, HEAD_DIM, device_path, empty_like_q
from stutter_tpu_torch.ops.flash_mha import _check, _key_padding_bias

LEFT, RIGHT = 64, 8  # the clamp of the distance j - i, as the kernel is built
TERMS = LEFT + RIGHT + 1
TABLE_PITCH = 80  # T's row: 73 terms and 7 of padding, 16-byte aligned rows


def relative_terms(L: int, device=None) -> torch.Tensor:
    """[L, L] int64: the term clamp(j - i, -LEFT, RIGHT) + LEFT of query i and key j."""
    pos = torch.arange(L, device=device)
    return (pos[None, :] - pos[:, None]).clamp(-LEFT, RIGHT) + LEFT


def _check_table(q: torch.Tensor, emb: torch.Tensor) -> None:
    if tuple(emb.shape) != (TERMS, q.shape[-1]) or emb.device != q.device:
        raise ValueError(f"the distance embeddings must be [{TERMS}, {q.shape[-1]}] on "
                         f"{q.device}, got {tuple(emb.shape)} on {emb.device}")


def relkey_attention_reference(q, k, v, emb, kv_valid=None):
    """Plain version: q, k, v [B, H, L, d] (q pre-scaled), emb [73, d] ->
    [B, H, L, d] in q's dtype, with T, the scores, softmax and both products
    in f32 (the [B, H, L, L] scores materialised)."""
    _check_table(q, emb)
    qf = q.float()
    L = q.shape[2]
    table = torch.matmul(qf, emb.float().t())  # [B, H, L, 73]
    terms = relative_terms(L, q.device).expand(*q.shape[:2], L, L)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) + torch.gather(table, -1, terms)
    if kv_valid is not None:
        s = s + _key_padding_bias(kv_valid, L)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def relkey_attention(q, k, v, emb, kv_valid=None):
    """Kernel path. q, k, v [B, H, L, 64] as ``flash_mha`` takes them (q
    pre-scaled; k and v with q's shape and strides, the head dimension
    contiguous); emb [73, 64] in q's dtype; kv_valid [B] int32 true key
    counts, or None when every key is valid. Returns [B, H, L, 64] in q's
    dtype, laid out like q."""
    if q.device.type != "cuda":
        raise ValueError(f"relkey_attention launches a CUDA kernel; got a tensor on {q.device}")
    device_path(q, k, v, (HEAD_DIM,))
    _check(q, k, v, kv_valid)
    _check_table(q, emb)
    if emb.dtype != q.dtype:
        raise TypeError(f"emb is {emb.dtype}, q is {q.dtype}")
    from stutter_tpu_torch.ops._build import kernel_library

    # [B, L, H, 80]: one product over the rows of q's [B, L, H, 64] layout (a
    # view where q is the heads of a [B, L, H 64] projection), against E
    # padded to 80 rows, so that T's rows start 16-byte aligned (cuBLAS takes
    # an unaligned 73-wide output to an older, slower kernel)
    padded = torch.nn.functional.pad(emb, (0, 0, 0, TABLE_PITCH - TERMS))
    table = torch.matmul(q.transpose(1, 2), padded.t()).transpose(1, 2)
    lib = kernel_library()
    out = empty_like_q(q)
    B, H, L, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.relkey_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                                  None if kv_valid is None else kv_valid.data_ptr(),
                                  out.data_ptr(), B, H, L, q.stride(0), q.stride(1),
                                  q.stride(2), table.stride(0), table.stride(1),
                                  table.stride(2), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"relkey_attention launch failed: CUDA error {rc}")
    relkey_attention.launches += 1
    return out


relkey_attention.launches = 0


def relkey_self_attention(q, k, v, emb, kv_valid=None):
    """[B, H, L, d] -> [B, H, L, d], q pre-scaled: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return relkey_attention_reference(q, k, v, emb, kv_valid)
    return relkey_attention(q, k, v, emb, kv_valid)
