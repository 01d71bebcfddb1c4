"""Flash attention with optional key padding (the Whisper encoder's attention
core) or with a materialised additive bias (WavLM's long-bucket escape hatch).

Counterpart of ``stutter_tpu/models/attention.py``'s ``flash_mha`` (the
Pallas TPU flash attention), ``mha_self`` (its dispatch) and
``flash_mha_bias``. For q pre-scaled (sm_scale 1)::

    out = softmax_rows(q @ k^T [+ -1e9 where key j >= kv_valid[b]]) @ v
    out = softmax_rows(q @ k^T + ab) @ v                  (flash_mha_bias)

``flash_mha_bias`` launches the same kernel's ``FullBias`` policy and counts
its launches in ``flash_mha_bias.launches``; ``flash_mha_bias_reference`` is
its plain version.

``flash_mha`` launches the hand-written CUDA kernel (``csrc/flash_mha.cu``)
and counts each launch in ``flash_mha.launches``; ``flash_mha_reference`` is
the plain PyTorch version (f32 throughout, rounded once to q's dtype), which
the tests and the on-card comparison use. ``mha_self`` sends CUDA tensors to
the kernel and CPU tensors to the plain version. Unlike the JAX package,
which takes its Pallas path for bf16 only, both presets go through the
kernel: bf16 on the tensor cores, f32 on scalar FMAs.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops._attention import DTYPE_CODES, check_qkv, empty_like_q


def _key_padding_bias(kv_valid: torch.Tensor, Lk: int) -> torch.Tensor:
    """[B] true key counts -> [B, 1, 1, Lk] f32: 0 for a valid key, -1e9 past it."""
    keys = torch.arange(Lk, device=kv_valid.device)
    return torch.where(keys[None, :] < kv_valid[:, None], 0.0, -1e9).float()[:, None, None, :]


def flash_mha_reference(q, k, v, kv_valid=None):
    """Plain version: [B, H, Lq, d] x [B, H, Lk, d] -> [B, H, Lq, d] in q's
    dtype, with scores, softmax and both products in f32 (the [B, H, Lq, Lk]
    scores materialised)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if kv_valid is not None:
        s = s + _key_padding_bias(kv_valid, k.shape[2])
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _check(q, k, v, kv_valid) -> None:
    check_qkv(q, k, v)  # k and v of q's shape: the kernel takes Lq == Lk
    B = q.shape[0]
    if kv_valid is not None and (
            tuple(kv_valid.shape) != (B,) or kv_valid.dtype != torch.int32
            or not kv_valid.is_contiguous() or kv_valid.device != q.device):
        raise ValueError(f"kv_valid must be a contiguous int32 [{B}] on {q.device}, got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)} on {kv_valid.device}")


def flash_mha(q, k, v, kv_valid=None):
    """Kernel path. q, k, v [B, H, L, 64] (q pre-scaled; k and v with q's
    shape and strides, the head dimension contiguous); kv_valid [B] int32 true
    key counts, or None when every key is valid. Returns [B, H, L, 64] in q's
    dtype, laid out like q."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha launches a CUDA kernel; got a tensor on {q.device}")
    _check(q, k, v, kv_valid)
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    out = empty_like_q(q)
    B, H, L, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           None if kv_valid is None else kv_valid.data_ptr(),
                           out.data_ptr(), B, H, L, q.stride(0), q.stride(1), q.stride(2),
                           DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_mha launch failed: CUDA error {rc}")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0


def flash_mha_bias_reference(q, k, v, ab):
    """Plain version of ``flash_mha_bias``: scores, softmax and both products
    in f32 (the [B, H, L, L] scores materialised), rounded once to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) + ab.float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def flash_mha_bias(q, k, v, ab):
    """Kernel path. q, k, v [B, H, L, 64] as ``flash_mha`` takes them; ab
    [B, H, L, L] contiguous f32 additive bias (mask folded in). Returns
    [B, H, L, 64] in q's dtype, laid out like q."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bias launches a CUDA kernel; got a tensor on {q.device}")
    check_qkv(q, k, v)
    B, H, L, _ = q.shape
    if (tuple(ab.shape) != (B, H, L, L) or ab.dtype != torch.float32
            or not ab.is_contiguous() or ab.device != q.device):
        raise ValueError(f"ab must be a contiguous float32 {(B, H, L, L)} on {q.device}, got "
                         f"{ab.dtype} {tuple(ab.shape)} on {ab.device}, "
                         f"contiguous={ab.is_contiguous()}")
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    out = empty_like_q(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_mha_bias(q.data_ptr(), k.data_ptr(), v.data_ptr(), ab.data_ptr(),
                                out.data_ptr(), B, H, L, q.stride(0), q.stride(1),
                                q.stride(2), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_mha_bias launch failed: CUDA error {rc}")
    flash_mha_bias.launches += 1
    return out


flash_mha_bias.launches = 0


def mha_self(q, k, v, kv_valid=None):
    """[B, H, Lq, d] x [B, H, Lk, d] -> [B, H, Lq, d], q pre-scaled: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, kv_valid)
    return flash_mha(q, k, v, kv_valid)
