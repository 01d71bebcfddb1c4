"""WavLM's gated relative-position-bias attention core.

Counterpart of ``stutter_tpu/ops/wavlm_attention_pallas.py`` (both its short
and its long kernel). For q pre-scaled by head_dim^-0.5::

    out = softmax_rows(q @ k^T + gate[..., None] * bias + mask[:, None, None, :]) @ v

``gated_relpos_attention`` launches the hand-written CUDA kernel
(``csrc/wavlm_attention.cu``) for CUDA tensors and counts each launch in
``gated_relpos_attention.launches``; for CPU tensors it runs
``gated_relpos_attention_reference``, the plain PyTorch version, which the
tests and the on-card comparison also use.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops._attention import DTYPE_CODES, check_qkv, empty_like_q


def gated_relpos_attention_reference(q, k, v, position_bias, gate, key_mask_bias):
    """Plain version: scores, softmax and both products in f32, the
    [B, H, L, L] scores materialised; output in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s + gate.float()[..., None] * position_bias.float()[None]
    s = s + key_mask_bias.float()[:, None, None, :]
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _check(q, k, v, position_bias, gate, key_mask_bias) -> None:
    check_qkv(q, k, v)
    B, H, L, _ = q.shape
    expect = {"position_bias": (position_bias, (H, L, L)),
              "gate": (gate, (B, H, L)), "key_mask_bias": (key_mask_bias, (B, L))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found one on {t.device}")


def gated_relpos_attention(q, k, v, position_bias, gate, key_mask_bias):
    """q, k, v [B, H, L, d] (q pre-scaled; k and v with q's strides, the head
    dimension contiguous); position_bias [H, L, L] f32; gate [B, H, L] f32;
    key_mask_bias [B, L] f32 (0 or -1e9). Returns [B, H, L, d] in q's dtype,
    laid out like q."""
    if q.device.type == "cpu":
        return gated_relpos_attention_reference(q, k, v, position_bias, gate,
                                                key_mask_bias)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, position_bias, gate, key_mask_bias)
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    out = empty_like_q(q)
    B, H, L, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.wavlm_gated_relpos_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), position_bias.data_ptr(),
            gate.data_ptr(), key_mask_bias.data_ptr(), out.data_ptr(),
            B, H, L, q.stride(0), q.stride(1), q.stride(2),
            DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wavlm_gated_relpos_attention launch failed: CUDA error {rc}")
    gated_relpos_attention.launches += 1
    return out


gated_relpos_attention.launches = 0
