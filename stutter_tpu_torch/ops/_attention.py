"""What the two attention kernels' wrappers share (``csrc/attention_tiles.cuh``).

Both kernels take q, k, v as [B, H, L, 64] views with one set of strides and
a contiguous head dimension, in float32 or bfloat16, and write an output
laid out like q; the bf16 kernels load 16-byte rows.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v are what the tiles take."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, L, d], got shape {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {q.shape[-1]}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"q is {q.dtype} {tuple(q.shape)}")
        if t.stride() != q.stride():
            raise ValueError(f"{name} strides {t.stride()} differ from q's {q.stride()}")
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found one on {t.device}")
    if q.stride(-1) != 1:
        raise ValueError("the head dimension must be contiguous")
    if q.dtype == torch.bfloat16 and (
            any(s % 8 for s in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the bf16 kernel loads 16-byte rows: strides must be "
                         f"multiples of 8 and data 16-byte aligned, got {q.stride()}")


def empty_like_q(q: torch.Tensor) -> torch.Tensor:
    """The output buffer, laid out like q (the kernel writes with q's strides)."""
    out = torch.empty_like(q)
    if out.stride() != q.stride():
        raise ValueError(f"cannot lay the output out like q (strides {q.stride()})")
    return out
