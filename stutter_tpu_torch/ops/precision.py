"""Full-f32 products on the card, and TF32 where it is exact.

A float32 matrix product on CUDA runs in full f32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, but cuDNN's convolutions
default to TF32, which keeps ~3 decimal digits. ``no_tf32`` turns both off
for its block and restores them after. ``tf32`` turns TF32 on for the
matmuls of its block: f32 operands that hold bf16 or f16 values lose nothing
in TF32 (10 mantissa bits), the sums stay f32, and the product runs on the
tensor cores instead of the f32 CUDA cores.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Full f32 for matmuls and cuDNN convolutions (cuDNN defaults to TF32)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def tf32():
    """TF32 matmuls for the block (exact on bf16- or f16-valued f32 operands)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
