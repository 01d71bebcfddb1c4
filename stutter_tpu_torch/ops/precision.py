"""Full-f32 products on the card.

A float32 matrix product on CUDA runs in full f32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, but cuDNN's convolutions
default to TF32, which keeps ~3 decimal digits. ``no_tf32`` turns both off
for its block and restores them after.
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
