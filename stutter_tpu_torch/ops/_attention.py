"""What the two attention kernels' wrappers share (``csrc/attention_tiles.cuh``).

Both kernels take q, k, v as [B, H, L, d] views with one set of strides and
a contiguous head dimension, in float32 or bfloat16, and write an output
laid out like q; the bf16 kernels load 16-byte rows. The tiles are built at
head_dim 64 (every kernel) and 120 (``flash_mha`` alone, for wav2vec2
XLS-R): ``HEAD_DIMS``; a wrapper names the widths its kernel takes.
"""

from __future__ import annotations

import torch

HEAD_DIM = 64
HEAD_DIMS = (HEAD_DIM, 120)  # the widths the tiles are instantiated at
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the tiles a call runs on (``device_path`` of either wrapper): bf16 on the
# wgmma tiles of ``csrc/attention_tiles_sm90.cuh``, f32 on the scalar ones of
# ``csrc/attention_tiles.cuh``
BF16_TILES, F32_TILES = "bf16_wgmma_ring", "f32_scalar"


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              head_dims: tuple[int, ...] = HEAD_DIMS) -> None:
    """Raise unless q, k and v are what the tiles take, at one of
    ``head_dims`` (a kernel built at 64 alone passes ``(HEAD_DIM,)``)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, L, d], got shape {tuple(q.shape)}")
    if q.shape[-1] not in head_dims:
        widths = " or ".join(map(str, head_dims))
        raise ValueError(f"the kernel takes head_dim {widths}, got {q.shape[-1]}")
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


def device_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                head_dims: tuple[int, ...] = HEAD_DIMS) -> str:
    """Which tiles these inputs launch: bf16 the wgmma tiles, f32 the scalar
    ones. Raises what ``check_qkv`` raises for inputs that neither takes
    (another dtype, a head_dim not in ``head_dims``, strides that differ, a
    head dimension that is not contiguous and, for bf16, rows that are not
    16-byte aligned)."""
    check_qkv(q, k, v, head_dims)
    return BF16_TILES if q.dtype == torch.bfloat16 else F32_TILES


def vector_bytes(*planes: torch.Tensor) -> int:
    """How the bf16 tiles copy rows of f32 planes (a bias, a key mask) into
    shared memory: as 16-byte vectors when every row starts 16-byte aligned
    (rows of a multiple of 4 floats and aligned bases), else as 4-byte
    elements."""
    aligned = all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0 for t in planes)
    return 16 if aligned else 4


def empty_like_q(q: torch.Tensor) -> torch.Tensor:
    """The output buffer, laid out like q (the kernel writes with q's strides)."""
    out = torch.empty_like(q)
    if out.stride() != q.stride():
        raise ValueError(f"cannot lay the output out like q (strides {q.stride()})")
    return out
