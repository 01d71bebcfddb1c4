"""Operations and bytes of the flash attention kernel at any head_dim,
frozen beside ``yardstick.py`` (whose ``HEAD_DIM`` is the 64 of the kernels
it prices): the true work at the model's width, never the width a kernel
pads it to, so that a share of the roofline reads the same work whatever
implements it. ``tests/test_bench_hd120_roofline.py`` holds it equal to
the program's own count."""

from __future__ import annotations


def flash_mha_fwd(B: int, H: int, L: int, head_dim: int, elem: int = 2,
                  key_counts: bool = True) -> tuple[float, float]:
    """(operations, bytes) of one self-attention call with key padding:
    q k^T and p v over ``head_dim``; q, k, v read and the output written
    once each in the activation dtype (``elem`` bytes), and the [B] int32
    key counts read once where the call takes them."""
    n = B * H * L * head_dim
    return 4.0 * n * L, 4.0 * n * elem + (4.0 * B if key_counts else 0.0)
