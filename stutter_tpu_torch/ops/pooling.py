"""Length-masked pooling over time (counterpart of ``stutter_tpu/ops/pooling.py``).

Clips are padded into length buckets, so the mean ignores padding: the sum
over valid frames over the true length, in float32 whatever the activation
dtype.
"""

from __future__ import annotations

import torch


def masked_mean_pool(hidden: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, L, D] x [B] int lengths -> [B, D] float32 mean over valid frames."""
    L = hidden.shape[1]
    mask = (torch.arange(L, device=hidden.device)[None, :] < lengths[:, None]).float()
    total = torch.einsum("bld,bl->bd", hidden.float(), mask)
    return total / torch.clamp(lengths.float(), min=1.0)[:, None]
