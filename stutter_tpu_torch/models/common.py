"""Building blocks that WavLM and Whisper share, with the JAX package's numerics.

- ``layer_norm`` takes f32 statistics and casts back to the input's dtype;
- ``gelu`` is the tanh form on bf16 and the erf form on f32 (both models'
  ``_gelu`` in the JAX package);
- ``param`` makes an uninitialised, frozen parameter on an explicit device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x: torch.Tensor, scale, bias, eps: float, dim: int = -1) -> torch.Tensor:
    """Norm over `dim` with f32 statistics, cast back to x's dtype; scale
    and bias broadcast along `dim`."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    var = (xf - mean).square().mean(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.view(shape) + bias.view(shape)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
