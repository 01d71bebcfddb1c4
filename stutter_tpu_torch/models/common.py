"""Building blocks that WavLM and Whisper share, with the JAX package's numerics.

- ``layer_norm`` takes f32 statistics and casts back to the input's dtype;
  over the last axis it is ``ops.layer_norm.add_layer_norm``'s norm, whose
  ``add_layer_norm`` (x + delta, the norm of that sum) is the residual add in
  front of it: both run the hand-written kernel where its gate passes (bf16
  on the card, contiguous, no autograd) and the plain version elsewhere;
- ``gelu`` is the tanh form on bf16 and the erf form on f32 (both models'
  ``_gelu`` in the JAX package);
- ``param`` makes an uninitialised, frozen parameter on an explicit device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.ops.layer_norm import add_layer_norm, layer_norm_reference


def layer_norm(x: torch.Tensor, scale, bias, eps: float, dim: int = -1) -> torch.Tensor:
    """Norm over `dim` with f32 statistics, cast back to x's dtype; scale
    and bias broadcast along `dim`."""
    if dim in (-1, x.dim() - 1):
        return add_layer_norm(x, None, scale, bias, eps)[1]
    return layer_norm_reference(x, scale, bias, eps, dim)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
