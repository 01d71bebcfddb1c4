"""The fine-tune head and its loss (counterpart of ``stutter_tpu/train/heads.py``).

An MLP on the pooled [B, D] features: dense layers with weights stored in the
JAX package's layout (``w`` [in, out], ``b`` [out]), so that the converter
copies them as they are; GELU between layers is ``jax.nn.gelu``'s default,
the tanh approximation, in f32; dropout draws its keep mask from a
``torch.Generator`` on the activations' device. The class-weighted
cross-entropy keeps the JAX package's split into an un-normalised (loss
sum, weight mass) pair, so gradient accumulation normalises once; ``valid``
masks pad rows out of both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """The fields of the JAX package's ``HeadConfig`` that the fine-tune head
    uses (its optimiser and epoch fields belong to the downstream
    classifier, which is not ported yet)."""

    in_dim: int
    n_classes: int
    hidden_dims: tuple[int, ...] = ()  # () = linear / logistic head
    dropout: float = 0.1


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(din, dout, device=device))
        self.b = nn.Parameter(torch.empty(dout, device=device))


class MLPHead(nn.Module):
    """Dense layers in_dim -> hidden_dims... -> n_classes, f32."""

    def __init__(self, cfg: HeadConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.in_dim, *cfg.hidden_dims, cfg.n_classes)
        self.layers = nn.ModuleList(_Dense(a, b, device) for a, b in zip(dims[:-1], dims[1:]))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MLPHead":
        """He-normal weights (normal * sqrt(2 / in)), zero biases, drawn on
        the CPU like ``init_head_params``."""
        for layer in self.layers:
            din, dout = layer.w.shape
            layer.w.copy_(torch.randn(din, dout, generator=generator) * np.sqrt(2.0 / din))
            layer.b.zero_()
        return self

    def forward(self, x: torch.Tensor, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits for [B, D] features."""
        h = x
        for i, layer in enumerate(self.layers):
            h = h @ layer.w + layer.b
            if i < len(self.layers) - 1:
                h = F.gelu(h, approximate="tanh")
                if dropout > 0.0 and generator is not None:
                    keep = torch.rand(h.shape, generator=generator,
                                      device=h.device) < 1.0 - dropout
                    h = torch.where(keep, h / (1.0 - dropout), 0.0)
        return h


def weighted_xent_sums(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: torch.Tensor | None = None,
                       label_smoothing: float = 0.0,
                       valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(weighted loss SUM, weight mass): the un-normalised pair, so that
    microbatch sums add like one big batch."""
    n_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_classes).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_example = -(onehot * logp).sum(dim=-1)
    w = (class_weights.float()[labels.long()] if class_weights is not None
         else torch.ones_like(per_example))
    if valid is not None:
        w = w * valid.to(w.dtype)
    return (per_example * w).sum(), w.sum()


def weighted_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: torch.Tensor | None = None,
                          label_smoothing: float = 0.0,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Class-weighted CE, the weighted mean over ``valid`` rows."""
    loss_sum, w_sum = weighted_xent_sums(logits, labels, class_weights, label_smoothing,
                                         valid)
    return loss_sum / torch.clamp(w_sum, min=1e-9)
