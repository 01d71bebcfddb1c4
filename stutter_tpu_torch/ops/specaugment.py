"""SpecAugment time and feature span masking for fine-tuning.

Counterpart of ``stutter_tpu/ops/specaugment.py`` (HF WavLM's
``_mask_hidden_states``): span starts are drawn i.i.d. at rate prob/span and
each start masks itself and the ``span - 1`` positions after it (the window
at position t looks back over t - span + 1 .. t, as the JAX package's
``reduce_window`` with padding (span - 1, 0) does). Time masks are cut to the
valid frames and filled with ``masked_spec_embed``; feature masks fill with
zero. The starts come from an explicit ``torch.Generator`` on the hidden
states' device, or the masks are given precomputed, so that a test can hand
both packages the same masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def span_mask(generator: torch.Generator, shape: tuple[int, int], prob: float,
              span: int) -> torch.Tensor:
    """[B, L] bool mask, on the generator's device, where ~prob of the
    positions fall inside spans."""
    starts = torch.rand(shape, generator=generator, device=generator.device) < prob / span
    return expand_spans(starts, span)


def expand_spans(starts: torch.Tensor, span: int) -> torch.Tensor:
    """[B, L] bool starts -> [B, L] bool: position t is masked when a start
    lies in t - span + 1 .. t."""
    x = F.pad(starts.float()[:, None, :], (span - 1, 0))
    return F.max_pool1d(x, span, stride=1)[:, 0, :] > 0.0


def spec_augment(hidden: torch.Tensor, lengths: torch.Tensor | None = None,
                 mask_time_prob: float = 0.05, mask_time_length: int = 10,
                 mask_feature_prob: float = 0.0, mask_feature_length: int = 10,
                 mask_embedding: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 time_mask: torch.Tensor | None = None,
                 feature_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Time and feature span masking of ``hidden`` [B, L, D] (training only).

    ``time_mask`` [B, L] / ``feature_mask`` [B, D] replace the drawn masks
    (each still applies only where its probability is > 0)."""
    B, L, D = hidden.shape
    out = hidden
    if mask_time_prob > 0.0:
        tmask = time_mask if time_mask is not None else span_mask(
            generator, (B, L), mask_time_prob, mask_time_length)
        tmask = tmask.to(hidden.device)
        if lengths is not None:
            tmask = tmask & (torch.arange(L, device=hidden.device)[None, :] < lengths[:, None])
        fill = (mask_embedding.to(hidden.dtype)[None, None, :] if mask_embedding is not None
                else torch.zeros((), dtype=hidden.dtype, device=hidden.device))
        out = torch.where(tmask[:, :, None], fill, out)
    if mask_feature_prob > 0.0:
        fmask = feature_mask if feature_mask is not None else span_mask(
            generator, (B, D), mask_feature_prob, mask_feature_length)
        out = torch.where(fmask.to(hidden.device)[:, None, :],
                          torch.zeros((), dtype=hidden.dtype, device=hidden.device), out)
    return out
