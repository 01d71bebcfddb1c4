"""WavLM waveform frontend: per-clip zero-mean / unit-variance norm.

Counterpart of ``stutter_tpu/frontend/wavlm_frontend.py``: the statistics of
each clip are taken over its true (unpadded) length with variance epsilon
1e-7, and padding is zero afterwards, so a padded batch normalises each clip
as if it were alone.
"""

from __future__ import annotations

import torch

_VAR_EPS = 1e-7


def _valid_mask(waveform: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    T = waveform.shape[-1]
    return (torch.arange(T, device=waveform.device)[None, :] < lengths[:, None]).float()


def wavlm_normalize(waveform: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Masked per-clip zero-mean/unit-var norm of a padded [B, T] batch (f32)."""
    mask = _valid_mask(waveform, lengths)
    n = torch.clamp(lengths.float(), min=1.0)[:, None]
    x = waveform.float() * mask
    mean = x.sum(dim=-1, keepdim=True) / n
    centered = (waveform.float() - mean) * mask
    var = (centered * centered).sum(dim=-1, keepdim=True) / n
    return centered / torch.sqrt(var + _VAR_EPS) * mask


def wavlm_prepare_batch(waveform: torch.Tensor, lengths: torch.Tensor,
                        do_normalize: bool) -> torch.Tensor:
    """Apply the checkpoint's normalisation policy to a padded batch."""
    if do_normalize:
        return wavlm_normalize(waveform, lengths)
    return waveform.float() * _valid_mask(waveform, lengths)
