"""Windowed-sinc resampling as one strided convolution (counterpart of
``stutter_tpu/ops/resample.py``).

The reference resamples with ``torchaudio.transforms.Resample``
(``sinc_interp_hann``, lowpass_filter_width=6, rolloff=0.99). The kernel is
built in numpy as the JAX package builds it, and applied as one strided
``conv1d`` with ``[new, 1, K]`` weights: every polyphase output phase is one
output channel, batched over clips, on the input's device. The convolution
runs in full f32 (``no_tf32``): cuDNN would take TF32 by default, where the
JAX package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch.ops.precision import no_tf32


@functools.lru_cache(maxsize=64)
def resample_kernel_weights(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                            rolloff: float = 0.99) -> tuple[np.ndarray, int, int, int]:
    """Polyphase sinc kernel for orig_freq -> new_freq.

    Returns (kernel [new, 1, K] float32, width, orig, new) where orig/new are
    the gcd-reduced rates and K = 2*width + orig. The array is shared by every
    caller: do not write to it."""
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64) / orig  # [K]
    t = (-np.arange(new, dtype=np.float64) / new)[:, None] + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    scale = base_freq / orig
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = (kernel * window * scale).astype(np.float32)
    return kernel[:, None, :], width, orig, new


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample [..., T] float32 from orig_freq to new_freq on its device.

    torchaudio's ``sinc_interp_hann`` semantics: output length
    ``ceil(new_freq * T / orig_freq)``."""
    if orig_freq == new_freq:
        return waveform
    kernel, width, orig, new = resample_kernel_weights(orig_freq, new_freq,
                                                       lowpass_filter_width, rolloff)
    batch_shape, length = waveform.shape[:-1], waveform.shape[-1]
    x = waveform.reshape(-1, 1, length).float()
    x = F.pad(x, (width, width + orig))
    with no_tf32():
        y = F.conv1d(x, torch.from_numpy(kernel).to(x.device), stride=orig)  # [B, new, frames]
    y = y.transpose(1, 2).reshape(len(y), -1)  # interleave the phases
    target_len = int(math.ceil(new * length / orig))
    return y[:, :target_len].reshape(*batch_shape, target_len)
