"""w2v-BERT 2.0's input frontend: a Kaldi fbank, normalised per clip, frames stacked in pairs.

HF's ``SeamlessM4TFeatureExtractor`` at its defaults, batched on the device
(the JAX package has no counterpart). For each clip of a padded [B, T] batch
(waves in [-1, 1], scaled by 2^15 as the Kaldi frontend takes 16-bit
samples):

1. frames of 400 samples every 160 (25 ms at 10 ms, no centring), 1 +
   (n - 400) // 160 of a clip of n samples;
2. each frame: its mean removed, pre-emphasis 0.97 (the first sample times
   0.03), a Povey window (Hann^0.85, symmetric), zero-padded to 512;
3. the power spectrum of its real FFT, 257 bins, times a Kaldi mel bank of
   80 filters over 20-8000 Hz (``ops.mel.kaldi_mel_filter_bank``, built once
   on the host), floored at 1.1920929e-7, then the natural log;
4. each mel bin normalised over the clip's own frames: mean, and variance
   with ddof 1, (x - mean) / sqrt(var + 1e-7); frames past the clip are 0;
5. frame pairs stacked into rows of 160, 20 ms each: a clip of f frames has
   f // 2 valid rows, and an odd last frame sits in a masked row beside a
   zero frame, as HF's padding to a multiple of 2 leaves it.

Everything is f32 on the device (HF computes the fbank in float64 and keeps
float32 values). A padded batch gives each clip the rows it gets alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stutter_tpu_torch.ops.mel import kaldi_mel_filter_bank
from stutter_tpu_torch.ops.precision import no_tf32

FRAME, HOP, N_FFT = 400, 160, 512
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07
VAR_EPS = 1e-7
PCM_SCALE = 2.0 ** 15


def fbank_frames(n_samples):
    """Fbank frames of a clip of ``n_samples`` (an int or an int tensor):
    1 + (n - 400) // 160, and 0 under one frame."""
    if isinstance(n_samples, torch.Tensor):
        return torch.where(n_samples >= FRAME, (n_samples - FRAME) // HOP + 1, 0)
    return (int(n_samples) - FRAME) // HOP + 1 if n_samples >= FRAME else 0


def w2v_bert_frame_lengths(n_samples, stride: int = 2):
    """The encoder's valid rows of a clip of ``n_samples``: fbank frames // stride."""
    return fbank_frames(n_samples) // stride


@functools.cache
def _constants(num_mel_bins: int, sampling_rate: int, device: str):
    n = np.arange(FRAME, dtype=np.float64)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * n / (FRAME - 1))) ** 0.85
    bank = kaldi_mel_filter_bank(N_FFT // 2 + 1, num_mel_bins, 20.0, sampling_rate // 2,
                                 sampling_rate)
    return (torch.tensor(window, dtype=torch.float32, device=device),
            torch.from_numpy(bank).to(device))


def log_mel_fbank(waves: torch.Tensor, num_mel_bins: int = 80,
                  sampling_rate: int = 16000) -> torch.Tensor:
    """[B, T] f32 waves in [-1, 1] (T >= 400) -> [B, F, num_mel_bins] f32
    Kaldi log-mel fbank of every frame of the padded batch (steps 1-3)."""
    if waves.shape[-1] < FRAME:
        raise ValueError(f"the fbank takes at least {FRAME} samples, got {waves.shape[-1]}")
    window, bank = _constants(num_mel_bins, sampling_rate, str(waves.device))
    frames = (waves.float() * PCM_SCALE).unfold(-1, FRAME, HOP)  # [B, F, 400] view
    frames = frames - frames.mean(dim=-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1.0 - PREEMPHASIS),
                        frames[..., 1:] - PREEMPHASIS * frames[..., :-1]], dim=-1) * window
    spec = torch.fft.rfft(frames, n=N_FFT)
    power = spec.real.square() + spec.imag.square()
    with no_tf32():  # energies span ~13 decades: no TF32 rounding of the mel sums
        mel = torch.matmul(power, bank)
    return mel.clamp_min(MEL_FLOOR).log()


def w2v_bert_features(waves: torch.Tensor, lengths: torch.Tensor, num_mel_bins: int = 80,
                      stride: int = 2, sampling_rate: int = 16000):
    """A padded [B, T] f32 batch in [-1, 1] and its [B] true sample counts ->
    (features [B, F // stride, num_mel_bins * stride] f32, valid rows [B]
    int64), F the batch's fbank frames."""
    mel = log_mel_fbank(waves, num_mel_bins, sampling_rate)
    B, F, _ = mel.shape
    n = fbank_frames(lengths.to(mel.device).long())
    valid = (torch.arange(F, device=mel.device)[None, :] < n[:, None]).float()[..., None]
    mean = (mel * valid).sum(dim=1, keepdim=True) / n.clamp_min(1)[:, None, None]
    centred = (mel - mean) * valid
    var = centred.square().sum(dim=1, keepdim=True) / (n - 1).clamp_min(1)[:, None, None]
    feats = centred / torch.sqrt(var + VAR_EPS)
    rows = F // stride
    feats = feats[:, : rows * stride].reshape(B, rows, num_mel_bins * stride)
    return feats, n // stride
