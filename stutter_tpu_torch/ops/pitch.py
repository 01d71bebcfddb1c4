"""Phase-vocoder pitch shift (counterpart of ``stutter_tpu/ops/pitch.py``).

The reference uses ``torchaudio.transforms.PitchShift`` (phase-vocoder time
stretch, then a resample). The same algorithm in the JAX package's order of
operations, on the input's device: an STFT by two matmuls with the windowed
Fourier bases, the phase accumulated by ``cumsum``, an overlap-add inverse
STFT with ``index_add_``, then ``ops.resample``. The matmuls run in full f32
(``no_tf32``) and the phase sum over ~560 frames in float64: the rounding
of either would grow along that sum. torchaudio's defaults: n_fft=512,
hop=n_fft//4, hann, rate = 2^(-n_steps/12).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch.ops.precision import no_tf32
from stutter_tpu_torch.ops.resample import resample


@functools.lru_cache(maxsize=4)
def _fourier_bases(n_fft: int):
    """(fwd_cos, fwd_sin [bins, n_fft], inv_cos, inv_sin [bins, n_fft], hann
    [n_fft]) float32, the JAX package's."""
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_fft // 2 + 1)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))[None, :]
    fwd_cos = (np.cos(ang) * win).astype(np.float32)
    fwd_sin = (-np.sin(ang) * win).astype(np.float32)
    # inverse: x[n] = sum_k w_k (Re X_k cos - Im X_k sin), w_k = 1/N * (1 or 2)
    scale = np.full((n_fft // 2 + 1, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    inv_cos = (np.cos(ang) * scale).astype(np.float32)
    inv_sin = (-np.sin(ang) * scale).astype(np.float32)
    return fwd_cos, fwd_sin, inv_cos, inv_sin, win[0].astype(np.float32)


def _basis(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _stft(x: torch.Tensor, n_fft: int, hop: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Centre reflect-padded STFT of [T] -> (real, imag) [F, bins]."""
    pad = n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, n_fft, hop)  # [F, n_fft]
    fwd_cos, fwd_sin, *_ = _fourier_bases(n_fft)
    with no_tf32():
        real = frames @ _basis(fwd_cos, x.device).T
        imag = frames @ _basis(fwd_sin, x.device).T
    return real, imag


def _istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
           length: int) -> torch.Tensor:
    """Overlap-add inverse STFT with the hann synthesis window and its COLA norm."""
    _, _, inv_cos, inv_sin, win = _fourier_bases(n_fft)
    device = real.device
    with no_tf32():
        frames = real @ _basis(inv_cos, device) + imag @ _basis(inv_sin, device)
    win_t = _basis(win, device)
    frames = frames * win_t[None, :]
    n_frames = frames.shape[0]
    total = n_fft + (n_frames - 1) * hop
    idx = (torch.arange(n_frames, device=device)[:, None] * hop
           + torch.arange(n_fft, device=device)[None, :]).reshape(-1)
    out = torch.zeros(total, dtype=frames.dtype, device=device).index_add_(
        0, idx, frames.reshape(-1))
    norm = torch.zeros(total, dtype=frames.dtype, device=device).index_add_(
        0, idx, (win_t * win_t).expand(n_frames, n_fft).reshape(-1))
    pad = n_fft // 2
    return out[pad: pad + length] / torch.clamp(norm[pad: pad + length], min=1e-8)


def phase_vocoder(real: torch.Tensor, imag: torch.Tensor, rate: float, hop: int,
                  n_fft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-stretch a (real, imag) STFT by ``rate`` (torchaudio semantics)."""
    n_frames, n_bins = real.shape
    device = real.device
    phase_advance = _basis(np.linspace(0, np.pi * hop, n_bins, dtype=np.float32)[None, :],
                           device)
    # the output frame positions, as jnp.arange computes them (float32 steps)
    steps = _basis(np.arange(0, n_frames, rate, dtype=np.float32), device)
    # two zero frames so that idx + 1 stays valid at the stretched tail
    zeros = torch.zeros((2, n_bins), dtype=real.dtype, device=device)
    real_p = torch.cat([real, zeros])
    imag_p = torch.cat([imag, zeros])

    idx = torch.floor(steps).long()
    frac = (steps - idx)[:, None]

    mag0 = torch.sqrt(real_p[idx] ** 2 + imag_p[idx] ** 2)
    mag1 = torch.sqrt(real_p[idx + 1] ** 2 + imag_p[idx + 1] ** 2)
    mag = (1 - frac) * mag0 + frac * mag1

    phase0 = torch.atan2(imag_p[idx], real_p[idx])
    phase1 = torch.atan2(imag_p[idx + 1], real_p[idx + 1])
    dphase = phase1 - phase0 - phase_advance
    dphase = dphase - 2 * np.pi * torch.round(dphase / (2 * np.pi))
    dphase = dphase + phase_advance

    # the output phase: the first frame's, then the accumulated advances,
    # summed in float64 on every device (PyTorch's CPU cumsum of f32 already
    # accumulates in double, its CUDA cumsum in float: the high bins' phase
    # reaches ~2e5 rad, where an f32 step is 0.016 rad)
    acc = torch.cumsum(torch.cat([phase0[0:1], dphase[:-1]]).double(), dim=0).float()
    return mag * torch.cos(acc), mag * torch.sin(acc)


def pitch_shift(waveform: torch.Tensor, sample_rate: int, n_steps: int,
                bins_per_octave: int = 12, n_fft: int = 512,
                freq_quantum: int = 50) -> torch.Tensor:
    """Shift [T] by ``n_steps`` semitones, keeping its length.

    ``freq_quantum`` snaps the intermediate resample rate to a multiple of
    itself: the exact ``int(sr / rate)`` is usually coprime with the sample
    rate (17959 against 16000 for +2 semitones), whose gcd-reduced sinc
    kernel would be ~[16000, 18000]. 50 Hz steps keep it small at <= 0.3 %
    rate error (< 0.06 semitones)."""
    if n_steps == 0:
        return waveform
    hop = n_fft // 4
    length = waveform.shape[0]
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    real, imag = _stft(waveform.float(), n_fft, hop)
    real_s, imag_s = phase_vocoder(real, imag, rate, hop, n_fft)
    y = _istft(real_s, imag_s, n_fft, hop, int(round(length / rate)))
    orig_freq = int(sample_rate / rate)
    if freq_quantum > 1:
        orig_freq = max(freq_quantum, round(orig_freq / freq_quantum) * freq_quantum)
    y = resample(y, orig_freq, sample_rate)
    # pad or trim back to the input's length (torchaudio fixes the length)
    if y.shape[0] >= length:
        return y[:length]
    return F.pad(y, (0, length - y.shape[0]))
