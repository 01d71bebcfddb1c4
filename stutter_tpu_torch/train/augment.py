"""Audio augmentation for minority-class re-extraction (counterpart of
``stutter_tpu/train/augment.py``).

Two profiles, the reference's two variants:
- 'balanced' (``model_training_01.py:140-192``): speed (a 0.9-1.1x resample
  round trip), gaussian noise (0.005-0.02), pitch shift (+-2 semitones) or
  volume (0.8-1.2x);
- 'conservative' (``model_training_1.py:167-214``): speed 0.95-1.05, noise
  0.001-0.005, volume 0.9-1.1 or 'none'; no pitch.

The draws are the JAX package's: ``random.Random`` picks the kind and the
factors, and the noise comes from ``np.random.RandomState`` seeded by that
``Random``, so one seed gives the same augmentation in both packages. Speed
factors snap to a 9-point grid and DSP inputs are zero-padded to multiples
of 0.5 s, which bounds the shapes the resample and pitch kernels see. The
resample and pitch DSP run on the device the caller names (the card by
default). The output is clamped to [-1, 1], as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random

import numpy as np
import torch

from stutter_tpu_torch.ops.pitch import pitch_shift
from stutter_tpu_torch.ops.resample import resample

logger = logging.getLogger("stutter_tpu_torch.train.augment")

# DSP inputs are zero-padded up to a multiple of this many samples (0.5 s at
# 16 kHz); only the last ~filter width of true samples sees the padding
DSP_LENGTH_QUANTUM = 8000
# speed factors snap to this many evenly spaced points of the profile's range
SPEED_GRID_POINTS = 9


def _snap_speed(f: float, lo: float, hi: float) -> float:
    grid = np.linspace(lo, hi, SPEED_GRID_POINTS)
    return float(grid[int(np.argmin(np.abs(grid - f)))])


def _pad_quantum(x: np.ndarray) -> np.ndarray:
    padded = max(DSP_LENGTH_QUANTUM,
                 int(math.ceil(len(x) / DSP_LENGTH_QUANTUM)) * DSP_LENGTH_QUANTUM)
    return np.pad(x, (0, padded - len(x))) if padded != len(x) else x


def _resampled_len(length: int, orig_freq: int, new_freq: int) -> int:
    g = math.gcd(orig_freq, new_freq)
    return int(math.ceil((new_freq // g) * length / (orig_freq // g)))


def _run_dsp(fn, x: np.ndarray, device) -> np.ndarray:
    """``fn`` on the quantum-padded clip, on ``device``; the result on the host."""
    xp = torch.from_numpy(_pad_quantum(np.asarray(x, np.float32))).to(device)
    return fn(xp).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    kinds: tuple[str, ...]
    speed_range: tuple[float, float]
    noise_range: tuple[float, float]
    volume_range: tuple[float, float]
    pitch_steps: int = 2

    @staticmethod
    def balanced() -> "AugmentConfig":
        return AugmentConfig(kinds=("speed", "noise", "pitch", "volume"),
                             speed_range=(0.9, 1.1), noise_range=(0.005, 0.02),
                             volume_range=(0.8, 1.2))

    @staticmethod
    def conservative() -> "AugmentConfig":
        return AugmentConfig(kinds=("speed", "noise", "volume", "none"),
                             speed_range=(0.95, 1.05), noise_range=(0.001, 0.005),
                             volume_range=(0.9, 1.1))


def augment_audio(waveform: np.ndarray, sample_rate: int = 16000,
                  augmentation_type: str = "random", config: AugmentConfig | None = None,
                  rng: random.Random | None = None,
                  device: torch.device | str = "cuda") -> np.ndarray:
    """Apply one augmentation (a random kind of the profile by default);
    returns float32 in [-1, 1].

    An unknown ``augmentation_type`` logs a warning and returns the input
    unchanged, the reference's fallback. Unlike the JAX package, which falls
    back on any exception, an error of the resample or pitch DSP (a CUDA
    error among them) propagates."""
    cfg = config or AugmentConfig.balanced()
    r = rng or random
    x = np.asarray(waveform, np.float32)
    if augmentation_type == "random":
        augmentation_type = r.choice(list(cfg.kinds))
    if augmentation_type == "speed":
        # the reference's same-length round trip sr -> ~sr*f -> sr
        # (model_training_01.py:158-164), the factor snapped to the grid and
        # the intermediate rate to 50 Hz: a bare int() can give a rate coprime
        # with sr, whose gcd-reduced kernel is ~1 GB
        f = _snap_speed(r.uniform(*cfg.speed_range), *cfg.speed_range)
        new_sr = max(50, int(round(sample_rate * f / 50.0)) * 50)
        if new_sr == sample_rate:
            y = x
        else:
            sr = sample_rate
            y = _run_dsp(lambda xp: resample(resample(xp, sr, new_sr), new_sr, sr), x, device)
            y = y[: _resampled_len(_resampled_len(len(x), sr, new_sr), new_sr, sr)]
    elif augmentation_type == "noise":
        nf = r.uniform(*cfg.noise_range)
        noise_rng = np.random.RandomState(r.randrange(2**32))
        y = x + noise_rng.randn(*x.shape).astype(np.float32) * nf
    elif augmentation_type == "pitch":
        n_steps = r.randint(-cfg.pitch_steps, cfg.pitch_steps)
        if n_steps == 0:
            y = x
        else:
            y = _run_dsp(lambda xp: pitch_shift(xp, sample_rate, n_steps), x, device)[: len(x)]
    elif augmentation_type == "volume":
        y = x * r.uniform(*cfg.volume_range)
    elif augmentation_type == "none":
        y = x
    else:
        logger.warning("augmentation failed: unknown augmentation %r. Returning original audio.",
                       augmentation_type)
        return x
    return np.clip(y, -1.0, 1.0).astype(np.float32)
