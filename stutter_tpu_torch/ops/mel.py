"""Slaney-style mel filter bank in numpy (copy of ``stutter_tpu/ops/mel.py``).

The filter bank that Whisper's log-mel frontend multiplies its power
spectrum by: 201 frequency bins, 80 (or 128) mel filters over 0-8 kHz,
slaney scale and slaney area normalisation, as HF's
``WhisperFeatureExtractor`` builds it. Computed once on the host in float64
and cast to float32; the tests hold it equal, element for element, to the
JAX package's.
"""

from __future__ import annotations

import numpy as np

# Slaney scale constants: linear below 1 kHz, logarithmic above.
_MEL_BREAK_HZ = 1000.0
_MEL_BREAK = 15.0  # mel value at 1 kHz: 3 * 1000 / 200
_LOGSTEP = 27.0 / np.log(6.4)


def hertz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= _MEL_BREAK_HZ
    # np.where evaluates both branches; silence log(0) for the linear region.
    with np.errstate(divide="ignore", invalid="ignore"):
        log_mels = _MEL_BREAK + np.log(freq / _MEL_BREAK_HZ) * _LOGSTEP
    return np.where(log_region, log_mels, mels)


def mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= _MEL_BREAK
    return np.where(log_region, _MEL_BREAK_HZ * np.exp((mels - _MEL_BREAK) / _LOGSTEP), freq)


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filter bank, shape ``[num_frequency_bins, num_mel_filters]``."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = hertz_to_mel(min_frequency)
    mel_max = hertz_to_mel(max_frequency)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz(mel_pts)

    # Triangular filters expressed via slope differences.
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        fb *= enorm[np.newaxis, :]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm!r}")

    return fb.astype(dtype)
