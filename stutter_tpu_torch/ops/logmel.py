"""Whisper's log-mel frontend: the hand-written CUDA kernel and its plain version.

Counterpart of ``stutter_tpu/ops/logmel.py`` (the constants, the DFT basis,
the mel matrix, ``pad_or_trim`` and the plain f32 frontend) and of
``stutter_tpu/ops/logmel_pallas.py`` (the fused kernel). The contract is
HF's ``WhisperFeatureExtractor``: Hann STFT with n_fft 400 and hop 160,
centre reflect padding, the last frame dropped, slaney mels over 0-8 kHz,
``log10(max(., 1e-10))``, a floor at each clip's max - 8, then (x + 4) / 4.

``whisper_log_mel`` launches ``csrc/logmel.cu`` for CUDA tensors (counted
once a call in ``whisper_log_mel.launches``; a call is two kernel launches:
the features, then each clip's floor and affine in place); for CPU tensors
it runs ``log_mel_spectrogram_reference``, the plain version, which the
tests and the on-card comparison also use.

The kernel computes each frame by a real FFT (a 200-point complex FFT of the
even and odd samples in Stockham stages of ``FFT_RADICES``, then the
real-split step) and multiplies only the mel bank's nonzero taps; its tables
(``fft_tables``, ``mel_taps``) are made here in float64 and rounded once to
f32. It reads the unpadded wave and reflects the ends itself
(``reflect_index`` is its rule).

Both products stay in full f32 (the JAX package runs them at
``Precision.HIGHEST``): quiet frames rely on cancellation that bf16 or TF32
loses. The plain version frames with ``unfold`` and multiplies with f32
``matmul`` under ``no_tf32``; a ``conv1d`` would go through cuDNN, which
defaults to TF32. Given a float64 wave it computes in float64 throughout,
with float64 tables: the exact log-mel that the kernel is also held to.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from stutter_tpu_torch.ops.mel import mel_filter_bank
from stutter_tpu_torch.ops.precision import no_tf32

WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_N_MELS = 80
WHISPER_SR = 16000
WHISPER_CHUNK_S = 30
WHISPER_N_SAMPLES = WHISPER_SR * WHISPER_CHUNK_S  # 480_000
WHISPER_N_FRAMES = WHISPER_N_SAMPLES // WHISPER_HOP  # 3000
MAX_MELS = 128  # the kernel's limit (large-v3 has 128)
FFT_RADICES = (8, 5, 5)  # the kernel's Stockham stages of its 200-point complex FFT
TILE_FRAMES = 16  # frames a block of the kernel computes
N_TILES = -(-WHISPER_N_FRAMES // TILE_FRAMES)  # 188 blocks a clip


def _hann_periodic(n: int) -> np.ndarray:
    # Periodic hann, matching HF window_function / torch.hann_window.
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


@functools.lru_cache(maxsize=4)
def _dft_basis64(n_fft: int) -> np.ndarray:
    """Windowed real-DFT basis in float64, shape [2 * (n_fft//2 + 1), 1, n_fft].

    Row k is window * cos(2 pi k n / N); row n_bins + k is -window * sin(...).
    Power spectrum = cos_part^2 + sin_part^2 (sign of sin irrelevant).
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    win = _hann_periodic(n_fft)[None, :]
    basis = np.concatenate([np.cos(ang) * win, -np.sin(ang) * win], axis=0)
    return basis[:, None, :]


@functools.lru_cache(maxsize=4)
def _dft_basis(n_fft: int) -> np.ndarray:
    """``_dft_basis64`` rounded to float32."""
    return _dft_basis64(n_fft).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _whisper_mel_matrix(n_fft: int, n_mels: int, sr: int, dtype=np.float32) -> np.ndarray:
    return mel_filter_bank(
        num_frequency_bins=n_fft // 2 + 1,
        num_mel_filters=n_mels,
        min_frequency=0.0,
        max_frequency=float(sr) / 2.0,
        sampling_rate=sr,
        norm="slaney",
        dtype=dtype,
    )


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device, n_mels: int,
               dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(basis [400, 402], mel matrix [201, n_mels]), f32 (or float64, from
    the unrounded tables) and contiguous on device."""
    wide = dtype == torch.float64
    basis = _dft_basis64(WHISPER_N_FFT) if wide else _dft_basis(WHISPER_N_FFT)
    basis = np.ascontiguousarray(basis[:, 0, :].T)
    mel = _whisper_mel_matrix(WHISPER_N_FFT, n_mels, WHISPER_SR,
                              np.float64 if wide else np.float32)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


@functools.lru_cache(maxsize=1)
def fft_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's FFT tables, made in float64 and rounded once to f32: the
    periodic Hann window [400] and the twiddles [400, 2], (cos, sin) of
    2 pi m / 400 (the kernel multiplies by cos - i sin)."""
    ang = 2.0 * np.pi * np.arange(WHISPER_N_FFT) / WHISPER_N_FFT
    twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return _hann_periodic(WHISPER_N_FFT).astype(np.float32), twiddles.astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_taps(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The mel bank's nonzero taps as the kernel reads them: (weights f32,
    index int32 [2 * n_mels + 1]). Filter m's weights are
    ``weights[index[m]:index[m + 1]]``, for the consecutive bins from
    ``index[n_mels + 1 + m]`` on; they are the entries of
    ``_whisper_mel_matrix`` (made in float64, rounded once)."""
    fb = _whisper_mel_matrix(WHISPER_N_FFT, n_mels, WHISPER_SR)
    weights, offsets, first = [], [0], []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        weights.append(fb[lo:hi, m])
        offsets.append(offsets[-1] + hi - lo)
        first.append(lo)
    return np.concatenate(weights).astype(np.float32), np.array(offsets + first, np.int32)


def reflect_index(s: np.ndarray) -> np.ndarray:
    """The kernel's rule for sample s of the centre-padded wave (s = padded
    index - 200): its index into the unpadded clip, reflected at both ends
    without repeating the edge sample, as ``_reflect_pad`` pads."""
    s = np.abs(s)
    return np.where(s < WHISPER_N_SAMPLES, s, 2 * (WHISPER_N_SAMPLES - 1) - s)


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: torch.device, n_mels: int) -> tuple[torch.Tensor, ...]:
    """(window, twiddles, tap weights, tap index) on device."""
    return tuple(torch.from_numpy(t).to(device) for t in (*fft_tables(), *mel_taps(n_mels)))


def pad_or_trim(waveform: torch.Tensor, n_samples: int = WHISPER_N_SAMPLES) -> torch.Tensor:
    """Pad with zeros / trim the last axis to exactly n_samples (HF pad/trim to 30 s)."""
    t = waveform.shape[-1]
    if t >= n_samples:
        return waveform[..., :n_samples]
    return F.pad(waveform, (0, n_samples - t))


def _reflect_pad(waveform: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T + n_fft] f32 (float64 stays), centre reflect padding
    (torch.stft's)."""
    pad = WHISPER_N_FFT // 2
    wave = waveform if waveform.dtype == torch.float64 else waveform.float()
    return F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]


def _floor_affine(log_spec: torch.Tensor) -> torch.Tensor:
    """[B, F, n_mels] log10 mel -> [B, n_mels, F] features: each clip floored
    at its max - 8, then (x + 4) / 4."""
    clip_max = log_spec.amax(dim=(1, 2), keepdim=True)
    out = (torch.maximum(log_spec, clip_max - 8.0) + 4.0) / 4.0
    return out.transpose(1, 2).contiguous()


def log_mel_spectrogram_reference(waveform: torch.Tensor,
                                  n_mels: int = WHISPER_N_MELS) -> torch.Tensor:
    """Plain version: [B, T] -> [B, n_mels, T // 160] f32 (float64 for a
    float64 wave), every product in full f32 (the [B, F, 402] spectrum is
    materialised)."""
    dtype = torch.float64 if waveform.dtype == torch.float64 else torch.float32
    basis, mel_m = _constants(waveform.device, n_mels, dtype)
    frames = _reflect_pad(waveform).unfold(-1, WHISPER_N_FFT, WHISPER_HOP)[:, :-1]
    n_bins = WHISPER_N_FFT // 2 + 1
    with no_tf32():
        spec = torch.matmul(frames, basis)  # [B, F, 402]
        power = spec[..., :n_bins].square() + spec[..., n_bins:].square()
        mel = torch.matmul(power, mel_m)
    return _floor_affine(torch.log10(torch.clamp(mel, min=1e-10)))


def _check(waveform: torch.Tensor, n_mels: int) -> None:
    if waveform.dim() != 2 or waveform.shape[1] != WHISPER_N_SAMPLES:
        raise ValueError(f"the kernel takes [B, {WHISPER_N_SAMPLES}] waves (pad_or_trim "
                         f"first), got shape {tuple(waveform.shape)}")
    if waveform.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 waves, got {waveform.dtype}")
    if not 1 <= waveform.shape[0] <= 65535:
        raise ValueError(f"the kernel takes 1 to 65535 clips, got {waveform.shape[0]}")
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"the kernel takes 1 to {MAX_MELS} mel bins, got {n_mels}")


def whisper_log_mel(waveform: torch.Tensor, n_mels: int = WHISPER_N_MELS) -> torch.Tensor:
    """[B, 480000] f32 waves -> [B, n_mels, 3000] Whisper input features."""
    if waveform.device.type == "cpu":
        return log_mel_spectrogram_reference(waveform, n_mels)
    if waveform.device.type != "cuda":
        raise ValueError(f"no kernel for device {waveform.device}")
    _check(waveform, n_mels)
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    x = waveform.contiguous()
    if x.data_ptr() % 16:  # the kernel stages the samples with 16-byte copies
        x = x.clone()
    window, twiddles, taps, tap_index = _kernel_tables(waveform.device, n_mels)
    B = waveform.shape[0]
    out = torch.empty((B, n_mels, WHISPER_N_FRAMES), dtype=torch.float32,
                      device=waveform.device)
    block_max = torch.empty((B, N_TILES), dtype=torch.float32, device=waveform.device)
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream(waveform.device).cuda_stream
        rc = lib.whisper_log_mel(x.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
                                 taps.data_ptr(), tap_index.data_ptr(), out.data_ptr(),
                                 block_max.data_ptr(), B, n_mels, stream)
    if rc != 0:
        raise RuntimeError(f"whisper_log_mel launch failed: CUDA error {rc}")
    whisper_log_mel.launches += 1
    return out


whisper_log_mel.launches = 0
