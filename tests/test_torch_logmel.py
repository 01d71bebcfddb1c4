"""stutter_tpu_torch's Whisper log-mel frontend against the JAX package, on the CPU.

The constants (DFT basis, mel banks) must be equal element for element; the
plain f32 frontend must match both the JAX XLA path and the Pallas kernel
(interpret mode, as tests/test_pallas_kernels.py runs it) to 1e-4 max-abs,
the JAX package's own bar for its kernel. The CUDA kernel itself runs only
on the card: chip_smoke.py holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.frontend.whisper_frontend import whisper_features as jax_features
from stutter_tpu.ops import logmel as jlogmel
from stutter_tpu.ops import mel as jmel
from stutter_tpu.ops.logmel_pallas import whisper_log_mel_pallas
from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
from stutter_tpu_torch.ops import logmel, mel

torch.set_num_threads(2)  # six xdist workers share the host

MAX_ABS = 1e-4  # tests/test_pallas_kernels.py's bar for the Pallas kernel


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bank_exact(n_mels):
    ours = mel.mel_filter_bank(201, n_mels, 0.0, 8000.0, 16000, norm="slaney")
    ref = jmel.mel_filter_bank(201, n_mels, 0.0, 8000.0, 16000, norm="slaney")
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (201, n_mels)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(logmel._whisper_mel_matrix(400, n_mels, 16000),
                                  jlogmel._whisper_mel_matrix(400, n_mels, 16000))


def test_dft_basis_and_constants_exact():
    np.testing.assert_array_equal(logmel._hann_periodic(400), jlogmel._hann_periodic(400))
    ours, ref = logmel._dft_basis(400), jlogmel._dft_basis(400)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (402, 1, 400)
    np.testing.assert_array_equal(ours, ref)
    basis, mel_m = logmel._constants(torch.device("cpu"), 80)
    np.testing.assert_array_equal(basis.numpy(), ref[:, 0, :].T)
    assert basis.is_contiguous() and mel_m.shape == (201, 80)
    for name in ("WHISPER_N_FFT", "WHISPER_HOP", "WHISPER_N_MELS", "WHISPER_SR",
                 "WHISPER_N_SAMPLES", "WHISPER_N_FRAMES"):
        assert getattr(logmel, name) == getattr(jlogmel, name)


def _clips(seed: int) -> np.ndarray:
    """Three 30 s clips: silent, quiet (peak 1e-3), 2 s of audio then zeros."""
    r = np.random.RandomState(seed)
    t = np.arange(480_000) / 16000.0
    w = np.zeros((3, 480_000), np.float32)
    quiet = 0.3 * r.randn(480_000) + np.sin(2 * np.pi * 440 * t)
    w[1] = 1e-3 * quiet / np.abs(quiet).max()
    w[2, :32_000] = 0.1 * r.randn(32_000) + 0.3 * np.sin(2 * np.pi * 220 * t[:32_000])
    return w


@pytest.mark.parametrize("n_mels", [80, 128])
def test_reference_matches_pallas_and_xla(n_mels):
    w = _clips(n_mels)
    ours = logmel.log_mel_spectrogram_reference(_t(w), n_mels).numpy()
    pallas = np.asarray(whisper_log_mel_pallas(jnp.asarray(w), interpret=True, n_mels=n_mels))
    xla = np.asarray(jlogmel.log_mel_spectrogram(jnp.asarray(w), n_mels=n_mels))
    assert ours.shape == pallas.shape == (3, n_mels, 3000) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[0], np.full((n_mels, 3000), -1.5, np.float32))
    np.testing.assert_allclose(ours, pallas, atol=MAX_ABS, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=MAX_ABS, rtol=0)


@pytest.mark.parametrize("n_samples", [32_000, 480_000, 500_000])
def test_whisper_features_matches_jax(rng, n_samples):
    w = (rng.randn(2, n_samples) * 0.2).astype(np.float32)
    w[1, n_samples // 3:] = 0.0
    ours = whisper_features(_t(w)).numpy()
    ref = np.asarray(jax_features(jnp.asarray(w)))
    assert ours.shape == ref.shape == (2, 80, 3000)
    np.testing.assert_allclose(ours, ref, atol=MAX_ABS, rtol=0)


def test_pad_or_trim_matches_jax(rng):
    for n in (100, 480_000, 480_123):
        w = rng.randn(2, n).astype(np.float32)
        ours = logmel.pad_or_trim(_t(w), 480_000).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jlogmel.pad_or_trim(jnp.asarray(w))))


def test_batched_equals_per_clip():
    w = _clips(3)
    batched = logmel.log_mel_spectrogram_reference(_t(w)).numpy()
    for b in range(3):
        alone = logmel.log_mel_spectrogram_reference(_t(w[b:b + 1])).numpy()
        np.testing.assert_allclose(batched[b], alone[0], atol=1e-6, rtol=0)


def test_cpu_wrapper_leaves_launches_at_zero(rng):
    w = _t((rng.randn(1, 480_000) * 0.1).astype(np.float32))
    out = logmel.whisper_log_mel(w, n_mels=128)
    assert out.shape == (1, 128, 3000)
    whisper_features(w[:, :16_000])
    assert logmel.whisper_log_mel.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        logmel.whisper_log_mel(torch.empty(1, 480_000, device="meta"))


@pytest.mark.parametrize("fault", ["length", "rank", "dtype", "too_many_mels", "no_mels"])
def test_kernel_input_checks(fault):
    w, n_mels = torch.zeros(2, 480_000), 80
    if fault == "length":
        w = torch.zeros(2, 479_999)
    elif fault == "rank":
        w = torch.zeros(2, 1, 480_000)
    elif fault == "dtype":
        w = w.double()
    elif fault == "too_many_mels":
        n_mels = 129
    else:
        n_mels = 0
    with pytest.raises((ValueError, TypeError)):
        logmel._check(w, n_mels)
    logmel._check(torch.zeros(2, 480_000), 128)  # the large-v3 shape is taken
