"""The host side of the port's FFT log-mel kernel, on the CPU.

``csrc/logmel.cu`` computes each frame by a 200-point complex FFT of the
even and odd windowed samples, in Stockham stages of radix 8, 5 and 5, then
the real-split step, the power of the 201 bins and only the mel bank's
nonzero taps; it reflects the wave's ends itself. The kernel runs only on
the card (chip_smoke.py holds it against the plain version there), so this
file checks what it is built from: the f32 tables made on the host in
float64, the sparse taps against the dense mel matrix, its reflection rule
against ``_reflect_pad``, and a torch model of its radix plan, written here
from those tables with the kernel's butterflies, against the JAX package's
Pallas kernel (interpret mode) and XLA path at the JAX package's 1e-4 bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.ops import logmel as jlogmel
from stutter_tpu.ops.logmel_pallas import whisper_log_mel_pallas
from stutter_tpu_torch.ops import logmel

torch.set_num_threads(2)  # six xdist workers share the host

MAX_ABS = 1e-4  # tests/test_pallas_kernels.py's bar for the Pallas kernel


def test_fft_tables_are_float64_rounded_once():
    window, twiddles = logmel.fft_tables()
    assert window.dtype == twiddles.dtype == np.float32
    assert window.shape == (400,) and twiddles.shape == (400, 2)
    np.testing.assert_array_equal(window, jlogmel._hann_periodic(400).astype(np.float32))
    ang = 2.0 * np.pi * np.arange(400, dtype=np.float64) / 400.0
    np.testing.assert_array_equal(twiddles[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(twiddles[:, 1], np.sin(ang).astype(np.float32))
    # the f32 angle would round differently: the table is not made in f32
    ang32 = (np.float32(2.0 * np.pi) * np.arange(400, dtype=np.float32)) / np.float32(400)
    assert np.any(np.cos(ang32).astype(np.float32) != twiddles[:, 0])
    assert logmel.FFT_RADICES == (8, 5, 5) and np.prod(logmel.FFT_RADICES) == 200


@pytest.mark.parametrize("n_mels", [80, 128])
def test_taps_rebuild_the_mel_matrix(n_mels):
    weights, index = logmel.mel_taps(n_mels)
    assert weights.dtype == np.float32 and index.dtype == np.int32
    assert index.shape == (2 * n_mels + 1,) and index[0] == 0 and index[n_mels] == weights.size
    dense = np.zeros((201, n_mels), np.float32)
    per_bin = np.zeros(201, int)
    for m in range(n_mels):
        run = weights[index[m]:index[m + 1]]
        first = index[n_mels + 1 + m]
        dense[first:first + run.size, m] = run
        per_bin[first:first + run.size] += 1
        assert run.size > 0 and np.all(run > 0)
    ref = jlogmel._whisper_mel_matrix(400, n_mels, 16000)
    np.testing.assert_array_equal(dense, ref)
    np.testing.assert_array_equal(dense, logmel._whisper_mel_matrix(400, n_mels, 16000))
    assert weights.size == np.count_nonzero(ref)
    assert per_bin.max() <= 2


def test_reflect_index_equals_reflect_pad():
    wave = np.random.RandomState(1).randn(1, 480_000).astype(np.float32)
    padded = logmel._reflect_pad(torch.from_numpy(wave)).numpy()[0]
    for lo, hi in ((0, 600), (479_600, 480_400)):  # both ends and a margin inside
        s = np.arange(lo, hi) - 200
        np.testing.assert_array_equal(wave[0, logmel.reflect_index(s)], padded[lo:hi])
    # the last tile's frames past 3000 read past the padded end: still inside the clip
    s = np.arange(480_400, 160 * (logmel.N_TILES * logmel.TILE_FRAMES - 1) + 400) - 200
    assert np.all((logmel.reflect_index(s) >= 0) & (logmel.reflect_index(s) < 480_000))


# The kernel's arithmetic, on [..., n] pairs of real and imaginary tensors.

def _twiddle(vr, vi, c, s):  # (vr + i vi)(c - i s)
    return vr * c + vi * s, vi * c - vr * s


def _fft4(a):
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i) = a
    t0 = (a0r + a2r, a0i + a2i)
    t1 = (a0r - a2r, a0i - a2i)
    t2 = (a1r + a3r, a1i + a3i)
    t3 = (a1r - a3r, a1i - a3i)
    return [(t0[0] + t2[0], t0[1] + t2[1]), (t1[0] + t3[1], t1[1] - t3[0]),
            (t0[0] - t2[0], t0[1] - t2[1]), (t1[0] - t3[1], t1[1] + t3[0])]


def _fft8(v, h):
    a = _fft4(v[0::2])
    c = _fft4(v[1::2])
    c = [c[0], ((c[1][0] + c[1][1]) * h, (c[1][1] - c[1][0]) * h), (c[2][1], -c[2][0]),
         ((c[3][1] - c[3][0]) * h, -(c[3][0] + c[3][1]) * h)]
    return ([(a[k][0] + c[k][0], a[k][1] + c[k][1]) for k in range(4)]
            + [(a[k][0] - c[k][0], a[k][1] - c[k][1]) for k in range(4)])


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _sc(s, a):
    return s * a[0], s * a[1]


def _fft5(v, c1, s1, c2, s2):
    a1, b1, a2, b2 = _add(v[1], v[4]), _sub(v[1], v[4]), _add(v[2], v[3]), _sub(v[2], v[3])
    t1 = _add(_add(v[0], _sc(c1, a1)), _sc(c2, a2))
    t2 = _add(_add(v[0], _sc(c2, a1)), _sc(c1, a2))
    u1 = _add(_sc(s1, b1), _sc(s2, b2))
    u2 = _sub(_sc(s2, b1), _sc(s1, b2))
    return [_add(_add(v[0], a1), a2), (t1[0] + u1[1], t1[1] - u1[0]),
            (t2[0] + u2[1], t2[1] - u2[0]), (t2[0] - u2[1], t2[1] + u2[0]),
            (t1[0] - u1[1], t1[1] + u1[0])]


def _kernel_model(wave: np.ndarray, n_mels: int) -> np.ndarray:
    """The kernel's plan in f32: reflected frames, the window, Stockham
    stages of radix 8, 5, 5 (twiddles tw[400 q r / (R Ns)]), the real split,
    the power, the sparse taps in bin order, log10, the floor and affine."""
    window, tw = (torch.from_numpy(t) for t in logmel.fft_tables())
    taps, index = logmel.mel_taps(n_mels)
    s = np.arange(3000)[:, None] * 160 + np.arange(400)[None, :] - 200
    xw = torch.from_numpy(wave[:, logmel.reflect_index(s)]) * window  # [B, 3000, 400]
    zr, zi = xw[..., 0::2], xw[..., 1::2]
    h = float(tw[50, 0])
    c1, s1, c2, s2 = float(tw[80, 0]), float(tw[80, 1]), float(tw[160, 0]), float(tw[160, 1])
    ns = 1
    for radix in logmel.FFT_RADICES:
        j = torch.arange(200 // radix)
        v = []
        for r in range(radix):
            vr, vi = zr[..., j + r * (200 // radix)], zi[..., j + r * (200 // radix)]
            if ns > 1:
                m = (400 // (radix * ns)) * r * (j % ns)
                vr, vi = _twiddle(vr, vi, tw[m, 0], tw[m, 1])
            v.append((vr, vi))
        v = _fft8(v, h) if radix == 8 else _fft5(v, c1, s1, c2, s2)
        dest = (j // ns) * radix * ns + j % ns
        nr, ni = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(radix):
            nr[..., dest + ns * r], ni[..., dest + ns * r] = v[r]
        zr, zi, ns = nr, ni, ns * radix
    k = torch.arange(201)
    ka, kb = k % 200, (200 - k) % 200
    ar, ai, br, bi = zr[..., ka], zi[..., ka], zr[..., kb], zi[..., kb]
    er, ei, orr, oi = 0.5 * (ar + br), 0.5 * (ai - bi), 0.5 * (ai + bi), -0.5 * (ar - br)
    xr = er + (tw[k, 0] * orr + tw[k, 1] * oi)
    xi = ei + (tw[k, 0] * oi - tw[k, 1] * orr)
    power = xr * xr + xi * xi  # [B, 3000, 201]
    mel = torch.zeros(*power.shape[:2], n_mels)
    for m in range(n_mels):
        first = index[n_mels + 1 + m]
        acc = torch.zeros(power.shape[:2])
        for o in range(index[m], index[m + 1]):
            acc = acc + power[..., first + o - index[m]] * float(taps[o])
        mel[..., m] = acc
    v = torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)
    clip_max = v.amax(dim=(1, 2), keepdim=True)
    return ((torch.maximum(v, clip_max - 8.0) + 4.0) / 4.0).numpy()


def _clips() -> np.ndarray:
    """Noise, a pure tone, a silent clip, a clip of peak 1e-3, 2 s then zeros."""
    r = np.random.RandomState(7)
    t = np.arange(480_000) / 16000.0
    w = np.zeros((5, 480_000), np.float32)
    w[0] = 0.1 * r.randn(480_000)
    w[1] = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    quiet = 0.3 * r.randn(480_000) + np.sin(2 * np.pi * 330 * t)
    w[3] = 1e-3 * quiet / np.abs(quiet).max()
    w[4, :32_000] = 0.1 * r.randn(32_000) + 0.3 * np.sin(2 * np.pi * 220 * t[:32_000])
    return w


@pytest.mark.parametrize("n_mels", [80, 128])
def test_radix_plan_matches_pallas_and_xla(n_mels):
    w = _clips()
    ours = _kernel_model(w, n_mels)
    pallas = np.asarray(whisper_log_mel_pallas(jnp.asarray(w), interpret=True, n_mels=n_mels))
    xla = np.asarray(jlogmel.log_mel_spectrogram(jnp.asarray(w), n_mels=n_mels))
    assert ours.shape == pallas.shape == (5, n_mels, 3000) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[2], np.full((n_mels, 3000), -1.5, np.float32))
    np.testing.assert_allclose(ours, pallas, atol=MAX_ABS, rtol=0)
    np.testing.assert_allclose(ours, xla, atol=MAX_ABS, rtol=0)
    # and the exact log-mel: the plain version in float64
    exact = logmel.log_mel_spectrogram_reference(torch.from_numpy(w).double(), n_mels).numpy()
    print(f"n_mels {n_mels}: model vs float64 {np.abs(ours - exact).max():.3e}, "
          f"vs Pallas {np.abs(ours - pallas).max():.3e}")
    np.testing.assert_allclose(ours, exact, atol=MAX_ABS, rtol=0)


def test_float64_reference_is_float64():
    w = _clips()[:2, :]
    exact = logmel.log_mel_spectrogram_reference(torch.from_numpy(w).double(), 80)
    plain = logmel.log_mel_spectrogram_reference(torch.from_numpy(w), 80)
    assert exact.dtype == torch.float64 and plain.dtype == torch.float32
    assert float((exact - plain.double()).abs().max()) <= MAX_ABS
