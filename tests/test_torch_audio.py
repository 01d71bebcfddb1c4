"""The port's native host audio runtime against the JAX package's, on the CPU.

Both packages build the same C++ sources (the port's copies) with g++: the
port's ``read_wav``, ``decode_batch`` and host resampler are held bit-equal
to JAX's on the cases of ``tests/test_audio_robustness.py`` and on a mixed
corpus; its numpy plain versions bit-equal to JAX's numpy parser; the
native resampler within 1e-4 of the port's torch ``ops.resample`` (the JAX
test's bar); ``make_synthetic_corpus`` byte for byte. The build raises
where it fails, and without libav the runtime reads WAV only.
"""

import os

import numpy as np
import pytest
import torch

from stutter_tpu.audio import wavio as jwavio
from stutter_tpu.audio.synthetic import make_synthetic_corpus as jax_corpus
from stutter_tpu_torch.audio import build
from stutter_tpu_torch.audio import wavio
from stutter_tpu_torch.audio.synthetic import make_synthetic_corpus
from stutter_tpu_torch.ops.resample import resample
from tests.test_audio_robustness import _build_wav, _encode, _write

torch.set_num_threads(2)  # six xdist workers share the host

RESAMPLE_VS_TORCH = 1e-4  # tests/test_resample.py's bar, host kernel vs the op

FORMATS = [(1, 8, 1), (1, 16, 2), (1, 24, 2), (1, 32, 1), (3, 32, 2), (3, 64, 1)]


def _same_decode(path):
    ours, sr = wavio.read_wav(path)
    ref, ref_sr = jwavio.read_wav(path)
    assert sr == ref_sr and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    plain, plain_sr = wavio.read_wav_plain(path)
    ref_plain, _ = jwavio._read_wav_numpy(path)
    assert plain_sr == sr
    np.testing.assert_array_equal(plain, ref_plain)
    np.testing.assert_allclose(ours, plain, atol=1e-7, rtol=0)
    return ours


@pytest.mark.parametrize("fmt_tag,bits,channels", FORMATS)
def test_read_wav_bit_equal_to_jax(tmp_path, rng, fmt_tag, bits, channels):
    x = np.clip(rng.randn(200, channels) * 0.3, -0.99, 0.99)
    path = _write(tmp_path, _build_wav(_encode(x, fmt_tag, bits), fmt_tag=fmt_tag,
                                       channels=channels, bits=bits))
    _same_decode(path)
    # the formats the robustness test names are bit-equal to the numpy parser
    np.testing.assert_array_equal(wavio.read_wav(path)[0], wavio.read_wav_plain(path)[0])


def _odd_cases(rng):
    x = np.clip(rng.randn(128, 2) * 0.3, -0.99, 0.99)
    mono = x[:, :1]
    junk = b"JUNK" + (7).to_bytes(4, "little") + b"abcdefg" + b"\x00"
    return {
        "junk_chunk": _build_wav(_encode(mono, 1, 16), pre_chunks=junk),
        "extensible": _build_wav(_encode(x, 1, 16), channels=2, bits=16,
                                 extensible_subformat=1),
        "truncated_mid_frame": _build_wav(_encode(x, 1, 16)[:-3], channels=2, bits=16),
        "streaming_size": _build_wav(_encode(mono, 1, 16), data_size_override=0xFFFFFFF0),
    }


@pytest.mark.parametrize("case", ["junk_chunk", "extensible", "truncated_mid_frame",
                                  "streaming_size"])
def test_read_wav_odd_headers_bit_equal_to_jax(tmp_path, rng, case):
    path = _write(tmp_path, _odd_cases(rng)[case])
    ours = _same_decode(path)
    assert len(ours) == {"junk_chunk": 128, "extensible": 128, "truncated_mid_frame": 127,
                         "streaming_size": 128}[case]
    np.testing.assert_array_equal(wavio.load_audio(path), jwavio.load_audio(path))


@pytest.mark.parametrize("case", ["garbage", "truncated_header", "zero_channels",
                                  "unsupported_tag", "empty_data", "missing"])
def test_corrupt_files_are_skipped_in_both(tmp_path, case):
    blob = {"garbage": b"\x13\x37" * 500,
            "truncated_header": b"RIFF\x10\x00\x00\x00WA",
            "zero_channels": _build_wav(b"\x00" * 64, channels=0),
            "unsupported_tag": _build_wav(b"\x00" * 64, fmt_tag=0x55),
            "empty_data": _build_wav(b""),
            "missing": None}[case]
    path = str(tmp_path / "t.wav") if blob is None else _write(tmp_path, blob)
    assert wavio.load_audio(path) is None
    assert jwavio.load_audio(path) is None
    with pytest.raises(ValueError):
        wavio.read_wav(path)


@pytest.fixture(scope="module")
def mixed_corpus(tmp_path_factory):
    """Mono clips at 8, 16 and 44.1 kHz, a stereo 22.05 kHz clip, a clip
    longer than the buffer, a missing file and a corrupt file."""
    d = tmp_path_factory.mktemp("mixed")
    r = np.random.RandomState(7)
    paths = []
    for i, (sr, n) in enumerate([(8000, 4000), (16000, 12000), (44100, 30000),
                                 (16000, 40000), (44100, 9000)]):
        p = str(d / f"m{i}.wav")
        jwavio.write_wav(p, (r.randn(n) * 0.2).astype(np.float32), sr)
        paths.append(p)
    x = np.clip(r.randn(11025, 2) * 0.3, -0.99, 0.99)
    stereo = d / "stereo.wav"
    stereo.write_bytes(_build_wav(_encode(x, 1, 16), channels=2, bits=16, rate=22050))
    bad = d / "bad.wav"
    bad.write_bytes(b"RIFFxxxxWAVEfmt corrupt")
    return paths[:3] + [str(stereo), str(d / "missing.wav"), str(bad)] + paths[3:]


@pytest.mark.parametrize("n_threads", [1, 4])
def test_decode_batch_bit_equal_to_jax(mixed_corpus, n_threads):
    ours = wavio.decode_batch(mixed_corpus, 16000, 24000, n_threads=n_threads)
    ref = jwavio.decode_batch(mixed_corpus, 16000, 24000, n_threads=n_threads)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    waves, lengths, ok = ours
    assert list(ok) == [True, True, True, True, False, False, True, True]
    assert list(lengths) == [8000, 12000, 10885, 8000, 0, 0, 24000, 3266]
    assert not waves[4].any() and not waves[5].any()
    # the plain version: the same rows, its resampler in f32
    plain = wavio.decode_batch_plain(mixed_corpus, 16000, 24000)
    np.testing.assert_array_equal(plain[1], lengths)
    np.testing.assert_array_equal(plain[2], ok)
    np.testing.assert_allclose(plain[0], waves, atol=RESAMPLE_VS_TORCH, rtol=0)
    for i in (1, 6):  # 16 kHz mono: no resampling, bit-equal
        np.testing.assert_array_equal(plain[0][i], waves[i])


def test_decode_batch_default_threads_and_empty():
    assert wavio.default_threads() == min(8, os.cpu_count() or 1)
    waves, lengths, ok = wavio.decode_batch([], 16000, 100)
    assert waves.shape == (0, 100) and lengths.shape == ok.shape == (0,)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (8000, 16000), (22050, 16000),
                                          (16000, 14400)])
def test_host_resample_bit_equal_to_jax(rng, sr_in, sr_out):
    x = (rng.randn(sr_in // 3) * 0.3).astype(np.float32)
    ours = wavio.resample_host(x, sr_in, sr_out)
    np.testing.assert_array_equal(ours, jwavio._resample_host(x, sr_in, sr_out))
    torch_op = resample(torch.from_numpy(x), sr_in, sr_out).numpy()
    assert ours.shape == torch_op.shape
    np.testing.assert_allclose(ours, torch_op, atol=RESAMPLE_VS_TORCH, rtol=0)


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_host_resample_threads_bit_equal_to_jax(rng, monkeypatch, n_threads):
    """Six seconds at 44.1 kHz make 75 tiles of interior frames, which up to
    four threads share (one per 16 tiles at least)."""
    monkeypatch.setattr(wavio, "default_threads", lambda: n_threads)
    x = (rng.randn(44100 * 6 + 123) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(wavio.resample_host(x, 44100, 16000),
                                  jwavio._resample_host(x, 44100, 16000))


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (48000, 16000), (8000, 16000),
                                          (22050, 16000)])
def test_host_resample_edges_and_tiles_bit_equal_to_jax(rng, sr_in, sr_out):
    """Lengths about the kernel's taps (15, 41 and 475 for these ratios)
    and about the eight-frame tiles of interior outputs, where the port
    changes from the edge loop to the tiles and back."""
    for n in (1, 2, 14, 15, 16, 40, 41, 42, 474, 475, 476, 4003, 4004, 4445, 7057, 12345):
        x = (rng.randn(n) * 0.3).astype(np.float32)
        np.testing.assert_array_equal(wavio.resample_host(x, sr_in, sr_out),
                                      jwavio._resample_host(x, sr_in, sr_out), err_msg=str(n))


def test_load_audio_resamples_on_the_host_as_jax(tmp_path, rng):
    p = str(tmp_path / "a.wav")
    wavio.write_wav(p, (rng.randn(22050) * 0.2).astype(np.float32), 44100)
    ours = wavio.load_audio(p, target_sr=16000, max_length=0.4)
    np.testing.assert_array_equal(ours, jwavio.load_audio(p, target_sr=16000, max_length=0.4))
    assert len(ours) == 6400


def test_synthetic_corpus_bytes_equal_jax(tmp_path):
    n = {"train": 5, "test": 3, "devel": 2, "empty": 0}
    rows = make_synthetic_corpus(str(tmp_path / "port"), n_per_split=n, seed=0)
    ref = jax_corpus(str(tmp_path / "jax"), n_per_split=n, seed=0)
    for sub in ("wav", "lab"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        for name in names:
            assert ((tmp_path / "port" / sub / name).read_bytes()
                    == (tmp_path / "jax" / sub / name).read_bytes()), name
    assert len(rows) == len(ref) == 10
    for row, (_, r) in zip(rows, ref.iterrows()):
        assert row["path"] == r["path"].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        for col in ("filename", "label", "split", "duration"):
            assert row[col] == r[col]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build._compile(bad)
    assert not list((tmp_path / "build").glob("*"))  # no half-written library


def test_library_named_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "ok.cpp"
    src.write_text('extern "C" int f() { return 7; }\n')
    lib = build._compile(src)
    assert lib == build.library_path(src, build.CXX_FLAGS) and lib.exists()
    assert build.library_path(src, (*build.CXX_FLAGS, "-DX")) != lib
    assert build._compile(src) == lib  # built once
    src.write_text('extern "C" int f() { return 8; }\n')
    assert build.library_path(src, build.CXX_FLAGS) != lib


def test_without_libav_headers_only_wav_decodes(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(build, "LIBAV_HEADERS", (str(tmp_path / "none" / "avformat.h"),))
    with caplog.at_level("INFO", logger="stutter_tpu_torch.audio.build"):
        assert build._load_ff() is None
    assert "no libav headers" in caplog.text
    monkeypatch.setattr(wavio, "get_ff_lib", lambda: None)
    p = tmp_path / "x.flac"
    p.write_bytes(b"fLaC\x80\x00\x00\x22" + bytes(34))
    with pytest.raises(ValueError):
        wavio.audio_info(str(p))
    with pytest.raises(RuntimeError, match="libav"):
        wavio.encode_audio(str(tmp_path / "y.flac"), np.zeros(10, np.float32), 16000)
