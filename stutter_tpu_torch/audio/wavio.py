"""Audio decode, resample and write on the host (counterpart of
``stutter_tpu/audio/wavio.py``).

The main path runs on the native runtime (``audio/build.py``): ``read_wav``
and ``decode_batch`` parse RIFF/WAVE in C++ (PCM 8, 16, 24 and 32 bit, IEEE
float 32 and 64 bit, WAVE_FORMAT_EXTENSIBLE, mixed down to mono float32) and
decode any other format through libav where the host has it (FLAC, MP3,
OGG, ...; probed by content, not by suffix). ``decode_batch`` decodes,
resamples and pads a whole batch on a C++ thread pool; ``load_audio``
resamples another rate with the same windowed-sinc kernel as ``ops.resample``
accumulated in double (``resample_host``; a long file split over threads). The calls go through
``ctypes.CDLL``, which releases the GIL while they run, so decoding the next
batch does not hold up the thread that enqueues the device's work.

``read_wav_plain`` (the numpy RIFF parser) and ``decode_batch_plain`` (a
serial loop over it, resampling with ``ops.resample``) are the plain
versions the tests and ``chip_smoke.py`` hold the native runtime against;
nothing on the main path calls them.

``load_audio`` keeps the reference loader's per-file skip contract: None for
a file that cannot be read or decoded. ``read_wav`` raises ValueError where
the JAX package's falls back to its numpy parser after the native parser
refused the file; the numpy parser then raises too, unless the file holds
no whole frame or a sample rate of 0.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import wave

import numpy as np
import torch

from stutter_tpu_torch.audio.build import get_ff_lib, get_lib
from stutter_tpu_torch.ops.resample import resample

logger = logging.getLogger("stutter_tpu_torch.audio")

_F = ctypes.POINTER(ctypes.c_float)


def _data_arr(data: bytes, dtype) -> np.ndarray:
    n = len(data) // np.dtype(dtype).itemsize
    return np.frombuffer(data[: n * np.dtype(dtype).itemsize], dtype)


def read_wav_plain(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file to (mono float32 samples, sample_rate) in
    numpy: the plain version of the native parser."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt_tag = channels = bits = rate = None
    data = None
    while pos + 8 <= len(blob):
        cid = blob[pos: pos + 4]
        (size,) = struct.unpack("<I", blob[pos + 4: pos + 8])
        body = blob[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt_tag, channels, rate = struct.unpack("<HHI", body[0:8])
            (bits,) = struct.unpack("<H", body[14:16])
            if fmt_tag == 0xFFFE and size >= 40:  # extensible
                (fmt_tag,) = struct.unpack("<H", body[24:26])
        elif cid == b"data":
            data = body
            break
        pos += 8 + size + (size & 1)
    if fmt_tag is None or data is None or len(data) == 0 or channels == 0:
        raise ValueError(f"missing/empty fmt/data chunk: {path}")

    if fmt_tag == 1:
        if bits == 8:
            x = (_data_arr(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = _data_arr(data, np.int16).astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8)
            raw = raw[: len(raw) // 3 * 3].reshape(-1, 3)
            x = (raw[:, 0].astype(np.int32)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = np.where(x & 0x800000, x - (1 << 24), x).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = _data_arr(data, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bits={bits}")
    elif fmt_tag == 3:
        if bits == 32:
            x = _data_arr(data, np.float32).astype(np.float32)
        elif bits == 64:
            x = _data_arr(data, np.float64).astype(np.float32)
        else:
            raise ValueError(f"unsupported IEEE-float bits={bits}")
    else:
        raise ValueError(f"unsupported wav format tag {fmt_tag}")

    x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x.mean(axis=1).astype(np.float32), rate


def _take(lib, out, n: int) -> np.ndarray:
    """Copy a native float buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib(out)
    return arr


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode an audio file to (mono float32 samples, sample_rate): WAV by
    the native RIFF parser, any other format through libav where the host
    has it. Raises ValueError when the file cannot be decoded."""
    lib = get_lib()
    out, n, sr = _F(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.wavio_decode(os.fsencode(path), ctypes.byref(out), ctypes.byref(n),
                          ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"cannot decode audio file (rc={rc}): {path}")
    return _take(lib.wavio_free, out, n.value), sr.value


def wav_info(path: str) -> tuple[int, int]:
    """Header-only probe: (n_mono_samples, sample_rate)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        channels = bits = rate = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[0:4]
            (size,) = struct.unpack("<I", hdr[4:8])
            if cid == b"fmt ":
                body = f.read(size)
                _, channels, rate = struct.unpack("<HHI", body[0:8])
                (bits,) = struct.unpack("<H", body[14:16])
            elif cid == b"data":
                data_size = size
                break
            else:
                f.seek(size + (size & 1), 1)
        if channels is None or data_size is None or bits in (None, 0):
            raise ValueError(f"missing fmt/data chunk: {path}")
        if channels == 0 or bits < 8:
            # e.g. 4-bit ADPCM: the sample count is not in the header walk,
            # but libav's probe can size it
            raise ValueError(f"unsupported fmt (channels={channels}, bits={bits}): {path}")
        return data_size // (channels * (bits // 8)), rate


def audio_info(path: str) -> tuple[int, int]:
    """Cheap probe of any audio file: (n_mono_samples, sample_rate). WAV
    through its RIFF header; other formats through libav's stream info (exact
    for FLAC's STREAMINFO and MP3's Xing header, no decode). Without libav a
    file that is not WAV raises ValueError."""
    try:
        return wav_info(path)
    except ValueError:
        ff = get_ff_lib()
        if ff is None:
            raise
        n, sr = ctypes.c_int64(), ctypes.c_int32()
        rc = ff.ffdecode_probe(os.fsencode(path), ctypes.byref(n), ctypes.byref(sr))
        if rc != 0:
            raise ValueError(f"cannot probe audio file (rc={rc}): {path}") from None
        return n.value, sr.value


def encode_audio(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Encode float32 PCM ([T] mono or [T, C] interleaved) to a compressed
    file, the codec chosen by the suffix (.flac, .mp3, .ogg, ...). A test
    and fixture helper; raises RuntimeError without libav."""
    ff = get_ff_lib()
    if ff is None:
        raise RuntimeError("compressed-audio encode needs libav, which this host lacks")
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    x = np.ascontiguousarray(x)
    rc = ff.ffdecode_encode(os.fsencode(path), x.ctypes.data_as(_F), x.shape[0],
                            sample_rate, x.shape[1])
    if rc != 0:
        raise RuntimeError(f"encode failed (rc={rc}) for {path}")


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] samples as 16-bit PCM WAV."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample_host(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample mono float32 samples on the host with the native windowed-sinc
    kernel (``ops.resample``'s, accumulated in double): the JAX package's
    ``_resample_host``. A long input is split over up to ``default_threads()``
    threads; the output does not depend on how many."""
    if sr_in == sr_out:
        return x
    lib = get_lib()
    xin = np.ascontiguousarray(x, np.float32)
    out, n = _F(), ctypes.c_int64()
    rc = lib.wavio_resample_threads(xin.ctypes.data_as(_F), len(xin), sr_in, sr_out, 6, 0.99,
                                    default_threads(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"cannot resample {len(xin)} samples from {sr_in} to {sr_out} Hz "
                         f"(rc={rc})")
    return _take(lib.wavio_free, out, n.value)


def load_audio(path: str, target_sr: int = 16000,
               max_length: float | None = None) -> np.ndarray | None:
    """Decode -> mono -> resample to ``target_sr`` on the host -> optional
    trim to ``max_length`` seconds -> float32.

    Returns None for a file that cannot be read, decoded or resampled
    (per-file skip contract)."""
    try:
        x, sr = read_wav(path)
        x = resample_host(x, sr, target_sr)
    except (OSError, ValueError) as e:
        logger.error("error loading %s: %s", path, e)
        return None
    if max_length is not None:
        x = x[: int(max_length * target_sr)]
    return x.astype(np.float32)


def default_threads() -> int:
    """``decode_batch``'s and ``resample_host``'s thread count:
    ``min(8, os.cpu_count())``, as in JAX."""
    return min(8, os.cpu_count() or 1)


def decode_batch(paths: list[str], target_sr: int = 16000, max_samples: int = 16000 * 30,
                 n_threads: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode, resample and trim many files into one zero-padded buffer on the
    native thread pool (``n_threads``, default ``default_threads()``).

    Returns (waves [N, max_samples] float32, lengths [N] int64, ok [N] bool)."""
    n = len(paths)
    if n_threads is None:
        n_threads = default_threads()
    waves = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros((n,), np.int64)
    status = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    get_lib().wavio_decode_batch(
        c_paths, n, target_sr, max_samples, n_threads, waves.ctypes.data_as(_F),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return waves, lengths, status == 0


def decode_batch_plain(paths: list[str], target_sr: int = 16000,
                       max_samples: int = 16000 * 30,
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version of ``decode_batch``: one file after another through
    ``read_wav_plain`` (WAV only) and ``ops.resample`` in torch."""
    n = len(paths)
    waves = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros((n,), np.int64)
    ok = np.zeros((n,), bool)
    for i, p in enumerate(paths):
        try:
            x, sr = read_wav_plain(p)
        except (OSError, ValueError, struct.error) as e:
            logger.error("error loading %s: %s", p, e)
            continue
        if sr != target_sr:
            x = resample(torch.from_numpy(x), sr, target_sr).numpy()
        keep = min(len(x), max_samples)
        waves[i, :keep] = x[:keep]
        lengths[i] = keep
        ok[i] = True
    return waves, lengths, ok
