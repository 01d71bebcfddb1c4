"""WAV decode and write in numpy (counterpart of ``stutter_tpu/audio/wavio.py``).

``read_wav`` parses RIFF/WAVE as the JAX package's numpy parser does: PCM 8,
16, 24 and 32 bit, IEEE float 32 and 64 bit, WAVE_FORMAT_EXTENSIBLE, mixed
down to mono float32. ``load_audio`` keeps the reference loader's per-file
skip contract (None on a file it cannot decode) and resamples a clip of
another rate on the host through ``ops.resample``, as the JAX package's
reader does. There is no compressed-format decoder in this package yet.
"""

from __future__ import annotations

import logging
import struct
import wave

import numpy as np
import torch

from stutter_tpu_torch.ops.resample import resample

logger = logging.getLogger("stutter_tpu_torch.audio")


def _data_arr(data: bytes, dtype) -> np.ndarray:
    n = len(data) // np.dtype(dtype).itemsize
    return np.frombuffer(data[: n * np.dtype(dtype).itemsize], dtype)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file to (mono float32 samples, sample_rate)."""
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
            raise ValueError(f"unsupported fmt (channels={channels}, bits={bits}): {path}")
        return data_size // (channels * (bits // 8)), rate


def audio_info(path: str) -> tuple[int, int]:
    """Cheap probe of any audio file: (n_mono_samples, sample_rate). WAV
    through its RIFF header; any other format raises ValueError, as this
    package's reader does (no compressed-format decoder yet)."""
    return wav_info(path)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] samples as 16-bit PCM WAV."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def load_audio(path: str, target_sr: int = 16000,
               max_length: float | None = None) -> np.ndarray | None:
    """Decode -> mono -> resample to ``target_sr`` (on the host) -> optional
    trim to ``max_length`` seconds -> float32.

    Returns None for a file that cannot be read or parsed (per-file skip
    contract)."""
    try:
        x, sr = read_wav(path)
    except (OSError, ValueError, struct.error) as e:
        logger.error("error loading %s: %s", path, e)
        return None
    if sr != target_sr:
        x = resample(torch.from_numpy(x), sr, target_sr).numpy()
    if max_length is not None:
        x = x[: int(max_length * target_sr)]
    return x.astype(np.float32)


def decode_batch(paths: list[str], target_sr: int = 16000, max_samples: int = 16000 * 30,
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode many files into one padded buffer.

    Returns (waves [N, max_samples] float32 zero-padded, lengths [N] int64,
    ok [N] bool)."""
    n = len(paths)
    waves = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros((n,), np.int64)
    ok = np.zeros((n,), bool)
    for i, p in enumerate(paths):
        x = load_audio(p, target_sr=target_sr, max_length=max_samples / target_sr)
        if x is None:
            continue
        keep = min(len(x), max_samples)
        waves[i, :keep] = x[:keep]
        lengths[i] = keep
        ok[i] = True
    return waves, lengths, ok
