"""The benchmark's corpus generator: KSF-layout clips made from the seed.

The layout of KSF / ComParE-22 (``wav/{split}_{i:04d}.wav`` at 16 kHz,
16-bit mono, and ``lab/{split}.csv`` with ``filename,label``), as the
program's scanner reads it. A traffic file fixes the clip count and the
range of lengths; every seed gets the same set of lengths (evenly spaced
over the range) in another order, and its own tones, noise and labels, so
that the work is the same from seed to seed and only its content moves.
"""

from __future__ import annotations

import csv
import struct
from pathlib import Path

import numpy as np

KSF_LABELS = ("no_disfluency", "block", "prolongation", "sound_repetition")


def clip_lengths(n: int, seconds: tuple[float, float], sample_rate: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``n`` sample counts spread evenly over ``seconds``, in the seed's order."""
    lo, hi = seconds
    spaced = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return rng.permutation(np.rint(spaced * sample_rate).astype(np.int64))


def pcm16(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float samples as 16-bit PCM."""
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """A canonical 44-byte-header PCM WAV of int16 mono ``samples``."""
    data = samples.tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                         1, 1, sample_rate, 2 * sample_rate, 2, 16, b"data", len(data))
    return header + data


def read_wav(path: str | Path) -> np.ndarray:
    """The samples of a file ``wav_bytes`` wrote, as float32 in [-1, 1)."""
    blob = Path(path).read_bytes()
    return np.frombuffer(blob[44:], "<i2").astype(np.float32) / 32768.0


def write_corpus(root: Path, traffic: dict, seed: int) -> dict:
    """Write ``traffic["clips"]`` clips of ``traffic["seconds"]`` under
    ``root`` in split ``traffic["split"]``; returns {path: samples}."""
    rng = np.random.default_rng(seed)
    sr = int(traffic.get("sample_rate", 16000))
    split = traffic.get("split", "train")
    (root / "wav").mkdir(parents=True, exist_ok=True)
    (root / "lab").mkdir(exist_ok=True)
    lengths = clip_lengths(int(traffic["clips"]), tuple(traffic["seconds"]), sr, rng)
    n_max = int(lengths.max())
    # one draw for every clip: a tone plus noise, each scaled under full range
    f0 = rng.uniform(100, 600, size=(len(lengths), 1)).astype(np.float32)
    t = np.arange(n_max, dtype=np.float32) / sr
    x = 0.4 * np.sin((2 * np.pi) * f0 * t) + 0.05 * rng.standard_normal(
        (len(lengths), n_max), dtype=np.float32)
    x *= (np.arange(n_max) < lengths[:, None])
    x /= np.maximum(1.0, np.abs(x).max(axis=1, keepdims=True) * 1.05)
    labels = rng.integers(len(KSF_LABELS), size=len(lengths))
    written, rows = {}, []
    for i, n in enumerate(lengths):
        name = f"{split}_{i:04d}.wav"
        path = root / "wav" / name
        path.write_bytes(wav_bytes(pcm16(x[i, :n]), sr))
        rows.append((name, KSF_LABELS[labels[i]]))
        written[str(path)] = int(n)
    with open(root / "lab" / f"{split}.csv", "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(("filename", "label"))
        w.writerows(rows)
    return written
