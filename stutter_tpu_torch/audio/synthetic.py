"""Synthetic KSF-layout corpora for tests and benchmarks (counterpart of
``stutter_tpu/audio/synthetic.py``).

Writes ``{root}/wav/*.wav`` and ``{root}/lab/{split}.csv`` in the
ComParE-22 KSF label layout the scanner reads, from tones and noise, so that
decode, resampling, the frontends and augmentation get signals that are not
degenerate. For the same arguments it writes the same WAV bytes and label
CSVs as the JAX package (the same draws from ``np.random.RandomState``; the
CSVs through the ``csv`` module as pandas writes them, since the card's
machine has no pandas).
"""

from __future__ import annotations

import csv
import os
import shutil

import numpy as np

from stutter_tpu_torch.audio.wavio import encode_audio, read_wav, write_wav

DEFAULT_LABELS = ("no_disfluency", "block", "prolongation", "sound_repetition")


def make_synthetic_corpus(root: str, n_per_split: dict[str, int] | None = None,
                          sample_rate: int = 16000,
                          duration_range: tuple[float, float] = (0.5, 3.0),
                          labels: tuple[str, ...] = DEFAULT_LABELS, label_skew: float = 0.5,
                          seed: int = 0) -> list[dict]:
    """Write a small corpus; returns its ground-truth metadata, one dict a
    clip (filename without suffix, path, label, split, duration).

    ``label_skew`` puts that share of the draws on the first label, so that
    the minority-class augmentation and SMOTE paths have work."""
    if n_per_split is None:
        n_per_split = {"train": 12, "test": 6, "devel": 6}
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(root, "wav")
    lab_dir = os.path.join(root, "lab")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)

    probs = np.full(len(labels), (1.0 - label_skew) / max(1, len(labels) - 1))
    probs[0] = label_skew

    rows = []
    for split, n in n_per_split.items():
        csv_rows = []
        for i in range(n):
            name = f"{split}_{i:04d}.wav"
            dur = rng.uniform(*duration_range)
            t = np.arange(int(dur * sample_rate)) / sample_rate
            f0 = rng.uniform(100, 600)
            x = (0.4 * np.sin(2 * np.pi * f0 * t)
                 + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t)
                 + 0.05 * rng.randn(len(t))).astype(np.float32)
            x /= max(1.0, np.abs(x).max() * 1.05)
            write_wav(os.path.join(wav_dir, name), x, sample_rate)
            label = labels[rng.choice(len(labels), p=probs)]
            csv_rows.append((name, label))
            rows.append({"filename": os.path.splitext(name)[0],
                         "path": os.path.join(wav_dir, name), "label": label,
                         "split": split, "duration": dur})
        with open(os.path.join(lab_dir, f"{split}.csv"), "w", newline="") as f:
            if not csv_rows:  # pandas writes an empty frame as one empty line
                f.write("\n")
                continue
            w = csv.writer(f, lineterminator="\n")
            w.writerow(("filename", "label"))
            w.writerows(csv_rows)
    return rows


def flac_copy(root: str, dest: str) -> list[str]:
    """Copy a KSF-layout corpus of 16-bit WAV clips to ``dest`` with every
    clip re-encoded as FLAC (through libav) so that it decodes to the WAV's
    samples exactly, and the label CSVs as they are (the scanner joins a
    label row to a clip by name without its suffix). Returns the FLAC paths.

    The WAV reader gives n / 32768 for a 16-bit sample n; the FLAC encoder
    writes round(x * 32767), so the clip is encoded from n / 32767."""
    os.makedirs(os.path.join(dest, "wav"), exist_ok=True)
    shutil.copytree(os.path.join(root, "lab"), os.path.join(dest, "lab"), dirs_exist_ok=True)
    paths = []
    for name in sorted(os.listdir(os.path.join(root, "wav"))):
        x, sr = read_wav(os.path.join(root, "wav", name))
        path = os.path.join(dest, "wav", os.path.splitext(name)[0] + ".flac")
        encode_audio(path, x * np.float32(32768.0 / 32767.0), sr)
        paths.append(path)
    return paths
