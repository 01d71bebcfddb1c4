"""Minority-class augmentation and batched re-extraction (counterpart of
``stutter_tpu/train/augment_extract.py``; reference C13).

The reference (``model_training_01.py:290-388``) makes
``augmentation_factor`` augmented copies of every clip of a class with
fewer than ``minority_threshold`` training samples, runs the full model
forward on each copy one at a time, and appends the embeddings as
``{filename}_aug_{i}`` rows. Here every copy is made first (the DSP on the
extractor's device), then the copies go through the extractor in padded
batches of 64, one padded length for all, through the same ``submit`` and
``collect`` as the extraction pipeline: WavLM's batches go through the
gated attention kernel, Whisper's through the log-mel and flash attention
kernels.
"""

from __future__ import annotations

import logging
import random
from collections import Counter

import numpy as np

from stutter_tpu_torch.audio.wavio import load_audio
from stutter_tpu_torch.extract.batcher import Batch
from stutter_tpu_torch.train.augment import AugmentConfig, augment_audio

logger = logging.getLogger("stutter_tpu_torch.train.augment_extract")


def _embed_waves(extractor, waves: list[np.ndarray], chunk: int = 64) -> dict[str, np.ndarray]:
    """{column: [n, D]} of the waves, one extractor call per chunk of
    ``chunk`` clips, all padded to one length (frame-aligned by the
    extractor's ``frame_align`` where it has one)."""
    sr = 16000
    out: dict[str, list] = {name: [] for name in extractor.column_names}
    max_len = max(len(w) for w in waves)
    align = getattr(extractor, "frame_align", None)
    if align is not None:
        k, s, m = align
        frames = max(1, (max_len - k) // s + 1)
        frames = ((frames + m - 1) // m) * m
        max_len = (frames - 1) * s + k

    for i in range(0, len(waves), chunk):
        group = waves[i: i + chunk]
        padded = np.zeros((len(group), max_len), np.float32)
        lengths = np.zeros((len(group),), np.int64)
        for j, w in enumerate(group):
            w = w[:max_len]
            padded[j, : len(w)] = w
            lengths[j] = len(w)
        batch = Batch(paths=[f"<aug:{i + j}>" for j in range(len(group))],
                      rows=list(range(len(group))), waves=padded, lengths=lengths,
                      ok=np.ones(len(group), bool), bucket_s=max_len / sr, sample_rate=sr)
        embs = extractor(batch)
        for name in out:
            out[name].append(embs[name][: len(group)])
    return {name: np.concatenate(v) for name, v in out.items()}


def _minority_classes(labels: list, threshold: int) -> list:
    """Labels with fewer than ``threshold`` rows, in pandas' ``value_counts``
    order: count descending, ties in order of first appearance. None is not
    a class."""
    counts = Counter(lab for lab in labels if lab is not None)
    first = {}
    for i, lab in enumerate(labels):
        first.setdefault(lab, i)
    ordered = sorted(counts, key=lambda lab: (-counts[lab], first[lab]))
    return [lab for lab in ordered if counts[lab] < threshold]


def apply_data_augmentation(train_meta: list[dict], train_embeddings: dict[str, np.ndarray],
                            extractor, augmentation_factor: int = 3,
                            minority_threshold: int = 100, config: AugmentConfig | None = None,
                            seed: int = 0) -> tuple[list[dict], dict[str, np.ndarray]]:
    """Augment the minority classes and append their re-extracted embeddings.

    A clip that cannot be augmented (``ValueError``) is skipped, as in the
    reference; any other error, a CUDA error among them, ends the run."""
    if not any("path" in row for row in train_meta):
        logger.warning("no audio file paths found; skipping data augmentation")
        return train_meta, train_embeddings
    if not any("label" in row for row in train_meta):
        logger.warning("no labels found; skipping data augmentation")
        return train_meta, train_embeddings

    minority = _minority_classes([row.get("label") for row in train_meta], minority_threshold)
    logger.info("classes to augment (< %d samples): %s", minority_threshold, minority)
    if not minority:
        logger.info("no minority classes found; skipping augmentation")
        return train_meta, train_embeddings

    rng = random.Random(seed)
    aug_rows: list[dict] = []
    aug_waves: list[np.ndarray] = []
    for class_name in minority:
        class_rows = [row for row in train_meta if row.get("label") == class_name]
        logger.info("augmenting %d samples for class %r", len(class_rows), class_name)
        for row in class_rows:
            original = load_audio(row["path"], target_sr=16000)
            if original is None:
                continue
            for aug_idx in range(augmentation_factor):
                try:
                    wave = augment_audio(original, 16000, "random", config=config, rng=rng,
                                         device=extractor.device)
                except ValueError as e:
                    logger.warning("failed to augment %s: %s", row["filename"], e)
                    continue
                aug_rows.append(dict(row, filename=f"{row['filename']}_aug_{aug_idx}",
                                     augmented=True, augmentation_type="mixed"))
                aug_waves.append(wave)

    if not aug_rows:
        logger.warning("no augmented samples were created")
        return train_meta, train_embeddings

    aug_embeddings = _embed_waves(extractor, aug_waves)
    combined_meta = list(train_meta) + aug_rows
    combined = {}
    for layer_name, original in train_embeddings.items():
        if layer_name in aug_embeddings:
            combined[layer_name] = np.vstack([original, aug_embeddings[layer_name]])
        else:
            combined[layer_name] = original
        logger.info("combined %s: %d original + %d augmented = %d total", layer_name,
                    len(original), len(combined[layer_name]) - len(original),
                    len(combined[layer_name]))
    logger.info("data augmentation complete: %d -> %d samples", len(train_meta),
                len(combined_meta))
    return combined_meta, combined
