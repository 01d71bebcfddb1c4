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

Under the extractor's plan (``parallel.mesh.MeshPlan``) rank 0 makes the
copies and sends them to the other ranks (``broadcast_round``), so that
every rank holds the same copies, bit for bit, whatever its card's DSP
gives. The batches pad to the data size, every rank encodes its rows of
each (``extract.pipeline.submit_rows``), and rank 0 alone gets the rows.
"""

from __future__ import annotations

import logging
import random
from collections import Counter

import numpy as np

from stutter_tpu_torch.audio.wavio import load_audio
from stutter_tpu_torch.extract.batcher import Batch
from stutter_tpu_torch.extract.pipeline import collect_rows, submit_rows
from stutter_tpu_torch.parallel.mesh import broadcast_round
from stutter_tpu_torch.train.augment import AugmentConfig, augment_audio

logger = logging.getLogger("stutter_tpu_torch.train.augment_extract")


def _embed_waves(extractor, waves: list[np.ndarray],
                 chunk: int = 64) -> dict[str, np.ndarray] | None:
    """{column: [n, D]} of the waves, one extractor call per chunk of
    ``chunk`` clips, all padded to one length (frame-aligned by the
    extractor's ``frame_align`` where it has one). Under the extractor's
    plan the chunk and each batch pad to a multiple of the data size (pad
    rows not ok), as the JAX package pads to its mesh; every rank encodes
    its rows, and rank 0 gets the result, the other ranks None."""
    sr = 16000
    out: dict[str, list] = {name: [] for name in extractor.column_names}
    plan = getattr(extractor, "plan", None)
    multiple = plan.data_size if plan is not None else 1
    chunk = -(-chunk // multiple) * multiple
    max_len = max(len(w) for w in waves)
    align = getattr(extractor, "frame_align", None)
    if align is not None:
        k, s, m = align
        frames = max(1, (max_len - k) // s + 1)
        frames = ((frames + m - 1) // m) * m
        max_len = (frames - 1) * s + k

    for i in range(0, len(waves), chunk):
        group = waves[i: i + chunk]
        bsz = -(-len(group) // multiple) * multiple
        padded = np.zeros((bsz, max_len), np.float32)
        lengths = np.zeros((bsz,), np.int64)
        for j, w in enumerate(group):
            w = w[:max_len]
            padded[j, : len(w)] = w
            lengths[j] = len(w)
        batch = Batch(paths=[f"<aug:{i + j}>" for j in range(len(group))],
                      rows=list(range(len(group))), waves=padded, lengths=lengths,
                      ok=np.arange(bsz) < len(group), bucket_s=max_len / sr, sample_rate=sr)
        got = collect_rows(extractor, submit_rows(extractor, batch))
        if got is not None:
            for name in out:
                out[name].append(got.columns[name])
    if plan is not None and plan.rank != 0:
        return None
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


def _augmented_copies(train_meta: list[dict], extractor, augmentation_factor: int,
                      minority_threshold: int, config: AugmentConfig | None,
                      seed: int) -> tuple[list[dict], list[np.ndarray]]:
    """The minority classes' augmented copies and their metadata rows, in the
    reference's order; empty where there is nothing to augment."""
    if not any("path" in row for row in train_meta):
        logger.warning("no audio file paths found; skipping data augmentation")
        return [], []
    if not any("label" in row for row in train_meta):
        logger.warning("no labels found; skipping data augmentation")
        return [], []

    minority = _minority_classes([row.get("label") for row in train_meta], minority_threshold)
    logger.info("classes to augment (< %d samples): %s", minority_threshold, minority)
    if not minority:
        logger.info("no minority classes found; skipping augmentation")
        return [], []

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
    return aug_rows, aug_waves


def apply_data_augmentation(train_meta: list[dict], train_embeddings: dict[str, np.ndarray],
                            extractor, augmentation_factor: int = 3,
                            minority_threshold: int = 100, config: AugmentConfig | None = None,
                            seed: int = 0) -> tuple[list[dict], dict[str, np.ndarray]]:
    """Augment the minority classes and append their re-extracted embeddings.

    A clip that cannot be augmented (``ValueError``) is skipped, as in the
    reference; any other error, a CUDA error among them, ends the run. Under
    the extractor's plan rank 0 makes the copies and every rank encodes its
    rows of them; the other ranks get ``train_meta`` and
    ``train_embeddings`` back as they were."""
    plan = getattr(extractor, "plan", None)
    aug_rows: list[dict] = []
    aug_waves: list[np.ndarray] = []
    if plan is None or plan.rank == 0:
        aug_rows, aug_waves = _augmented_copies(train_meta, extractor, augmentation_factor,
                                                minority_threshold, config, seed)
    if plan is not None:
        aug_rows, aug_waves = broadcast_round(plan, (aug_rows, aug_waves))
    if not aug_waves:
        return train_meta, train_embeddings

    aug_embeddings = _embed_waves(extractor, aug_waves)
    if aug_embeddings is None:  # not rank 0
        return train_meta, train_embeddings
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
