"""Whisper for the benchmark: the program's model and extractor as
``cli/extract_whisper.py`` builds them, and the plain reference beside them.

A configuration file of this family holds ``WhisperConfig``'s fields under
the names of the model's ``config.json``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import yardstick
from benchmark.reference import whisper as reference
from benchmark.reference.wavlm import no_tf32
from benchmark.weights import seeded_weights

REFERENCE_BATCH = 8  # clips a reference call: every clip is one 30 s window


def model_config(config: dict):
    from stutter_tpu_torch.models.whisper import WhisperConfig

    fields = {f.name for f in dataclasses.fields(WhisperConfig)}
    return WhisperConfig(**{k: v for k, v in config.items() if k in fields})


def build(config: dict, seed: int, device: torch.device):
    """(float32 model on ``device`` filled from ``seed``, its bf16 weights)."""
    from stutter_tpu_torch.models.whisper import WhisperModel

    model = WhisperModel(model_config(config), device=device)
    return model, seeded_weights(model, seed)


def extractor(model, device, preset: str):
    from stutter_tpu_torch.extract.pipeline import WhisperExtractor

    return WhisperExtractor(model, device, preset=preset)


def batcher(extractor, config: dict):
    """``cli/extract_whisper.py``'s defaults: the 30 s bucket, 16 clips a batch."""
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    return BucketBatcher(buckets_s=(30.0,), audio_budget_s=30.0 * 16, max_batch=16)


def columns(config: dict) -> dict[str, tuple[str, int]]:
    """The reference extraction's columns: the last three states of the
    encoder and of the decoder, by name."""
    e, d = config["encoder_layers"] + 1, config["decoder_layers"] + 1
    return {**{f"encoder_layer_{i}": ("encoder", i) for i in (e - 1, e - 2, e - 3)},
            **{f"decoder_layer_{i}": ("decoder", i) for i in (d - 1, d - 2, d - 3)}}


def column_groups(config: dict) -> dict[str, list[str]]:
    groups: dict[str, list[str]] = {}
    for name, (part, _) in columns(config).items():
        groups.setdefault(part, []).append(name)
    return groups


def clip_flops(config: dict, n_samples: int) -> float:
    """The frozen encoder count of one 30 s window, the model's defined work
    for any clip; the decoder's single step is left out."""
    return yardstick.whisper_encoder_flops(config)


def reference_rows(config: dict, weights: dict, clips: list[np.ndarray],
                   device) -> list[dict[str, np.ndarray]]:
    """Each clip's reference row, {column: [D] float64}, in batches of 30 s
    windows."""
    W = {k: v.float() for k, v in weights.items()}
    cols = columns(config)
    enc = [i for part, i in cols.values() if part == "encoder"]
    dec = [i for part, i in cols.values() if part == "decoder"]
    rows = []
    with no_tf32():
        for start in range(0, len(clips), REFERENCE_BATCH):
            part = clips[start: start + REFERENCE_BATCH]
            waves = torch.zeros((len(part), reference.N_SAMPLES), dtype=torch.float32)
            for j, w in enumerate(part):
                w = w[: reference.N_SAMPLES]
                waves[j, : len(w)] = torch.from_numpy(w)
            out = reference.pooled(config, W, waves.to(device), enc, dec)
            out = out.double().cpu().numpy()  # [S, b, D]
            rows.extend(dict(zip(cols, out[:, j])) for j in range(len(part)))
    return rows
