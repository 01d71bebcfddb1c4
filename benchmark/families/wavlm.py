"""WavLM for the benchmark: the program's model and extractor as
``cli/extract_wavlm.py`` builds them, and the plain reference beside them.

A configuration file of this family holds ``WavLMConfig``'s fields under
the names of the model's ``config.json``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import yardstick
from benchmark.reference import wavlm as reference
from benchmark.weights import seeded_weights


def model_config(config: dict):
    from stutter_tpu_torch.models.wavlm import WavLMConfig

    fields = {f.name for f in dataclasses.fields(WavLMConfig)}
    return WavLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config.items() if k in fields})


def build(config: dict, seed: int, device: torch.device):
    """(float32 model on ``device`` filled from ``seed``, its bf16 weights)."""
    from stutter_tpu_torch.models.wavlm import WavLMModel

    model = WavLMModel(model_config(config), device=device)
    return model, seeded_weights(model, seed)


def extractor(model, device, preset: str):
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor

    return WavLMExtractor(model, device, preset=preset)


def batcher(extractor, config: dict):
    """``cli/extract_wavlm.py``'s defaults: 240 audio-s a batch, at most 128 clips."""
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    return BucketBatcher(audio_budget_s=240.0, max_batch=128,
                         frame_align=extractor.frame_align)


def columns(config: dict) -> dict[str, int]:
    """The reference extraction's columns: states N, N - 1, N - 2 and
    (N + 1) // 2 of the N + 1, by name."""
    n = config["num_hidden_layers"] + 1
    return {f"layer_{i}": i for i in (n - 1, n - 2, n - 3, n // 2)}


def column_groups(config: dict) -> dict[str, list[str]]:
    return {"pooled": list(columns(config))}


def clip_flops(config: dict, n_samples: int) -> float:
    """The frozen model count at the clip's true length: padding is waste."""
    return yardstick.wavlm_flops(config, n_samples)


def reference_rows(config: dict, weights: dict, clips: list[np.ndarray],
                   device) -> list[dict[str, np.ndarray]]:
    """Each clip's reference row, {column: [D] float64}, one clip at a time."""
    W = {k: v.float() for k, v in weights.items()}
    cols = columns(config)
    rows = []
    with reference.no_tf32():
        for wave in clips:
            x = torch.from_numpy(wave).to(device)
            pooled = reference.pooled(config, W, x, list(cols.values())).double().cpu().numpy()
            rows.append(dict(zip(cols, pooled)))
    return rows
