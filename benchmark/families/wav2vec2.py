"""wav2vec 2.0 (XLS-R) for the benchmark: the program's model and extractor
as ``cli/extract_wav2vec2.py`` builds them (with ``cli/extract_wavlm.py``'s
batcher defaults), and the plain reference beside them.

A configuration file of this family holds ``Wav2Vec2Config``'s fields under
the names of the model's ``config.json``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# WavLM's batcher, store columns and frozen FLOP count serve this family too
# (``yardstick.wavlm_flops`` counts this encoder: its stem, and per token per
# layer q, k, v, o, scores and values and the FFN; WavLM's gate and bias add
# nothing it counts)
from benchmark.families.wavlm import batcher, clip_flops, column_groups, columns
from benchmark.reference import wav2vec2 as reference
from benchmark.weights import seeded_weights

__all__ = ["batcher", "build", "clip_flops", "column_groups", "columns", "extractor",
           "model_config", "reference_rows"]


def model_config(config: dict):
    from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    fields = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    return Wav2Vec2Config(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in config.items() if k in fields})


def build(config: dict, seed: int, device: torch.device):
    """(float32 model on ``device`` filled from ``seed``, its bf16 weights)."""
    from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    model = Wav2Vec2Model(model_config(config), device=device)
    return model, seeded_weights(model, seed)


def extractor(model, device, preset: str):
    from stutter_tpu_torch.extract.pipeline import Wav2Vec2Extractor

    return Wav2Vec2Extractor(model, device, preset=preset)


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
