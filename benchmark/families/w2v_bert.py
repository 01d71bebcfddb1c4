"""w2v-BERT 2.0 for the benchmark: the program's model and extractor as
``cli/extract_w2v_bert.py`` builds them, and the plain reference beside
them.

A configuration file of this family holds ``W2VBertConfig``'s fields under
the names of the model's ``config.json`` (and the feature extractor's
``preprocessor_config.json``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# WavLM's batcher (the extraction CLIs' defaults) and store columns (states N,
# N - 1, N - 2 and N // 2 of the N + 1)
from benchmark import yardstick_conformer
from benchmark.families.wavlm import batcher, column_groups, columns
from benchmark.reference import w2v_bert as reference
from benchmark.weights import seeded_weights

__all__ = ["batcher", "build", "clip_flops", "column_groups", "columns", "extractor",
           "model_config", "reference_rows"]


def model_config(config: dict):
    from stutter_tpu_torch.models.w2v_bert import W2VBertConfig

    fields = {f.name for f in dataclasses.fields(W2VBertConfig)}
    return W2VBertConfig(**{k: v for k, v in config.items() if k in fields})


def build(config: dict, seed: int, device: torch.device):
    """(float32 model on ``device`` filled from ``seed``, its bf16 weights).

    The distance embeddings are drawn at k's scale (each entry ~1), not at a
    dense weight's 1/sqrt(head_dim): drawn like a weight, the relative-key
    term is an eighth of the scores, and the pooled rows move no further
    without it than bf16 moves them, so the check could not see it."""
    from stutter_tpu_torch.models.w2v_bert import W2VBertModel

    model = W2VBertModel(model_config(config), device=device)
    weights = seeded_weights(model, seed)
    scale = model.cfg.head_dim ** 0.5  # 8: exact in bf16
    for name, w in weights.items():
        if name.endswith("attention.distance_embedding"):
            w.mul_(scale)
    model.load_state_dict(weights)
    return model, weights


def extractor(model, device, preset: str):
    from stutter_tpu_torch.extract.pipeline import W2VBertExtractor

    return W2VBertExtractor(model, device, preset=preset)


def clip_flops(config: dict, n_samples: int) -> float:
    """The frozen Conformer count at the clip's true length: padding is waste."""
    return yardstick_conformer.w2v_bert_flops(config, n_samples)


def reference_rows(config: dict, weights: dict, clips: list[np.ndarray],
                   device) -> list[dict[str, np.ndarray]]:
    """Each clip's reference row, {column: [D] float64}, one clip at a time."""
    W = {k: v.float() for k, v in weights.items()}
    cols = columns(config)
    rows = []
    with reference.no_tf32():
        for wave in clips:
            pooled = reference.pooled(config, W, wave, list(cols.values()), device)
            rows.append(dict(zip(cols, pooled.double().cpu().numpy())))
    return rows
