"""Balanced class weights (numpy; a copy of ``stutter_tpu/train/class_weights.py``).

sklearn 'balanced' semantics: w_c = n_samples / (n_classes * count_c),
computed over the classes present in y.
"""

from __future__ import annotations

import numpy as np


def compute_class_weights(y: np.ndarray, n_classes: int | None = None) -> np.ndarray:
    """Return per-class weights [n_classes]; absent classes get weight 0."""
    y = np.asarray(y, np.int64)
    if n_classes is None:
        n_classes = int(y.max()) + 1
    counts = np.bincount(y, minlength=n_classes).astype(np.float64)
    present = counts > 0
    weights = np.zeros(n_classes)
    weights[present] = len(y) / (present.sum() * counts[present])
    return weights
