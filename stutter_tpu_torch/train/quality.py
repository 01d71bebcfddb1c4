"""Data-quality reporting (counterpart of ``stutter_tpu/train/quality.py``;
reference ``model_training_1.py:466-540``).

``check_data_quality``: NaN/inf counts, feature statistics, row/label
alignment. ``analyze_class_distribution``: count, fraction and imbalance
ratio per class, as rows (dicts) in place of a DataFrame.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np

logger = logging.getLogger("stutter_tpu_torch.train.quality")


def check_data_quality(X: np.ndarray, y: np.ndarray) -> dict:
    X = np.asarray(X)
    report = {
        "n_samples": int(len(X)),
        "n_features": int(X.shape[1]) if X.ndim > 1 else 1,
        "nan_count": int(np.isnan(X).sum()),
        "inf_count": int(np.isinf(X).sum()),
        "feature_mean": float(np.nanmean(X)),
        "feature_std": float(np.nanstd(X)),
        "rows_match_labels": bool(len(X) == len(y)),
    }
    logger.info("data quality: %s", report)
    if report["nan_count"] or report["inf_count"]:
        logger.warning("found %d NaN and %d inf values in features",
                       report["nan_count"], report["inf_count"])
    return report


def analyze_class_distribution(y, idx_to_label: dict | None = None) -> list[dict]:
    """One row a class, in sorted class order: class, count, fraction,
    imbalance_ratio (the largest count over this one)."""
    counts = Counter(np.asarray(y).tolist())
    total = sum(counts.values())
    largest = max(counts.values()) if counts else 0
    rows = [{"class": idx_to_label.get(cls, cls) if idx_to_label else cls,
             "count": int(count),
             "fraction": count / total,
             "imbalance_ratio": float(largest / count)}
            for cls, count in sorted(counts.items())]
    logger.info("class distribution:\n%s", "\n".join(
        f"{r['class']} {r['count']} {r['fraction']:.6f} {r['imbalance_ratio']:.6f}"
        for r in rows))
    return rows
