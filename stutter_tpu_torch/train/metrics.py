"""Evaluation metrics (numpy; a copy of ``stutter_tpu/train/metrics.py``).

Parity targets: the metric set the reference reports per classifier
(``model_training_01.py:521-561``, ``model_training_1.py:688-723``):
balanced accuracy (primary), plain accuracy, weighted/macro F1, per-class
precision/recall/F1, confusion matrix. The tests hold it to the JAX
package's copy.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, np.int64), np.asarray(y_pred, np.int64)), 1)
    return cm


def _prf(cm: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    true_pos = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(true_pos > 0, tp / true_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1


def classification_metrics(
    y_true,
    y_pred,
    n_classes: int | None = None,
    class_names: list[str] | None = None,
) -> dict:
    """Full metric bundle (reference C17/C18 reporting set)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if n_classes is None:
        n_classes = int(max(y_true.max(), y_pred.max())) + 1
    cm = confusion_matrix(y_true, y_pred, n_classes)
    precision, recall, f1 = _prf(cm)
    support = cm.sum(axis=1)
    total = support.sum()
    present = support > 0

    weighted_f1 = float((f1 * support).sum() / max(total, 1))
    macro_f1 = float(f1[present].mean()) if present.any() else 0.0
    accuracy = float(np.diag(cm).sum() / max(total, 1))
    bal_acc = float(recall[present].mean()) if present.any() else 0.0

    per_class = {}
    for c in range(n_classes):
        name = class_names[c] if class_names else str(c)
        per_class[name] = {
            "precision": float(precision[c]),
            "recall": float(recall[c]),
            "f1": float(f1[c]),
            "support": int(support[c]),
        }
    return {
        "accuracy": accuracy,
        "balanced_accuracy": bal_acc,
        "weighted_f1": weighted_f1,
        "macro_f1": macro_f1,
        "per_class": per_class,
        "confusion_matrix": cm,
    }


def classification_report_text(metrics: dict) -> str:
    """sklearn-style plain-text report from a classification_metrics bundle."""
    lines = [f"{'':>20} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}", ""]
    for name, m in metrics["per_class"].items():
        lines.append(f"{name:>20} {m['precision']:>9.4f} {m['recall']:>9.4f} "
                     f"{m['f1']:>9.4f} {m['support']:>9d}")
    lines.append("")
    lines.append(f"{'accuracy':>20} {metrics['accuracy']:>29.4f}")
    lines.append(f"{'balanced accuracy':>20} {metrics['balanced_accuracy']:>29.4f}")
    lines.append(f"{'macro f1':>20} {metrics['macro_f1']:>29.4f}")
    lines.append(f"{'weighted f1':>20} {metrics['weighted_f1']:>29.4f}")
    return "\n".join(lines)
