"""Evaluation plots (counterpart of ``stutter_tpu/report/plots.py``; reference C19).

The artifact set of ``create_visualizations`` (``model_training_01.py:565-624``)
and ``create_comparison_visualizations`` (``model_training_1.py:727-759``):
raw and row-normalised confusion-matrix heatmaps, per-class
precision/recall/F1 bars, a per-layer comparison line with its best point
marked, and the grid comparison bars, under the same file names.
matplotlib (backend 'Agg') is imported inside each function: the rest of
the package runs without it.
"""

from __future__ import annotations

import os

import numpy as np


def pyplot():
    """matplotlib.pyplot on the headless 'Agg' backend, or an ImportError
    that names the package."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the training plots need matplotlib, which is not installed; "
                          "run without plots (make_plots=False)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _heatmap(ax, data, class_names, fmt, title, cmap="Blues"):
    im = ax.imshow(data, cmap=cmap)
    ax.set_xticks(range(len(class_names)))
    ax.set_yticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=45, ha="right")
    ax.set_yticklabels(class_names)
    thresh = data.max() / 2.0 if data.size else 0
    for i in range(data.shape[0]):
        for j in range(data.shape[1]):
            ax.text(j, i, format(data[i, j], fmt), ha="center", va="center",
                    color="white" if data[i, j] > thresh else "black", fontsize=8)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    ax.figure.colorbar(im, ax=ax, fraction=0.046)


def plot_confusion_matrices(
    cm: np.ndarray, class_names: list[str], out_dir: str, tag: str
) -> str:
    """Raw + row-normalized confusion heatmaps, one figure."""
    os.makedirs(out_dir, exist_ok=True)
    plt = pyplot()
    cm = np.asarray(cm, np.float64)
    with np.errstate(invalid="ignore"):
        norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, axes = plt.subplots(1, 2, figsize=(6 + 1.2 * len(class_names), 4 + 0.5 * len(class_names)))
    _heatmap(axes[0], cm.astype(int), class_names, "d", f"{tag} — confusion matrix")
    _heatmap(axes[1], norm, class_names, ".2f", f"{tag} — normalized")
    fig.tight_layout()
    path = os.path.join(out_dir, f"{tag}_confusion_matrix.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_per_class_metrics(per_class: dict, out_dir: str, tag: str) -> str:
    """Grouped precision/recall/F1 bars per class."""
    os.makedirs(out_dir, exist_ok=True)
    plt = pyplot()
    names = list(per_class)
    x = np.arange(len(names))
    width = 0.27
    fig, ax = plt.subplots(figsize=(max(6, 1.5 * len(names)), 4))
    for off, key in zip((-width, 0, width), ("precision", "recall", "f1")):
        ax.bar(x + off, [per_class[n][key] for n in names], width, label=key)
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.set_title(f"{tag} — per-class metrics")
    fig.tight_layout()
    path = os.path.join(out_dir, f"{tag}_per_class_metrics.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_layer_comparison(
    layer_results: dict[str, dict], out_dir: str,
    metric: str = "balanced_accuracy", tag: str = "layer_comparison",
) -> str:
    """Line plot of a metric across layers with the best point annotated."""
    os.makedirs(out_dir, exist_ok=True)
    plt = pyplot()
    layers = list(layer_results)
    values = [layer_results[k][metric] for k in layers]
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(layers)), 4))
    ax.plot(range(len(layers)), values, marker="o")
    best = int(np.argmax(values))
    ax.annotate(
        f"best: {layers[best]} ({values[best]:.3f})",
        xy=(best, values[best]), xytext=(best, min(1.0, values[best] + 0.05)),
        arrowprops=dict(arrowstyle="->"), ha="center",
    )
    ax.set_xticks(range(len(layers)))
    ax.set_xticklabels(layers, rotation=30, ha="right")
    ax.set_ylabel(metric)
    ax.set_title(f"{tag}: {metric} by layer")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    path = os.path.join(out_dir, f"{tag}_{metric}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_grid_comparison(
    results: dict[str, dict], out_dir: str, tag: str = "model_comparison"
) -> str:
    """Bars of balanced accuracy / weighted F1 per grid configuration."""
    os.makedirs(out_dir, exist_ok=True)
    plt = pyplot()
    names = list(results)
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(max(7, 1.4 * len(names)), 4))
    ax.bar(x - 0.2, [results[n]["balanced_accuracy"] for n in names], 0.4,
           label="balanced accuracy")
    ax.bar(x + 0.2, [results[n]["weighted_f1"] for n in names], 0.4, label="weighted F1")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.set_title(tag)
    fig.tight_layout()
    path = os.path.join(out_dir, f"{tag}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
