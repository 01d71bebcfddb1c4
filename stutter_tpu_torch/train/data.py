"""Label maps for the fine-tune CLI (the list-based counterpart of
``stutter_tpu/train/data.py:build_label_maps``, without pandas)."""

from __future__ import annotations


def build_label_maps(labels) -> tuple[dict, dict]:
    """Sorted (by ``str``) distinct labels -> ({label: index}, {index: label});
    None and empty labels are left out, as pandas' ``dropna`` leaves out NaN."""
    classes = sorted({lab for lab in labels if lab is not None and lab != ""}, key=str)
    label_to_idx = {c: i for i, c in enumerate(classes)}
    idx_to_label = {i: c for c, i in label_to_idx.items()}
    return label_to_idx, idx_to_label
