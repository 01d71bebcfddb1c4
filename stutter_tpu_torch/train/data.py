"""Training data preparation on metadata rows (counterpart of
``stutter_tpu/train/data.py``, on a list of dicts in place of a DataFrame).

``prepare_data`` (``model_training_01.py:420-452``) aligns labels with
embedding rows, dropping rows without a label, and builds the label maps.
The train/eval slicing is positional over the store's train -> test ->
devel order (``model_training_01.py:781-789``); ``positional_split`` holds
that contract, and test+devel form the eval set
(``model_training_01.py:719-728``).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("stutter_tpu_torch.train.data")


def build_label_maps(labels) -> tuple[dict, dict]:
    """Sorted (by ``str``) distinct labels -> ({label: index}, {index: label});
    None and empty labels are left out, as pandas' ``dropna`` leaves out NaN."""
    classes = sorted({lab for lab in labels if lab is not None and lab != ""}, key=str)
    label_to_idx = {c: i for i, c in enumerate(classes)}
    idx_to_label = {i: c for c, i in label_to_idx.items()}
    return label_to_idx, idx_to_label


def prepare_data(metadata: list[dict], embeddings: np.ndarray, label_to_idx: dict | None = None,
                 ) -> tuple[np.ndarray, np.ndarray, dict, dict]:
    """Return (X, y, label_to_idx, idx_to_label) for the rows with a label
    (and, given a map, a label in it)."""
    if len(metadata) != len(embeddings):
        logger.warning("metadata rows (%d) != embedding rows (%d); truncating to min",
                       len(metadata), len(embeddings))
        n = min(len(metadata), len(embeddings))
        metadata = metadata[:n]
        embeddings = embeddings[:n]

    labels = [row["label"] for row in metadata]
    valid = np.array([lab is not None for lab in labels], bool)
    if label_to_idx is None:
        label_to_idx, idx_to_label = build_label_maps(labels)
    else:
        idx_to_label = {i: c for c, i in label_to_idx.items()}
        # a label outside the given map (a class seen only in eval) is dropped
        known = np.array([lab in label_to_idx for lab in labels], bool)
        unknown = valid & ~known
        if unknown.any():
            logger.warning("dropping %d rows with labels outside the training label map: %s",
                           int(unknown.sum()),
                           sorted({str(lab) for lab, u in zip(labels, unknown) if u})[:5])
        valid = valid & known

    X = np.asarray(embeddings)[valid]
    y = np.array([label_to_idx[lab] for lab, v in zip(labels, valid) if v], np.int64)
    logger.info("prepared %d samples, %d classes", len(y), len(label_to_idx))
    return X, y, label_to_idx, idx_to_label


def stratified_test_mask(metadata: list[dict], test_size: float = 0.2,
                         seed: int = 42) -> np.ndarray:
    """Boolean test-row mask of a stratified split, positional so that every
    layer is sliced alike. Classes in order of first appearance (a missing
    label is a class of its own), each shuffled by one RandomState."""
    rng = np.random.RandomState(seed)
    by_class: dict = {}
    for i, row in enumerate(metadata):
        lab = row.get("label")
        by_class.setdefault("__nan__" if lab is None else lab, []).append(i)
    test_idx: list[int] = []
    for members in by_class.values():
        idx = np.array(members, np.int64)
        rng.shuffle(idx)
        n_test = max(1, int(round(len(idx) * test_size))) if len(idx) > 1 else 0
        test_idx.extend(idx[:n_test])
    mask = np.zeros(len(metadata), bool)
    mask[test_idx] = True
    return mask


def stratified_split(metadata: list[dict], embeddings: np.ndarray, test_size: float = 0.2,
                     seed: int = 42) -> tuple[list[dict], np.ndarray, list[dict], np.ndarray]:
    """Stratified train/test split (the reference's ``--split train_test``,
    which its loader accepts but does not implement)."""
    test_mask = stratified_test_mask(metadata, test_size, seed)
    train_meta = [r for r, t in zip(metadata, test_mask) if not t]
    test_meta = [r for r, t in zip(metadata, test_mask) if t]
    logger.info("stratified split: %d train / %d test", len(train_meta), len(test_meta))
    return train_meta, embeddings[~test_mask], test_meta, embeddings[test_mask]


def positional_split(metadata: list[dict], embeddings: np.ndarray,
                     ) -> tuple[list[dict], np.ndarray, list[dict], np.ndarray]:
    """Train rows form the training set, test+devel rows the eval set; the
    train rows must lead (the loader's order)."""
    train_mask = np.array([row.get("split") == "train" for row in metadata], bool)
    n_train = int(train_mask.sum())
    if not train_mask[:n_train].all():
        raise ValueError("loader order violated: train rows not leading")
    return (metadata[:n_train], embeddings[:n_train], metadata[n_train:],
            embeddings[n_train:])
