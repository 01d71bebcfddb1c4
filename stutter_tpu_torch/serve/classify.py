"""Serving-side classification: trained downstream models over served
embeddings (counterpart of ``stutter_tpu/serve/classify.py``).

A model the port's trainer wrote (``train/persistence.py``: a head as
``{base}_model.npz`` or an estimator as ``{base}_model.pkl``, beside its
``{base}_info.json`` sidecar) rides on top of ``EmbeddingServer``: each
response carries the predicted class label, and the per-class probabilities
where the model gives them, computed from the embedding column the model was
trained on. The JAX package's ``.joblib`` files are not read (this package
does not depend on joblib): such a path raises and names the port's formats.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logger = logging.getLogger("stutter_tpu_torch.serve.classify")

MODEL_SUFFIXES = ("_model.npz", "_model.pkl")


def sidecar_path(model_path: str) -> str:
    """``{base}_model.npz`` (or ``.pkl``, ``.joblib``) -> ``{base}_info.json``."""
    for suffix in MODEL_SUFFIXES + ("_model.joblib",):
        if model_path.endswith(suffix):
            return model_path[: -len(suffix)] + "_info.json"
    return os.path.splitext(model_path)[0] + "_info.json"


class ServingClassifier:
    """A trained model bound to the embedding column it was trained on.

    ``estimator`` has sklearn's predict API (a ``train.heads.HeadClassifier``
    or an sklearn estimator); ``layer`` names the served column (e.g.
    ``layer_24``, ``encoder_layer_32``, ``combined_top``);
    ``class_names[i]`` is the label of class index i (``str(i)`` where the
    sidecar has none)."""

    def __init__(self, estimator, layer: str, class_names: list[str] | None = None):
        self.estimator = estimator
        self.layer = layer
        self.class_names = [str(c) for c in class_names] if class_names else None

    @classmethod
    def load(cls, model_path: str, device="cuda") -> "ServingClassifier":
        """Load a ``save_model`` file (a head onto ``device``, a card unless
        the caller names the CPU); the sidecar gives the layer and the
        labels."""
        from stutter_tpu_torch.extract.pipeline import resolve_device
        from stutter_tpu_torch.train.persistence import load_model

        device = resolve_device(device)
        if not model_path.endswith((".npz", ".pkl")):
            raise ValueError(
                f"{model_path}: this package reads the models its trainer writes, "
                f"{{base}}_model.npz (heads) and {{base}}_model.pkl (estimators), not the "
                f"JAX package's .joblib files")
        estimator = load_model(model_path, device=device)
        info_path = sidecar_path(model_path)
        layer, class_names = None, None
        if os.path.exists(info_path):
            with open(info_path) as f:
                info = json.load(f)
            layer = info.get("layer")
            class_names = info.get("class_names")
        if layer is None:
            raise ValueError(f"cannot determine the embedding column for {model_path}: "
                             f"no 'layer' in {info_path}")
        logger.info("loaded classifier %s (layer=%s, classes=%s)", model_path, layer,
                    class_names)
        return cls(estimator, layer, class_names)

    def _name(self, idx) -> str:
        i = int(idx)
        if self.class_names and 0 <= i < len(self.class_names):
            return self.class_names[i]
        return str(idx)

    def predict_rows(self, X: np.ndarray) -> tuple[list[str], list[dict[str, float]] | None]:
        """Predict a [n, D] batch -> (labels, per-class probability dicts or None)."""
        X = np.asarray(X, np.float32)
        pred = np.asarray(self.estimator.predict(X))
        labels = [self._name(p) for p in pred]
        probs = None
        proba_fn = getattr(self.estimator, "predict_proba", None)
        if proba_fn is not None:
            try:
                P = np.asarray(proba_fn(X), np.float64)
            except AttributeError:  # e.g. SVC without probability=True
                logger.debug("predict_proba unavailable; serving labels only")
            else:
                # column j is estimator.classes_[j] (sklearn), a class index (heads)
                classes = getattr(self.estimator, "classes_", None)
                if classes is None:
                    classes = np.arange(P.shape[1])
                probs = [{self._name(c): float(P[r, j]) for j, c in enumerate(classes)}
                         for r in range(P.shape[0])]
        return labels, probs

    def classify_embeddings(self, embeddings: dict[str, np.ndarray]
                            ) -> tuple[str, dict[str, float] | None]:
        """Classify one request's column -> vector dict (a Response's payload)."""
        if self.layer not in embeddings:
            raise KeyError(f"served embeddings have no column '{self.layer}' "
                           f"(columns: {sorted(embeddings)})")
        labels, probs = self.predict_rows(embeddings[self.layer][None, :])
        return labels[0], probs[0] if probs else None
