"""Downstream classifier training (counterpart of ``stutter_tpu/train/classifiers.py``).

Two trainer surfaces of the reference:
- ``train_balanced_model`` (``model_training_01.py:454-563``): SMOTE ->
  scale -> fit -> the balanced-accuracy/F1 metric bundle, for one
  classifier;
- ``train_improved_models`` (``model_training_1.py:630-725``): the
  {Original, SMOTE} x model grid, without Weighted-on-SMOTE.

Backends: 'mlp'/'jax_mlp' and 'linear'/'logreg' are ``HeadClassifier``s
trained on the device (no package beyond torch); 'svm', 'rf' and 'xgb' are
sklearn pipelines on the host (the reference's hyperparameters: SVC(rbf,
C=10), RF(100)), and 'xgb' takes xgboost where it is installed, else
sklearn's HistGradientBoosting. sklearn is imported only when one of its
backends is asked for.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from stutter_tpu_torch.train.heads import HeadClassifier, HeadConfig
from stutter_tpu_torch.train.metrics import classification_metrics
from stutter_tpu_torch.train.smote import apply_smote_oversampling

logger = logging.getLogger("stutter_tpu_torch.train.classifiers")


def _require_sklearn(classifier_type: str) -> None:
    """An ImportError that says what needs sklearn, where it is missing."""
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"the {classifier_type!r} classifier needs scikit-learn (sklearn), which is not "
            "installed; 'mlp' and 'linear' need no extra package") from e


class LabelEncodedClassifier:
    """LabelEncoder round trip around the 'xgb' backend (reference
    ``model_training_01.py:470-523``): XGBClassifier takes labels 0..K-1
    only, so y is encoded before the fit and predictions decoded after."""

    def __init__(self, base):
        self.base = base
        self.label_encoder_ = None

    def fit(self, X, y):
        from sklearn.preprocessing import LabelEncoder

        self.label_encoder_ = LabelEncoder()
        y_enc = self.label_encoder_.fit_transform(np.asarray(y))
        logger.info("Encoded %d classes for XGBoost: %s",
                    len(self.label_encoder_.classes_), self.label_encoder_.classes_)
        self.base.fit(X, y_enc)
        return self

    def predict(self, X):
        y_enc = np.asarray(self.base.predict(X), np.int64)
        return self.label_encoder_.inverse_transform(y_enc)

    def predict_proba(self, X):
        return self.base.predict_proba(X)

    @property
    def classes_(self):
        """The original labels in the order of predict_proba's columns."""
        return self.label_encoder_.classes_


def make_classifier(classifier_type: str, n_features: int, n_classes: int,
                    class_weight: str | None = "balanced", random_state: int = 42,
                    head_overrides: dict | None = None, device: torch.device | str = "cuda"):
    """An sklearn-style estimator for the backend name. The sklearn backends
    are Pipeline(StandardScaler, clf), as in the reference; the heads scale
    inside and train on ``device``. ``head_overrides`` are more
    ``HeadConfig`` fields (epochs, learning_rate, ...) for the heads."""
    overrides = dict(head_overrides or {})
    if classifier_type in ("mlp", "jax_mlp", "linear", "logreg"):
        overrides.setdefault("hidden_dims", (256,) if "mlp" in classifier_type else ())
        return HeadClassifier(HeadConfig(in_dim=n_features, n_classes=n_classes,
                                         seed=random_state, **overrides),
                              class_weight=class_weight, device=device)
    if classifier_type not in ("svm", "rf", "xgb"):
        raise ValueError(f"unknown classifier type: {classifier_type!r}")

    _require_sklearn(classifier_type)
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler as SkScaler

    if classifier_type == "svm":
        from sklearn.svm import SVC

        clf = SVC(kernel="rbf", C=10, class_weight=class_weight, random_state=random_state)
    elif classifier_type == "rf":
        from sklearn.ensemble import RandomForestClassifier

        clf = RandomForestClassifier(n_estimators=100, class_weight=class_weight,
                                     random_state=random_state, n_jobs=-1)
    else:
        try:
            from xgboost import XGBClassifier

            clf = XGBClassifier(n_estimators=100, max_depth=6, learning_rate=0.1,
                                random_state=random_state)
        except ImportError:
            from sklearn.ensemble import HistGradientBoostingClassifier

            logger.warning("xgboost not installed; using sklearn HistGradientBoosting as the "
                           "'xgb' backend (same gradient-boosted-trees capability)")
            clf = HistGradientBoostingClassifier(max_iter=100, max_depth=6, learning_rate=0.1,
                                                 random_state=random_state)
    pipeline = Pipeline([("scaler", SkScaler()), ("clf", clf)])
    return LabelEncodedClassifier(pipeline) if classifier_type == "xgb" else pipeline


def train_balanced_model(X_train: np.ndarray, y_train: np.ndarray, X_test: np.ndarray,
                         y_test: np.ndarray, classifier_type: str = "svm",
                         class_names: list[str] | None = None, use_smote: bool = True,
                         smote_k_neighbors: int = 3, random_state: int = 42,
                         head_overrides: dict | None = None,
                         device: torch.device | str = "cuda") -> tuple[Any, dict]:
    """SMOTE -> scale -> fit -> metric bundle (reference C17)."""
    n_classes = len(class_names) if class_names else int(max(y_train.max(), y_test.max())) + 1
    if use_smote:
        X_train, y_train = apply_smote_oversampling(
            X_train, y_train, k_neighbors=smote_k_neighbors, random_state=random_state,
            device=device)
    model = make_classifier(classifier_type, X_train.shape[1], n_classes,
                            class_weight="balanced", random_state=random_state,
                            head_overrides=head_overrides, device=device)
    logger.info("training %s on %d samples x %d dims", classifier_type, *X_train.shape)
    model.fit(X_train, np.asarray(y_train))
    results = classification_metrics(y_test, model.predict(X_test), n_classes, class_names)
    results["classifier"] = classifier_type
    results["used_smote"] = use_smote
    logger.info("%s: balanced_acc=%.4f weighted_f1=%.4f macro_f1=%.4f", classifier_type,
                results["balanced_accuracy"], results["weighted_f1"], results["macro_f1"])
    return model, results


GRID_MODELS = ("SVM_Basic", "SVM_Weighted", "RF_Basic", "RF_Weighted")
# the grid's extension by the heads (the JAX package's name for the key set,
# kept: the grid CLI's --include_jax_heads adds them)
GRID_MODELS_JAX = ("Linear_Weighted", "MLP_Weighted")


def _grid_estimator(name: str, n_features: int, n_classes: int, random_state: int,
                    device: torch.device | str = "cuda"):
    base, variant = name.split("_")
    cw = "balanced" if variant == "Weighted" else None
    kind = {"SVM": "svm", "RF": "rf", "Linear": "linear", "MLP": "mlp"}[base]
    return make_classifier(kind, n_features, n_classes, class_weight=cw,
                           random_state=random_state, device=device)


def train_improved_models(X_train: np.ndarray, y_train: np.ndarray, X_test: np.ndarray,
                          y_test: np.ndarray, class_names: list[str] | None = None,
                          smote_k_neighbors: int = 5, random_state: int = 42,
                          model_names: tuple[str, ...] = GRID_MODELS, include_smote: bool = True,
                          device: torch.device | str = "cuda") -> dict[str, dict]:
    """{Original, SMOTE} x model grid, skipping Weighted-on-SMOTE (C18)."""
    n_classes = len(class_names) if class_names else int(max(y_train.max(), y_test.max())) + 1
    datasets = {"Original": (X_train, y_train)}
    if include_smote:
        datasets["SMOTE"] = apply_smote_oversampling(
            X_train, y_train, k_neighbors=smote_k_neighbors, random_state=random_state,
            device=device)

    results: dict[str, dict] = {}
    for data_name, (Xd, yd) in datasets.items():
        for model_name in model_names:
            if data_name == "SMOTE" and "Weighted" in model_name:
                continue  # class weights on SMOTE's balanced set correct twice (reference :670-672)
            key = f"{data_name}_{model_name}"
            model = _grid_estimator(model_name, Xd.shape[1], n_classes, random_state, device)
            logger.info("training %s", key)
            model.fit(Xd, np.asarray(yd))
            r = classification_metrics(y_test, model.predict(X_test), n_classes, class_names)
            r["model"] = model_name
            r["data"] = data_name
            r["estimator"] = model
            results[key] = r
            logger.info("%s: acc=%.4f balanced_acc=%.4f weighted_f1=%.4f", key,
                        r["accuracy"], r["balanced_accuracy"], r["weighted_f1"])
    return results
