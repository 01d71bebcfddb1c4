"""Trained models and results on disk (counterpart of ``stutter_tpu/train/persistence.py``).

``save_results`` writes the same JSON. ``save_model`` writes beside the
same ``{base}_info.json`` sidecar:
- a fine-tuned model's parameters (a dict of leaves) or a
  ``HeadClassifier`` as ``{base}_model.npz``, one array per leaf keyed by
  its path in the JAX package's tree ("backbone/encoder/layers/q_w",
  "head/0/w", ...; a classifier's "head/{i}/w", "head/{i}/b",
  "scaler/mean", "scaler/scale");
- any other estimator (an sklearn pipeline) pickled as ``{base}_model.pkl``.
The JAX package writes ``.joblib`` files instead; neither package reads the
other's model files. ``load_model`` reads both of the port's kinds back.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from datetime import datetime

import numpy as np
import torch

from stutter_tpu_torch.train.heads import HeadClassifier, HeadConfig, MLPHead

logger = logging.getLogger("stutter_tpu_torch.train.persistence")


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _classifier_leaves(clf: HeadClassifier) -> dict[str, np.ndarray]:
    leaves = {}
    for i, layer in enumerate(clf.head.layers):
        leaves[f"head/{i}/w"] = layer.w.detach().cpu().numpy()
        leaves[f"head/{i}/b"] = layer.b.detach().cpu().numpy()
    leaves["scaler/mean"] = clf.scaler.mean_
    leaves["scaler/scale"] = clf.scaler.scale_
    return leaves


def save_model(model, results_dir: str, model_type: str, layer_name: str,
               classifier_name: str, metrics: dict | None = None,
               class_names: list | None = None) -> str:
    """Write ``model`` (a dict of leaves {tree path: array}, a
    ``HeadClassifier`` or a picklable estimator) plus the JSON sidecar;
    returns the model path. ``class_names[i]`` is the label of class i."""
    os.makedirs(results_dir, exist_ok=True)
    base = f"{model_type}_{layer_name}_{classifier_name}"
    if isinstance(model, (dict, HeadClassifier)):
        model_path = os.path.join(results_dir, f"{base}_model.npz")
        np.savez(model_path, **(model if isinstance(model, dict) else _classifier_leaves(model)))
    else:
        model_path = os.path.join(results_dir, f"{base}_model.pkl")
        with open(model_path, "wb") as f:
            pickle.dump(model, f)

    info = {
        "model_type": model_type,
        "layer": layer_name,
        "classifier": classifier_name,
        "date": datetime.now().isoformat(),
        "framework": "stutter_tpu_torch",
    }
    if class_names is not None:
        info["class_names"] = [str(c) for c in class_names]
    if metrics:
        info["metrics"] = _jsonable(
            {k: v for k, v in metrics.items() if k not in ("confusion_matrix", "estimator")}
        )
    with open(os.path.join(results_dir, f"{base}_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    logger.info("saved model to %s", model_path)
    return model_path


def load_model(model_path: str, device: torch.device | str = "cuda"):
    """Read back what ``save_model`` wrote: a ``HeadClassifier`` (on
    ``device``) or a dict of leaves from a ``.npz``, an estimator from a
    ``.pkl`` (unpickled: read only files this package wrote)."""
    if model_path.endswith(".pkl"):
        with open(model_path, "rb") as f:
            return pickle.load(f)
    with np.load(model_path) as z:
        leaves = {k: z[k] for k in z.files}
    if "scaler/mean" not in leaves:
        return leaves
    n_layers = sum(1 for k in leaves if k.startswith("head/") and k.endswith("/w"))
    params = [{"w": leaves[f"head/{i}/w"], "b": leaves[f"head/{i}/b"]} for i in range(n_layers)]
    dims = [p["w"].shape[0] for p in params] + [params[-1]["w"].shape[1]]
    cfg = HeadConfig(in_dim=dims[0], n_classes=dims[-1], hidden_dims=tuple(dims[1:-1]))
    clf = HeadClassifier(cfg, device=device)
    clf.head = MLPHead(cfg, device=clf.device).load_params(params).eval()
    clf.scaler.mean_, clf.scaler.scale_ = leaves["scaler/mean"], leaves["scaler/scale"]
    return clf


def save_results(all_results: dict, results_dir: str, filename: str = "results.json") -> str:
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, filename)
    with open(path, "w") as f:
        json.dump(_jsonable(all_results), f, indent=2, default=str)
    logger.info("saved results to %s", path)
    return path
