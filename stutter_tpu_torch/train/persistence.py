"""Fine-tuned model and results on disk (counterpart of ``stutter_tpu/train/persistence.py``).

``save_results`` writes the same JSON. ``save_model`` writes the parameters
as ``{base}_model.npz``, one array per leaf keyed by its path in the JAX
package's parameter tree ("backbone/encoder/layers/q_w", "head/0/w", ...),
beside the same ``{base}_info.json`` sidecar; the JAX package pickles its
tree with joblib instead, which the port does not use.
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime

import numpy as np

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


def save_model(leaves: dict[str, np.ndarray], results_dir: str, model_type: str,
               layer_name: str, classifier_name: str, metrics: dict | None = None,
               class_names: list | None = None) -> str:
    """Write ``leaves`` ({tree path: array}) as .npz plus the JSON sidecar;
    returns the model path."""
    os.makedirs(results_dir, exist_ok=True)
    base = f"{model_type}_{layer_name}_{classifier_name}"
    model_path = os.path.join(results_dir, f"{base}_model.npz")
    np.savez(model_path, **leaves)

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


def save_results(all_results: dict, results_dir: str, filename: str = "results.json") -> str:
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, filename)
    with open(path, "w") as f:
        json.dump(_jsonable(all_results), f, indent=2, default=str)
    logger.info("saved results to %s", path)
    return path
