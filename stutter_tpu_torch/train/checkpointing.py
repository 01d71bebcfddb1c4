"""Fine-tune checkpoint and resume (counterpart of ``stutter_tpu/train/checkpointing.py``).

The same layout as the JAX package, ``{ckpt_dir}/step_{step:08d}``, holding
the parameters, the optimizer state and the step, but written with
``torch.save`` (one ``state.pt`` per step directory): the port's checkpoints
are not orbax's, and neither package reads the other's. A step is written to
a temporary directory and renamed into place, so a reader never sees half of
one.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

import torch

logger = logging.getLogger("stutter_tpu_torch.train.checkpointing")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_train_state(ckpt_dir: str, step: int, params: dict, opt_state: dict) -> str:
    """Write {params, opt_state, step} for ``step``; returns its directory."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_step_", dir=os.path.dirname(path))
    try:
        torch.save({"params": params, "opt_state": opt_state, "step": int(step)},
                   os.path.join(tmp, "state.pt"))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    logger.info("saved train state at step %d -> %s", step, path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                steps.append(int(d.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, step: int, like_params: dict, like_opt_state: dict,
                        ) -> tuple[dict, dict, int]:
    """(params, opt_state, step) of ``step``, each tensor on the device of
    its counterpart in the templates."""
    path = os.path.join(_step_dir(ckpt_dir, step), "state.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)

    def place(loaded, like, what):
        if set(loaded) != set(like):
            raise ValueError(f"{path}: {what} keys differ from the model's")
        return {k: (place(v, like[k], what) if isinstance(v, dict)
                    else v.to(like[k].device) if torch.is_tensor(v) else v)
                for k, v in loaded.items()}

    logger.info("restored train state from %s", path)
    return (place(state["params"], like_params, "params"),
            place(state["opt_state"], like_opt_state, "optimizer state"), int(state["step"]))
