"""Extraction checkpoint/resume, on the JAX package's on-disk contract.

A pickled list of per-file result dicts at
``{output_dir}/checkpoints/checkpoint_{split}_{n}.pkl``; resume finds the
highest-numbered checkpoint and skips the paths it holds. The pickles hold
numpy arrays and strings only, so either package reads the other's.
Each write is an ``extract.checkpoint`` span (``utils.profiling.span``)
with the rows it pickles.
"""

from __future__ import annotations

import logging
import os
import pickle

from stutter_tpu_torch.utils.profiling import span

logger = logging.getLogger("stutter_tpu_torch.extract.checkpoint")


def _ckpt_path(output_dir: str, split: str, n: int) -> str:
    return os.path.join(output_dir, "checkpoints", f"checkpoint_{split}_{n}.pkl")


def save_checkpoint(results: list[dict], output_dir: str, split: str, checkpoint_num: int) -> None:
    with span("extract.checkpoint", checkpoint=checkpoint_num, rows=len(results)):
        os.makedirs(os.path.join(output_dir, "checkpoints"), exist_ok=True)
        with open(_ckpt_path(output_dir, split, checkpoint_num), "wb") as f:
            pickle.dump(results, f)
    logger.info("saved checkpoint %d for %s split with %d processed files",
                checkpoint_num, split, len(results))


def load_checkpoint(output_dir: str, split: str, checkpoint_num: int) -> list[dict]:
    path = _ckpt_path(output_dir, split, checkpoint_num)
    if not os.path.exists(path):
        logger.info("no checkpoint found at %s", path)
        return []
    with open(path, "rb") as f:
        results = pickle.load(f)
    logger.info("loaded checkpoint %d for %s split with %d processed files",
                checkpoint_num, split, len(results))
    return results


def find_latest_checkpoint(output_dir: str, split: str) -> int | None:
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    nums = []
    for f in os.listdir(ckpt_dir):
        if f.startswith(f"checkpoint_{split}_") and f.endswith(".pkl"):
            try:
                nums.append(int(f.rsplit("_", 1)[-1].split(".")[0]))
            except ValueError:
                continue
    return max(nums) if nums else None
