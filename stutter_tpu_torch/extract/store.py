"""The .npy+CSV embedding store (write side of ``stutter_tpu/extract/store.py``).

Per split, ``embedding_metadata.csv`` holds every non-embedding column and
each embedding column becomes ``{name}_embeddings.npy`` (row-stacked, row
order == metadata order). The files are the JAX package's: columns in order
of first appearance, missing values empty, ``\\n`` line ends.
"""

from __future__ import annotations

import csv
import logging
import math
import os

import numpy as np

logger = logging.getLogger("stutter_tpu_torch.extract.store")


def _is_embedding_col(col: str) -> bool:
    return col.startswith(("layer_", "encoder_layer_", "decoder_layer_"))


def _cell(value) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def save_embeddings(rows: list[dict], output_dir: str, split: str | None = None,
                    expected_dim: int | None = None) -> None:
    """Persist one split's embeddings: metadata CSV + one .npy per layer."""
    if not rows:
        logger.warning("no embeddings to save")
        return
    split_dir = os.path.join(output_dir, split) if split and split != "all" else output_dir
    os.makedirs(split_dir, exist_ok=True)

    columns = list(dict.fromkeys(col for row in rows for col in row))
    metadata_cols = [c for c in columns if not _is_embedding_col(c)]
    with open(os.path.join(split_dir, "embedding_metadata.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(metadata_cols)
        for row in rows:
            writer.writerow([_cell(row.get(c)) for c in metadata_cols])
    logger.info("saved metadata for %d files to %s", len(rows), split_dir)

    for col in [c for c in columns if _is_embedding_col(c)]:
        arr = np.stack([np.asarray(row[col]) for row in rows])
        if expected_dim is not None and arr.shape[-1] != expected_dim:
            logger.warning("WARNING: %s has dimension %d but expected %d",
                           col, arr.shape[-1], expected_dim)
        np.save(os.path.join(split_dir, f"{col}_embeddings.npy"), arr)
        logger.info("saved %s embeddings with shape %s", col, arr.shape)
