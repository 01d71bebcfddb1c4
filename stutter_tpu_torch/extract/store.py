"""The .npy+CSV embedding store (counterpart of ``stutter_tpu/extract/store.py``).

Per split, ``embedding_metadata.csv`` holds every non-embedding column and
each embedding column becomes ``{name}_embeddings.npy`` (row-stacked, row
order == metadata order). The files are the JAX package's: columns in order
of first appearance, missing values empty, ``\\n`` line ends.

The read side returns metadata as a list of dicts, one a row, with every
column in every row. It reads the cells as ``pandas.read_csv`` types them,
so that labels, and the class names made from them by ``str``, are the JAX
package's: a column of integers gives ints, one with a number that is not an
integer or with an empty cell gives floats, true/false gives bools, anything
else strings; an empty cell (or one of pandas' NA words) is None. Across
splits, a column that is integer in one file and float or empty in another
becomes float, as ``pd.concat`` makes it.

A write is an ``extract.store`` span (``utils.profiling.span``) with its rows.
"""

from __future__ import annotations

import csv
import logging
import math
import os
import re

import numpy as np

from stutter_tpu_torch.utils.profiling import span

logger = logging.getLogger("stutter_tpu_torch.extract.store")

SPLIT_ORDER = ("train", "test", "devel")

# pandas.read_csv's default NA words
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                 "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                 "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*")


def _is_embedding_col(col: str) -> bool:
    return col.startswith(("layer_", "encoder_layer_", "decoder_layer_"))


def csv_cell(value) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return str(value)


def save_embeddings(rows: list[dict], output_dir: str, split: str | None = None,
                    expected_dim: int | None = None, columns: list[str] | None = None) -> None:
    """Persist one split's embeddings: metadata CSV + one .npy per layer.
    ``columns`` orders the columns (default: first appearance in ``rows``)."""
    with span("extract.store", rows=len(rows)):
        if not rows:
            logger.warning("no embeddings to save")
            return
        split_dir = os.path.join(output_dir, split) if split and split != "all" else output_dir
        os.makedirs(split_dir, exist_ok=True)

        if columns is None:
            columns = list(dict.fromkeys(col for row in rows for col in row))
        metadata_cols = [c for c in columns if not _is_embedding_col(c)]
        with open(os.path.join(split_dir, "embedding_metadata.csv"), "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(metadata_cols)
            for row in rows:
                writer.writerow([csv_cell(row.get(c)) for c in metadata_cols])
        logger.info("saved metadata for %d files to %s", len(rows), split_dir)

        for col in [c for c in columns if _is_embedding_col(c)]:
            arr = np.stack([np.asarray(row[col]) for row in rows])
            if expected_dim is not None and arr.shape[-1] != expected_dim:
                logger.warning("WARNING: %s has dimension %d but expected %d",
                               col, arr.shape[-1], expected_dim)
            np.save(os.path.join(split_dir, f"{col}_embeddings.npy"), arr)
            logger.info("saved %s embeddings with shape %s", col, arr.shape)


def _number(cell: str):
    """``cell`` as a float, or None where it is not a number."""
    if "_" in cell:
        return None
    try:
        return float(cell)
    except ValueError:
        return None


def _typed_column(cells: list[str]) -> tuple[str, list]:
    """(kind, values) of one CSV column as pandas types it: kind is "int",
    "float", "bool", "str" or "empty" (every cell NA); NA cells are None."""
    present = [c for c in cells if c not in _NA]
    if not present:
        return "empty", [None] * len(cells)
    if all(_INT.fullmatch(c) for c in present):
        if len(present) == len(cells):
            return "int", [int(c) for c in cells]
        return "float", [None if c in _NA else float(int(c)) for c in cells]
    if all(_number(c) is not None for c in present):
        return "float", [None if c in _NA else _number(c) for c in cells]
    if all(c.lower() in ("true", "false") for c in present):
        return "bool", [None if c in _NA else c.lower() == "true" for c in cells]
    return "str", [None if c in _NA else c for c in cells]


def _read_metadata(path: str) -> tuple[list[str], dict[str, tuple[str, list]]]:
    """(columns, {column: (kind, values)}) of one metadata CSV."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        body = [row for row in reader if row]
    cells = {c: [row[i] if i < len(row) else "" for row in body] for i, c in enumerate(header)}
    return header, {c: _typed_column(v) for c, v in cells.items()}


def _concat_columns(parts: list[tuple[list[str], dict, int]]) -> list[dict]:
    """Rows of several typed CSVs in order, with pd.concat's dtype rules
    for int columns: float (or empty, or missing) elsewhere makes them float,
    bool elsewhere leaves them int and turns the bools into ints."""
    columns = list(dict.fromkeys(c for header, _, _ in parts for c in header))
    merged: dict[str, list] = {}
    for col in columns:
        kinds = {typed[col][0] if col in typed else "empty" for _, typed, _ in parts}
        values = []
        for _, typed, n in parts:
            values.extend(typed[col][1] if col in typed else [None] * n)
        if "int" in kinds and kinds & {"float", "empty"} and kinds <= {"int", "float", "empty"}:
            values = [None if v is None else float(v) for v in values]
        elif kinds == {"int", "bool"}:
            values = [None if v is None else int(v) for v in values]
        merged[col] = values
    n_rows = sum(n for _, _, n in parts)
    return [{c: merged[c][i] for c in columns} for i in range(n_rows)]


def load_embeddings(embeddings_dir: str, model_type: str,
                    splits: tuple[str, ...] = SPLIT_ORDER,
                    ) -> tuple[list[dict] | None, dict[str, np.ndarray]]:
    """Load the predefined-split store: (metadata rows with 'split', {layer: X}).

    Each layer's rows follow the concatenated metadata rows (train -> test
    -> devel): downstream code slices positionally. ``{embeddings_dir}/
    {model_type}`` is used where that directory exists, else
    ``embeddings_dir`` itself."""
    candidate = os.path.join(embeddings_dir, model_type)
    model_dir = candidate if os.path.isdir(candidate) else embeddings_dir
    if not os.path.isdir(model_dir):
        logger.error("embeddings directory for %s not found: %s", model_type, model_dir)
        return None, {}

    parts = []
    per_split_layers: dict[str, list[np.ndarray]] = {}
    for sub in splits:
        split_dir = os.path.join(model_dir, sub)
        meta_path = os.path.join(split_dir, "embedding_metadata.csv")
        if not os.path.exists(meta_path):
            logger.error("metadata file not found for %s: %s", sub, meta_path)
            return None, {}
        header, typed = _read_metadata(meta_path)
        n = len(next(iter(typed.values()))[1]) if typed else 0
        typed["split"] = ("str", [sub] * n)
        parts.append((header + ["split"], typed, n))

        files = sorted(f for f in os.listdir(split_dir) if f.endswith("_embeddings.npy"))
        for f in files:
            layer = f[: -len("_embeddings.npy")]
            per_split_layers.setdefault(layer, []).append(np.load(os.path.join(split_dir, f)))

    metadata = _concat_columns(parts)
    layers = {k: np.vstack(v) if len(v) > 1 else v[0] for k, v in per_split_layers.items()}
    for k, v in layers.items():
        if len(v) != len(metadata):
            logger.warning("layer %s rows (%d) != metadata rows (%d)", k, len(v), len(metadata))
    return metadata, layers


def combined_top_key(columns) -> str:
    """The per-part 'top' layer of ``combined_top``: the highest-numbered
    column that is not a decoder's."""

    def num(k):
        tail = k.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else -1

    pref = [k for k in columns if not k.startswith("decoder_")] or list(columns)
    return max(pref, key=num)


def _dedupe(meta: list[dict], layers: dict[str, np.ndarray], part: str):
    """Keep the first row of each (filename, split)."""
    seen: set = set()
    keep = np.zeros(len(meta), bool)
    for i, row in enumerate(meta):
        key = (row.get("filename"), row.get("split"))
        keep[i] = key not in seen
        seen.add(key)
    if not keep.all():
        logger.warning("combined store: part %r has %d duplicate (filename, split) rows; "
                       "keeping first", part, int((~keep).sum()))
        meta = [r for r, k in zip(meta, keep) if k]
        layers = {k: v[keep] for k, v in layers.items()}
    return meta, layers


def load_embeddings_combined(embeddings_dir: str, parts: tuple[str, ...] = ("wavlm", "whisper"),
                             splits: tuple[str, ...] = SPLIT_ORDER,
                             ) -> tuple[list[dict] | None, dict[str, np.ndarray]]:
    """The multi-model store: rows aligned by (filename, split) on the first
    part's order, each part's layers prefixed with its name, and
    ``combined_top``, the parts' top layers side by side. Rows missing from
    any part are dropped."""
    metas, layer_sets = [], []
    for part in parts:
        meta, layers = load_embeddings(embeddings_dir, part, splits)
        if meta is None or not layers:
            logger.error("combined store: missing part %r under %s", part, embeddings_dir)
            return None, {}
        metas.append(meta)
        layer_sets.append(layers)

    base, base_layers = _dedupe(metas[0], layer_sets[0], parts[0])
    out_layers = {f"{parts[0]}_{k}": v for k, v in base_layers.items()}
    keep = np.ones(len(base), bool)
    for part, meta, layers in zip(parts[1:], metas[1:], layer_sets[1:]):
        meta, layers = _dedupe(meta, layers, part)
        row_of = {(r.get("filename"), r.get("split")): i for i, r in enumerate(meta)}
        rows = [row_of.get((r.get("filename"), r.get("split"))) for r in base]
        keep &= np.array([i is not None for i in rows], bool)
        idx = np.array([0 if i is None else i for i in rows], np.int64)
        for k, v in layers.items():
            out_layers[f"{part}_{k}"] = v[idx]
    if not keep.all():
        logger.warning("combined store: dropping %d rows missing in some part",
                       int((~keep).sum()))
        base = [r for r, k in zip(base, keep) if k]
        out_layers = {k: v[keep] for k, v in out_layers.items()}

    tops = [out_layers[f"{p}_{combined_top_key(layer_sets[i])}"] for i, p in enumerate(parts)]
    out_layers["combined_top"] = np.hstack(tops)
    return base, out_layers
