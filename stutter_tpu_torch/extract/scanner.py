"""Corpus scanner: KSF / ComParE-22 layout -> metadata rows.

The layout rules of ``stutter_tpu/extract/scanner.py``, read with the ``csv``
module (every value a string) and returned as a list of row dicts:

- ``{data_dir}/wav/**`` holds clips; ``{data_dir}/lab/*.csv`` holds labels,
  joined by file stem;
- a label CSV's split comes from 'train'/'test'/'devel' in its filename;
- id column = first column; label column = the first column containing
  'label' (case-insensitive), else the second column;
- all label-CSV columns ride along into the row;
- clips named ``{split}_{id}`` join a CSV row of that split whose id lacks
  the prefix;
- files without a CSV mapping take their split from the filename;
- ``split != 'all'`` filters rows.
"""

from __future__ import annotations

import csv
import logging
import os

logger = logging.getLogger("stutter_tpu_torch.extract.scanner")

_SPLITS = ("train", "test", "devel")
_AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg", ".opus", ".m4a")


def _split_from_name(name: str) -> str:
    for s in _SPLITS:
        if s in name:
            return s
    return "unknown"


def _load_label_mapping(lab_dir: str, split: str,
                        ) -> tuple[dict[str, dict], dict[tuple[str, str], dict]]:
    """(by_stem, by_split_stem): last CSV wins in by_stem; by_split_stem keys
    (csv_split, stem) for the ``{split}_{id}`` fallback."""
    mapping: dict[str, dict] = {}
    by_split: dict[tuple[str, str], dict] = {}
    if not os.path.isdir(lab_dir):
        logger.warning("label directory not found: %s", lab_dir)
        return mapping, by_split
    for csv_file in sorted(f for f in os.listdir(lab_dir) if f.endswith(".csv")):
        try:
            with open(os.path.join(lab_dir, csv_file), newline="") as f:
                reader = csv.reader(f)
                header = next(reader)
                rows = list(reader)
        except (OSError, UnicodeDecodeError, csv.Error, StopIteration) as e:
            logger.error("error processing label file %s: %s", csv_file, e)
            continue
        current_split = _split_from_name(csv_file)
        if split != "all" and current_split not in ("unknown", split):
            continue
        if not header:
            continue
        label_idx = next((i for i, c in enumerate(header) if "label" in c.lower()), None)
        if label_idx is None and len(header) > 1:
            label_idx = 1
        if label_idx is None:
            continue
        for values in rows:
            row = dict(zip(header, values))
            file_id = values[0] if values else ""
            stem, ext = os.path.splitext(file_id)
            if ext.lower() not in _AUDIO_EXTS:
                stem = file_id
            entry = dict(row)
            entry["label"] = values[label_idx] if label_idx < len(values) else ""
            entry["split"] = current_split
            mapping[stem] = entry
            by_split[(current_split, stem)] = entry
        logger.info("added %d label mappings from %s", len(rows), csv_file)
    return mapping, by_split


def create_metadata_from_files(data_dir: str, split: str = "all") -> list[dict]:
    """Scan a KSF-layout corpus into rows with filename, path, label, split."""
    wav_dir = os.path.join(data_dir, "wav")
    lab_dir = os.path.join(data_dir, "lab")
    if not os.path.isdir(wav_dir):
        logger.error("WAV directory not found: %s", wav_dir)
        return []

    label_mapping, labels_by_split = _load_label_mapping(lab_dir, split)

    rows = []
    for root, _dirs, files in os.walk(wav_dir):
        for file in sorted(files):
            stem, ext = os.path.splitext(file)
            if ext.lower() not in _AUDIO_EXTS:
                continue
            mapped = label_mapping.get(stem)
            if mapped is None:
                for s in _SPLITS:
                    if stem.startswith(f"{s}_"):
                        mapped = labels_by_split.get((s, stem[len(s) + 1:]))
                        break
            entry: dict = dict(mapped) if mapped is not None else {}
            entry["filename"] = stem
            entry["path"] = os.path.join(root, file)
            if mapped is None:
                entry["split"] = _split_from_name(file)
            if split != "all" and entry.get("split", "unknown") != split:
                continue
            rows.append(entry)

    if not rows:
        logger.warning("no audio files found in %s for split %s", wav_dir, split)
    else:
        logger.info("found %d audio files in %s", len(rows), wav_dir)
    return rows
