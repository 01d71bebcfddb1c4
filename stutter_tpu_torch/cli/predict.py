"""Batch prediction CLI on one or many GPUs: audio corpus -> embeddings ->
trained classifier -> CSV (flags of ``stutter_tpu.cli.predict``, plus ``--device``).

    python -m stutter_tpu_torch.cli.predict --audio_dir /data/new_clips \\
      --classifier_model results/layer_24/wavlm_layer_24_mlp_model.npz \\
      --model_type wavlm_large --model_name <checkpoint dir> --output predictions.csv

Three input modes, exactly one:
- ``--data_dir``: a KSF-layout corpus (wav/ + lab/); its labels ride into
  the output and a balanced-accuracy line is logged;
- ``--audio_dir``: a directory of audio files, searched recursively, no labels;
- ``--embeddings_dir``: an extraction store; its vectors are classified
  with no backbone forward.

The classifier is a model the port's trainer wrote (``{base}_model.npz`` or
``.pkl``) with its ``_info.json`` sidecar naming the layer column and the
class names; ``--model_type combined`` extracts both backbones and
classifies the fusion store's columns (``combined_top`` among them).
Metadata is a list of dict rows and the CSV is written with the ``csv``
module, in the JAX CLI's columns.

``--devices N --tp T`` extract on N cards (``cli.common.run_on_devices``;
under ``torchrun`` the CLI joins its group) through the data-parallel
``ExtractionPipeline``: every rank decodes and encodes its rows, rank 0
writes the store, loads it, classifies and writes the CSV; the other ranks
leave after the pipeline. Every rank must see the corpus at the same paths.
``--embeddings_dir`` has no device work: rank 0 does it alone.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import tempfile

import numpy as np

from stutter_tpu_torch.cli.common import add_mesh_args
from stutter_tpu_torch.utils.logging import get_logger, setup_logging

MODEL_TYPES = ["wavlm", "wavlm_large", "whisper", "whisper_large_fixed", "combined"]
_SPLIT_DIRS = ("train", "test", "devel", "predict", "unknown")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Apply a trained stutter classifier to a corpus of audio (PyTorch/CUDA)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--data_dir", type=str, default=None,
                     help="KSF-layout corpus (wav/ + lab/); labels, when present, are "
                          "carried into the output and scored")
    src.add_argument("--audio_dir", type=str, default=None,
                     help="Directory of audio files (recursive, no labels)")
    src.add_argument("--embeddings_dir", type=str, default=None,
                     help="Existing extraction store: classify stored vectors, no "
                          "backbone forward")
    parser.add_argument("--classifier_model", type=str, required=True,
                        help="Trained model: {...}_model.npz or .pkl with its _info.json "
                             "sidecar (train/persistence.py)")
    parser.add_argument("--output", type=str, default="predictions.csv",
                        help="Prediction CSV path")
    parser.add_argument("--model_type", type=str, default="wavlm_large", choices=MODEL_TYPES)
    parser.add_argument("--model_name", type=str, default=None,
                        help="Local HF checkpoint directory (default name by model_type; "
                             "for 'combined' this names the WavLM part)")
    parser.add_argument("--whisper_model_name", type=str, default="openai/whisper-large",
                        help="'combined' only: the Whisper part's checkpoint")
    parser.add_argument("--keep_embeddings_dir", type=str, default=None,
                        help="Persist the intermediate extraction store here "
                             "(default: a temp dir)")
    parser.add_argument("--batch_size", type=int, default=128,
                        help="Max clips per device batch")
    parser.add_argument("--audio_budget", type=float, default=240.0,
                        help="Audio seconds per device batch")
    parser.add_argument("--max_length", type=float, default=None,
                        help="Maximum audio length in seconds (longer trimmed)")
    parser.add_argument("--long_files", type=str, default="trim", choices=["trim", "chunk"])
    parser.add_argument("--random_init", action="store_true",
                        help="Random backbone weights from seed 0 (no checkpoint load)")
    add_mesh_args(parser)
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset of the backbone")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def _scan_audio_dir(audio_dir: str) -> list[dict]:
    """A clip directory, searched recursively -> metadata rows with split 'predict'."""
    from stutter_tpu_torch.extract.scanner import _AUDIO_EXTS

    rows = []
    for root, _dirs, files in os.walk(audio_dir):
        for f in sorted(files):
            stem, ext = os.path.splitext(f)
            if ext.lower() in _AUDIO_EXTS:
                rows.append({"filename": stem, "path": os.path.join(root, f),
                             "split": "predict"})
    return rows


def _splits_of(metadata: list[dict]) -> list[str]:
    return list(dict.fromkeys(r["split"] for r in metadata if isinstance(r.get("split"), str)))


def _present_splits(model_dir: str, restrict=None) -> tuple[str, ...]:
    """Split directories of a store that hold a metadata CSV; ``restrict``
    limits them to the splits this run extracted, so that a reused
    ``--keep_embeddings_dir`` holding another corpus's splits adds nothing."""
    names = _SPLIT_DIRS if restrict is None else tuple(restrict)
    return tuple(s for s in names
                 if os.path.exists(os.path.join(model_dir, s, "embedding_metadata.csv")))


def _load_store(embeddings_dir: str, model_type: str, logger, restrict=None):
    """(metadata rows, {layer: X}) of a store, any subset of splits."""
    from stutter_tpu_torch.extract.store import load_embeddings, load_embeddings_combined

    if model_type == "combined":
        part_dir = os.path.join(embeddings_dir, "wavlm")
        splits = _present_splits(part_dir, restrict)
        if not splits:
            logger.error("combined store: no splits under %s", part_dir)
            return None, {}
        return load_embeddings_combined(embeddings_dir, splits=splits)
    candidate = os.path.join(embeddings_dir, model_type)
    model_dir = candidate if os.path.isdir(candidate) else embeddings_dir
    splits = _present_splits(model_dir, restrict)
    if not splits:
        logger.error("no split directories with metadata under %s", model_dir)
        return None, {}
    return load_embeddings(embeddings_dir, model_type, splits=splits)


def _extract_corpus(args, metadata: list[dict], out_root: str, device, logger,
                    plan=None) -> bool:
    """Run the extraction pipeline(s) into ``out_root``: one directory per
    part for 'combined' (the fusion layout the train CLI reads); under
    ``plan`` on every rank, rank 0 writing."""
    from stutter_tpu_torch.cli import common
    from stutter_tpu_torch.cli.train import build_extractor_for
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline

    name = common.default_model_name(args.model_type, args.model_name)
    whisper_only = args.model_type.startswith("whisper")
    if args.model_type == "combined":
        # --max_length trims the WavLM part only: Whisper keeps its native
        # 30 s window, as its training store was extracted
        parts = [("wavlm", name, args.max_length), ("whisper", args.whisper_model_name, None)]
    else:
        if whisper_only and args.max_length:
            logger.warning("--max_length is ignored for whisper predict: training-time "
                           "whisper embeddings use the native 30 s window")
        parts = [(args.model_type, name, None if whisper_only else args.max_length)]

    splits = _splits_of(metadata)
    for part_type, part_name, part_max_len in parts:
        extractor = build_extractor_for(part_type, part_name, args.random_init, device,
                                        args.preset, plan)
        if extractor is None:
            logger.error("unsupported model_type %s", part_type)
            return False
        batcher = common.make_bucket_batcher(extractor, plan=plan,
                                             audio_budget_s=args.audio_budget,
                                             max_batch=args.batch_size,
                                             max_length_s=part_max_len)
        pipe = ExtractionPipeline(extractor, batcher=batcher, long_file_policy=args.long_files)
        dest = os.path.join(out_root, part_type if args.model_type == "combined"
                            else args.model_type)
        # a reused --keep_embeddings_dir may hold a split of the same name from
        # another corpus: drop its layer files before writing this one's
        for split in splits if plan is None or plan.rank == 0 else ():
            split_dir = os.path.join(dest, split)
            if os.path.isdir(split_dir):
                for f in os.listdir(split_dir):
                    if f.endswith("_embeddings.npy"):
                        os.unlink(os.path.join(split_dir, f))
        pipe.run(metadata, dest, splits=splits)
    return True


def write_predictions(path: str, meta: list[dict], labels: list[str],
                      probs: list[dict] | None) -> list[dict]:
    """The prediction CSV: filename, path, split, label (those present),
    predicted_label, then prob_{class} in sorted class order. Returns the rows."""
    from stutter_tpu_torch.extract.store import csv_cell

    present = set().union(*(r.keys() for r in meta)) if meta else set()
    keep = [c for c in ("filename", "path", "split", "label") if c in present]
    prob_cols = sorted(probs[0]) if probs else []
    header = keep + ["predicted_label"] + [f"prob_{c}" for c in prob_cols]
    rows = []
    for i, r in enumerate(meta):
        row = {c: r.get(c) for c in keep}
        row["predicted_label"] = labels[i]
        for c in prob_cols:
            row[f"prob_{c}"] = probs[i][c]
        rows.append(row)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows([csv_cell(row[c]) for c in header] for row in rows)
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("predict")
    logger = get_logger("cli.predict")

    from stutter_tpu_torch.cli.common import build_plan, rank_device, run_on_devices
    from stutter_tpu_torch.parallel.mesh import broadcast_round
    from stutter_tpu_torch.serve.classify import ServingClassifier

    rc = run_on_devices("stutter_tpu_torch.cli.predict", argv, args,
                        os.path.dirname(os.path.abspath(args.output)))
    if rc is not None:
        return rc
    plan = build_plan(args)
    leads = plan is None or plan.rank == 0
    if args.embeddings_dir and not leads:
        return 0  # no device work: rank 0 classifies the store alone
    device = rank_device(args, plan)
    if leads:
        clf = ServingClassifier.load(args.classifier_model, device=device)

    corpus_splits = None  # None: every split on disk (--embeddings_dir)
    if args.embeddings_dir:
        store_root = args.embeddings_dir
    else:
        if args.audio_dir is not None:
            metadata = _scan_audio_dir(args.audio_dir)
        else:
            from stutter_tpu_torch.extract.scanner import create_metadata_from_files

            metadata = create_metadata_from_files(args.data_dir, "all")
        if not metadata:
            logger.error("no audio files found")
            return 1
        store_root = None
        if leads:
            store_root = args.keep_embeddings_dir or tempfile.mkdtemp(prefix="stutter_predict_")
            logger.info("extracting %d clips -> %s", len(metadata), store_root)
        if plan is not None:  # one store, rank 0's
            store_root = broadcast_round(plan, store_root)
        if not _extract_corpus(args, metadata, store_root, device, logger, plan):
            return 1
        if not leads:
            return 0
        corpus_splits = _splits_of(metadata)

    meta, layers = _load_store(store_root, args.model_type, logger, restrict=corpus_splits)
    if meta is None or not layers:
        return 1
    if clf.layer not in layers:
        logger.error("classifier was trained on column %r; store has %s", clf.layer,
                     sorted(layers))
        return 1

    labels, probs = clf.predict_rows(layers[clf.layer])
    rows = write_predictions(args.output, meta, labels, probs)
    logger.info("wrote %d predictions -> %s", len(rows), args.output)

    scored = [r for r in rows if r.get("label") is not None]
    if scored:
        from stutter_tpu_torch.train.metrics import classification_metrics

        names = sorted({str(r["label"]) for r in scored}
                       | {str(r["predicted_label"]) for r in scored})
        idx = {n: i for i, n in enumerate(names)}
        y_true = np.array([idx[str(r["label"])] for r in scored], np.int64)
        y_pred = np.array([idx[str(r["predicted_label"])] for r in scored], np.int64)
        bal = classification_metrics(y_true, y_pred, len(names), names)["balanced_accuracy"]
        logger.info("balanced accuracy on %d labeled clips: %.4f", len(scored), bal)
    return 0


if __name__ == "__main__":
    sys.exit(main())
