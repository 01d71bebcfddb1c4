"""Balanced downstream training CLI on one or many GPUs (flags of ``stutter_tpu.cli.train``).

    python -m stutter_tpu_torch.cli.train --embeddings_dir <store> \\
        --results_dir <out> --classifier mlp --random_init [--device cuda]

The reference's flags (``model_training_01.py:41-70``) with the heads
(mlp, linear) among the classifiers. ``--device`` names the torch device
of SMOTE, the heads and the augmentation's re-extraction (default
``cuda``); with no card it fails rather than running on the CPU. The
re-extraction model is loaded from the local HF checkpoint directory
``--model_name`` names, or built with random weights from seed 0
(``--random_init``); a hub name raises ``OSError`` (no download).
'bestrq' (accepted, never implemented
by the reference) and ``--split all`` exit with 2, a missing store with 1.
Plots need matplotlib: without it the run logs one warning and writes no
plots. ``--devices N --tp T`` run the augmentation's re-extraction on N
cards (``cli.common.run_on_devices``; under ``torchrun`` the CLI joins its
group): rank 0 makes the augmented copies, every rank encodes its rows of
them, and rank 0 alone fits and writes (the other ranks leave once the
rows are gathered). Every rank reads the store, so all must see it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from stutter_tpu_torch.cli.common import add_mesh_args
from stutter_tpu_torch.cli.extract_wavlm import long_attention_from_env
from stutter_tpu_torch.utils.logging import get_logger, setup_logging

MODEL_TYPES = ["whisper", "wavlm", "wavlm_large", "bestrq", "combined", "whisper_large_fixed"]
# accepted by the reference but implemented by neither it nor this package
UNIMPLEMENTED = {"bestrq"}


def add_device_args(parser: argparse.ArgumentParser) -> None:
    add_mesh_args(parser)
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset of the re-extraction model")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train stuttering classification models with balanced approach "
                    "(PyTorch/CUDA)")
    parser.add_argument("--embeddings_dir", type=str, required=True)
    parser.add_argument("--results_dir", type=str, required=True)
    parser.add_argument("--model_type", type=str, default="wavlm", choices=MODEL_TYPES)
    parser.add_argument("--split", type=str, default="predefined",
                        choices=["train_test", "predefined", "all"])
    parser.add_argument("--test_size", type=float, default=0.2)
    parser.add_argument("--augmentation_factor", type=int, default=3)
    parser.add_argument("--minority_threshold", type=int, default=100)
    parser.add_argument("--smote_k_neighbors", type=int, default=3)
    parser.add_argument("--no_smote", action="store_true", help="Disable SMOTE")
    parser.add_argument("--no_augmentation", action="store_true",
                        help="Disable augmentation re-extraction")
    parser.add_argument("--model_name", type=str, default="microsoft/wavlm-large",
                        help="Model for re-extracting embeddings from augmented audio")
    parser.add_argument("--classifier", type=str, default="svm",
                        choices=["svm", "rf", "xgb", "mlp", "linear", "all"])
    parser.add_argument("--head_epochs", type=int, default=200,
                        help="Training epochs for the mlp/linear heads")
    parser.add_argument("--random_init", action="store_true",
                        help="Random re-extraction weights from seed 0 (no checkpoint load)")
    add_device_args(parser)
    return parser.parse_args(argv)


def build_extractor_for(model_type: str, model_name: str, random_init: bool, device,
                        preset: str, plan=None):
    """The re-extraction model for augmentation (reference :735-758), or None
    for a model type without one (combined); cut and sharded by ``plan``."""
    from stutter_tpu_torch.cli.common import load_wavlm_model, load_whisper_model
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor, WhisperExtractor

    kind = model_type.lower()
    if kind in ("wavlm", "wavlm_large"):
        _, model = load_wavlm_model(model_name, random_init)
        return WavLMExtractor(model, device, preset=preset, plan=plan,
                              **long_attention_from_env())
    if kind in ("whisper", "whisper_large_fixed"):
        # the JAX CLI's rule (a WavLM name means the default Whisper), but a
        # local checkpoint directory is taken whatever its name
        local = os.path.isdir(model_name)
        name = model_name if local or "whisper" in model_name else "openai/whisper-large"
        _, model = load_whisper_model(name, random_init)
        return WhisperExtractor(model, device, preset=preset, plan=plan)
    return None


def plots_available(logger: logging.Logger) -> bool:
    """Whether matplotlib imports; logs one warning line when it does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.warning("matplotlib is not installed: writing no plots")
        return False
    return True


def trainer_ranks(module: str, argv, args):
    """(exit code, None) once spawned ranks are done, else (None, (plan,
    this rank's device)); only the augmentation's re-extraction runs on
    several cards."""
    from stutter_tpu_torch.cli.common import build_plan, rank_device, run_on_devices

    rc = run_on_devices(module, argv, args, args.results_dir)
    if rc is not None:
        return rc, None
    plan = build_plan(args)
    return None, (plan, rank_device(args, plan))


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("model_training")
    logger = get_logger("cli.train")
    if args.model_type in UNIMPLEMENTED:
        logger.error("--model_type %s is accepted by the reference CLI but has no "
                     "implementation there or here; use one of %s",
                     args.model_type, sorted(set(MODEL_TYPES) - UNIMPLEMENTED))
        return 2
    if args.split not in ("predefined", "train_test"):
        logger.error("--split must be 'predefined' or 'train_test' (the reference accepts "
                     "'all' but has no implementation)")
        return 2
    rc, ranks = trainer_ranks("stutter_tpu_torch.cli.train", argv, args)
    if rc is not None:
        return rc

    from stutter_tpu_torch.train.trainer import TrainConfig, run_balanced_training

    plan, device = ranks
    classifiers = ("svm", "rf", "xgb") if args.classifier == "all" else (args.classifier,)
    extractor = None
    if args.augmentation_factor > 0 and not args.no_augmentation:
        extractor = build_extractor_for(args.model_type, args.model_name, args.random_init,
                                        device, args.preset, plan)
    if plan is not None and plan.rank != 0 and extractor is None:
        return 0  # no re-extraction for this model type: rank 0 fits alone

    cfg = TrainConfig(
        embeddings_dir=args.embeddings_dir, results_dir=args.results_dir,
        model_type=args.model_type, classifiers=classifiers, use_smote=not args.no_smote,
        smote_k_neighbors=args.smote_k_neighbors,
        augmentation_factor=0 if args.no_augmentation else args.augmentation_factor,
        minority_threshold=args.minority_threshold, make_plots=plots_available(logger),
        head_overrides={"epochs": args.head_epochs}, split=args.split,
        test_size=args.test_size, device=str(device))
    try:
        best = run_balanced_training(cfg, extractor=extractor)
    except FileNotFoundError as e:
        logger.error("%s", e)
        return 1
    if plan is not None and plan.rank != 0:
        return 0
    best_layer = max(best, key=lambda k: best[k]["balanced_accuracy"])
    logger.info("BEST: %s balanced_acc=%.4f", best_layer, best[best_layer]["balanced_accuracy"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
