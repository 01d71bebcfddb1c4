"""Grid downstream training CLI on one or many GPUs (flags of ``stutter_tpu.cli.train_grid``).

    python -m stutter_tpu_torch.cli.train_grid --embeddings_dir <store> \\
        --results_dir <out> --include_jax_heads --random_init [--device cuda]

The reference's flags (``model_training_1.py:40-97``), its paired boolean
flags parsed correctly (its ``type=bool`` took ``--use_smote False`` for
True) beside the ``--no_*`` overrides. ``--include_jax_heads`` adds the
linear and MLP heads to the grid (the name is the JAX CLI's). ``--device``,
``--preset``, ``--random_init``, ``--devices``/``--tp`` and the exit codes
are ``cli.train``'s.
"""

from __future__ import annotations

import argparse
import sys

from stutter_tpu_torch.cli.train import (
    MODEL_TYPES,
    UNIMPLEMENTED,
    add_device_args,
    build_extractor_for,
    plots_available,
    trainer_ranks,
)
from stutter_tpu_torch.utils.logging import get_logger, setup_logging


def str2bool(v: str | bool) -> bool:
    """The reference's boolean flag syntax, parsed correctly."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train stuttering classifiers with class balancing and augmentation "
                    "(PyTorch/CUDA)")
    parser.add_argument("--embeddings_dir", type=str, required=True)
    parser.add_argument("--results_dir", type=str, required=True)
    parser.add_argument("--model_type", type=str, default="wavlm_large", choices=MODEL_TYPES)
    parser.add_argument("--split", type=str, default="predefined",
                        choices=["train_test", "predefined", "all"])
    parser.add_argument("--test_size", type=float, default=0.2)
    parser.add_argument("--use_smote", type=str2bool, default=True)
    parser.add_argument("--no_smote", action="store_true")
    parser.add_argument("--use_class_weights", type=str2bool, default=True)
    parser.add_argument("--no_class_weights", action="store_true")
    parser.add_argument("--use_augmentation", type=str2bool, default=True)
    parser.add_argument("--no_augmentation", action="store_true")
    parser.add_argument("--smote_k_neighbors", type=int, default=3)
    parser.add_argument("--augmentation_factor", type=int, default=2)
    parser.add_argument("--minority_threshold", type=int, default=200)
    parser.add_argument("--model_name", type=str, default="microsoft/wavlm-large")
    parser.add_argument("--n_splits", type=int, default=5,
                        help="Accepted for reference compatibility")
    parser.add_argument("--include_jax_heads", action="store_true",
                        help="Add the Linear/MLP heads to the grid")
    parser.add_argument("--random_init", action="store_true",
                        help="Random re-extraction weights from seed 0 (no checkpoint load)")
    add_device_args(parser)
    args = parser.parse_args(argv)
    if args.no_smote:
        args.use_smote = False
    if args.no_class_weights:
        args.use_class_weights = False
    if args.no_augmentation:
        args.use_augmentation = False
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("model_training_grid")
    logger = get_logger("cli.train_grid")
    if args.model_type in UNIMPLEMENTED:
        logger.error("--model_type %s has no implementation; use one of %s",
                     args.model_type, sorted(set(MODEL_TYPES) - UNIMPLEMENTED))
        return 2
    if args.split not in ("predefined", "train_test"):
        logger.error("--split must be 'predefined' or 'train_test' (the reference accepts "
                     "'all' but has no implementation)")
        return 2
    rc, ranks = trainer_ranks("stutter_tpu_torch.cli.train_grid", argv, args)
    if rc is not None:
        return rc

    from stutter_tpu_torch.train.classifiers import GRID_MODELS, GRID_MODELS_JAX
    from stutter_tpu_torch.train.trainer import TrainConfig, run_grid_training

    plan, device = ranks
    model_names = list(GRID_MODELS)
    if not args.use_class_weights:
        model_names = [m for m in model_names if "Weighted" not in m]
    if args.include_jax_heads:
        model_names += list(GRID_MODELS_JAX)

    extractor = None
    if args.use_augmentation and args.augmentation_factor > 0:
        extractor = build_extractor_for(args.model_type, args.model_name, args.random_init,
                                        device, args.preset, plan)
    if plan is not None and plan.rank != 0 and extractor is None:
        return 0  # no re-extraction for this model type: rank 0 fits alone

    cfg = TrainConfig(
        embeddings_dir=args.embeddings_dir, results_dir=args.results_dir,
        model_type=args.model_type, use_smote=args.use_smote,
        smote_k_neighbors=args.smote_k_neighbors,
        augmentation_factor=args.augmentation_factor if args.use_augmentation else 0,
        minority_threshold=args.minority_threshold, make_plots=plots_available(logger),
        split=args.split, test_size=args.test_size, device=str(device))
    try:
        best = run_grid_training(cfg, extractor=extractor, model_names=tuple(model_names))
    except FileNotFoundError as e:
        logger.error("%s", e)
        return 1
    if plan is not None and plan.rank != 0:
        return 0
    best_layer = max(best, key=lambda k: best[k]["balanced_accuracy"])
    logger.info("BEST: %s (%s) balanced_acc=%.4f", best_layer,
                best[best_layer]["configuration"], best[best_layer]["balanced_accuracy"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
