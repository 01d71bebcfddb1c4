"""End-to-end WavLM fine-tuning on one GPU (flags of ``stutter_tpu.cli.finetune``).

    python -m stutter_tpu_torch.cli.finetune --data_dir <corpus> \\
        --results_dir <out> --random_init [--epochs 5] [--batch_size 32] \\
        [--grad_accum K] [--checkpoint_dir <dir> [--resume]] [--device cuda]

WavLM backbone + layer-weighted sum + MLP head, class-weighted cross-entropy,
bf16 activations on f32 master weights. The train split is decoded once into
length-bucketed batches (frame-aligned to 16 frames, ``--max_length``
trimming), which each epoch visits in an order drawn from
``np.random.RandomState(0)``; ``--grad_accum K`` accumulates K same-shape
batches per update. The full train state is checkpointed after each epoch
under ``--checkpoint_dir`` and ``--resume`` continues from the latest one.
Test and devel are evaluated at the end; ``finetune_results.json`` and the
model (``.npz`` + ``_info.json``) go to ``--results_dir``.

``--device`` names the torch device (default ``cuda``; with no card it fails
rather than running on the CPU). ``--random_init`` (seed 0) is the only
model source for now; ``--int8_forward``, the remat policies ``layer_dots``,
``layer_probs`` and ``dots``, ``--devices``/``--tp`` above 1, and the JAX
package's ``STUTTER_TPU_LONG_ATTENTION_FLASH`` switch (its backward is not
ported) raise.
``--preset`` is accepted and ignored, as in the JAX CLI: fine-tuning always
runs bf16 activations.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from stutter_tpu_torch.cli.extract_wavlm import WAVLM_CONFIGS, long_attention_from_env


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fine-tune WavLM end-to-end (PyTorch/CUDA)")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--results_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="microsoft/wavlm-large",
                        choices=sorted(WAVLM_CONFIGS))
    parser.add_argument("--model_path", type=str, default=None,
                        help="Local checkpoint directory (not supported yet)")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--backbone_lr", type=float, default=1e-5)
    parser.add_argument("--head_lr", type=float, default=1e-3)
    parser.add_argument("--max_length", type=float, default=10.0)
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Accumulate gradients over K same-bucket batches "
                             "before each optimizer update: effective batch "
                             "K*batch_size at the memory of one batch")
    parser.add_argument("--freeze_backbone", action="store_true",
                        help="SUPERB-style probe: train only layer weights + head")
    parser.add_argument("--no_remat", action="store_true",
                        help="Keep encoder activations for the backward pass "
                             "instead of recomputing them")
    parser.add_argument("--remat_policy",
                        choices=["layer", "layer_probs", "layer_dots", "nothing", "dots"],
                        default="layer",
                        help="'layer' (default) recomputes each encoder layer in "
                             "its backward; 'nothing' recomputes the whole "
                             "encoder; 'layer_probs', 'layer_dots' and 'dots' "
                             "are not ported yet")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="Save the full train state (params + optimizer "
                             "state) here after every epoch; off when unset")
    parser.add_argument("--resume", action="store_true",
                        help="Restore the latest state under --checkpoint_dir "
                             "and continue from its epoch (the dropout and "
                             "SpecAugment generator is not part of the checkpoint)")
    parser.add_argument("--int8_forward", action="store_true",
                        help="int8 forward GEMMs (not ported yet)")
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights from seed 0 (no checkpoint load)")
    parser.add_argument("--devices", type=int, default=None,
                        help="Number of devices (only 1 is supported)")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (only 1 is supported)")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Accepted and ignored: fine-tuning runs bf16 activations")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def _check_supported(args) -> None:
    if not args.random_init:
        raise NotImplementedError(
            "loading HF checkpoints is not ported yet (ROADMAP Queue 1, HF checkpoint "
            "loading); pass --random_init")
    if (args.devices or 1) != 1 or args.tp != 1:
        raise NotImplementedError(
            "multi-device runs are not ported yet (ROADMAP Queue 1, multi-GPU)")
    if long_attention_from_env()["long_attention"] != "gated":
        raise NotImplementedError(
            "STUTTER_TPU_LONG_ATTENTION_FLASH is set: the backward of the materialised-bias "
            "attention is not ported yet (ROADMAP Queue 1, fine-tuning); unset it to train")


def main(argv=None) -> int:
    args = parse_args(argv)
    _check_supported(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    logger = logging.getLogger("stutter_tpu_torch.cli.finetune")

    import dataclasses

    import torch

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import resolve_device
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.train.checkpointing import (
        latest_step, restore_train_state, save_train_state)
    from stutter_tpu_torch.train.class_weights import compute_class_weights
    from stutter_tpu_torch.train.data import build_label_maps
    from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneTrainer
    from stutter_tpu_torch.train.metrics import classification_metrics
    from stutter_tpu_torch.train.persistence import save_model, save_results
    from stutter_tpu_torch.weights.convert import finetune_params_to_numpy, flatten_tree

    cfg_model = getattr(WavLMConfig, WAVLM_CONFIGS[args.model_name])()
    cfg = FinetuneConfig(  # n_classes is set once the labels are read
        model=cfg_model, n_classes=1,
        backbone_lr=args.backbone_lr, head_lr=args.head_lr,
        freeze_backbone=args.freeze_backbone,
        remat_encoder=not args.no_remat,
        remat_policy=args.remat_policy,
        int8_forward=args.int8_forward,
        activation_dtype=torch.bfloat16,
    )
    cfg.check_supported()  # int8_forward and the unported remat policies raise
    if args.resume and not args.checkpoint_dir:
        logger.error("--resume requires --checkpoint_dir")
        return 2
    device = resolve_device(args.device)
    logger.warning("--random_init: using fresh %s weights (seed 0, no checkpoint load)",
                   args.model_name)

    metadata = [r for r in create_metadata_from_files(args.data_dir, split="all")
                if r.get("label") not in (None, "")]
    if not metadata:
        logger.error("no labeled files under %s", args.data_dir)
        return 1
    label_to_idx, idx_to_label = build_label_maps([r["label"] for r in metadata])
    class_names = [str(idx_to_label[i]) for i in range(len(idx_to_label))]
    train_meta = [r for r in metadata if r.get("split") == "train"]
    eval_meta = [r for r in metadata if r.get("split") in ("test", "devel")]
    y_train = np.array([label_to_idx[r["label"]] for r in train_meta], np.int64)
    class_weights = compute_class_weights(y_train, len(class_names))

    cfg = dataclasses.replace(cfg, n_classes=len(class_names))
    # a random backbone from seed cfg.seed = 0, as --random_init says
    trainer = FinetuneTrainer(cfg, device=device, grad_accum=max(1, args.grad_accum))
    batcher = BucketBatcher(
        audio_budget_s=args.batch_size * 3.0, max_batch=args.batch_size,
        max_length_s=args.max_length,
        # bucket lengths snapped to a multiple of 16 frames, as extraction does
        frame_align=(*cfg.model.stem_geometry, 16),
    )

    label_by_path = {r["path"]: int(label_to_idx[r["label"]]) for r in train_meta}
    # decode once; epochs reuse the cached padded batches
    cached = []
    for batch in batcher.batches([r["path"] for r in train_meta]):
        n_pad = len(batch.waves) - len(batch.paths)
        labels = np.array([label_by_path.get(p, 0) for p in batch.paths] + [0] * n_pad,
                          np.int32)
        # mask bucket-pad rows, decode failures and unlabeled paths out of the
        # loss and accuracy
        valid = np.array([bool(batch.ok[j]) and p in label_by_path
                          for j, p in enumerate(batch.paths)] + [False] * n_pad, np.float32)
        cached.append((batch.waves, batch.lengths, labels, valid))

    start_epoch = 0
    if args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            params, opt_state, start_epoch = restore_train_state(
                args.checkpoint_dir, step, trainer.state_dict(), trainer.opt.state_dict())
            trainer.model.load_state_dict(params)
            trainer.opt.load_state_dict(opt_state)
            logger.info("resuming from epoch %d", start_epoch)

    rng = np.random.RandomState(0)
    K = max(1, args.grad_accum)
    for epoch in range(start_epoch, args.epochs):
        # steps are enqueued without waiting (sync=False); the losses are
        # read once at the epoch's end
        auxes = []
        if K == 1:
            for i in rng.permutation(len(cached)):
                waves, lengths, labels, valid = cached[i]
                auxes.append(trainer.step(waves, lengths, labels, class_weights,
                                          valid=valid, sync=False))
        else:
            # grad accumulation needs same-shape microbatches: shuffle within
            # each bucket shape, then accumulate K consecutive batches per
            # update (short tails are valid=0-padded inside step_accum)
            by_shape: dict[tuple, list[int]] = {}
            for i in rng.permutation(len(cached)):
                by_shape.setdefault(cached[i][0].shape, []).append(i)
            for idxs in by_shape.values():
                for s in range(0, len(idxs), K):
                    group = [cached[i] for i in idxs[s: s + K]]
                    auxes.append(trainer.step_accum(group, class_weights, sync=False))
        losses = [float(a["loss"]) for a in auxes]
        logger.info("epoch %d: mean loss %.4f", epoch, float(np.mean(losses)))
        if args.checkpoint_dir:
            # epoch index as the checkpoint step: resume restarts at epoch+1
            save_train_state(args.checkpoint_dir, epoch + 1, trainer.state_dict(),
                             trainer.opt.state_dict())

    # evaluation
    y_true, y_pred = [], []
    eval_labels = {r["path"]: int(label_to_idx[r["label"]]) for r in eval_meta}
    for batch in batcher.batches([r["path"] for r in eval_meta]):
        preds = trainer.predict(batch.waves, batch.lengths)
        for j, p in enumerate(batch.paths):
            if batch.ok[j] and p in eval_labels:
                y_true.append(eval_labels[p])
                y_pred.append(int(preds[j]))
    results = classification_metrics(np.array(y_true, np.int64), np.array(y_pred, np.int64),
                                     len(class_names), class_names)
    logger.info("eval balanced_acc=%.4f weighted_f1=%.4f",
                results["balanced_accuracy"], results["weighted_f1"])
    save_results({k: v for k, v in results.items() if k != "confusion_matrix"},
                 args.results_dir, "finetune_results.json")
    save_model(flatten_tree(finetune_params_to_numpy(trainer.state_dict(), cfg_model)),
               args.results_dir, "wavlm_finetune", "weighted_sum", "mlp", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
