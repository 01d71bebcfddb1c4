"""Whisper embedding extraction CLI, one or more GPUs (flags of ``stutter_tpu.cli.extract_whisper``).

    python -m stutter_tpu_torch.cli.extract_whisper --data_dir <corpus> \\
        --output_dir <out> --model_path <local HF checkpoint dir> \\
        [--preset fast|fidelity|turbo] [--long_files trim|chunk] [--verify_model] \\
        [--devices N [--tp T]] [--device cuda]

``--device`` names the torch device (default ``cuda``); with no card it
fails rather than running on the CPU. The weights come from a local HF
checkpoint directory (``--model_path``, or ``--model_name`` naming one), or
with ``--random_init`` from seed 0 in the size ``--model_name`` names; a hub
name raises ``OSError`` (no download). ``--verify_model`` runs the
dummy-forward check first; ``--long_files chunk`` embeds files longer than
30 s as length-weighted 30 s chunks. ``--devices N`` runs N processes, one
per card (default: every visible card), ``--tp T`` cuts encoder and decoder
over T of them (T must divide the heads: 20 in Whisper-large) and splits the
batches over N / T; under ``torchrun`` the CLI joins its group.
``--preset`` takes the JAX CLI's three: fast (bf16), fidelity (f32, no
TF32) and turbo (fast with int8 projections). As in the reference, every
clip is padded or trimmed to 30 s, the one decoder step uses token id 0, and
a run always resumes from the latest checkpoint.
"""

from __future__ import annotations

import argparse
import sys

from stutter_tpu_torch.cli.common import add_mesh_args, build_plan, rank_device, run_on_devices
from stutter_tpu_torch.utils.logging import get_logger, setup_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract Whisper encoder+decoder embeddings (PyTorch/CUDA)")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="openai/whisper-large",
                        help="Whisper model name (any size)")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Local checkpoint directory (overrides --model_name source)")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Clips per device batch (30 s mel each)")
    parser.add_argument("--split", type=str, default="all",
                        choices=["train", "test", "devel", "all"])
    parser.add_argument("--checkpoint_interval", type=int, default=50)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights from seed 0 (no checkpoint load)")
    parser.add_argument("--long_files", type=str, default="trim", choices=["trim", "chunk"],
                        help="Files longer than 30 s: trim (reference behavior) or "
                             "chunk+weighted-average")
    parser.add_argument("--verify_model", action="store_true",
                        help="Dummy-forward model verification before extraction")
    add_mesh_args(parser)
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32, "
                             "turbo=fast with int8 W8A8 encoder projections")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("whisper_embedding")
    logger = get_logger("cli.extract_whisper")
    rc = run_on_devices("stutter_tpu_torch.cli.extract_whisper", argv, args, args.output_dir)
    if rc is not None:
        return rc

    from stutter_tpu_torch.cli.common import load_whisper_model
    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WhisperExtractor
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    plan = build_plan(args)
    device = rank_device(args, plan)
    cfg, model = load_whisper_model(args.model_path or args.model_name, args.random_init)
    logger.info("model: %s (%d enc / %d dec layers, d_model %d) on %s, preset %s",
                args.model_name, cfg.encoder_layers, cfg.decoder_layers, cfg.d_model,
                device, args.preset)

    metadata = create_metadata_from_files(args.data_dir, split=args.split)
    if not metadata:
        logger.error("no files found under %s", args.data_dir)
        return 1
    if args.verify_model:  # after the cheap metadata check
        from stutter_tpu_torch.models.verify import verify_whisper

        verify_whisper(model.to(device), model_name=args.model_path or args.model_name)
    extractor = WhisperExtractor(model, device, preset=args.preset, plan=plan)
    batcher = BucketBatcher(
        target_sr=args.sample_rate,
        buckets_s=(30.0,),  # whisper contract: 30 s pad/trim
        audio_budget_s=30.0 * args.batch_size,
        max_batch=args.batch_size,
        batch_multiple=plan.data_size if plan else 1,
    )
    pipe = ExtractionPipeline(extractor, batcher=batcher,
                              checkpoint_interval=args.checkpoint_interval,
                              long_file_policy=args.long_files)
    splits = [args.split] if args.split != "all" else ["train", "test", "devel"]
    # the whisper reference resumes unconditionally
    pipe.run(metadata, args.output_dir, splits=splits, resume=True)
    logger.info("extraction complete -> %s", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
